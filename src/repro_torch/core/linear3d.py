"""Layer-level parallel primitives (port of ``repro/core/linear3d.py``):
the 3-D linear with its direction swap, the norms and the embedding lookup.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import rmsnorm as k3
from . import ops3d
from .topology import Dirs, Layout


def plinear(layout: Layout, dirs: Dirs, x, w, b=None, *, kind: str = "first",
            shard_f: bool = True,
            decode: bool = False) -> Tuple[torch.Tensor, Dirs]:
    """Parallel linear y = x @ w (+ b).  Returns (y, new_dirs): the 3-D
    branch of the reference (``linear3d.py:90-126``) swaps the directions.
    ``kind`` names the 1-D baseline's column/row split and is unused by the
    3-D branch."""
    if layout.strategy != "3d":
        raise NotImplementedError(
            f"strategy {layout.strategy!r}: the 1-D and 2-D baselines are "
            "not ported yet (ROADMAP.md, Queue 1 item 4)")
    if decode:
        y = ops3d.matmul3d_decode(layout, dirs.in_ax, dirs.out_ax, x, w,
                                  shard_f)
    else:
        y = ops3d.matmul3d(layout, dirs.in_ax, dirs.out_ax, x, w, shard_f)
    if b is not None:
        y = y + b.to(y.dtype)
    return y, dirs.swap()


def rmsnorm(x, gamma, eps: float = 1e-6, zero_centered: bool = False):
    """RMSNorm over the last dim through K3 (``kernels/rmsnorm.py``),
    forward and backward."""
    return k3.rmsnorm(x.contiguous(), gamma.contiguous(), eps, zero_centered)


def layernorm(x, gamma, beta, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def embed_lookup(layout: Layout, dirs: Dirs, ids, table, decode: bool = False):
    """ids (B, S) -> activations in the entry layout."""
    if layout.strategy == "3d" and not decode:
        return ops3d.embedding3d(layout, dirs.in_ax, dirs.out_ax, ids, table)
    return table[ids]
