"""The paper's 3-D parallel linear operations, forward paths (port of
``repro/core/ops3d.py``), written over ``core/comm.py``.

Layouts of the local shards (paper §3.1.1):

    x  : (B, S, H)   split (batch, in_ax, out_ax)
    w  : (H, F)      split (out_ax, (in_ax, x))
    y  : (B, S, F)   split (batch, out_ax, in_ax)     directions exchanged

Algorithm 1: all-gather x along in_ax, all-gather w along 'x', local
matmul, reduce-scatter along out_ax.  The local matmul ``_mm`` is the K1
kernel.  The backward islands (Algorithm 2) arrive with the training slice.
"""
from __future__ import annotations

import torch

from ..kernels import matmul as k1
from . import comm
from .topology import Layout


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Local shard matmul through K1: f32 accumulation, output in a's dtype."""
    return k1.matmul(a.contiguous(), b.contiguous())


def matmul3d(layout: Layout, in_ax: str, out_ax: str, x, w,
             shard_f: bool = True):
    """3-D parallel ``y = x @ w`` for (B, S, H) x (H, F), Algorithm 1
    (reference ``ops3d.py:195-207``).  Output directions swapped."""
    xg = comm.all_gather(layout, x, in_ax, dim=1)           # (b, S', h/so)
    wg = comm.all_gather(layout, w, "x", dim=1) if shard_f else w
    c = _mm(xg, wg)                                         # partial over out_ax
    return comm.psum_scatter(layout, c, out_ax, dim=1)


def matmul3d_decode(layout: Layout, in_ax: str, out_ax: str, x, w,
                    shard_f: bool = True):
    """Single-token matvec against the 3-D weight placement (reference
    ``ops3d.py:353-367``): x (B, 1, H) split over out_ax -> (B, 1, F) split
    over in_ax.  s == 1 cannot be sequence-split, so the island is: gather
    w along 'x' (not with the x-replicated ``inference_opt`` layout), local
    matmul, all-reduce along out_ax."""
    gather_w = shard_f and not layout.inference_opt
    wg = comm.all_gather(layout, w, "x", dim=1) if gather_w else w
    return comm.psum(layout, _mm(x, wg), out_ax)


def embedding3d(layout: Layout, in_ax: str, out_ax: str, ids, table):
    """Vocab-parallel embedding (reference ``ops3d.py:386-400``): table rows
    split over in_ax, columns over out_ax.  Gather the ids along in_ax, take
    from the local vocab slice with masking, and reduce-scatter along in_ax
    (which sums the vocab partials and restores the sequence split)."""
    v_loc = table.shape[0]
    idsg = comm.all_gather(layout, ids, in_ax, dim=1)       # (b, S')
    local = idsg - comm.axis_index(layout, in_ax) * v_loc
    ok = (local >= 0) & (local < v_loc)
    emb = table[local.clamp(0, v_loc - 1)]
    emb = torch.where(ok[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                      device=emb.device))
    return comm.psum_scatter(layout, emb, in_ax, dim=1)
