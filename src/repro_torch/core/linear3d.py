"""Layer-level parallel primitives (port of ``repro/core/linear3d.py``):
the 3-D linear with its direction swap, the norms, the embedding lookup,
the vocab-parallel cross entropy, and the declarations of their leaves
with the reference's specs.

The reference leaves the norms' moments and the cross entropy's sums over
a split dim to GSPMD, which "emits exactly the paper's psum over out_ax"
(``linear3d.py:128-160``, ``:201-213``); here each of those reductions is
issued by name (``core/comm.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import rmsnorm as k3
from . import comm, ops3d
from .params import Param
from .topology import Dirs, Layout


def weight_param(dirs: Dirs, h: int, f: int, *, shard_f: bool = True,
                 init_scale: float = 1.0) -> Param:
    """An (h, f) weight of a 3-D linear (reference ``linear3d.py:44-68``):
    rows over out_ax, columns over (in_ax, 'x'), or ``P(out_ax, None)``
    with ``shard_f=False``.  Its island sums its gradient."""
    spec = (dirs.out_ax, (dirs.in_ax, "x")) if shard_f else (dirs.out_ax,
                                                             None)
    return Param((h, f), scale=init_scale, spec=spec, synced=True)


def norm_param(dirs: Dirs, h: int, *, init: str = "ones") -> Param:
    """A norm's (h,) gain or bias, split like the hidden dim it scales,
    over out_ax (reference ``linear3d.py:138-146``)."""
    return Param((h,), init=init, spec=(dirs.out_ax,))


def embed_param(dirs: Dirs, vocab: int, h: int) -> Param:
    """The (vocab, h) table: rows over in_ax, columns over out_ax
    (reference ``linear3d.py:170-180``); ``embedding3d`` sums its
    gradient."""
    return Param((vocab, h), init="embed", spec=(dirs.in_ax, dirs.out_ax),
                 synced=True)


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


def rmsnorm(x, gamma, eps: float = 1e-6, zero_centered: bool = False,
            layout: Layout = None, axis=None):
    """RMSNorm over the last dim through K3 (``kernels/rmsnorm.py``),
    forward and backward.  When ``axis`` (out_ax) of ``layout`` splits the
    hidden dim, K3 runs in two phases around a ``psum`` of the rows'
    partial moments, and the dot of its backward, over the axis."""
    x, gamma = x.contiguous(), gamma.contiguous()
    if layout is None or not layout.live((axis,)):
        return k3.rmsnorm(x, gamma, eps, zero_centered)
    n = layout.size(axis)
    return k3.rmsnorm_split(x, gamma, eps, zero_centered,
                            x.shape[-1] * n,
                            lambda t: comm.psum(layout, t, axis))


def layernorm(x, gamma, beta, eps: float = 1e-5, layout: Layout = None,
              axis=None):
    """LayerNorm over the last dim in f32, as the reference's is jnp.  When
    ``axis`` splits the hidden dim, the mean and the variance sum the
    rows' partials over it (``comm.psum_ad``: each rank applies them to
    its own columns, so the gradients sum back)."""
    xf = x.float()
    n = 1 if layout is None else layout.size(axis)
    h = xf.shape[-1] * n
    if n == 1:
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    else:
        mu = comm.psum_ad(layout, xf.sum(dim=-1, keepdim=True), axis) / h
        var = comm.psum_ad(layout, ((xf - mu) ** 2).sum(dim=-1, keepdim=True),
                           axis) / h
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def embed_lookup(layout: Layout, dirs: Dirs, ids, table, decode: bool = False):
    """ids (B, S) -> activations in the entry layout."""
    if layout.strategy == "3d" and not decode:
        return ops3d.embedding3d(layout, dirs.in_ax, dirs.out_ax, ids, table)
    return table[ids]


def cross_entropy_sums(layout: Layout, vocab_ax, logits, labels, mask):
    """(sum of the masked per-token nll, sum of the mask) over this rank's
    tokens, with the vocab dim of ``logits`` (..., V_loc) split over
    ``vocab_ax`` (reference ``linear3d.py:201-213`` and
    ``transformer.py:268-275``): the detached running max is a ``pmax``,
    and the softmax's sum and the picked logit (masked to this rank's
    vocab range, as ``embedding3d`` masks ids) are ``psum``s over the
    axis.  Every rank of the axis then holds the same nll and seeds the
    same gradient, so those sums take the identity as their backward
    (``comm.psum_id``)."""
    lf = logits.float()
    v_loc = lf.shape[-1]
    m = comm.pmax(layout, lf.amax(dim=-1, keepdim=True).detach(), vocab_ax)
    se = comm.psum_id(layout, torch.exp(lf - m).sum(dim=-1), vocab_ax)
    lse = torch.log(se) + m[..., 0]
    local = labels - comm.axis_index(layout, vocab_ax) * v_loc
    ok = (local >= 0) & (local < v_loc)
    picked = torch.gather(lf, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    picked = comm.psum_id(layout, torch.where(ok, picked, 0.0), vocab_ax)
    nll = (lse - picked) * mask
    return nll.sum(), mask.sum()
