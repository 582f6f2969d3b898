"""Layer-level parallel primitives (port of ``repro/core/linear3d.py``):
the linear that dispatches on the layout's strategy (the paper's 3-D
algorithm with its direction swap, or the 1-D and 2-D baselines of
``ops1d``/``ops2d``), the norms, the embedding lookup, the vocab-parallel
cross entropy, the axes that split the activations per strategy, and the
declarations of their leaves with the reference's specs.

The reference leaves the norms' moments and the cross entropy's sums over
a split dim to GSPMD, which "emits exactly the paper's psum over out_ax"
(``linear3d.py:128-160``, ``:201-213``); here each of those reductions is
issued by name (``core/comm.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import rmsnorm as k3
from . import comm, ops1d, ops2d, ops3d
from .params import Param
from .topology import Dirs, Layout


def act_axes(layout: Layout, dirs: Dirs):
    """(sequence axis, hidden axis) of the activations in the layout of
    ``dirs`` (reference ``act_spec``): 3d (in_ax, out_ax), 2d ('y', 'z'),
    1d (None, None), replicated over the model axes."""
    if layout.strategy == "3d":
        return dirs.in_ax, dirs.out_ax
    if layout.strategy == "2d":
        return "y", "z"
    return None, None


def out_axes(layout: Layout, dirs: Dirs):
    """(sequence axis, feature axis) of a first linear's output from the
    layout of ``dirs``: the post-qkv heads (reference ``blocks._head_axes``)
    and the logits' vocab (``logits_spec``).  3d (out_ax, in_ax), 2d ('y',
    'z'), 1d (None, 'z')."""
    if layout.strategy == "3d":
        return dirs.out_ax, dirs.in_ax
    if layout.strategy == "2d":
        return "y", "z"
    return None, "z"


def weight_param(dirs: Dirs, h: int, f: int, *, kind: str = "first",
                 shard_f: bool = True, init_scale: float = 1.0,
                 strategy: str = "3d") -> Param:
    """An (h, f) weight with the strategy's placement (reference
    ``linear3d.py:44-68``): 3d rows over out_ax, columns over (in_ax, 'x'),
    or ``(out_ax, None)`` with ``shard_f=False``; 2d ('y', 'z') or ('y',
    None); 1d (None, 'z') for the first linear of a pair (``kind``), ('z',
    None) for the second, or replicated.  Its linear sums its gradient."""
    if strategy == "3d":
        spec = (dirs.out_ax, (dirs.in_ax, "x")) if shard_f else (
            dirs.out_ax, None)
    elif strategy == "2d":
        spec = ("y", "z" if shard_f else None)
    elif not shard_f:
        spec = (None, None)
    else:
        spec = (None, "z") if kind == "first" else ("z", None)
    return Param((h, f), scale=init_scale, spec=spec, synced=True)


def bias_param(dirs: Dirs, f: int, *, kind: str = "first",
               shard_f: bool = True, strategy: str = "3d") -> Param:
    """An (f,) bias split like its linear's output features (reference
    ``linear3d.py:71-82``); the row linear's bias at 1d is read by
    activations replicated over 'z'."""
    if not shard_f:
        return Param((f,), init="zeros", spec=(None,))
    if strategy == "3d":
        return Param((f,), init="zeros", spec=(dirs.in_ax,))
    if strategy == "2d" or kind == "first":
        return Param((f,), init="zeros", spec=("z",))
    return Param((f,), init="zeros", spec=(None,), act_rep=("z",))


def norm_param(dirs: Dirs, h: int, *, init: str = "ones",
               strategy: str = "3d") -> Param:
    """A norm's (h,) gain or bias, split like the hidden dim it scales
    (reference ``linear3d.py:138-146``): 3d over out_ax, 2d over 'z', 1d
    whole, read by activations replicated over 'z'."""
    if strategy == "3d":
        return Param((h,), init=init, spec=(dirs.out_ax,))
    if strategy == "2d":
        return Param((h,), init=init, spec=("z",))
    return Param((h,), init=init, spec=(None,), act_rep=("z",))


def embed_param(dirs: Dirs, vocab: int, h: int,
                strategy: str = "3d") -> Param:
    """The (vocab, h) table (reference ``linear3d.py:170-180``): 3d rows
    over in_ax, columns over out_ax, 2d ('y', 'z'), both summed by
    ``embedding3d``; 1d rows over 'z', its gradient summed over the data
    axes by the train step (``embed_lookup``)."""
    if strategy == "1d":
        return Param((vocab, h), init="embed", spec=("z", None))
    spec = ("y", "z") if strategy == "2d" else (dirs.in_ax, dirs.out_ax)
    return Param((vocab, h), init="embed", spec=spec, synced=True)


def plinear(layout: Layout, dirs: Dirs, x, w, b=None, *, kind: str = "first",
            shard_f: bool = True,
            decode: bool = False) -> Tuple[torch.Tensor, Dirs]:
    """Parallel linear y = x @ w (+ b).  Returns (y, new_dirs): the 3-D
    branch of the reference (``linear3d.py:90-126``) swaps the directions,
    the baselines do not.  ``kind`` names the 1-D baseline's column
    ("first") or row ("second") split.  A 1-D or 2-D decode runs at one
    device only (multi-rank serving is refused), where it is the local
    product."""
    if layout.strategy == "3d":
        if decode:
            y = ops3d.matmul3d_decode(layout, dirs.in_ax, dirs.out_ax, x, w,
                                      shard_f)
        else:
            y = ops3d.matmul3d(layout, dirs.in_ax, dirs.out_ax, x, w,
                               shard_f)
        dirs = dirs.swap()
    elif decode:
        y = ops3d._mm(x, w)
    elif layout.strategy == "2d":
        y = (ops2d.matmul2d if shard_f else ops2d.matmul2d_rep)(layout, x,
                                                                 w)
    elif not shard_f:
        y = ops1d.linear1d_rep(layout, x, w)
    else:
        y = (ops1d.linear1d_col if kind == "first"
             else ops1d.linear1d_row)(layout, x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y, dirs


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
    """ids (B, S) -> activations in the entry layout.  3d and 2d:
    ``embedding3d`` over (in_ax, out_ax), at 2d ('y', 'z'), the placement
    of the 2-D table and activations; 1d: the masked lookup of the rank's
    vocab rows, summed over 'z' by ``comm.psum_id``, since every rank of
    'z' holds the whole cotangent; a decode (one device): the lookup."""
    if decode:
        return table[ids]
    if layout.strategy != "1d":
        in_ax, out_ax = act_axes(layout, dirs)
        return ops3d.embedding3d(layout, in_ax, out_ax, ids, table)
    v_loc = table.shape[0]
    local = ids - comm.axis_index(layout, "z") * v_loc
    ok = (local >= 0) & (local < v_loc)
    emb = torch.where(ok[..., None], table[local.clamp(0, v_loc - 1)],
                      torch.zeros((), dtype=table.dtype,
                                  device=table.device))
    return comm.psum_id(layout, emb, "z")


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
