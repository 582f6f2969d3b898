"""The paper's 3-D parallel linear operations, forward and backward (port of
``repro/core/ops3d.py``), written over ``core/comm.py``.

Layouts of the local shards (paper §3.1.1):

    x  : (B, S, H)   split (batch, in_ax, out_ax)
    w  : (H, F)      split (out_ax, (in_ax, x))
    y  : (B, S, F)   split (batch, out_ax, in_ax)     directions exchanged

Algorithm 1: all-gather x along in_ax, all-gather w along 'x', local
matmul, reduce-scatter along out_ax.  The local matmul ``_mm`` is the K1
kernel.  Algorithm 2, the backward, is the reference's fused island
(``ops3d.py:276-336``): one gather of dc shared by ``dx = dc w^T`` and
``dw = x^T dc``, both products with f32 accumulation.  These two are einsums
outside any Pallas kernel in the reference and ``torch.matmul`` here, which
accumulates bf16 products in f32 (the train launcher turns off cuBLAS's
reduced-precision reductions).  Only
the balanced blocks (x, w) are saved for the backward, as in the paper.
"""
from __future__ import annotations

import torch

from ..kernels import matmul as k1
from . import comm
from .topology import Layout


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Local shard matmul through K1: f32 accumulation, output in a's dtype."""
    return k1.matmul(a.contiguous(), b.contiguous())


class _MatMul3D(torch.autograd.Function):
    """Algorithm 1 forward, the fused Algorithm-2 backward island."""

    @staticmethod
    def forward(ctx, x, w, layout, in_ax, out_ax, shard_f):
        xg = comm.all_gather(layout, x, in_ax, dim=1)       # (b, S', h/so)
        wg = comm.all_gather(layout, w, "x", dim=1) if shard_f else w
        c = _mm(xg, wg)                                     # partial over out_ax
        ctx.save_for_backward(x, w)                         # balanced blocks
        ctx.cfg = (layout, in_ax, out_ax, shard_f)
        return comm.psum_scatter(layout, c, out_ax, dim=1)

    @staticmethod
    def backward(ctx, dc):
        x, w = ctx.saved_tensors
        layout, in_ax, out_ax, shard_f = ctx.cfg
        dcg = comm.all_gather(layout, dc, out_ax, dim=1)    # shared gather
        b, s, f = dcg.shape
        dc2 = dcg.reshape(b * s, f)
        wg = comm.all_gather(layout, w, "x", dim=1) if shard_f else w
        dxp = torch.matmul(dc2, wg.t()).reshape(b, s, -1)
        if shard_f:
            # contraction dim f is split over in_ax: the reduce-scatter sums
            dx = comm.psum_scatter(layout, dxp, in_ax, dim=1)
        else:
            # f unsplit: dxp is the full value on every in_ax rank; take this
            # rank's sequence slice, no communication
            s_loc = s // layout.size(in_ax)
            i0 = comm.axis_index(layout, in_ax) * s_loc
            dx = dxp[:, i0:i0 + s_loc]
        xg = comm.all_gather(layout, x, in_ax, dim=1)
        # dw cast to x's dtype before its reduce-scatter (ops3d.py:253-255)
        dwp = torch.matmul(xg.reshape(b * s, -1).t(), dc2).to(x.dtype)
        if shard_f:
            dw = comm.psum_scatter(layout, dwp, "x", dim=1)
        else:
            dw = comm.psum(layout, dwp, "x")
        sync = grad_sync_axes(layout)
        if sync:
            dw = comm.psum(layout, dw, sync)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None, None


def grad_sync_axes(layout: Layout):
    """Axes the weight gradient is summed over beyond the cube's 'x'
    reduce-scatter: the data-parallel axes (reference ``_grad_sync_axes``
    with batch axes (pod, dp, x) and no sequence axes)."""
    return tuple(a for a in ("pod", "dp") if layout.size(a) > 1)


def matmul3d(layout: Layout, in_ax: str, out_ax: str, x, w,
             shard_f: bool = True):
    """3-D parallel ``y = x @ w`` for (B, S, H) x (H, F), Algorithm 1
    (reference ``ops3d.py:195-207``), differentiable through Algorithm 2.
    Output directions swapped."""
    return _MatMul3D.apply(x, w, layout, in_ax, out_ax, shard_f)


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


class _Embedding3D(torch.autograd.Function):
    """Vocab-parallel lookup; the backward is the reference's f32
    scatter-add into the local table (``ops3d.py:408-425``)."""

    @staticmethod
    def forward(ctx, table, ids, layout, in_ax, out_ax):
        v_loc = table.shape[0]
        idsg = comm.all_gather(layout, ids, in_ax, dim=1)   # (b, S')
        local = idsg - comm.axis_index(layout, in_ax) * v_loc
        ok = (local >= 0) & (local < v_loc)
        emb = table[local.clamp(0, v_loc - 1)]
        emb = torch.where(ok[..., None], emb,
                          torch.zeros((), dtype=emb.dtype, device=emb.device))
        ctx.save_for_backward(ids)
        ctx.cfg = (layout, in_ax, table.shape, table.dtype)
        return comm.psum_scatter(layout, emb, in_ax, dim=1)

    @staticmethod
    def backward(ctx, dc):
        (ids,) = ctx.saved_tensors
        layout, in_ax, tshape, tdtype = ctx.cfg
        v_loc = tshape[0]
        idsg = comm.all_gather(layout, ids, in_ax, dim=1)
        dcg = comm.all_gather(layout, dc, in_ax, dim=1)     # (b, S', h/so)
        local = idsg - comm.axis_index(layout, in_ax) * v_loc
        ok = (local >= 0) & (local < v_loc)
        upd = torch.where(ok[..., None], dcg.float(), 0.0)
        dtab = torch.zeros((v_loc, dcg.shape[-1]), dtype=torch.float32,
                           device=dc.device)
        dtab.index_add_(0, local.clamp(0, v_loc - 1).reshape(-1),
                        upd.reshape(-1, dcg.shape[-1]))
        sync = grad_sync_axes(layout) + tuple(
            a for a in ("x",) if layout.size(a) > 1)
        if sync:
            dtab = comm.psum(layout, dtab, sync)
        return dtab.to(tdtype), None, None, None, None


def embedding3d(layout: Layout, in_ax: str, out_ax: str, ids, table):
    """Vocab-parallel embedding (reference ``ops3d.py:386-436``): table rows
    split over in_ax, columns over out_ax.  Gather the ids along in_ax, take
    from the local vocab slice with masking, and reduce-scatter along in_ax
    (which sums the vocab partials and restores the sequence split);
    differentiable in the table."""
    return _Embedding3D.apply(table, ids, layout, in_ax, out_ax)
