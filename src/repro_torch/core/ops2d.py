"""Optimus / SUMMA-style 2-D tensor parallelism, the paper's second
baseline (port of ``repro/core/ops2d.py``, paper §2.2 [21]), written over
``core/comm.py``.

The model degree q·q lives on the ('y', 'z') axes (cube (1, q, q)).
Activations and weights are both blocked (q, q):

    x : (B, S, H)  split (batch, 'y', 'z')   sequence rows over y, hidden over z
    w : (H, F)     split ('y', 'z')

Forward: all-gather x along 'z' (whole rows of H), all-gather w along 'y'
(whole columns of H), the local product through K1 (``ops3d._mm``): the
output is blocked (y, z) with no reduction.

The backward is the reference's ``_bwd`` as written (``ops2d.py:187-209``),
so that the port's gradients equal the JAX package's, and it is wrong on
every rank off the grid's diagonal (ROADMAP.md, Queue 3, fault 6): rank
(y=i, z=j) forms dx from the row block j of w gathered over 'z', which is
the block the ranks with y=j hold, where it holds block i; dw likewise
comes out as block (h_j, f_j) where the rank holds (h_i, f_j).
"""
from __future__ import annotations

import torch

from . import comm
from .ops3d import _mm, grad_sync_axes
from .topology import Layout


class _MatMul2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, layout):
        xg = comm.all_gather(layout, x, "z", dim=2)        # (b, s/q, H)
        wg = comm.all_gather(layout, w, "y", dim=0)        # (H, f/q)
        ctx.save_for_backward(x, w)
        ctx.layout = layout
        return _mm(xg, wg)                                  # (b, s/q, f/q)

    @staticmethod
    def backward(ctx, dc):
        x, w = ctx.saved_tensors
        layout = ctx.layout
        dcg = comm.all_gather(layout, dc, "z", dim=2)      # (b, s/q, F)
        wg = comm.all_gather(layout, w, "z", dim=1)        # (h/q, F)
        dx = torch.matmul(dcg, wg.t())
        xg = comm.all_gather(layout, x, "y", dim=1)        # (b, S', h/q)
        dcg = comm.all_gather(layout, dc, "y", dim=1)      # (b, S', f/q)
        dw = torch.matmul(xg.reshape(-1, xg.shape[-1]).t(),
                          dcg.reshape(-1, dcg.shape[-1]))
        sync = grad_sync_axes(layout)
        if sync:
            dw = comm.psum(layout, dw, sync)
        return dx.to(x.dtype), dw.to(w.dtype), None


class _MatMul2DRep(torch.autograd.Function):
    """``shard_f=False``: w (H, F) split ('y', None), the output (b, s/q, F)
    whole over 'z' (the reference's GSPMD einsum, ``linear3d.py:112``).  The
    attention island sums the cotangent of such an output over 'z'
    (``comm.grad_psum``), so every rank of 'z' holds it whole: dx is the
    rank's 'z' block of dc @ w^T, and dw the reduce-scatter over 'y' of
    x^T dc."""

    @staticmethod
    def forward(ctx, x, w, layout):
        xg = comm.all_gather(layout, x, "z", dim=2)        # (b, s/q, H)
        wg = comm.all_gather(layout, w, "y", dim=0)        # (H, F)
        ctx.save_for_backward(x, w)
        ctx.layout = layout
        return _mm(xg, wg)

    @staticmethod
    def backward(ctx, dc):
        x, w = ctx.saved_tensors
        layout = ctx.layout
        wg = comm.all_gather(layout, w, "y", dim=0)
        h = x.shape[-1]
        i0 = comm.axis_index(layout, "z") * h
        dx = torch.matmul(dc, wg[i0:i0 + h].t())
        xg = comm.all_gather(layout, x, "z", dim=2)
        dw = torch.matmul(xg.reshape(-1, xg.shape[-1]).t(),
                          dc.reshape(-1, dc.shape[-1]))
        dw = comm.psum_scatter(layout, dw, "y", dim=0)
        sync = grad_sync_axes(layout)
        if sync:
            dw = comm.psum(layout, dw, sync)
        return dx.to(x.dtype), dw.to(w.dtype), None


def matmul2d(layout: Layout, x, w):
    """2-D parallel ``y = x @ w`` for (B, S, H) x (H, F) (reference
    ``ops2d.py:173-212``), differentiable through the reference's backward
    (fault 6 above)."""
    return _MatMul2D.apply(x, w, layout)


def matmul2d_rep(layout: Layout, x, w):
    """2-D ``y = x @ w`` with w's features whole (``_MatMul2DRep``)."""
    return _MatMul2DRep.apply(x, w, layout)
