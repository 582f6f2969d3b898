"""Megatron-LM style 1-D tensor parallelism, the paper's first baseline
(port of ``repro/core/ops1d.py``, paper §2.2 [17]), written over
``core/comm.py``.

The model degree n lives on the 'z' axis (cube (1, 1, n)).  Activations
are replicated over it; weights split along one dim:

    column:  w (None, 'z')   y = x @ w            no forward communication
    row:     w ('z', None)   y = psum_z(x @ w)    forward all-reduce

The local product is K1 (``ops3d._mm``, the reference's ``_LOCAL_MATMUL``
hook).  The backward's products are ``torch.matmul``, which accumulates
in f32 as the reference's einsums do (``ops3d``): the column linear
all-reduces dx over 'z'; the row linear's dx is local, since its incoming
cotangent is whole on every rank.  dw is summed over ``ops3d.grad_sync_axes`` here, so
the weight leaves are ``synced``.
"""
from __future__ import annotations

import torch

from . import comm
from .ops3d import _mm, grad_sync_axes
from .topology import Layout


class _Linear1D(torch.autograd.Function):
    """The local product, all-reduced over 'z' after it when ``reduce`` (the
    row linear); ``gather_dx`` all-reduces dx over 'z' (the column
    linear)."""

    @staticmethod
    def forward(ctx, x, w, layout, reduce, gather_dx):
        ctx.save_for_backward(x, w)
        ctx.cfg = (layout, gather_dx)
        y = _mm(x, w)
        return comm.psum(layout, y, "z") if reduce else y

    @staticmethod
    def backward(ctx, dc):
        x, w = ctx.saved_tensors
        layout, gather_dx = ctx.cfg
        dx = torch.matmul(dc, w.t())
        if gather_dx:
            dx = comm.psum(layout, dx, "z")
        dw = torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                          dc.reshape(-1, dc.shape[-1]))
        sync = grad_sync_axes(layout)
        if sync:
            dw = comm.psum(layout, dw, sync)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def linear1d_col(layout: Layout, x, w):
    """x (B, S, H) replicated over 'z' @ w (H, F/n) -> (B, S, F/n), the
    output's features split over 'z' (reference ``ops1d.py:51-79``)."""
    return _Linear1D.apply(x, w, layout, False, True)


def linear1d_row(layout: Layout, x, w):
    """x (B, S, F/n) split over 'z' @ w (F/n, H) -> (B, S, H) replicated,
    a forward all-reduce over 'z' (reference ``ops1d.py:82-110``)."""
    return _Linear1D.apply(x, w, layout, True, False)


def linear1d_rep(layout: Layout, x, w):
    """x (B, S, H) @ w (H, F), both replicated over 'z': one local product
    (the reference's GSPMD einsum for ``shard_f=False``, ``linear3d.py:119``).
    Every rank holds the whole cotangent, so dx is local and dw is summed
    over the data axes only."""
    return _Linear1D.apply(x, w, layout, False, False)
