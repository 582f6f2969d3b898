"""The paper's 3-D parallel linear operations, forward and backward (port of
``repro/core/ops3d.py``), written over ``core/comm.py``.

Layouts of the local shards (paper §3.1.1):

    x  : (B, S, H)   split (batch, in_ax, out_ax)
    w  : (H, F)      split (out_ax, (in_ax, x))
    y  : (B, S, F)   split (batch, out_ax, in_ax)     directions exchanged

Algorithm 1: all-gather x along in_ax, all-gather w along 'x', local
matmul, reduce-scatter along out_ax.  MLA's low-rank projections use the
two variants of ``ops3d.py:440-558``: ``matmul3d_noswap`` (the down
projections and the mtp head's: contraction psum over out_ax, output
features replicated, no direction swap) and ``matmul3d_repc`` (the up
projections: the contraction replicated, so the local product is exact and
the reduce-scatter is a sequence slice), with ``matmul3d_repc_decode``.  The local matmul ``_mm`` is the K1
kernel.  Algorithm 2, the backward, is the reference's fused island
(``ops3d.py:276-336``): one gather of dc shared by ``dx = dc w^T`` and
``dw = x^T dc``, both products with f32 accumulation.  These two are einsums
outside any Pallas kernel in the reference and ``torch.matmul`` here, which
accumulates bf16 products in f32 (the train launcher turns off cuBLAS's
reduced-precision reductions).  Only
the balanced blocks (x, w) are saved for the backward, as in the paper.

Async-TP (``Layout.overlap``, reference ``ops3d.py:84-172``): each
``matmul3d`` island splits its local contraction dim into k chunks
(``_overlap_k``), so that chunk t+1's all-gathers are in flight
(``comm.all_gather_start``) while chunk t's product runs, and chunk t's
reduce-scatter while chunk t+1's does.  The forward's and dx's partials
are reduce-scattered in f32 and summed in f32 (k scatters of f32 where
the plain island scatters one sum in the activations' dtype), dw's row
chunks are concatenated.  The gathered sequence order is the plain one,
so the result equals the plain island's up to the f32 summation order.
Nothing else chunks: not ``noswap``, ``repc``, decode or the embedding.
"""
from __future__ import annotations

import torch

from ..kernels import matmul as k1
from . import comm
from .topology import Layout


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Local shard matmul through K1: f32 accumulation, output in a's dtype."""
    return k1.matmul(a.contiguous(), b.contiguous())


def _overlap_k(layout: Layout, n: int) -> int:
    """The chunk count of an island whose local contraction dim is ``n``:
    the largest divisor of ``n`` that is <= ``layout.overlap_chunks``; 1
    when overlap is off (reference ``ops3d.py:94-102``)."""
    if not layout.overlap:
        return 1
    k = max(1, min(layout.overlap_chunks, n))
    while n % k:
        k -= 1
    return k


def _pipelined(k: int, start, compute):
    """Run ``compute(t, *gathered_t)`` for t < k, chunk t+1's gathers
    (``start(t + 1)``, a tuple of ``comm.Pending``) in flight meanwhile;
    ``compute`` returns a ``Pending`` reduction, waited on after the next
    chunk's product is launched.  Yields the waited results in chunk
    order, each as soon as it is waited on."""
    nxt, red = start(0), None
    for t in range(k):
        got = [h.wait() for h in nxt]
        if t + 1 < k:
            nxt = start(t + 1)
        cur = compute(t, *got)
        if red is not None:
            yield red.wait()
        red = cur
    yield red.wait()


def _summed(parts):
    """The f32 partials summed into one buffer as each arrives, in chunk
    order (the reference's ``acc = acc + p``); a partial is a fresh tensor
    of its reduction, so the first is the buffer."""
    acc = None
    for p in parts:
        acc = p if acc is None else acc.add_(p)
    return acc


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in f32 (the reference's
    ``preferred_element_type=f32``): on the card one GEMM of the operands'
    own type with an f32 output; the CPU has no such GEMM, so there the
    operands are widened first (bf16 products are exact in f32)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _fwd_chunked(layout, in_ax, out_ax, shard_f, x, w, k):
    """Algorithm 1 in k chunks of the contraction dim (reference
    ``ops3d.py:105-118``): per chunk x's slice gathered over in_ax, w's
    rows over 'x', K1, the partial in f32 reduce-scattered over out_ax;
    the partials summed in f32, cast to x's dtype once."""
    ck = x.shape[-1] // k

    def start(t):
        xk = x[..., t * ck:(t + 1) * ck]
        wk = w[t * ck:(t + 1) * ck]
        return (comm.all_gather_start(layout, xk, in_ax, dim=1),
                comm.all_gather_start(layout, wk, "x", dim=1) if shard_f
                else comm.ready(wk))

    def compute(t, xg, wg):
        return comm.psum_scatter_start(layout, _mm(xg, wg).float(), out_ax,
                                       dim=1)
    return _summed(_pipelined(k, start, compute)).to(x.dtype)


def _dx_chunked(layout, in_ax, dcg, w, k):
    """dx = dc w^T in k chunks of the contraction dim f (reference
    ``ops3d.py:121-142``; ``shard_f`` only): ``dcg`` is the shared gather
    of dc over out_ax; w's column chunks are gathered over 'x', x-major
    blocks of the local width, so dc's matching features come from its
    (sx, f_loc) reshape.  The f32 partials reduce-scattered over in_ax and
    summed in f32."""
    f_loc = w.shape[1]
    ck = f_loc // k
    sx = layout.size("x")
    b, s, _ = dcg.shape
    dcr = dcg.reshape(b, s, sx, f_loc)

    def start(t):
        return (comm.all_gather_start(layout, w[:, t * ck:(t + 1) * ck],
                                      "x", dim=1),)    # (h/so, sx * ck)

    def compute(t, wg):
        dck = dcr[..., t * ck:(t + 1) * ck].reshape(b * s, sx * ck)
        dxp = _mm_f32(dck, wg.t()).reshape(b, s, -1)
        return comm.psum_scatter_start(layout, dxp, in_ax, dim=1)
    return _summed(_pipelined(k, start, compute))


def _dw_chunked(layout, in_ax, shard_f, x, dc2, k):
    """dw = x^T dc in k chunks of its rows (reference ``ops3d.py:145-166``):
    per chunk x's slice gathered over in_ax, the row block cast to x's
    dtype and reduce-scattered over 'x' (summed over it without
    ``shard_f``); the disjoint blocks concatenated.  At k = 1 this is the
    plain island's dw: one gather, one product, one reduction."""
    ck = x.shape[-1] // k

    def start(t):
        return (comm.all_gather_start(layout, x[..., t * ck:(t + 1) * ck],
                                      in_ax, dim=1),)  # (b, S', ck)

    def compute(t, xg):
        dwp = torch.matmul(xg.reshape(-1, ck).t(), dc2).to(x.dtype)
        if shard_f:
            return comm.psum_scatter_start(layout, dwp, "x", dim=1)
        return comm.ready(comm.psum(layout, dwp, "x"))
    rows = list(_pipelined(k, start, compute))
    return torch.cat(rows, dim=0) if k > 1 else rows[0]


class _MatMul3D(torch.autograd.Function):
    """Algorithm 1 forward, the fused Algorithm-2 backward island; both
    chunked under ``layout.overlap`` as the reference's islands are
    (``ops3d.py:195-208``, ``:276-336``)."""

    @staticmethod
    def forward(ctx, x, w, layout, in_ax, out_ax, shard_f):
        ctx.save_for_backward(x, w)                         # balanced blocks
        ctx.cfg = (layout, in_ax, out_ax, shard_f)
        k = _overlap_k(layout, x.shape[-1])
        if k > 1:
            return _fwd_chunked(layout, in_ax, out_ax, shard_f, x, w, k)
        xg = comm.all_gather(layout, x, in_ax, dim=1)       # (b, S', h/so)
        wg = comm.all_gather(layout, w, "x", dim=1) if shard_f else w
        c = _mm(xg, wg)                                     # partial over out_ax
        return comm.psum_scatter(layout, c, out_ax, dim=1)

    @staticmethod
    def backward(ctx, dc):
        x, w = ctx.saved_tensors
        layout, in_ax, out_ax, shard_f = ctx.cfg
        dcg = comm.all_gather(layout, dc, out_ax, dim=1)    # shared gather
        b, s, f = dcg.shape
        dc2 = dcg.reshape(b * s, f)
        k = _overlap_k(layout, x.shape[-1])
        kf = _overlap_k(layout, w.shape[1]) if k > 1 and shard_f else 1
        if kf > 1:
            dx = _dx_chunked(layout, in_ax, dcg, w, kf).to(dc.dtype)
        else:
            wg = comm.all_gather(layout, w, "x", dim=1) if shard_f else w
            dxp = torch.matmul(dc2, wg.t()).reshape(b, s, -1)
            if shard_f:
                # contraction dim f is split over in_ax: the reduce-scatter
                # sums
                dx = comm.psum_scatter(layout, dxp, in_ax, dim=1)
            else:
                # f unsplit: dxp is the full value on every in_ax rank; take
                # this rank's sequence slice, no communication
                s_loc = s // layout.size(in_ax)
                i0 = comm.axis_index(layout, in_ax) * s_loc
                dx = dxp[:, i0:i0 + s_loc]
        dw = _dw_chunked(layout, in_ax, shard_f, x, dc2, k)
        sync = grad_sync_axes(layout)
        if sync:
            dw = comm.psum(layout, dw, sync)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None, None


class _MatMul3DNoSwap(torch.autograd.Function):
    """``matmul3d_noswap`` (reference ``ops3d.py:446-484``): x (B, S, H)
    split (batch, in_ax, out_ax) @ w (H, F) split (out_ax, -) -> (B, S, F)
    split (batch, in_ax, -); the backward's dx is local, dw sums over 'x',
    in_ax and the data axes."""

    @staticmethod
    def forward(ctx, x, w, layout, in_ax, out_ax):
        ctx.save_for_backward(x, w)
        ctx.cfg = (layout, in_ax)
        return comm.psum(layout, _mm(x, w), out_ax)

    @staticmethod
    def backward(ctx, dc):
        x, w = ctx.saved_tensors
        layout, in_ax = ctx.cfg
        b, s, f = dc.shape
        dc2 = dc.reshape(b * s, f)
        dx = torch.matmul(dc2, w.t()).reshape(b, s, -1).to(dc.dtype)
        dw = torch.matmul(x.reshape(b * s, -1).t(), dc2)
        red = tuple(a for a in ("x", in_ax, *grad_sync_axes(layout))
                    if layout.size(a) > 1)
        if red:
            dw = comm.psum(layout, dw, red)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


class _MatMul3DRepC(torch.autograd.Function):
    """``matmul3d_repc`` (reference ``ops3d.py:487-555``): x (B, S, R)
    split (batch, in_ax, -) @ w (R, F) split (-, (in_ax, x)) -> (B, S, F)
    split (batch, out_ax, in_ax).  R is replicated, so the local product
    is exact and the output's sequence split is a slice."""

    @staticmethod
    def forward(ctx, x, w, layout, in_ax, out_ax):
        xg = comm.all_gather(layout, x, in_ax, dim=1)       # (b, S', R)
        wg = comm.all_gather(layout, w, "x", dim=1)         # (R, f/si)
        c = _mm(xg, wg)
        s_loc = c.shape[1] // layout.size(out_ax)
        i0 = comm.axis_index(layout, out_ax) * s_loc
        ctx.save_for_backward(x, w)
        ctx.cfg = (layout, in_ax, out_ax)
        return c[:, i0:i0 + s_loc]

    @staticmethod
    def backward(ctx, dc):
        x, w = ctx.saved_tensors
        layout, in_ax, out_ax = ctx.cfg
        dcg = comm.all_gather(layout, dc, out_ax, dim=1)    # (b, S', f/si)
        wg = comm.all_gather(layout, w, "x", dim=1)
        b, s, f = dcg.shape
        dc2 = dcg.reshape(b * s, f)
        dxp = torch.matmul(dc2, wg.t()).reshape(b, s, -1).to(dc.dtype)
        dx = comm.psum_scatter(layout, dxp, in_ax, dim=1)
        xg = comm.all_gather(layout, x, in_ax, dim=1)
        dwp = torch.matmul(xg.reshape(b * s, -1).t(), dc2)
        dw = comm.psum_scatter(layout, dwp, "x", dim=1)
        sync = grad_sync_axes(layout)
        if sync:
            dw = comm.psum(layout, dw, sync)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def matmul3d_noswap(layout: Layout, in_ax: str, out_ax: str, x, w):
    """The no-swap 3-D linear of MLA's down projections and the mtp head's
    projection (``_MatMul3DNoSwap``), differentiable; the local product
    through K1."""
    return _MatMul3DNoSwap.apply(x, w, layout, in_ax, out_ax)


def matmul3d_repc(layout: Layout, in_ax: str, out_ax: str, x, w):
    """The replicated-contraction 3-D linear of MLA's up projections
    (``_MatMul3DRepC``), differentiable; the local product through K1."""
    return _MatMul3DRepC.apply(x, w, layout, in_ax, out_ax)


def matmul3d_repc_decode(layout: Layout, in_ax: str, out_ax: str, x, w):
    """Decode variant of ``matmul3d_repc`` (reference ``ops3d.py:517-529``):
    x (B, 1, R) replicated -> (B, 1, F) split over in_ax; w gathered along
    'x' unless the layout keeps it x-replicated (``inference_opt``)."""
    wg = w if layout.inference_opt else comm.all_gather(layout, w, "x",
                                                        dim=1)
    return _mm(x, wg)


def grad_sync_axes(layout: Layout):
    """Axes the weight gradient is summed over beyond the cube's 'x'
    reduce-scatter (reference ``_grad_sync_axes``): the batch axes and the
    sequence axes outside the cube, of size > 1, each once."""
    axes = [a for a in (*layout.batch_axes, *layout.seq_axes)
            if a not in ("x", "y", "z") and layout.size(a) > 1]
    return tuple(dict.fromkeys(axes))


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
