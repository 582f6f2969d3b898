"""K5: the Mamba2 SSD chunked scan, forward and backward (CUDA C++,
``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd_scan.py:ssd_scan`` (Pallas kernel
``_ssd_kernel``, wrapper ``kernels/ops.py:pallas_ssd``), whose function the
JAX model computes in ``models/mamba2.py:ssd_chunked``.  Here
``models/mamba2.py:ssd_chunked`` calls ``ssd_scan`` below, so every SSD scan
of the model goes through K5.  The TPU kernel has no backward (JAX
differentiates ``ssd_chunked``); the port's backward is a kernel too.

The layout is the model's, not the Pallas kernel's flattened one:

    xbar (b, T, nh, P) f32    dt-scaled inputs
    la   (b, T, nh)    f32    per-step log-decays
    B, C (b, T, G, N)         float32 or bfloat16; head h reads group
                              h // (nh / G), ``jnp.repeat``'s order
    y    (b, T, nh, P) f32

Per chunk of Q steps (Q the largest divisor of T not above ``chunk``, as
``ssd_chunked`` picks it), with cum = cumsum(la) over the chunk and
tot = cum[-1]:

    y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xbar_j
          + exp(cum_i) C_i H
    H  <- exp(tot) H + sum_j exp(tot - cum_j) B_j^T xbar_j

with the state H (N, P) carried across the chunks in order, all in f32.
The forward also returns H at the start of every chunk, ``states``
(b, nh, n_chunks, N, P) f32, which is all the backward saves beside the
inputs.  The exponent exp(cum_i - cum_j) is formed only where i >= j: above
the diagonal it overflows to inf and inf * 0 is NaN in a backward
(``mamba2.py:70-73``).

Bound on an H100: bytes.  At the training shape (b 4, T 2048, 64 heads of
64, G 2, N 64, Q 256) a forward does about 26 GFLOP over the allowed pairs
(0.026 ms at the dense bf16 peak) and must move about 0.28 GB (0.083 ms at
3.35 TB/s): xbar in and y out in f32 are most of it.  Design (for Hopper,
chunk-parallel as the public Mamba2 SSD kernels are): every chunk is cut
into sub-chunks of ``SUB`` = 64 steps, across which the state is carried
(the recurrence holds for any split, and what the chunk's sub-blocks below
the diagonal would add becomes the carried state's term).  The forward
computes each sub-chunk's own state in parallel, then passes the state
over the sub-chunk boundaries in a short sequential pass (which writes
``states``), then each sub-chunk's outputs in parallel; the backward does
the same from ``states``, carries dH over the boundaries in reverse, and
computes dxbar, dla and the per-head dB and dC of each sub-chunk in
parallel, summed over the heads of each group by a last kernel in a fixed
order: no atomics, so the same inputs give the same bits.  C B^T is the
same for every head of a group and is formed once per group.  Every
product is a 64 x 64 x 64 tile in f32 FMA with 8 x 4 register tiles; the
exponent exp(cum_i - cum_j) is formed only where i >= j.  The repeated B
and C are never materialised; the per-sub-chunk states and C B^T live in
scratch the wrapper allocates.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

F32 = torch.float32
TILE = 64              # N and P are at most this
SUB = 64               # sub-chunk steps the state is carried across
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (chip_smoke.py reads and resets them)
launches = 0           # forward
launches_bwd = 0       # backward


def chunk_len(T: int, chunk: int) -> int:
    """The largest divisor of T not above ``chunk`` (``ssd_chunked``'s Q)."""
    q = max(1, min(chunk, T))
    while T % q:
        q -= 1
    return q


def _heads(t, rep: int):
    """(b, T, G, N) -> (b, T, nh, N) in f32, head h on group h // rep."""
    t = t.to(F32)
    return t.repeat_interleave(rep, dim=2) if rep > 1 else t


def _chunks(T: int, chunk: int):
    q = chunk_len(T, chunk)
    return q, [(s, s + q) for s in range(0, T, q)]


def ssd_scan_plain(xbar, la, B, C, chunk: int = 256):
    """The plain PyTorch forward, the kernel's arithmetic: ``(y, states)``
    (see the module docstring)."""
    b, T, nh, P = xbar.shape
    G, N = B.shape[2], B.shape[3]
    rep = nh // G
    q, spans = _chunks(T, chunk)
    Bh, Ch = _heads(B, rep), _heads(C, rep)
    causal = torch.ones(q, q, dtype=torch.bool, device=xbar.device).tril()
    h = torch.zeros(b, nh, N, P, dtype=F32, device=xbar.device)
    ys, states = [], []
    for s, e in spans:
        xq, Bq, Cq = xbar[:, s:e].float(), Bh[:, s:e], Ch[:, s:e]
        cum = torch.cumsum(la[:, s:e].float(), dim=1)          # (b, Q, nh)
        tot = cum[:, -1]                                        # (b, nh)
        cumT = cum.transpose(1, 2)                              # (b, nh, Q)
        ldec = torch.where(causal, cumT[..., :, None] - cumT[..., None, :],
                           float("-inf"))
        scores = torch.einsum("bihn,bjhn->bhij", Cq, Bq) * torch.exp(ldec)
        y = torch.einsum("bhij,bjhp->bihp", scores, xq)
        y = y + torch.einsum("bihn,bhnp->bihp",
                             Cq * torch.exp(cum)[..., None], h)
        states.append(h)
        w = torch.exp(tot[:, None] - cum)                       # (b, Q, nh)
        h = h * torch.exp(tot)[..., None, None] + torch.einsum(
            "bjhn,bjhp->bhnp", Bq * w[..., None], xq)
        ys.append(y)
    return torch.cat(ys, dim=1), torch.stack(states, dim=2)


def ssd_scan_bwd_plain(dy, xbar, la, B, C, states, chunk: int = 256):
    """The plain PyTorch backward, the kernels' arithmetic: ``(dxbar, dla,
    dB, dC)``, dB and dC in B's dtype and summed over the heads of each
    group.  Walks the chunks in reverse with dH, the gradient of the state
    after the chunk:

        dxbar_j = sum_{i >= j} S_ij dy_i + w_j B_j dH
        dC_i    = sum_{j <= i} dS_ij L_ij B_j + exp(cum_i) H dy_i
        dB_j    = sum_{i >= j} dS_ij L_ij C_i + w_j dH xbar_j
        dcum_k  = sum_j M_kj - sum_i M_ik + exp(cum_k) C_k.(H dy_k)
                  - w_k B_k.(dH xbar_k),       M = S * dS
        dtot    = sum_j w_j B_j.(dH xbar_j) + exp(tot) <H, dH>
        dla_m   = sum_{k >= m} dcum_k + dtot
        dH     <- exp(tot) dH + sum_i exp(cum_i) C_i^T dy_i

    with L_ij = exp(cum_i - cum_j) (i >= j, else 0), S = (C B^T) * L,
    dS_ij = dy_i . xbar_j and w_j = exp(tot - cum_j)."""
    b, T, nh, P = xbar.shape
    G, N = B.shape[2], B.shape[3]
    rep = nh // G
    q, spans = _chunks(T, chunk)
    Bh, Ch = _heads(B, rep), _heads(C, rep)
    causal = torch.ones(q, q, dtype=torch.bool, device=xbar.device).tril()
    dH = torch.zeros(b, nh, N, P, dtype=F32, device=xbar.device)
    dxs, dlas, dBs, dCs = [], [], [], []
    for c in reversed(range(len(spans))):
        s, e = spans[c]
        xq, Bq, Cq = xbar[:, s:e].float(), Bh[:, s:e], Ch[:, s:e]
        dyq, H = dy[:, s:e].float(), states[:, :, c]
        cum = torch.cumsum(la[:, s:e].float(), dim=1)           # (b, Q, nh)
        tot = cum[:, -1]
        cumT = cum.transpose(1, 2)
        L = torch.exp(torch.where(causal, cumT[..., :, None]
                                  - cumT[..., None, :], float("-inf")))
        S = torch.einsum("bihn,bjhn->bhij", Cq, Bq) * L
        dS = torch.einsum("bihp,bjhp->bhij", dyq, xq)
        dSL = dS * L
        M = S * dS
        dx = torch.einsum("bhij,bihp->bjhp", S, dyq)
        dC = torch.einsum("bhij,bjhn->bihn", dSL, Bq)
        dB = torch.einsum("bhij,bihn->bjhn", dSL, Cq)
        dcum = (M.sum(-1) - M.sum(-2)).transpose(1, 2)          # (b, Q, nh)
        ecum = torch.exp(cum)
        w = torch.exp(tot[:, None] - cum)
        dx_h = w[..., None] * torch.einsum("bjhn,bhnp->bjhp", Bq, dH)
        dC_h = ecum[..., None] * torch.einsum("bihp,bhnp->bihn", dyq, H)
        dB = dB + w[..., None] * torch.einsum("bjhp,bhnp->bjhn", xq, dH)
        qk = (dx_h * xq).sum(-1)
        dcum = dcum + (dC_h * Cq).sum(-1) - qk
        dtot = qk.sum(1) + torch.exp(tot) * (H * dH).sum((-2, -1))
        dla = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1]) \
            + dtot[:, None]
        dH = dH * torch.exp(tot)[..., None, None] + torch.einsum(
            "bihn,bihp->bhnp", Cq * ecum[..., None], dyq)
        dxs.append(dx + dx_h)
        dlas.append(dla)
        dBs.append(dB.reshape(b, e - s, G, rep, N).sum(3))
        dCs.append((dC + dC_h).reshape(b, e - s, G, rep, N).sum(3))
    cat = lambda ts: torch.cat(ts[::-1], dim=1)             # noqa: E731
    return cat(dxs), cat(dlas), cat(dBs).to(B.dtype), cat(dCs).to(C.dtype)


@functools.cache
def _lib():
    lib = _build.library("ssd_scan")
    fwd, bwd = lib.k5_ssd_fwd, lib.k5_ssd_bwd
    fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(xbar, la, B, C, chunk, *more):
    if xbar.dtype != F32 or la.dtype != F32:
        raise TypeError(f"K5 ssd_scan takes float32 xbar and la, got "
                        f"{xbar.dtype}, {la.dtype}")
    if B.dtype not in _DTYPES or C.dtype != B.dtype:
        raise TypeError(f"K5 ssd_scan takes float32 or bfloat16 B and C of "
                        f"one dtype, got {B.dtype}, {C.dtype}")
    if xbar.dim() != 4 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"K5 ssd_scan: xbar {tuple(xbar.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}; expected "
                         "(b, T, nh, P) and two (b, T, G, N)")
    b, T, nh, P = xbar.shape
    G, N = B.shape[2], B.shape[3]
    if (tuple(la.shape) != (b, T, nh) or B.shape[:2] != (b, T) or G == 0
            or nh % G or not 0 < P <= TILE or not 0 < N <= TILE):
        raise ValueError(
            f"K5 ssd_scan: xbar {tuple(xbar.shape)}, la {tuple(la.shape)}, "
            f"B {tuple(B.shape)}, chunk {chunk}; needs la (b, T, nh), nh "
            f"divisible by G, P and N in 1..{TILE}")
    if b > 65535 or nh > 65535 or b * T * nh * max(P, N) >= 2 ** 62:
        raise ValueError("K5 ssd_scan: a dimension is too large")
    for t in (xbar, la, B, C, *more):
        if not t.is_contiguous():
            raise ValueError("K5 ssd_scan takes contiguous tensors")


def _scratch(b, nh, G, T, q, N, P, device):
    """(per-sub-chunk states (b, nh, nsub, N, P), C B^T per group and
    sub-chunk (b, G, nsub, SUB, SUB), decays (b, nh, nsub)), f32, nsub =
    (T / q) * ceil(q / SUB): the kernels' scratch."""
    nsub = T // q * -(-q // SUB)
    return (torch.empty((b, nh, nsub, N, P), dtype=F32, device=device),
            torch.empty((b, G, nsub, SUB, SUB), dtype=F32, device=device),
            torch.empty((b, nh, nsub), dtype=F32, device=device))


def ssd_scan_fwd(xbar, la, B, C, chunk: int = 256):
    """``(y, states)``: the forward kernel for CUDA tensors,
    ``ssd_scan_plain`` for CPU tensors."""
    if not _build.on_cuda("K5 ssd_scan", xbar, la, B, C):
        return ssd_scan_plain(xbar, la, B, C, chunk)
    _check(xbar, la, B, C, chunk)
    b, T, nh, P = xbar.shape
    G, N = B.shape[2], B.shape[3]
    q = chunk_len(T, chunk)
    y = torch.empty_like(xbar)
    states = torch.empty((b, nh, T // q if T else 0, N, P), dtype=F32,
                         device=xbar.device)
    if xbar.numel():
        S, cb, decay = _scratch(b, nh, G, T, q, N, P, xbar.device)
        with torch.cuda.device(xbar.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _lib()[0](xbar.data_ptr(), la.data_ptr(), B.data_ptr(),
                            C.data_ptr(), y.data_ptr(), states.data_ptr(),
                            S.data_ptr(), cb.data_ptr(), decay.data_ptr(),
                            b, T, nh, P, G, N, q, _DTYPES[B.dtype], stream)
        _build.check_launch("K5 ssd_scan forward", err)
        global launches
        launches += 1
    return y, states


def ssd_scan_bwd(dy, xbar, la, B, C, states, chunk: int = 256):
    """``(dxbar, dla, dB, dC)``: the backward kernels for CUDA tensors,
    ``ssd_scan_bwd_plain`` for CPU tensors."""
    if not _build.on_cuda("K5 ssd_scan backward", dy, xbar, la, B, C,
                          states):
        return ssd_scan_bwd_plain(dy, xbar, la, B, C, states, chunk)
    _check(xbar, la, B, C, chunk, dy, states)
    b, T, nh, P = xbar.shape
    G, N = B.shape[2], B.shape[3]
    q = chunk_len(T, chunk)
    if dy.dtype != F32 or dy.shape != xbar.shape or states.dtype != F32 \
            or tuple(states.shape) != (b, nh, T // q if T else 0, N, P):
        raise ValueError("K5 ssd_scan backward: dy must be float32 shaped as"
                         " xbar, states float32 (b, nh, n_chunks, N, P)")
    dx, dla = torch.empty_like(xbar), torch.empty_like(la)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    if xbar.numel() == 0:
        return dx, dla, dB.zero_(), dC.zero_()
    # per-head partials of dB and dC, summed over each group's heads
    dBh = torch.empty((b, T, nh, N), dtype=F32, device=xbar.device)
    dCh = torch.empty_like(dBh)
    # the state at each sub-chunk's start and dH after it
    S, cb, decay = _scratch(b, nh, G, T, q, N, P, xbar.device)
    U = torch.empty_like(S)
    with torch.cuda.device(xbar.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()[1](dy.data_ptr(), xbar.data_ptr(), la.data_ptr(),
                        B.data_ptr(), C.data_ptr(), states.data_ptr(),
                        dx.data_ptr(), dla.data_ptr(), dBh.data_ptr(),
                        dCh.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                        S.data_ptr(), U.data_ptr(), cb.data_ptr(),
                        decay.data_ptr(),
                        b, T, nh, P, G, N, q, _DTYPES[B.dtype], stream)
    _build.check_launch("K5 ssd_scan backward", err)
    global launches_bwd
    launches_bwd += 1
    return dx, dla, dB, dC


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xbar, la, B, C, chunk):
        y, states = ssd_scan_fwd(xbar, la, B, C, chunk)
        ctx.save_for_backward(xbar, la, B, C, states)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        xbar, la, B, C, states = ctx.saved_tensors
        dx, dla, dB, dC = ssd_scan_bwd(dy.contiguous(), xbar, la, B, C,
                                       states, ctx.chunk)
        return dx, dla, dB, dC, None


def ssd_scan(xbar, la, B, C, chunk: int = 256):
    """The SSD chunked scan, differentiable in xbar, la, B and C; see the
    module docstring.  CUDA tensors launch the kernels; CPU tensors run the
    plain versions."""
    return _SSDScan.apply(xbar, la, B, C, int(chunk))
