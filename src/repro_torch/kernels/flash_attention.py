"""K2: flash attention, forward and backward, two hand-written CUDA C++
routes chosen by dtype and shape (``route``).

Replaces ``src/repro/kernels/flash_attention.py:flash_attention`` (Pallas
kernel ``_flash_kernel`` at ``:24``, ``pallas_call`` at ``:93``, wrapper
``kernels/ops.py:pallas_flash``) with the contract of the function the JAX
model runs, ``models/blocks.py:flash_attention_jnp``, of which the Pallas
kernel's is a subset: per-row ``q_pos``, validity where ``k_pos >= 0``, GQA
with query head ``h = kv_head * group + g`` (the Pallas kernel's
group-major fold), the causal and window masks, the logit scale, and
probabilities entering the PV product in v's dtype with f32 accumulation.
Every attention over a whole sequence goes through it
(``models/blocks.py:attention``): training and the serving prefill.  The
TPU kernel has no backward (JAX differentiates the jnp function); here the
backward is a kernel too.

    q (b, sq, nq, d), k and v (b, sk, nkv, d), q_pos (b, sq), k_pos (sk,)
    forward   -> out (b, sq, nq, d) in q's dtype, lse (b, nq, sq) f32 saved
    backward  (q, k, v, out, dout, lse) -> dq, dk, dv, with P recomputed
              and delta = rowsum(dout * out)

Bound on an H100: operations (a causal tinyllama layer at 4 x 2048 is 68.7
GFLOP forward, 0.07 ms at the dense bf16 peak of 989 TFLOP/s).  ``route``
picks one of two designs:

- ``tc`` (``csrc/flash_attention_hopper.cu``): bf16 with d in (64, 128)
  and q, k, v, out, dout starting on 16 bytes, as TMA requires.  wgmma on
  the tensor cores fed by a producer warp's TMA + mbarrier ring; each CTA
  lists the tiles with an allowed entry first, loads only those and masks
  only the partial ones; at d = 64 two CTAs share an SM, so that one's
  fixed cost overlaps the other's products.  Forward: one CTA per (128-row
  q tile, q head, batch), the online softmax on the accumulator fragments
  and P fed back from registers (wgmma's RS form).  Backward: delta, then
  a dq pass (one CTA per q tile) and a dk/dv pass (one CTA per 64-key
  tile, summing the GQA group), no atomics; dS enters its two products in
  bf16, where the plain version keeps it in f32.
- ``simt`` (``csrc/flash_attention.cu``): f32, where tensor cores would
  round to TF32, bf16 at d in (16, 32, 48, 256), and bf16 that TMA cannot
  describe.  64 x 64 f32 tiles in shared memory (32 x 32 at d = 256,
  where four 64-row f32 tiles of the backward would not fit), f32 FMA on
  CUDA cores, the same tile skipping and the same two backward passes.

This is a choice between kernels by dtype and shape, not a fallback: a
failed build or launch raises, and no bf16 attention of the model's main
paths takes ``simt`` (``chip_smoke.py`` checks it).

A row with no allowed key at all (possible only when every k_pos is -1 or
lies in its future) gets the mean of the values it saw in the reference's
chunked loop and something else here: the kernels skip empty tiles.  The
model never builds such a row (k_pos = arange, key 0 is always allowed).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

F32 = torch.float32
NEG_INF = -1e30
HEAD_DIMS = (16, 32, 48, 64, 128, 256)
TC_HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("tc", "simt")

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): the totals and each route's share
launches = 0           # forward
launches_bwd = 0       # backward
launches_by_route = dict.fromkeys(ROUTES, 0)
launches_bwd_by_route = dict.fromkeys(ROUTES, 0)


def _allowed(q_pos, k_pos, causal: bool, window: int):
    """(b, sq, sk) bool: key k allowed for query row i."""
    qp = q_pos[:, :, None]
    kp = k_pos[None, None, :]
    mask = (kp >= 0).expand(q_pos.shape[0], q_pos.shape[1], k_pos.shape[0])
    if causal:
        mask = mask & (qp >= kp)
        if window:
            mask = mask & (qp - kp < window)
    return mask


def _scale(d: int, logit_scale):
    return logit_scale if logit_scale is not None else 1.0 / math.sqrt(d)


def flash_attention_plain(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                          chunk=512, logit_scale=None):
    """The plain PyTorch forward: ``flash_attention_jnp`` of the reference
    (``blocks.py:56-110``), its chunked online softmax over k with P in
    v's dtype, the mask taken per row of ``q_pos``.  Returns
    ``(out, (m, l, o))`` with m, l (b, sq, nkv, group) and o
    (b, sq, nkv, group, d) in f32."""
    b, sq, nq, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    group = nq // nkv
    dv = v.shape[-1]
    qf = (q.to(F32) * _scale(d, logit_scale)).reshape(b, sq, nkv, group, d)

    chunk = min(chunk, sk)
    while sk % chunk:           # largest divisor of sk not above the target
        chunk -= 1
    m = torch.full((b, sq, nkv, group), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((b, sq, nkv, group), dtype=F32, device=q.device)
    o = torch.zeros((b, sq, nkv, group, dv), dtype=F32, device=q.device)
    for c0 in range(0, sk, chunk):
        kci, vci = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        mask = _allowed(q_pos, k_pos[c0:c0 + chunk], causal, window)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kci.to(F32))
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(v.dtype).to(F32), vci.to(F32))
        m = m_new
    out = (o / l.clamp_min(1e-30)[..., None]).reshape(b, sq, nq, dv)
    return out.to(q.dtype), (m, l, o)


def flash_attention_fwd_plain(q, k, v, q_pos, k_pos, *, causal=True,
                              window=0, logit_scale=None):
    """The plain version of the forward kernel: ``(out, lse)`` with lse
    (b, nq, sq) f32 = m + log(l) of ``flash_attention_plain``."""
    out, (m, l, _) = flash_attention_plain(q, k, v, q_pos, k_pos,
                                           causal=causal, window=window,
                                           logit_scale=logit_scale)
    b, sq, nq = q.shape[:3]
    lse = (m + torch.log(l.clamp_min(1e-30))).reshape(b, sq, nq)
    return out, lse.transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, out, dout, lse, q_pos, k_pos, *,
                              causal=True, window=0, logit_scale=None):
    """The plain version of the backward kernels, the same arithmetic:
    ``(dq, dk, dv)`` in the dtypes of q, k and v."""
    b, sq, nq, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = _scale(d, logit_scale)
    qf = (q.to(F32) * scale).reshape(b, sq, nkv, g, d)
    kf, vf = k.to(F32), v.to(F32)
    dof = dout.to(F32).reshape(b, sq, nkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
    mask = _allowed(q_pos, k_pos, causal, window)[:, None, None]
    p = torch.where(mask, torch.exp(s - lse.reshape(b, nkv, g, sq, 1)), 0.0)
    delta = (dof * out.to(F32).reshape(b, sq, nkv, g, d)).sum(-1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(v.dtype).to(F32), dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    return (dq.reshape(b, sq, nq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def route(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The kernels that compute an attention of head dim ``d``: ``"tc"`` or
    ``"simt"`` (module docstring).  ``aligned``: q, k, v (and out, dout for
    the backward) start on 16 bytes, as TMA needs; their row strides,
    heads x d x 2 bytes, are then multiples of 16 too."""
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS and aligned:
        return "tc"
    return "simt"


def route_for(q: torch.Tensor, *tensors: torch.Tensor) -> str:
    """``route`` for these operands, the alignment read off the pointers (a
    contiguous view may start anywhere)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, *tensors))
    return route(q.dtype, q.shape[-1], aligned)


def _way(force, q, *tensors) -> str:
    """The route a CUDA call takes: ``route_for``'s, or ``force``'s where it
    can take the operands (tests and timings compare the routes)."""
    way = route_for(q, *tensors)
    if force is None or force == way:
        return way
    if force == "tc":
        raise ValueError(
            f"K2 flash attention: the tc route takes bfloat16 with d in "
            f"{TC_HEAD_DIMS} and tensors starting on 16 bytes, got {q.dtype} "
            f"d={q.shape[-1]}")
    return force


def _check_force(force):
    if force is not None and force not in ROUTES:
        raise ValueError(f"K2 flash attention: route {force!r} not in "
                         f"{ROUTES}")


@functools.cache
def _lib(way: str, backward: bool):
    """The C entry point of route ``way``: its pointers, then B, Sq, Sk,
    Hq, Hkv, D, causal, window, the scale, (simt: the dtype,) the
    stream."""
    if way == "tc":
        lib = _build.library("flash_attention_hopper")
        fn = lib.k2_tc_backward if backward else lib.k2_tc_forward
        tail = [ctypes.c_float]
    else:
        lib = _build.library("flash_attention")
        fn = lib.k2_flash_bwd if backward else lib.k2_flash_fwd
        tail = [ctypes.c_float, ctypes.c_int]
    fn.argtypes = ([ctypes.c_void_p] * (12 if backward else 7)
                   + [ctypes.c_int] * 8 + tail + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, q_pos, k_pos, *grads):
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, *grads)):
        raise TypeError(f"K2 flash attention takes float32 or bfloat16 "
                        f"tensors of one dtype, got q {q.dtype}, k {k.dtype},"
                        f" v {v.dtype}")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError("K2 flash attention: q_pos and k_pos must be int32")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"K2 flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         "(b, sq, nq, d) and two (b, sk, nkv, d)")
    b, sq, nq, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != d or d not in HEAD_DIMS
            or nkv == 0 or nq % nkv or tuple(q_pos.shape) != (b, sq)
            or tuple(k_pos.shape) != (sk,)):
        raise ValueError(
            f"K2 flash attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"q_pos {tuple(q_pos.shape)}, k_pos {tuple(k_pos.shape)}; needs "
            f"d in {HEAD_DIMS}, nq divisible by nkv, q_pos (b, sq), k_pos "
            "(sk,)")
    if b > 65535 or nq > 65535 or max(sq, sk) * nq * d >= 2 ** 31:
        raise ValueError("K2 flash attention: a dimension is too large")
    for t in (q, k, v, q_pos, k_pos, *grads):
        if not t.is_contiguous():
            raise ValueError("K2 flash attention takes contiguous tensors")


def flash_attention_fwd(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                        logit_scale=None, force=None):
    """``(out, lse)``: the forward kernel of ``route`` (or of the route
    named by ``force``) for CUDA tensors, ``flash_attention_fwd_plain``
    for CPU tensors."""
    _check_force(force)
    if not _build.on_cuda("K2 flash attention", q, k, v, q_pos, k_pos):
        return flash_attention_fwd_plain(q, k, v, q_pos, k_pos, causal=causal,
                                         window=window,
                                         logit_scale=logit_scale)
    _check(q, k, v, q_pos, k_pos)
    b, sq, nq, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, nq, sq), dtype=F32, device=q.device)
    way = _way(force, q, k, v, out)
    if q.numel() and sk:
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                k_pos.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, sk,
                nq, nkv, d, int(causal), int(window), _scale(d, logit_scale)]
        if way == "simt":
            args.append(_DTYPES[q.dtype])
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _lib(way, False)(*args, stream)
        _build.check_launch(f"K2 flash attention forward ({way})", err)
        global launches
        launches += 1
        launches_by_route[way] += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos, *,
                        causal=True, window=0, logit_scale=None, force=None):
    """``(dq, dk, dv)``: the backward kernels of ``route`` (or of the route
    named by ``force``) for CUDA tensors, ``flash_attention_bwd_plain``
    for CPU tensors."""
    _check_force(force)
    if not _build.on_cuda("K2 flash attention backward", q, k, v, out, dout,
                          lse, q_pos, k_pos):
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, q_pos,
                                         k_pos, causal=causal, window=window,
                                         logit_scale=logit_scale)
    _check(q, k, v, q_pos, k_pos, out, dout)
    b, sq, nq, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or lse.dtype != F32 \
            or tuple(lse.shape) != (b, nq, sq) or not lse.is_contiguous():
        raise ValueError("K2 flash attention backward: out and dout must be "
                         "shaped as q, lse float32 (b, nq, sq)")
    way = _way(force, q, k, v, out, dout)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, nq, sq), dtype=F32, device=q.device)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, sq, sk, nq, nkv, d, int(causal), int(window),
            _scale(d, logit_scale)]
    if way == "simt":
        args.append(_DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib(way, True)(*args, stream)
    _build.check_launch(f"K2 flash attention backward ({way})", err)
    global launches_bwd
    launches_bwd += 1
    launches_bwd_by_route[way] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, logit_scale):
        out, lse = flash_attention_fwd(q, k, v, q_pos, k_pos, causal=causal,
                                       window=window, logit_scale=logit_scale)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, k_pos)
        ctx.opts = dict(causal=causal, window=window, logit_scale=logit_scale)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, q_pos, k_pos = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         q_pos, k_pos, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                    logit_scale=None):
    """Attention over a whole sequence, differentiable in q, k and v; see the
    module docstring.  Returns ``(out, lse)``; the chunk-wise ``(m, l, o)``
    of the reference come from ``flash_attention_plain``.  CUDA tensors
    launch the kernels of ``route``, forward and backward; CPU tensors run
    the plain versions."""
    return _FlashAttention.apply(q, k, v, q_pos, k_pos, causal, int(window),
                                 logit_scale)
