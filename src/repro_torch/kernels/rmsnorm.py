"""K3: RMSNorm, forward and backward (CUDA C++, ``csrc/rmsnorm.cu``).

Replaces ``src/repro/kernels/rmsnorm.py:rmsnorm`` (Pallas kernel
``_rmsnorm_kernel``, wrapper ``kernels/ops.py:pallas_rmsnorm``), which
computes what the JAX model's ``core/linear3d.py:rmsnorm`` computes.  Here
``core/linear3d.py:rmsnorm`` calls ``rmsnorm`` below, so every norm of the
model goes through K3: the block norms, ``ln_f`` and qk-norm, in training
and in serving.  The TPU kernel has no backward (JAX differentiates the jnp
function); the port's backward is a kernel too.

    forward   x (..., H), g (H,) -> y in x's dtype, rstd (rows,) f32 saved
    backward  dy -> dx = rstd * (g' * dy - xhat * mean(xhat * g' * dy)),
                    dg = sum over rows of dy * xhat,   xhat = x * rstd

with ``g' = g + 1`` when ``zero_centered`` (gemma), else ``g``.

Bound on an H100: bytes (about 4 flops per element read).  Design (for
Hopper): a row belongs to a group of 2-8 warps, read once with 16-byte
loads into registers; the sum of squares or the backward's dot is a
shuffle tree, then a fixed-order sum over the group's warps, and y or dx
is written from the same registers.  Instances exist for the paths'
widths 2048, 3072 and 4096 (tensors starting on 16 bytes); other widths
up to ``MAX_H``, and unaligned views, take the same kernel with a block
per row and scalar accesses.  The backward runs a persistent grid (as
many blocks as the SMs hold at once): each lane keeps its columns' share
of dg in registers across the rows it walks, loading the next row while
it finishes the current one; each block sums its groups' shares
in order, and a second kernel sums the blocks' partials in block order.
No float atomics, so dg is the same from run to run.  CUDA C++ rather
than Triton: the port's rule, and the reduction is short enough to write
by hand.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_H = 12288          # 48 columns a thread of a 256-thread block
BWD_BLOCKS_PER_SM = 4  # the most persistent backward blocks an SM takes

# kernel launches since the last reset (chip_smoke.py reads and resets them)
launches = 0           # forward
launches_bwd = 0       # backward


def rmsnorm_plain(x, gamma, eps: float = 1e-6, zero_centered: bool = False):
    """The plain PyTorch forward (``linear3d.py:rmsnorm`` of the reference):
    returns ``(y, rstd)`` with rstd (rows,) in f32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xf * rstd
    g = gamma.float()
    if zero_centered:
        g = g + 1.0
    return (y * g).to(x.dtype), rstd.reshape(-1)


def rmsnorm_bwd_plain(dy, x, gamma, rstd, zero_centered: bool = False):
    """The plain PyTorch backward, the kernel's arithmetic: ``(dx, dg)`` in
    the dtypes of x and gamma."""
    h = x.shape[-1]
    xf = x.float().reshape(-1, h)
    dyf = dy.float().reshape(-1, h)
    g = gamma.float() + (1.0 if zero_centered else 0.0)
    r = rstd.reshape(-1, 1)
    dot = (dyf * g * xf).sum(dim=-1, keepdim=True)
    dx = r * g * dyf - xf * (dot * r * r * r / h)
    dg = (dyf * (xf * r)).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dg.to(gamma.dtype)


@functools.cache
def _lib():
    lib = _build.library("rmsnorm")
    fwd, bwd = lib.k3_rmsnorm_fwd, lib.k3_rmsnorm_bwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(x, gamma):
    if x.dtype not in _DTYPES or gamma.dtype != x.dtype:
        raise TypeError(f"K3 rmsnorm takes float32 or bfloat16 x and gamma of "
                        f"one dtype, got {x.dtype}, {gamma.dtype}")
    h = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or tuple(gamma.shape) != (h,) or not 0 < h <= MAX_H:
        raise ValueError(f"K3 rmsnorm: x {tuple(x.shape)} and gamma "
                         f"{tuple(gamma.shape)}; gamma must be (H,) with "
                         f"0 < H <= {MAX_H}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("K3 rmsnorm takes contiguous tensors")
    if x.numel() // h >= 2 ** 31:
        raise ValueError("K3 rmsnorm: more than 2**31 - 1 rows")


def _aligned(*tensors) -> int:
    """1 when every tensor starts on 16 bytes, as the 16-byte accesses of
    the wide instances need (a contiguous view may start anywhere)."""
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def rmsnorm_fwd(x, gamma, eps: float = 1e-6, zero_centered: bool = False):
    """``(y, rstd)``: the kernel for CUDA tensors, ``rmsnorm_plain`` for CPU
    tensors."""
    if not _build.on_cuda("K3 rmsnorm", x, gamma):
        return rmsnorm_plain(x, gamma, eps, zero_centered)
    _check(x, gamma)
    h = x.shape[-1]
    m = x.numel() // h
    y = torch.empty_like(x)
    rstd = torch.empty(m, dtype=torch.float32, device=x.device)
    if m:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _lib()[0](x.data_ptr(), gamma.data_ptr(), y.data_ptr(),
                            rstd.data_ptr(), m, h, eps, int(zero_centered),
                            _aligned(x, gamma, y), _DTYPES[x.dtype], stream)
        _build.check_launch("K3 rmsnorm forward", err)
        global launches
        launches += 1
    return y, rstd


def rmsnorm_bwd(dy, x, gamma, rstd, zero_centered: bool = False):
    """``(dx, dg)``: the kernel for CUDA tensors, ``rmsnorm_bwd_plain`` for
    CPU tensors."""
    if not _build.on_cuda("K3 rmsnorm backward", dy, x, gamma, rstd):
        return rmsnorm_bwd_plain(dy, x, gamma, rstd, zero_centered)
    _check(x, gamma)
    h = x.shape[-1]
    m = x.numel() // h
    if dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous() \
            or rstd.dtype != torch.float32 or tuple(rstd.shape) != (m,):
        raise ValueError("K3 rmsnorm backward: dy must match x (dtype, shape,"
                         " contiguous) and rstd be float32 (rows,)")
    dx = torch.empty_like(x)
    if m == 0:
        return dx, torch.zeros_like(gamma)
    # the kernel uses as many rows as it launches blocks: at most nblocks
    nblocks = min(m, BWD_BLOCKS_PER_SM * _build.sm_count(x.device.index))
    part = torch.empty((nblocks, h), dtype=torch.float32, device=x.device)
    dg = torch.empty_like(gamma)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()[1](dy.data_ptr(), x.data_ptr(), gamma.data_ptr(),
                        rstd.data_ptr(), dx.data_ptr(), part.data_ptr(),
                        dg.data_ptr(), m, h, nblocks, int(zero_centered),
                        _aligned(dy, x, gamma, dx), _DTYPES[x.dtype], stream)
    _build.check_launch("K3 rmsnorm backward", err)
    global launches_bwd
    launches_bwd += 1
    return dx, dg


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, eps, zero_centered):
        y, rstd = rmsnorm_fwd(x, gamma, eps, zero_centered)
        ctx.save_for_backward(x, gamma, rstd)
        ctx.zero_centered = zero_centered
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, rstd = ctx.saved_tensors
        dx, dg = rmsnorm_bwd(dy.contiguous(), x, gamma, rstd,
                             ctx.zero_centered)
        return dx, dg, None, None


def rmsnorm(x, gamma, eps: float = 1e-6, zero_centered: bool = False):
    """RMSNorm over the last dim, differentiable in x and gamma; see the
    module docstring.  CUDA tensors launch the kernels; CPU tensors run the
    plain versions."""
    return _RMSNorm.apply(x, gamma, eps, zero_centered)
