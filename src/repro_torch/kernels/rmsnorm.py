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

Two phases (``rmsnorm_split``), for a row that a rank of the 3-D cube
holds only part of (the hidden dim split over out_ax): the forward's
``rmsnorm_moments`` writes each row's partial sum of squares, the caller
all-reduces it over the axis, and ``rmsnorm_apply`` normalises with the
norm's global width; the backward's ``rmsnorm_bwd_dot`` writes each row's
partial ``sum(dy * g' * x)``, the caller all-reduces it, and
``rmsnorm_bwd_apply`` writes dx and the local columns' dg.  They are
modes of the same kernels (``csrc/rmsnorm.cu``), each with its plain
version.

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
launches_moments = 0   # the two phases' four entry points
launches_apply = 0
launches_bwd_dot = 0
launches_bwd_apply = 0


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


def rmsnorm_moments_plain(x):
    """Each row's sum of squares over its columns, f32 (rows,)."""
    xf = x.float().reshape(-1, x.shape[-1])
    return (xf * xf).sum(dim=-1)


def rmsnorm_apply_plain(x, gamma, ss, h: int, eps: float = 1e-6,
                        zero_centered: bool = False):
    """``(y, rstd)`` from the rows' summed squares ``ss`` over the norm's
    width ``h``."""
    rstd = torch.rsqrt(ss / h + eps)
    g = gamma.float() + (1.0 if zero_centered else 0.0)
    y = x.float() * rstd.reshape(*x.shape[:-1], 1) * g
    return y.to(x.dtype), rstd


def rmsnorm_bwd_dot_plain(dy, x, gamma, zero_centered: bool = False):
    """Each row's ``sum(dy * g' * x)`` over its columns, f32 (rows,)."""
    h = x.shape[-1]
    g = gamma.float() + (1.0 if zero_centered else 0.0)
    return (dy.float().reshape(-1, h) * g
            * x.float().reshape(-1, h)).sum(dim=-1)


def rmsnorm_bwd_apply_plain(dy, x, gamma, rstd, dot, h: int,
                            zero_centered: bool = False):
    """``(dx, dg)`` from the rows' summed ``dot`` over the norm's width
    ``h``; dg is the sum over this tensor's rows."""
    hl = x.shape[-1]
    xf = x.float().reshape(-1, hl)
    dyf = dy.float().reshape(-1, hl)
    g = gamma.float() + (1.0 if zero_centered else 0.0)
    r = rstd.reshape(-1, 1)
    dx = r * g * dyf - xf * (dot.reshape(-1, 1) * r * r * r / h)
    dg = (dyf * (xf * r)).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dg.to(gamma.dtype)


@functools.cache
def _lib():
    lib = _build.library("rmsnorm")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {"fwd": (lib.k3_rmsnorm_fwd,
                   [P] * 4 + [L, I, ctypes.c_float] + [I] * 3 + [P]),
           "bwd": (lib.k3_rmsnorm_bwd, [P] * 7 + [L] + [I] * 5 + [P]),
           "moments": (lib.k3_rmsnorm_moments, [P, P, L, I, I, I, P]),
           "apply": (lib.k3_rmsnorm_apply,
                     [P] * 5 + [L, I, I, ctypes.c_float] + [I] * 3 + [P]),
           "bwd_dot": (lib.k3_rmsnorm_bwd_dot, [P] * 4 + [L] + [I] * 5
                       + [P]),
           "bwd_apply": (lib.k3_rmsnorm_bwd_apply, [P] * 8 + [L] + [I] * 6
                         + [P])}
    for fn, args in fns.values():
        fn.argtypes, fn.restype = args, ctypes.c_int
    return {k: fn for k, (fn, _) in fns.items()}


def _check(x, gamma=None):
    """Validate x (..., H) and, where given, gamma (H,) of x's dtype."""
    if x.dtype not in _DTYPES or (gamma is not None
                                  and gamma.dtype != x.dtype):
        raise TypeError(f"K3 rmsnorm takes float32 or bfloat16 x and gamma of "
                        f"one dtype, got {x.dtype}, "
                        f"{None if gamma is None else gamma.dtype}")
    h = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or not 0 < h <= MAX_H or (
            gamma is not None and tuple(gamma.shape) != (h,)):
        raise ValueError(f"K3 rmsnorm: x {tuple(x.shape)} and gamma "
                         f"{None if gamma is None else tuple(gamma.shape)};"
                         f" gamma must be (H,) with 0 < H <= {MAX_H}")
    if not (x.is_contiguous() and (gamma is None or gamma.is_contiguous())):
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
            err = _lib()["fwd"](x.data_ptr(), gamma.data_ptr(), y.data_ptr(),
                            rstd.data_ptr(), m, h, eps, int(zero_centered),
                            _aligned(x, gamma, y), _DTYPES[x.dtype], stream)
        _build.check_launch("K3 rmsnorm forward", err)
        global launches
        launches += 1
    return y, rstd


def _bwd_grid(x, m: int) -> int:
    """The most blocks a backward kernel launches (it uses a row of its
    dg scratch a block)."""
    return min(m, BWD_BLOCKS_PER_SM * _build.sm_count(x.device.index))


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
    nblocks = _bwd_grid(x, m)
    part = torch.empty((nblocks, h), dtype=torch.float32, device=x.device)
    dg = torch.empty_like(gamma)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()["bwd"](dy.data_ptr(), x.data_ptr(), gamma.data_ptr(),
                        rstd.data_ptr(), dx.data_ptr(), part.data_ptr(),
                        dg.data_ptr(), m, h, nblocks, int(zero_centered),
                        _aligned(dy, x, gamma, dx), _DTYPES[x.dtype], stream)
    _build.check_launch("K3 rmsnorm backward", err)
    global launches_bwd
    launches_bwd += 1
    return dx, dg


def _rows_f32(t, m: int, what: str):
    if t.dtype != torch.float32 or tuple(t.shape) != (m,) or \
            not t.is_contiguous():
        raise ValueError(f"K3 rmsnorm: {what} must be contiguous float32 "
                         f"(rows,) = ({m},), got {t.dtype} "
                         f"{tuple(t.shape)}")


def _width(h: int, hl: int):
    if not hl <= h:
        raise ValueError(f"K3 rmsnorm: the norm's width {h} is below the "
                         f"row's {hl} columns")


def rmsnorm_moments(x):
    """Phase 1 of the forward: the rows' partial sums of squares, f32
    (rows,).  The kernel for a CUDA tensor, ``rmsnorm_moments_plain`` for
    a CPU one."""
    if not _build.on_cuda("K3 rmsnorm moments", x):
        return rmsnorm_moments_plain(x)
    _check(x)
    h = x.shape[-1]
    m = x.numel() // h
    ss = torch.empty(m, dtype=torch.float32, device=x.device)
    if m:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _lib()["moments"](x.data_ptr(), ss.data_ptr(), m, h,
                                    _aligned(x), _DTYPES[x.dtype], stream)
        _build.check_launch("K3 rmsnorm moments", err)
        global launches_moments
        launches_moments += 1
    return ss


def rmsnorm_apply(x, gamma, ss, h: int, eps: float = 1e-6,
                  zero_centered: bool = False):
    """Phase 2 of the forward: ``(y, rstd)`` from the all-reduced ``ss``
    and the norm's width ``h``."""
    if not _build.on_cuda("K3 rmsnorm apply", x, gamma, ss):
        return rmsnorm_apply_plain(x, gamma, ss, h, eps, zero_centered)
    _check(x, gamma)
    hl = x.shape[-1]
    m = x.numel() // hl
    _rows_f32(ss, m, "ss")
    _width(h, hl)
    y = torch.empty_like(x)
    rstd = torch.empty(m, dtype=torch.float32, device=x.device)
    if m:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _lib()["apply"](x.data_ptr(), gamma.data_ptr(),
                                  ss.data_ptr(), y.data_ptr(),
                                  rstd.data_ptr(), m, hl, h, eps,
                                  int(zero_centered), _aligned(x, gamma, y),
                                  _DTYPES[x.dtype], stream)
        _build.check_launch("K3 rmsnorm apply", err)
        global launches_apply
        launches_apply += 1
    return y, rstd


def rmsnorm_bwd_dot(dy, x, gamma, zero_centered: bool = False):
    """Phase 1 of the backward: the rows' partial ``sum(dy * g' * x)``,
    f32 (rows,)."""
    if not _build.on_cuda("K3 rmsnorm backward dot", dy, x, gamma):
        return rmsnorm_bwd_dot_plain(dy, x, gamma, zero_centered)
    _check(x, gamma)
    hl = x.shape[-1]
    m = x.numel() // hl
    if dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError("K3 rmsnorm backward dot: dy must match x (dtype, "
                         "shape, contiguous)")
    dot = torch.empty(m, dtype=torch.float32, device=x.device)
    if m:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _lib()["bwd_dot"](dy.data_ptr(), x.data_ptr(),
                                    gamma.data_ptr(), dot.data_ptr(), m, hl,
                                    _bwd_grid(x, m), int(zero_centered),
                                    _aligned(dy, x, gamma), _DTYPES[x.dtype],
                                    stream)
        _build.check_launch("K3 rmsnorm backward dot", err)
        global launches_bwd_dot
        launches_bwd_dot += 1
    return dot


def rmsnorm_bwd_apply(dy, x, gamma, rstd, dot, h: int,
                      zero_centered: bool = False):
    """Phase 2 of the backward: ``(dx, dg)`` from the all-reduced ``dot``
    and the norm's width ``h``; dg is this tensor's rows' share."""
    if not _build.on_cuda("K3 rmsnorm backward apply", dy, x, gamma, rstd,
                          dot):
        return rmsnorm_bwd_apply_plain(dy, x, gamma, rstd, dot, h,
                                       zero_centered)
    _check(x, gamma)
    hl = x.shape[-1]
    m = x.numel() // hl
    if dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError("K3 rmsnorm backward apply: dy must match x "
                         "(dtype, shape, contiguous)")
    _rows_f32(rstd, m, "rstd")
    _rows_f32(dot, m, "dot")
    _width(h, hl)
    dx = torch.empty_like(x)
    if m == 0:
        return dx, torch.zeros_like(gamma)
    nblocks = _bwd_grid(x, m)
    part = torch.empty((nblocks, hl), dtype=torch.float32, device=x.device)
    dg = torch.empty_like(gamma)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()["bwd_apply"](dy.data_ptr(), x.data_ptr(),
                                  gamma.data_ptr(), rstd.data_ptr(),
                                  dot.data_ptr(), dx.data_ptr(),
                                  part.data_ptr(), dg.data_ptr(), m, hl, h,
                                  nblocks, int(zero_centered),
                                  _aligned(dy, x, gamma, dx),
                                  _DTYPES[x.dtype], stream)
    _build.check_launch("K3 rmsnorm backward apply", err)
    global launches_bwd_apply
    launches_bwd_apply += 1
    return dx, dg


class _RMSNormSplit(torch.autograd.Function):
    """The two phases around ``reduce`` (the caller's all-reduce of the
    rows' partial sums over the axis that splits the row)."""

    @staticmethod
    def forward(ctx, x, gamma, eps, zero_centered, h, reduce):
        ss = reduce(rmsnorm_moments(x))
        y, rstd = rmsnorm_apply(x, gamma, ss, h, eps, zero_centered)
        ctx.save_for_backward(x, gamma, rstd)
        ctx.cfg = (zero_centered, h, reduce)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, rstd = ctx.saved_tensors
        zero_centered, h, reduce = ctx.cfg
        dy = dy.contiguous()
        dot = reduce(rmsnorm_bwd_dot(dy, x, gamma, zero_centered))
        dx, dg = rmsnorm_bwd_apply(dy, x, gamma, rstd, dot, h,
                                   zero_centered)
        return dx, dg, None, None, None, None


def rmsnorm_split(x, gamma, eps: float, zero_centered: bool, h: int,
                  reduce):
    """RMSNorm of rows of width ``h`` of which ``x`` holds columns
    (gamma the same columns' gains), differentiable in x and gamma: K3's
    two phases, ``reduce`` summing each phase's (rows,) f32 partials over
    the ranks that hold the other columns.  dg is this rank's rows'
    share, summed over the other ranks by the caller (the train step's
    leaf sync)."""
    return _RMSNormSplit.apply(x, gamma, eps, zero_centered, h, reduce)


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
