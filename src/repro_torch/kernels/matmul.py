"""K1: tiled matmul with fused bias + activation (CUDA C++,
``csrc/matmul.cu``).

Replaces ``src/repro/kernels/matmul.py:matmul`` (Pallas kernel
``_matmul_kernel``, wrapper ``kernels/ops.py:pallas_matmul``), the local
GEMM that ``kernels/ops.py:enable_kernels`` installs in every 3-D island;
here ``core/ops3d.py:_mm`` calls ``matmul`` directly, so every linear of the
model, the LM head included, goes through it.

Bound on an H100: a decode GEMM (M = 8 rows) reads each weight element
once for 2*M flops, far below the ~295 flop/byte at which bf16 becomes
compute bound, so it is bound by the weight's bytes over 3.35 TB/s; a
prefill GEMM (M = 4096) is bound by operations.  Design: a plain
shared-memory tile kernel (64x64 output tile per 256-thread block, K staged
in 16-deep f32 slices, a 4x4 fmaf register tile, every ragged edge masked).
It uses no tensor cores: prefill runs at CUDA-core rate and a decode GEMM
launches only ceil(N/64) blocks.  ``wgmma``, TMA and split-K are later work;
PERF.md keeps its times beside the bound.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

ACTS = ("none", "gelu", "silu", "relu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0


def _activate(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(x, approximate="tanh")
    if act == "silu":
        return F.silu(x)
    if act == "relu":
        return F.relu(x)
    return x


def matmul_plain(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 act: str = "none") -> torch.Tensor:
    """The plain PyTorch version of K1: f32 product, bias, activation, cast
    back to x's dtype (``kernels/ref.py:matmul_ref`` of the reference)."""
    out = x.float() @ w.float()
    if bias is not None:
        out = out + bias.float()
    return _activate(out, act).to(x.dtype)


@functools.cache
def _lib():
    lib = _build.library("matmul")
    fn = lib.k1_matmul
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def matmul(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           act: str = "none") -> torch.Tensor:
    """``(..., K) @ (K, N) [+ bias (N,)]`` with a fused activation, f32
    accumulation, output in x's dtype.  Leading dims of x are flattened as
    ``ops.pallas_matmul`` flattens them.  CUDA tensors launch the kernel;
    CPU tensors run ``matmul_plain``."""
    if act not in ACTS:
        raise ValueError(f"matmul: act {act!r} not in {ACTS}")
    if not _build.on_cuda("K1 matmul", x, w, bias):
        return matmul_plain(x, w, bias, act)
    if x.dtype not in _DTYPES or w.dtype != x.dtype or (
            bias is not None and bias.dtype != x.dtype):
        raise TypeError(
            f"K1 matmul takes float32 or bfloat16 operands of one dtype, got "
            f"x {x.dtype}, w {w.dtype}"
            + (f", bias {bias.dtype}" if bias is not None else ""))
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"K1 matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not contract")
    k, n = w.shape
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"K1 matmul: bias {tuple(bias.shape)} != ({n},)")
    if not (x.is_contiguous() and w.is_contiguous()
            and (bias is None or bias.is_contiguous())):
        raise ValueError("K1 matmul takes contiguous operands")
    lead = x.shape[:-1]
    m = math.prod(lead)
    if min(m, n, k) == 0 or max(m, n, k) >= 2 ** 31:
        raise ValueError(f"K1 matmul: dims M={m} N={n} K={k} outside "
                         "[1, 2**31)")
    out = torch.empty((*lead, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(x.data_ptr(), w.data_ptr(),
                     bias.data_ptr() if bias is not None else None,
                     out.data_ptr(), m, n, k, _DTYPES[x.dtype],
                     ACTS.index(act), stream)
    _build.check_launch("K1 matmul", err)
    global launches
    launches += 1
    return out
