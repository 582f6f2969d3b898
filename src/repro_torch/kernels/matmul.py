"""K1: matmul with fused bias + activation, three hand-written CUDA C++
kernels chosen by shape (``route``).

Replaces ``src/repro/kernels/matmul.py:matmul`` (Pallas kernel
``_matmul_kernel``, wrapper ``kernels/ops.py:pallas_matmul``), the local
GEMM that ``kernels/ops.py:enable_kernels`` installs in every 3-D island;
here ``core/ops3d.py:_mm`` calls ``matmul`` directly, so every linear of the
model, the LM head included, goes through it.  The contract is the Pallas
kernel's: ``(..., K) @ (K, N) [+ bias (N,)]``, a fused activation, f32
accumulation, the output in the input dtype, and the weight in its (K, N)
row-major layout (no transposed copy is kept or made).

Bound on an H100: a decode GEMM (M = 8 rows) reads each weight element once
for 2*M flops, far below the ~295 flop/byte at which bf16 becomes compute
bound, so it is bound by the weight's bytes over 3.35 TB/s; a prefill or
training GEMM (M = 4096-8192) is bound by operations at 989 TFLOP/s.  One
design cannot serve both, so ``route`` picks one of three kernels:

- ``tc`` (``csrc/matmul_hopper.cu``): bf16 with M above
  ``DECODE_MAX_M``.  wgmma on the tensor cores fed by a TMA + mbarrier
  ring, a producer warp and two consumer warp groups, 128 x ``tile_n``
  output tiles;
- ``decode`` (``csrc/matmul_hopper.cu``): bf16 with M at or below
  ``DECODE_MAX_M``.  A and B swapped (N on the wgmma's 64-row side), split
  K over many CTAs (``decode_plan``) that stream the weight through TMA
  rings; a second kernel sums the f32 partials in a fixed order (no
  atomics) and applies bias, activation and cast;
- ``simt`` (``csrc/matmul.cu``): f32 operands, which tensor cores would
  round to TF32, and bf16 operands that TMA cannot describe (N or K not a
  multiple of 8, or x or w not starting on 16 bytes).  A shared-memory
  tile kernel of f32 FMA with every ragged edge masked.

This is a choice between kernels by shape, not a fallback: each route is a
kernel of its own, and no bf16 GEMM of the model's main paths takes
``simt`` (``chip_smoke.py`` checks it).
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

ROUTES = ("tc", "decode", "simt")
# M at or below which a bf16 GEMM takes the decode route: the crossover of
# the two routes' device times summed over tinyllama-1.1b's decode GEMMs at
# M in {8, 16, 32, 64, 128}, measured on an H100 by chip_smoke.py phase 2t
# (PERF.md).  Two runs put it at 128 and at 64 (at 128 the routes are
# within 2% of each other); 64 is where both agree
DECODE_MAX_M = 64
NUM_SMS = 132                 # H100 SXM
DECODE_COLS = 64              # columns of w per decode CTA (the wgmma's M)
DECODE_TILES = (64, 32, 16)   # rows of w per stage of the decode ring
DECODE_MIN_CTAS = 2 * NUM_SMS  # CTAs the decode plan aims for

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): the total and each route's share
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)


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


def route(m: int, n: int, k: int, dtype: torch.dtype,
          aligned: bool) -> str:
    """The kernel that computes an (m, k) @ (k, n) product: ``"tc"``,
    ``"decode"`` or ``"simt"`` (module docstring).  ``aligned``: x and w
    start on 16 bytes, as TMA and the decode kernel's 16-byte loads need."""
    if dtype != torch.bfloat16 or not aligned or n % 8 or k % 8:
        return "simt"
    return "decode" if m <= DECODE_MAX_M else "tc"


def route_for(x: torch.Tensor, w: torch.Tensor) -> str:
    """``route`` for the operands of ``matmul(x, w)``: the leading dims of
    x flattened into M, and the 16-byte alignment read off the pointers
    (a contiguous view may start anywhere)."""
    m = math.prod(x.shape[:-1])
    k, n = w.shape
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return route(m, n, k, x.dtype, aligned)


def tile_n(m: int, n: int) -> int:
    """Output tile width of the tc route: 64 for N <= 64 (zamba2's w_dt);
    256 where 128 x 256 tiles still fill every SM at least once, else
    128."""
    if n <= 64:
        return 64
    if -(-m // 128) * -(-n // 256) >= NUM_SMS:
        return 256
    return 128


@functools.cache
def decode_plan(n: int, k: int) -> tuple:
    """(kt, len, splits) of the decode route: K cut into ``splits`` ranges
    of ``len`` rows, a multiple of the stage's ``kt`` rows (the last range
    possibly shorter), enough that the 64-column blocks times the splits
    reach DECODE_MIN_CTAS where K allows it.  ``kt`` is the deepest of
    DECODE_TILES that still gives each wanted split a whole tile."""
    want = -(-DECODE_MIN_CTAS // -(-n // DECODE_COLS))
    kt = next((t for t in DECODE_TILES if -(-k // t) >= want),
              DECODE_TILES[-1])
    steps = -(-k // kt)
    length = max(1, steps // want) * kt
    return kt, length, -(-k // length)


def decode_rows(m: int) -> int:
    """Rows of x per decode CTA: the wgmma's N, 8 to 64."""
    return 8 if m <= 8 else 16 if m <= 16 else 32 if m <= 32 else 64


def _fn(lib_name, sym, n_ptr, n_int):
    fn = getattr(_build.library(lib_name), sym)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib(name: str):
    if name == "simt":        # x, w, bias, out; M, N, K, dtype, act
        return _fn("matmul", "k1_matmul", 4, 5)
    if name == "tc":          # x, w, bias, out; M, N, K, tile_n, act
        return _fn("matmul_hopper", "k1_tc", 4, 5)
    # x, w, bias, out, workspace; M, N, K, kt, len, splits, rows, act
    return _fn("matmul_hopper", "k1_decode", 5, 8)


def _launch(way, x, w, b_ptr, out, m, n, k, act) -> int:
    """Launch route ``way`` on the current device's current stream."""
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    if way == "tc":
        return _lib("tc")(x.data_ptr(), w.data_ptr(), b_ptr, out.data_ptr(),
                          m, n, k, tile_n(m, n), ACTS.index(act), stream)
    if way == "decode":
        kt, length, splits = decode_plan(n, k)
        ws = torch.empty((splits, m, n), dtype=torch.float32,
                         device=x.device)
        return _lib("decode")(x.data_ptr(), w.data_ptr(), b_ptr,
                              out.data_ptr(), ws.data_ptr(), m, n, k, kt,
                              length, splits, decode_rows(m),
                              ACTS.index(act), stream)
    return _lib("simt")(x.data_ptr(), w.data_ptr(), b_ptr, out.data_ptr(),
                        m, n, k, _DTYPES[x.dtype], ACTS.index(act), stream)


def matmul(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           act: str = "none", *, force: Optional[str] = None
           ) -> torch.Tensor:
    """``(..., K) @ (K, N) [+ bias (N,)]`` with a fused activation, f32
    accumulation, output in x's dtype.  Leading dims of x are flattened as
    ``ops.pallas_matmul`` flattens them.  CUDA tensors launch the kernel
    that ``route`` picks, or the one named by ``force`` (tests and
    timings compare the routes; a route that cannot take the operands
    raises); CPU tensors run ``matmul_plain``."""
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
    way = route_for(x, w)
    if force is not None:
        if force not in ROUTES:
            raise ValueError(f"K1 matmul: route {force!r} not in {ROUTES}")
        if force != "simt" and way == "simt":
            raise ValueError(f"K1 matmul: the {force} route takes bf16 "
                             "operands with N and K multiples of 8 starting "
                             f"on 16 bytes, got {x.dtype} M={m} N={n} K={k}")
        way = force
    out = torch.empty((*lead, n), dtype=x.dtype, device=x.device)
    b_ptr = bias.data_ptr() if bias is not None else None
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            err = _launch(way, x, w, b_ptr, out, m, n, k, act)
    else:
        err = _launch(way, x, w, b_ptr, out, m, n, k, act)
    _build.check_launch(f"K1 matmul ({way})", err)
    global launches
    launches += 1
    launches_by_route[way] += 1
    return out
