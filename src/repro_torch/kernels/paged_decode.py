"""K4: fused paged flash-decode, two hand-written CUDA C++ kernels chosen
by shape (``route``).

Replaces ``src/repro/kernels/paged_decode.py:paged_flash_decode`` (Pallas
kernel ``_decode_kernel`` via ``_pallas_impl``): attention for one new
token per slot, read straight out of the paged KV pool through the block
table.  Every attention layer of every fused decode step calls it through
``paged_flash_decode_step`` (``models/blocks.py:attention_decode_paged``),
which also folds the step's own token, not yet in the pool, into the same
softmax.

Shapes (one layer):

    q        (B, nq, dk)        new-token queries, nq = nkv * group
    k_pool   (phys, nkv, dk)    phys = n_blocks * block
    v_pool   (phys, nkv, dv)    dv may differ from dk
    pos_pool (phys,) int32      logical position per entry, -1 = invalid
    tables   (B, nb) int32      physical block id per view block
    cur      (B,) int32         current decode position per slot
    k_new    (B, nkv, dk)       the step's own key and value
    v_new    (B, nkv, dv)       (``paged_flash_decode_step`` only)
    -> out   (B, nq, dv) in q's dtype, or f32 (acc, m, l) with residuals

Entry ``e`` of slot ``b`` attends iff ``0 <= pos_pool[e] <= cur[b]`` (and
``cur[b] - pos_pool[e] < window`` when windowed).

Bound on an H100: bytes (every valid K/V entry is read once for 4*group
flops per element, far below what f32 FMA could do).  At the serving
shape (8 slots, ~280 tokens) the bytes take well under a microsecond, so
there the launches themselves are the cost.  ``route`` picks one of two
kernels:

- ``split`` (``csrc/paged_decode_hopper.cu``): bf16 with dk = dv in
  ``SPLIT_HEAD_DIMS``, a group in ``SPLIT_GROUPS``, a block that is a
  multiple of 8 up to ``SPLIT_MAX_BLOCK``, tensors on 16 bytes.  Split-K
  over the table's columns, the reference's cross-device algebra on one
  card: ``split_plan`` cuts each slot's columns into as many splits as
  fill one wave of the CTAs the SMs hold at once (the occupancy of the
  kernel instance and its ring, ``split_ring``); each CTA streams its live
  columns through a cp.async ring, runs QK and PV on the tensor cores
  (``mma.sync``: fewer instructions, not more flops) and writes f32
  partials; a second kernel combines them in split order and, in
  ``paged_flash_decode_step``, folds in the current token and normalises;
- ``simt`` (``csrc/paged_decode.cu``, the first port's kernel): f32,
  dv != dk, q f32 over bf16 pools (MLA's latent decode: one kv head of dk
  576 and dv 512, a group of all the heads), and the other shapes
  ``split`` does not take.  One CTA per (slot, kv head, tile of at most 8
  query rows) walks the slot's columns; its step entry folds the current
  token in PyTorch (``fold_current_token``).

This is a choice between kernels by shape, not a fallback: each route is
a kernel of its own, and no bf16 decode step of tinyllama-1.1b takes
``simt`` (``chip_smoke.py`` checks it).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

ROUTES = ("split", "simt")
SPLIT_HEAD_DIMS = (64, 128)
SPLIT_GROUPS = (1, 2, 4, 8)       # query rows per kv head
SPLIT_MAX_BLOCK = 32
WARPS = 4                         # warps of a split CTA
STAGE_BUDGET = 24 * 1024          # bytes of a warp's cp.async ring

# kernel launches since the last reset (chip_smoke.py reads and resets
# them): one per call in ``launches`` and by route; the split route's
# combine pass, once per call too, in ``launches_combine``
launches = 0
launches_by_route = dict.fromkeys(ROUTES, 0)
launches_combine = 0


def paged_flash_decode_plain(q, k_pool, v_pool, pos_pool, tables, cur, *,
                             block: int, window: int = 0,
                             scale: Optional[float] = None,
                             return_residuals: bool = False):
    """The plain PyTorch version of K4: gather the slots' views through the
    tables, mask by logical position, one f32 softmax (the reference's
    ``paged_decode.py:_jnp_impl``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    B, nq, dk = q.shape
    nkv = k_pool.shape[1]
    g = nq // nkv
    dv = v_pool.shape[-1]
    lane = torch.arange(block, device=tables.device, dtype=torch.long)
    flat = (tables.long()[:, :, None] * block + lane).reshape(B, -1)
    k = k_pool[flat].float()                            # (B, L, nkv, dk)
    v = v_pool[flat].float()                            # (B, L, nkv, dv)
    kp = pos_pool[flat]                                 # (B, L)
    cur = cur[:, None]
    valid = (kp >= 0) & (kp <= cur)
    if window:
        valid &= (cur - kp) < window
    qf = q.reshape(B, nkv, g, dk).float() * scale
    s = torch.einsum("bhgd,blhd->bhgl", qf, k)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vmask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if return_residuals:
        acc = torch.einsum("bhgl,blhd->bhgd", p, v)
        return (acc.reshape(B, nq, dv), m.reshape(B, nq), l.reshape(B, nq))
    out = torch.einsum("bhgl,blhd->bhgd", p / l.clamp_min(1e-30), v)
    return out.reshape(B, nq, dv).to(q.dtype)


def fold_current_token(q, k_new, v_new, acc, m, l, *,
                       scale: Optional[float] = None):
    """Fold the step's own token (always valid: age 0) into K4's softmax
    residuals and normalise (the reference's ``blocks.py:322-335``).
    q (B, nq, dk); k_new (B, nkv, dk); v_new (B, nkv, dv); acc (B, nq, dv),
    m and l (B, nq) f32.  Returns (B, nq, dv) in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    B, nq, d = q.shape
    hloc = k_new.shape[1]
    g = nq // hloc
    qf = q.float().reshape(B, hloc, g, d)
    s0 = torch.einsum("bhgd,bhd->bhg", qf, k_new.float()) * scale
    s0 = s0.reshape(B, nq)
    m2 = torch.maximum(m, s0)
    wp, wc = torch.exp(m - m2), torch.exp(s0 - m2)
    dv = v_new.shape[-1]
    vb = v_new[:, :, None].float().expand(B, hloc, g, dv).reshape(B, nq, dv)
    o = acc * wp[..., None] + vb * wc[..., None]
    ls = l * wp + wc
    return (o / ls.clamp_min(1e-30)[..., None]).to(q.dtype)


def paged_flash_decode_step_plain(q, k_new, v_new, k_pool, v_pool, pos_pool,
                                  tables, cur, *, block: int, window: int = 0,
                                  scale: Optional[float] = None):
    """The plain version of ``paged_flash_decode_step``: the plain K4's
    residuals, then ``fold_current_token``."""
    acc, m, l = paged_flash_decode_plain(
        q, k_pool, v_pool, pos_pool, tables, cur, block=block, window=window,
        scale=scale, return_residuals=True)
    return fold_current_token(q, k_new, v_new, acc, m, l, scale=scale)


def split_ring(block: int, d: int):
    """``(stages, bytes)`` of a split CTA's shared memory: each of its
    ``WARPS`` warps rings 2-4 table columns (K rows, then V rows) within
    ``STAGE_BUDGET``.  At d 64 and block 16, 4 stages and 64 KB, so that
    three CTAs fit an SM; at d 128 or block 32 the ring is larger and
    fewer fit."""
    stage = block * 2 * d * 2
    stages = max(2, min(4, STAGE_BUDGET // stage))
    return stages, WARPS * stages * stage


def split_cols(nb: int, splits: int, share: int = 1):
    """``(splits, cols)``: ``nb`` table columns cut into at most ``splits``
    runs of ``cols``, a multiple of ``share``, the last run possibly
    shorter; at least one run."""
    splits = min(max(1, splits), max(1, nb))
    cols = -(-max(1, nb) // splits)
    cols = -(-cols // share) * share
    return -(-max(1, nb) // cols), cols


def split_plan(B: int, nkv: int, nb: int, wave: int):
    """``(splits, cols)`` of the split route: each slot's ``nb`` table
    columns cut into as many splits as one wave of ``wave`` CTAs holds
    (the SMs times the CTAs an SM holds at once), at least one, ``cols`` a
    multiple of the warps of a CTA.  From sizes the host knows, never
    ``cur``.  One wave and no more, since a second, partial wave cost more
    than it gained (tools/k4_split_sweep.py on an H100: 64 slots of
    1024-2048 tokens at d 64 in 0.0538 ms at 1 split, 0.0601 at 2; 16 of
    them at d 128, block 32, one CTA an SM, 0.0311 at 2, 0.0351 at 4)."""
    return split_cols(nb, wave // max(1, B * nkv), WARPS)


def combine_plain(acc, m, l):
    """Pass 2 of the split route in plain PyTorch: partials acc (B, nq, S,
    dv), m and l (B, nq, S) over S column splits, combined as
    M = max m_s, acc = sum acc_s e^(m_s - M), l = sum l_s e^(m_s - M)."""
    M = m.amax(dim=-1)
    w = torch.exp(m - M[..., None])
    return (acc * w[..., None]).sum(dim=2), M, (l * w).sum(dim=-1)


def paged_flash_decode_split_plain(q, k_pool, v_pool, pos_pool, tables, cur,
                                   *, block: int, splits: int,
                                   window: int = 0,
                                   scale: Optional[float] = None,
                                   return_residuals: bool = False):
    """The split route's algebra in plain PyTorch: the plain K4's
    residuals over each run of columns of ``split_cols(nb, splits)``, then
    ``combine_plain``."""
    nb = tables.shape[1]
    n, cols = split_cols(nb, splits)
    parts = [paged_flash_decode_plain(
        q, k_pool, v_pool, pos_pool,
        tables[:, i * cols:min(nb, (i + 1) * cols)].contiguous(), cur,
        block=block, window=window, scale=scale, return_residuals=True)
        for i in range(n)]
    accs, ms, ls = zip(*parts)
    acc, m, l = combine_plain(torch.stack(accs, dim=2),
                              torch.stack(ms, dim=-1),
                              torch.stack(ls, dim=-1))
    if return_residuals:
        return acc, m, l
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def route(dtype: torch.dtype, dk: int, dv: int, group: int, block: int,
          aligned: bool) -> str:
    """The kernel that computes a decode step of these sizes: ``"split"``
    or ``"simt"`` (module docstring).  ``aligned``: q, the pools and
    pos_pool start on 16 bytes, as the split kernel's vector loads need."""
    if (dtype == torch.bfloat16 and dk == dv and dk in SPLIT_HEAD_DIMS
            and group in SPLIT_GROUPS and block % 8 == 0
            and 8 <= block <= SPLIT_MAX_BLOCK and aligned):
        return "split"
    return "simt"


def route_for(q, k_pool, v_pool, pos_pool, block: int) -> str:
    """``route`` for these operands, the alignment read off the pointers (a
    contiguous view may start anywhere)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool,
                                                    pos_pool))
    return route(q.dtype, q.shape[-1], v_pool.shape[-1],
                 q.shape[1] // max(1, k_pool.shape[1]), block, aligned)


def _check_force(force):
    if force is not None and force not in ROUTES:
        raise ValueError(f"K4 paged decode: route {force!r} not in {ROUTES}")


def _way(force, q, k_pool, v_pool, pos_pool, block) -> str:
    """The route a CUDA call takes: ``route_for``'s, or ``force``'s where it
    can take the operands (tests and timings compare the routes)."""
    way = route_for(q, k_pool, v_pool, pos_pool, block)
    if force is None or force == way:
        return way
    if force == "split":
        raise ValueError(
            f"K4 paged decode: the split route takes bfloat16 with dk = dv "
            f"in {SPLIT_HEAD_DIMS}, a group in {SPLIT_GROUPS}, a block that "
            f"is a multiple of 8 up to {SPLIT_MAX_BLOCK} and tensors on 16 "
            f"bytes, got {q.dtype}, dk {q.shape[-1]}, dv {v_pool.shape[-1]},"
            f" q {tuple(q.shape)}, {k_pool.shape[1]} kv heads, block {block}")
    return force


@functools.cache
def _simt():
    lib = _build.library("paged_decode")
    fn = lib.k4_paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _split():
    """The split route's C entry points: pass 1, pass 2, and the CTAs of
    pass 1 an SM holds."""
    lib = _build.library("paged_decode_hopper")
    one, two, per_sm = (lib.k4_split_decode, lib.k4_split_combine,
                        lib.k4_split_per_sm)
    one.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                    + [ctypes.c_float, ctypes.c_void_p])
    two.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                    + [ctypes.c_float, ctypes.c_void_p])
    per_sm.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    for fn in (one, two, per_sm):
        fn.restype = ctypes.c_int
    return one, two, per_sm


@functools.cache
def _per_sm(index: int, d: int, group: int, block: int, stages: int) -> int:
    """The split CTAs of this instance and ring that one SM of device
    ``index`` holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _split()[2](d, group, block, stages, ctypes.byref(n))
    if err != 0 or n.value < 1:
        raise RuntimeError(f"K4 paged decode: no split CTA of d {d}, group "
                           f"{group}, block {block}, {stages} stages fits an "
                           f"SM (CUDA error {err})")
    return n.value


def split_grid(q, k_pool, tables, block: int):
    """``(splits, cols, stages, per_sm)`` of a split-route call on these
    CUDA operands: ``split_plan`` over one wave of the ``per_sm`` CTAs
    each SM holds."""
    B, nq, d = q.shape
    nkv = k_pool.shape[1]
    stages, _ = split_ring(block, d)
    per_sm = _per_sm(q.device.index, d, nq // nkv, block, stages)
    wave = per_sm * _build.sm_count(q.device.index)
    return (*split_plan(B, nkv, tables.shape[1], wave), stages, per_sm)


def _check(q, k_pool, v_pool, pos_pool, tables, cur, block):
    if (q.dtype not in _DTYPES or k_pool.dtype not in _DTYPES
            or v_pool.dtype != k_pool.dtype
            or (q.dtype != k_pool.dtype and q.dtype != torch.float32)):
        raise TypeError(f"K4 paged decode takes float32 or bfloat16 pools of "
                        f"one dtype and q of theirs or float32 (MLA's latent "
                        f"decode), got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    for name, t in (("pos_pool", pos_pool), ("tables", tables), ("cur", cur)):
        if t.dtype != torch.int32:
            raise TypeError(f"K4 paged decode: {name} must be int32, got "
                            f"{t.dtype}")
    if q.dim() != 3 or k_pool.dim() != 3 or v_pool.dim() != 3 \
            or pos_pool.dim() != 1 or tables.dim() != 2 or cur.dim() != 1:
        raise ValueError("K4 paged decode: expected q (B,nq,dk), pools "
                         "(phys,nkv,d), pos_pool (phys,), tables (B,nb), "
                         "cur (B,)")
    B, nq, dk = q.shape
    phys, nkv, dk2 = k_pool.shape
    if (dk2 != dk or v_pool.shape[:2] != (phys, nkv)
            or tuple(pos_pool.shape) != (phys,) or tables.shape[0] != B
            or tuple(cur.shape) != (B,) or nq % nkv or block < 1
            or phys % block):
        raise ValueError(
            f"K4 paged decode: inconsistent shapes q {tuple(q.shape)}, "
            f"k_pool {tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}, "
            f"pos_pool {tuple(pos_pool.shape)}, tables {tuple(tables.shape)},"
            f" cur {tuple(cur.shape)}, block {block}")
    if max(B, nq, tables.shape[1], phys) >= 2 ** 31 or B > 65535:
        raise ValueError("K4 paged decode: a dim is too large")
    if not all(t.is_contiguous()
               for t in (q, k_pool, v_pool, pos_pool, tables, cur)):
        raise ValueError("K4 paged decode takes contiguous tensors")


def _check_new(q, k_pool, v_pool, k_new, v_new):
    B, nkv = q.shape[0], k_pool.shape[1]
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise TypeError("K4 paged decode step: k_new and v_new must have q's "
                        "dtype")
    if tuple(k_new.shape) != (B, nkv, q.shape[-1]) \
            or tuple(v_new.shape) != (B, nkv, v_pool.shape[-1]):
        raise ValueError(f"K4 paged decode step: k_new {tuple(k_new.shape)},"
                         f" v_new {tuple(v_new.shape)}; expected (B, nkv, d)")
    if not (k_new.is_contiguous() and v_new.is_contiguous()):
        raise ValueError("K4 paged decode takes contiguous tensors")


def _count(way: str, combine: bool):
    global launches, launches_combine
    launches += 1
    launches_by_route[way] += 1
    launches_combine += int(combine)


def _run_simt(q, k_pool, v_pool, pos_pool, tables, cur, block, window,
              scale, residuals):
    B, nq, dk = q.shape
    phys, nkv, _ = k_pool.shape
    dv = v_pool.shape[-1]
    dev = q.device
    out = torch.empty((B, nq, dv), device=dev,
                      dtype=torch.float32 if residuals else q.dtype)
    m = l = None
    if residuals:
        m = torch.empty((B, nq), device=dev, dtype=torch.float32)
        l = torch.empty((B, nq), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _simt()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                      pos_pool.data_ptr(), tables.data_ptr(), cur.data_ptr(),
                      out.data_ptr(),
                      m.data_ptr() if m is not None else None,
                      l.data_ptr() if l is not None else None,
                      B, nq, nkv, dk, dv, block, tables.shape[1],
                      phys // block, window, scale, _DTYPES[q.dtype],
                      _DTYPES[k_pool.dtype], int(residuals), stream)
    _build.check_launch("K4 paged decode (simt)", err)
    _count("simt", False)
    return (out, m, l) if residuals else out


def _run_split(q, k_pool, v_pool, pos_pool, tables, cur, block, window,
               scale, mode, k_new=None, v_new=None):
    """Both passes of the split route; ``mode`` 0 returns (acc, m, l), 1
    the normalised output, 2 the output with (k_new, v_new) folded in."""
    B, nq, d = q.shape
    phys, nkv, _ = k_pool.shape
    nb = tables.shape[1]
    dev = q.device
    n, cols, stages, _ = split_grid(q, k_pool, tables, block)
    f32 = torch.float32
    acc = torch.empty((B, nq, n, d), device=dev, dtype=f32)
    m = torch.empty((B, nq, n), device=dev, dtype=f32)
    l = torch.empty((B, nq, n), device=dev, dtype=f32)
    out = torch.empty((B, nq, d), device=dev,
                      dtype=f32 if mode == 0 else q.dtype)
    m_out = l_out = None
    if mode == 0:
        m_out = torch.empty((B, nq), device=dev, dtype=f32)
        l_out = torch.empty((B, nq), device=dev, dtype=f32)
    one, two, _ = _split()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = one(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  pos_pool.data_ptr(), tables.data_ptr(), cur.data_ptr(),
                  acc.data_ptr(), m.data_ptr(), l.data_ptr(), B, nq, nkv, d,
                  block, nb, phys // block, window, n, cols, stages, scale,
                  stream)
        _build.check_launch("K4 paged decode (split)", err)
        err = two(acc.data_ptr(), m.data_ptr(), l.data_ptr(), q.data_ptr(),
                  k_new.data_ptr() if k_new is not None else None,
                  v_new.data_ptr() if v_new is not None else None,
                  out.data_ptr(),
                  m_out.data_ptr() if m_out is not None else None,
                  l_out.data_ptr() if l_out is not None else None,
                  B, nq, nkv, d, n, mode, scale, stream)
        _build.check_launch("K4 paged decode (split combine)", err)
    _count("split", True)
    return (out, m_out, l_out) if mode == 0 else out


def paged_flash_decode(q, k_pool, v_pool, pos_pool, tables, cur, *,
                       block: int, window: int = 0,
                       scale: Optional[float] = None,
                       return_residuals: bool = False,
                       force: Optional[str] = None):
    """One decode step of paged attention over the pool alone; see the
    module docstring.

    ``return_residuals=True`` returns ``(acc, m, l)``: the unnormalized f32
    accumulator plus the online-softmax max and sum, so a caller can fold
    more keys into the same softmax.  CUDA tensors launch the kernel of
    ``route`` (or of the route named by ``force``); CPU tensors run
    ``paged_flash_decode_plain``."""
    _check_force(force)
    if not _build.on_cuda("K4 paged decode", q, k_pool, v_pool, pos_pool,
                          tables, cur):
        return paged_flash_decode_plain(
            q, k_pool, v_pool, pos_pool, tables, cur, block=block,
            window=window, scale=scale, return_residuals=return_residuals)
    _check(q, k_pool, v_pool, pos_pool, tables, cur, block)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    way = _way(force, q, k_pool, v_pool, pos_pool, block)
    if way == "simt":
        return _run_simt(q, k_pool, v_pool, pos_pool, tables, cur, block,
                         window, scale, return_residuals)
    return _run_split(q, k_pool, v_pool, pos_pool, tables, cur, block,
                      window, scale, 0 if return_residuals else 1)


def paged_flash_decode_step(q, k_new, v_new, k_pool, v_pool, pos_pool,
                            tables, cur, *, block: int, window: int = 0,
                            scale: Optional[float] = None,
                            force: Optional[str] = None):
    """One decode step with the step's own token folded in: attention of q
    over the pool's valid entries and (k_new, v_new), normalised, in q's
    dtype.  On the split route the combine pass does the fold; on the
    simt route ``fold_current_token`` follows the kernel's residuals; CPU
    tensors run ``paged_flash_decode_step_plain``."""
    _check_force(force)
    if not _build.on_cuda("K4 paged decode step", q, k_new, v_new, k_pool,
                          v_pool, pos_pool, tables, cur):
        return paged_flash_decode_step_plain(
            q, k_new, v_new, k_pool, v_pool, pos_pool, tables, cur,
            block=block, window=window, scale=scale)
    _check(q, k_pool, v_pool, pos_pool, tables, cur, block)
    _check_new(q, k_pool, v_pool, k_new, v_new)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    way = _way(force, q, k_pool, v_pool, pos_pool, block)
    if way == "simt":
        acc, m, l = _run_simt(q, k_pool, v_pool, pos_pool, tables, cur,
                              block, window, scale, True)
        return fold_current_token(q, k_new, v_new, acc, m, l, scale=scale)
    return _run_split(q, k_pool, v_pool, pos_pool, tables, cur, block,
                      window, scale, 2, k_new, v_new)

