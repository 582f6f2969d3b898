"""K4: fused paged flash-decode (CUDA C++, ``csrc/paged_decode.cu``).

Replaces ``src/repro/kernels/paged_decode.py:paged_flash_decode`` (Pallas
kernel ``_decode_kernel`` via ``_pallas_impl``): attention for one new
token per slot, read straight out of the paged KV pool through the block
table.  Every attention layer of every fused decode step calls it
(``models/blocks.py:attention_decode_paged``).

Shapes (one layer):

    q        (B, nq, dk)        new-token queries, nq = nkv * group
    k_pool   (phys, nkv, dk)    phys = n_blocks * block
    v_pool   (phys, nkv, dv)    dv may differ from dk
    pos_pool (phys,) int32      logical position per entry, -1 = invalid
    tables   (B, nb) int32      physical block id per view block
    cur      (B,) int32         current decode position per slot
    -> out   (B, nq, dv) in q's dtype, or f32 (acc, m, l) with residuals

Entry ``e`` of slot ``b`` attends iff ``0 <= pos_pool[e] <= cur[b]`` (and
``cur[b] - pos_pool[e] < window`` when windowed).

Bound on an H100: bytes (every valid K/V entry is read once for 4*group
flops per element).  Design: the TPU grid carries the online softmax from
one table column to the next; on Hopper one block per (slot, kv head) walks
the slot's table columns in a loop, reads each ``tables[b, j]`` itself,
stages each (block, dk) K and (block, dv) V tile in shared memory and keeps
(m, l, acc) there across the loop.  Columns with no valid entry are skipped
before their K/V are read.  Known limit: B*nkv blocks (32 at B = 8 on
tinyllama-1.1b) on 132 SMs; split-K over the table columns is later work.
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

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0


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


@functools.cache
def _lib():
    lib = _build.library("paged_decode")
    fn = lib.k4_paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pool, v_pool, pos_pool, tables, cur, block):
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"K4 paged decode takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k_pool.dtype}, "
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
    if max(B, nq, tables.shape[1], phys) >= 2 ** 31:
        raise ValueError("K4 paged decode: a dim does not fit in int32")
    if not all(t.is_contiguous()
               for t in (q, k_pool, v_pool, pos_pool, tables, cur)):
        raise ValueError("K4 paged decode takes contiguous tensors")


def paged_flash_decode(q, k_pool, v_pool, pos_pool, tables, cur, *,
                       block: int, window: int = 0,
                       scale: Optional[float] = None,
                       return_residuals: bool = False):
    """One decode step of paged attention; see the module docstring.

    ``return_residuals=True`` returns ``(acc, m, l)``: the unnormalized f32
    accumulator plus the online-softmax max and sum, so a caller can fold
    more keys into the same softmax.  CUDA tensors launch the kernel; CPU
    tensors run ``paged_flash_decode_plain``."""
    if not _build.on_cuda("K4 paged decode", q, k_pool, v_pool, pos_pool,
                          tables, cur):
        return paged_flash_decode_plain(
            q, k_pool, v_pool, pos_pool, tables, cur, block=block,
            window=window, scale=scale, return_residuals=return_residuals)
    _check(q, k_pool, v_pool, pos_pool, tables, cur, block)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    B, nq, dk = q.shape
    phys, nkv, _ = k_pool.shape
    dv = v_pool.shape[-1]
    nb = tables.shape[1]
    dev = q.device
    out = torch.empty((B, nq, dv), device=dev,
                      dtype=torch.float32 if return_residuals else q.dtype)
    m = l = None
    if return_residuals:
        m = torch.empty((B, nq), device=dev, dtype=torch.float32)
        l = torch.empty((B, nq), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                     pos_pool.data_ptr(), tables.data_ptr(), cur.data_ptr(),
                     out.data_ptr(),
                     m.data_ptr() if m is not None else None,
                     l.data_ptr() if l is not None else None,
                     B, nq, nkv, dk, dv, block, nb, phys // block, window,
                     scale, _DTYPES[q.dtype], int(return_residuals), stream)
    _build.check_launch("K4 paged decode", err)
    global launches
    launches += 1
    return (out, m, l) if return_residuals else out
