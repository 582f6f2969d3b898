"""Paged KV cache: fixed-size blocks, per-slot block tables, free-list
allocation, eviction on request completion (port of
``repro/serve/kvcache.py`` without the prefix index).

The *pool* is the single device-resident store of the dense family's decode
cache: per layer, keys and values ``(n_blocks * block, nkv, d)`` and the
logical position of every entry ``(n_blocks * block,)`` (-1 = invalid).
Which physical block holds which ``(slot, logical position)`` pair is
host-side bookkeeping (``PagedKVCache``: a ref-counted allocator plus one
block table per engine slot).  The device functions below update the pool
tensors in place (the reference returns new arrays; in place saves a copy
of the whole pool per step):

  * ``scatter_step``     write one fused decode step's new entries, all
                         layers in one scatter per leaf.
  * ``scatter_prefill``  write a whole chunk of prefill kv per slot at once.
  * ``clear_positions``  invalidate (pos = -1) freshly allocated blocks so a
                         reused block never leaks a previous request's keys.

Two physical blocks are reserved: block 0 is the *null* block — every
unallocated block-table entry points at it and its positions stay -1
forever, so it is masked out of attention — and block 1 is the *trash*
block, the write target for masked-out lanes (inactive slots, prompt
padding); no table references it.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig

RESERVED = 2                      # block 0 = null (reads), block 1 = trash (writes)


# ---------------------------------------------------------------------------
# Host-side allocation
# ---------------------------------------------------------------------------
class BlockAllocator:
    """Ref-counted free-list allocator over ``n_blocks`` fixed-size blocks
    with an LRU of cached (refcount-0 but content-preserving) blocks.

    Blocks 0 and 1 are reserved (null / trash) and never handed out.  Every
    non-reserved block is in exactly one of three states:

      * *free*    — content-less, on the plain free list;
      * *live*    — refcount >= 1 (one count per owner: a slot's table, a
        prefix-sharing acquirer, a COW-source hold);
      * *cached*  — refcount dropped to 0 via ``release(cache=True)``: the
        content (an indexed prefix block) stays resident and matchable
        until ``alloc`` needs the space, evicting in LRU order (and firing
        ``on_evict`` so the prefix index forgets the block first).

    Invariants (enforced by ``check``): the three sets partition the
    non-reserved blocks; a block is never handed out while its refcount is
    > 0; only live blocks may be released; releasing below zero raises.
    """

    def __init__(self, n_blocks: int):
        if n_blocks <= RESERVED:
            raise ValueError(f"need more than {RESERVED} blocks, got {n_blocks}")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(RESERVED, n_blocks))
        self._ref: Dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.on_evict: Optional[Callable[[int], None]] = None
        self.evictions = 0

    @property
    def n_free(self) -> int:
        """Allocatable blocks: truly free plus evictable cached ones."""
        return len(self._free) + len(self._lru)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n blocks at refcount 1, or None (and no state change) when fewer
        than n are allocatable.  Plain free blocks are preferred; cached
        blocks are evicted oldest-first, each eviction notifying
        ``on_evict`` before the block is handed to its new owner."""
        if n > self.n_free:
            return None
        blocks, self._free = self._free[:n], self._free[n:]
        while len(blocks) < n:
            b, _ = self._lru.popitem(last=False)         # oldest first
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(b)
            blocks.append(b)
        for b in blocks:
            self._ref[b] = 1
        return blocks

    def acquire(self, block: int):
        """Take a reference on a live or cached block (a prefix hit revives
        a cached block back to refcount 1).  Free/foreign blocks raise."""
        if block in self._ref:
            self._ref[block] += 1
        elif block in self._lru:
            del self._lru[block]
            self._ref[block] = 1
        else:
            raise ValueError(f"acquire of free / foreign block {block}")

    def release(self, block: int, cache: bool = False):
        """Drop one reference.  At refcount 0 the block returns to the free
        list, or — ``cache=True`` — parks on the LRU with its content
        matchable until evicted."""
        if block not in self._ref:
            raise ValueError(f"double free / foreign block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            del self._ref[block]
            if cache:
                self._lru[block] = None                  # MRU end
            else:
                self._free.append(block)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def free(self, blocks: Sequence[int]):
        """Bulk release without caching."""
        for b in blocks:
            self.release(b, cache=False)

    def check(self):
        """Invariant: free / live / cached partition the non-reserved
        blocks, and every live refcount is >= 1."""
        free, live, cached = set(self._free), set(self._ref), set(self._lru)
        assert len(self._free) == len(free)
        assert not (free & live) and not (free & cached) and not (live & cached)
        assert len(free) + len(live) + len(cached) == self.n_blocks - RESERVED
        assert all(c >= 1 for c in self._ref.values())


# ---------------------------------------------------------------------------
# Device-side pool updates (in place)
# ---------------------------------------------------------------------------
def _pairs(pool, updates):
    for kind, leaves in updates.items():
        for name, up in leaves.items():
            yield pool[kind][name], up


def scatter_step(pool, updates, phys):
    """Write one fused decode step's new entries back in a single batched
    scatter per leaf: update leaves (n, B, ...) — the per-layer (k, v, pos)
    stacks the fused decode collects — land at physical rows ``phys`` (B,)
    (masked lanes point at the trash block)."""
    for leaf, up in _pairs(pool, updates):
        leaf[:, phys] = up.to(leaf.dtype)
    return pool


def scatter_prefill(pool, updates, phys_map):
    """Write whole prefill chunks: update leaves (n, B, S, ...) land at flat
    physical rows ``phys_map`` (B, S) (padding lanes -> trash)."""
    flat = phys_map.reshape(-1)
    for leaf, up in _pairs(pool, updates):
        leaf[:, flat] = up.reshape(up.shape[0], -1, *up.shape[3:]).to(
            leaf.dtype)
    return pool


def clear_positions(pool, idx):
    """Invalidate the integer (position) leaves at flat rows ``idx`` so
    recycled blocks never leak a previous request's entries."""
    flat = idx.reshape(-1)
    for leaves in pool.values():
        for leaf in leaves.values():
            if not leaf.is_floating_point():
                leaf[:, flat] = -1
    return pool


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------
class PagedKVCache:
    """Host-side paged-cache bookkeeping for one engine.

    Block math: the cache length is ``L_abs = min(max_len, window)`` for
    sliding-window configs, else ``max_len``.  Each slot's view is
    ``nb = ceil(L_abs / block)`` whole blocks, so the view length (the
    decode ring modulus) is ``view_len = nb * block``.  A request needing
    ``t`` cache entries occupies ``ceil(min(t, view_len) / block)`` blocks,
    allocated at admission and freed when it completes.  The pool holds
    ``n_blocks`` physical blocks (default: 2 reserved + full residency for
    every slot).
    """

    def __init__(self, cfg: ModelConfig, batch_size: int, max_len: int,
                 block: int = 16, n_blocks: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16):
        l_abs = min(max_len, cfg.window) if cfg.window else max_len
        self.cfg = cfg
        self.dtype = dtype
        self.block = block
        self.blocks_per_slot = -(-l_abs // block)
        self.view_len = self.blocks_per_slot * block
        self.B = batch_size
        self.n_blocks = n_blocks or (RESERVED
                                     + batch_size * self.blocks_per_slot)
        self.allocator = BlockAllocator(self.n_blocks)
        self.tables = np.zeros((batch_size, self.blocks_per_slot), np.int32)
        self._owned: List[List[int]] = [[] for _ in range(batch_size)]

    def init_pool(self, device):
        """The zeroed pool on ``device`` (positions start at -1: every
        block, the null block included, is invalid until written)."""
        cfg = self.cfg
        phys = self.n_blocks * self.block
        shape = (cfg.n_layers, phys, cfg.n_kv, cfg.head_dim)
        return {"dense": {
            "k": torch.zeros(shape, dtype=self.dtype, device=device),
            "v": torch.zeros(shape, dtype=self.dtype, device=device),
            "pos": torch.full((cfg.n_layers, phys), -1, dtype=torch.int32,
                              device=device)}}

    # ---- admission / eviction -------------------------------------------
    def blocks_needed(self, n_tokens: int) -> int:
        return -(-min(n_tokens, self.view_len) // self.block)

    def can_admit(self, n_tokens: int) -> bool:
        return self.allocator.n_free >= self.blocks_needed(n_tokens)

    def admit(self, slot: int, n_tokens: int) -> bool:
        """Reserve the slot's blocks for a request needing ``n_tokens``
        cache entries; False (no state change) when the pool is exhausted."""
        if self._owned[slot]:
            raise ValueError(f"slot {slot} already holds blocks")
        blocks = self.allocator.alloc(self.blocks_needed(n_tokens))
        if blocks is None:
            return False
        self._owned[slot] = blocks
        self.tables[slot, :] = 0
        self.tables[slot, :len(blocks)] = blocks
        return True

    def release(self, slot: int):
        """Eviction on completion: the slot's blocks return to the free list."""
        for b in self._owned[slot]:
            self.allocator.release(b)
        self._owned[slot] = []
        self.tables[slot, :] = 0

    # ---- index computation (host) ---------------------------------------
    def phys(self, slot: int, pos: int) -> int:
        """Flat physical index of logical position ``pos`` for ``slot``
        (ring over the view length, like the contiguous decode cache)."""
        v = pos % self.view_len
        return int(self.tables[slot, v // self.block]) * self.block \
            + v % self.block

    def tables_device(self, device) -> torch.Tensor:
        return torch.from_numpy(self.tables).to(device)

    def trash_row(self, row: int) -> int:
        return self.block + row % self.block

    def prefill_phys_map(self, rows_len: Dict[int, int],
                         s_pad: int) -> np.ndarray:
        """(B, s_pad) flat physical targets for a prefill group: slot ``i``
        with prompt length ``rows_len[i]`` keeps its last ``view_len``
        positions (sliding-window ring); everything else -> trash."""
        out = np.empty((self.B, s_pad), np.int64)
        for i in range(self.B):
            out[i, :] = self.trash_row(i)
            n = rows_len.get(i, 0)
            for p in range(max(0, n - self.view_len), min(n, s_pad)):
                out[i, p] = self.phys(i, p)
        return out

    def clear_targets(self, slots: Sequence[int]) -> np.ndarray:
        """(B, blocks_per_slot*block) flat indices whose positions must be
        invalidated: the full allocated extent of the given slots; other
        rows target the trash block."""
        width = self.blocks_per_slot * self.block
        out = np.empty((self.B, width), np.int64)
        for i in range(self.B):
            out[i, :] = self.trash_row(i)
            if i in slots:
                for j, b in enumerate(self._owned[i]):
                    out[i, j * self.block:(j + 1) * self.block] = \
                        np.arange(b * self.block, (b + 1) * self.block)
        return out
