"""Paged KV cache: fixed-size blocks, per-slot block tables, free-list
allocation, eviction on request completion, and the shared-prefix index
with copy-on-write (port of ``repro/serve/kvcache.py``).

The *pool* is the single device-resident store of the paged families'
decode cache: one slab per block kind with attention ("dense", and "moe"
for the MoE family, as the reference's per-kind cache tree), and per layer
keys and values ``(n_blocks * block, nkv, d)`` and the logical position of
every entry ``(n_blocks * block,)`` (-1 = invalid).
Which physical block holds which ``(slot, logical position)`` pair is
host-side bookkeeping (``PagedKVCache``: a ref-counted allocator plus one
block table per engine slot).  The device functions below update the pool
tensors in place (the reference returns new arrays; in place saves a copy
of the whole pool per step):

  * ``scatter_step``     write one fused decode step's new entries, all
                         layers in one scatter per leaf.
  * ``gather_view``      pool + tables -> the per-slot contiguous view
                         (n_layers, B, view_len, ...) that the gather-view
                         decode and ``transformer.extend`` consume.
  * ``scatter_decode``   write the view's one new entry per slot back.
  * ``scatter_prefill``  write a whole chunk of prefill kv per slot at once.
  * ``copy_block``       copy-on-write of a partly shared prefix block.
  * ``clear_positions``  invalidate (pos = -1) freshly allocated blocks so a
                         reused block never leaks a previous request's keys.

``scatter_prefill_state`` writes prefill kv into a contiguous cache (the
speculative draft's), and ``cache_with_dtype`` sets a contiguous cache
tree's float dtypes.

Two physical blocks are reserved: block 0 is the *null* block — every
unallocated block-table entry points at it and its positions stay -1
forever, so it is masked out of attention — and block 1 is the *trash*
block, the write target for masked-out lanes (inactive slots, prompt
padding); no table references it.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..core.params import Param, tree_map
from ..models.registry import KIND_CACHES, KV_KINDS, layer_plan

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
# Prefix index: content-addressed lookup of cached full blocks
# ---------------------------------------------------------------------------
class PrefixIndex:
    """Maps full-block content to resident physical blocks.

    A full block holding prompt tokens ``t[j*B:(j+1)*B]`` is keyed by the
    chain key ``(parent_block_id, tuple(tokens))``: the parent id pins the
    entire prefix before this block (recursively, back to the root
    sentinel -1), the token tuple pins this block's content, and Python's
    tuple hashing gives exact-match lookup (one index serves one engine's
    pool, so the model never enters the key).

    ``deregister`` is recursive over the child tree: when a block is
    evicted and its id recycled, an indexed descendant's chain key would
    dangle on the stale parent id and could falsely match a future chain,
    so the whole subtree is forgotten with it.
    """

    def __init__(self):
        self._by_key: Dict[tuple, int] = {}
        self._children: Dict[int, List[int]] = {}
        self._tokens: Dict[int, tuple] = {}
        self._parent: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._tokens)

    def register(self, parent: int, tokens: tuple, block: int) -> int:
        """Index ``block`` as holding ``tokens`` directly after ``parent``
        (-1 = chain root).  Returns the indexed block: the existing one on
        a duplicate-content race (the caller's block then stays private)."""
        key = (parent, tokens)
        if key in self._by_key:
            return self._by_key[key]
        self._by_key[key] = block
        self._tokens[block] = tokens
        self._parent[block] = parent
        self._children.setdefault(parent, []).append(block)
        return block

    def deregister(self, block: int):
        """Forget a block and (recursively) every indexed descendant."""
        for c in list(self._children.get(block, ())):
            self.deregister(c)
        self._children.pop(block, None)
        if block in self._tokens:
            parent = self._parent.pop(block)
            self._by_key.pop((parent, self._tokens.pop(block)), None)
            sibs = self._children.get(parent)
            if sibs is not None:
                sibs.remove(block)
                if not sibs:
                    del self._children[parent]

    def match(self, tokens: Sequence[int], block: int):
        """Longest indexed chain for a prompt: returns ``(chain, partial)``,
        ``chain`` the matched full blocks in order, ``partial`` the
        ``(block, lcp)`` best partial continuation (an indexed child whose
        first ``lcp >= 1`` tokens extend the match) or None."""
        chain: List[int] = []
        parent = -1
        i = 0
        while i + block <= len(tokens):
            nxt = self._by_key.get((parent, tuple(tokens[i:i + block])))
            if nxt is None:
                break
            chain.append(nxt)
            parent = nxt
            i += block
        best = None
        rest = tokens[i:]
        if rest:
            for c in self._children.get(parent, ()):
                lcp = 0
                for a, b in zip(rest, self._tokens[c]):
                    if a != b:
                        break
                    lcp += 1
                if lcp and (best is None or lcp > best[1]):
                    best = (c, lcp)
        return chain, best


# ---------------------------------------------------------------------------
# Device-side pool and cache updates (in place)
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


def gather_view(pool, tables, block: int):
    """Pool leaves (n, n_blocks * block, ...) + tables (B, nb) -> view
    leaves (n, B, nb * block, ...): the contiguous per-slot cache (a copy)
    that the gather-view decode and ``transformer.extend`` consume."""
    lane = torch.arange(block, device=tables.device)
    flat = (tables.long()[:, :, None] * block + lane).reshape(
        tables.shape[0], -1)
    return tree_map(lambda leaf: leaf[:, flat], pool)


def scatter_decode(pool, new_view, slot, phys):
    """Write each slot's new entry, at view index ``slot`` (B,), back to
    its physical row ``phys`` (B,) (masked lanes point at the trash
    block)."""
    rows = torch.arange(slot.shape[0], device=slot.device)
    for leaf, view in _pairs(pool, new_view):
        leaf[:, phys] = view[:, rows, slot].to(leaf.dtype)
    return pool


def scatter_prefill(pool, updates, phys_map):
    """Write whole prefill chunks: update leaves (n, B, S, ...) land at flat
    physical rows ``phys_map`` (B, S) (padding lanes -> trash)."""
    flat = phys_map.reshape(-1)
    for leaf, up in _pairs(pool, updates):
        leaf[:, flat] = up.reshape(up.shape[0], -1, *up.shape[3:]).to(
            leaf.dtype)
    return pool


def copy_block(pool, src_rows, dst_rows, keep):
    """Copy-on-write: duplicate one block's worth of entries per slot from
    ``src_rows`` to ``dst_rows`` (both (B, block) flat physical rows;
    rows with nothing to copy point both at the trash block).  ``keep``
    (B, block) bool marks how much of the source is shared: position
    leaves outside it land as -1, so the copy is valid exactly up to the
    divergence point."""
    src, dst, k = (t.reshape(-1) for t in (src_rows, dst_rows, keep))
    for leaves in pool.values():
        for leaf in leaves.values():
            vals = leaf[:, src]
            if not leaf.is_floating_point():
                vals = torch.where(k[None, :], vals, -1)
            leaf[:, dst] = vals
    return pool


def scatter_prefill_state(cache, updates, idx):
    """Write prefill kv into a contiguous (n, B, L, ...) cache (the
    speculative draft's): update leaves (n, B, S, ...) land at per-row
    indices ``idx`` (B, S); padding lanes carry idx >= L and are
    dropped."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None] \
        .expand_as(idx)
    for leaf, up in _pairs(cache, updates):
        valid = idx < leaf.shape[2]
        leaf[:, rows[valid], idx[valid]] = up[:, valid].to(leaf.dtype)
    return cache


def cache_with_dtype(tree, dtype: torch.dtype):
    """Promote the floating leaves of an abstract cache tree to at least
    ``dtype`` (reference ``kvcache.py:340-350``): an f32 engine gets an f32
    kv cache, and leaves already wider (the f32 recurrent states) keep
    their dtype."""
    def one(p: Param) -> Param:
        dt = p.dtype or dtype
        if dt.is_floating_point:
            return dataclasses.replace(p, dtype=torch.promote_types(dt,
                                                                    dtype))
        return p
    return tree_map(one, tree)


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

    With ``prefix_cache`` a slot's table is its shared prefix blocks
    (acquired by reference from the ``PrefixIndex``) followed by its
    private blocks; a partly matching block is copied on write into the
    first private block, and indexed blocks park on the allocator's LRU
    when their last user completes.
    """

    def __init__(self, cfg: ModelConfig, batch_size: int, max_len: int,
                 block: int = 16, n_blocks: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 prefix_cache: bool = False):
        l_abs = min(max_len, cfg.window) if cfg.window else max_len
        if prefix_cache and l_abs < max_len:
            raise ValueError(
                f"{cfg.arch}: prefix sharing needs a non-wrapping view "
                f"(view {l_abs} < max_len {max_len}: the sliding-window "
                "ring would decode over shared blocks)")
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
        # _owned = the slot's private blocks in table order (its table is
        # _shared + _owned + null padding); _indexed marks private blocks
        # published to the prefix index at prefill completion
        self._owned: List[List[int]] = [[] for _ in range(batch_size)]
        self._shared: List[List[int]] = [[] for _ in range(batch_size)]
        self._indexed: List[set] = [set() for _ in range(batch_size)]
        self._prompt: List[tuple] = [() for _ in range(batch_size)]
        self._hit: List[int] = [0] * batch_size
        self._cow: List[Optional[Tuple[int, int]]] = [None] * batch_size
        self.prefix = PrefixIndex() if prefix_cache else None
        if prefix_cache:
            self.allocator.on_evict = self.prefix.deregister
        self.lookups = 0
        self.hits = 0
        self.tokens_reused = 0

    def init_pool(self, device):
        """The zeroed pool on ``device``, {kind: {"k", "v", "pos"}} (MLA:
        {kind: {"c_kv", "k_rope", "pos"}}, the latent pool) with leaves
        (layers of the kind, phys, ...) in plan order: each leaf of the
        kind's contiguous cache with its (batch, length) dims replaced by
        the physical rows (reference ``kvcache.py:415-433``).  Positions
        start at -1: every block, the null block included, is invalid
        until written."""
        phys = self.n_blocks * self.block
        plan = layer_plan(self.cfg)
        pool = {}
        for kind in dict.fromkeys(plan):
            if kind not in KV_KINDS:
                continue
            n = plan.count(kind)
            pool[kind] = {
                name: (torch.zeros((n, phys, *p.shape[2:]), device=device,
                                   dtype=self.dtype)
                       if p.dtype is None or p.dtype.is_floating_point else
                       torch.full((n, phys, *p.shape[2:]), -1, dtype=p.dtype,
                                  device=device))
                for name, p in KIND_CACHES[kind](self.cfg, 1, 1).items()}
        return pool

    # ---- admission / eviction -------------------------------------------
    def blocks_needed(self, n_tokens: int) -> int:
        return -(-min(n_tokens, self.view_len) // self.block)

    def _match(self, prompt: Sequence[int]):
        """Cap the raw index match to this prompt: at least one tail token
        stays un-hit (the extend step needs a fresh position to produce
        logits from).  Returns (full_chain_blocks, cow, hit_len), ``cow``
        being (source_block, n_tokens_reused) or None."""
        Bk = self.block
        chain, partial = self.prefix.match(prompt, Bk)
        usable = len(prompt) - 1
        m_full = min(len(chain), usable // Bk)
        if len(chain) > m_full:
            # the chain over-covers: reuse the next chain block partially
            cow_src, r = chain[m_full], usable - m_full * Bk
        elif partial is not None:
            cow_src, r = partial[0], min(partial[1], usable - m_full * Bk)
        else:
            cow_src, r = -1, 0
        cow = (cow_src, r) if r > 0 else None
        return chain[:m_full], cow, m_full * Bk + (r if cow else 0)

    def can_admit(self, n_tokens: int, prompt: Sequence[int] = None) -> bool:
        shared = 0
        if self.prefix is not None and prompt:
            shared = len(self._match(prompt)[0])
        return (self.allocator.n_free
                >= self.blocks_needed(n_tokens) - shared)

    def admit(self, slot: int, n_tokens: int,
              prompt: Sequence[int] = None) -> bool:
        """Reserve the slot's blocks for a request needing ``n_tokens``
        cache entries; False (no state change) when the pool is exhausted.

        With the prefix index on and a ``prompt`` given, the longest cached
        prefix chain enters the slot's table by reference (each shared
        block acquired before the private allocation, so that the
        allocator cannot evict it in the same breath), a partly matching
        block is scheduled for copy-on-write (``cow_info``), and only the
        remaining blocks are freshly allocated."""
        if self._owned[slot] or self._shared[slot]:
            raise ValueError(f"slot {slot} already holds blocks")
        chain: List[int] = []
        cow = None
        hit = 0
        if self.prefix is not None and prompt:
            self.lookups += 1
            chain, cow, hit = self._match(prompt)
            for b in chain:
                self.allocator.acquire(b)
            if cow is not None:
                self.allocator.acquire(cow[0])   # pinned until cow_done
        blocks = self.allocator.alloc(self.blocks_needed(n_tokens)
                                      - len(chain))
        if blocks is None:
            for b in chain:
                self.allocator.release(b, cache=True)
            if cow is not None:
                self.allocator.release(cow[0], cache=True)
            return False
        if hit:
            self.hits += 1
            self.tokens_reused += hit
        self._shared[slot] = chain
        self._owned[slot] = blocks
        self._prompt[slot] = tuple(prompt) if prompt else ()
        self._hit[slot] = hit
        self._cow[slot] = cow
        self.tables[slot, :] = 0
        self.tables[slot, :len(chain)] = chain
        self.tables[slot, len(chain):len(chain) + len(blocks)] = blocks
        return True

    def hit_len(self, slot: int) -> int:
        """Prompt tokens this slot reuses from the prefix cache (its extend
        starts at this offset)."""
        return self._hit[slot]

    def cow_info(self, slot: int) -> Optional[Tuple[int, int]]:
        """(source_block, n_tokens) the engine copies into the slot's first
        private block before prefilling, or None."""
        return self._cow[slot]

    def cow_done(self, slot: int):
        """Drop the copy-on-write source's pin taken at admission (the
        engine has issued the device copy)."""
        if self._cow[slot] is not None:
            self.allocator.release(self._cow[slot][0], cache=True)
            self._cow[slot] = None

    def register_prefix(self, slot: int):
        """Publish the slot's fully written prompt blocks to the prefix
        index (once the prompt's kv is resident).  Shared blocks are
        already indexed; each private full block is chained after its table
        predecessor.  A duplicate-content race keeps the existing entry and
        leaves this slot's copy private."""
        if self.prefix is None or not self._prompt[slot]:
            return
        prompt, Bk = self._prompt[slot], self.block
        for j in range(len(self._shared[slot]), len(prompt) // Bk):
            b = int(self.tables[slot, j])
            parent = int(self.tables[slot, j - 1]) if j else -1
            if self.prefix.register(parent, prompt[j * Bk:(j + 1) * Bk],
                                    b) == b:
                self._indexed[slot].add(b)

    def release(self, slot: int):
        """Eviction on completion: drop the slot's references.  Private
        blocks in the prefix index (and all shared blocks) park on the
        allocator's LRU, matchable until evicted; the other private blocks
        return to the free list."""
        self.cow_done(slot)
        for b in self._shared[slot]:
            self.allocator.release(b, cache=True)
        for b in self._owned[slot]:
            self.allocator.release(b, cache=b in self._indexed[slot])
        self._owned[slot] = []
        self._shared[slot] = []
        self._indexed[slot] = set()
        self._prompt[slot] = ()
        self._hit[slot] = 0
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

    def extend_phys_map(self, rows: Dict[int, Tuple[int, int]],
                        s_pad: int) -> np.ndarray:
        """(B, s_pad) flat physical targets for an extend group: slot ``i``
        with ``rows[i] = (offset, tail_len)`` lands its tokens at logical
        positions offset..offset+tail_len-1; padding -> trash.  Positions
        past the view (a speculative verify near ``max_len``) or on an
        unallocated (null) table entry also go to trash: the engine's
        clamp on the accepted count never emits such tokens."""
        out = np.empty((self.B, s_pad), np.int64)
        for i in range(self.B):
            out[i, :] = self.trash_row(i)
            off, n = rows.get(i, (0, 0))
            for t in range(min(n, s_pad)):
                p = off + t
                if p >= self.view_len \
                        or self.tables[i, p // self.block] == 0:
                    continue
                out[i, t] = self.phys(i, p)
        return out

    def cow_rows(self, slots: Sequence[int]):
        """(src, dst, keep) inputs of ``copy_block`` for the given slots'
        pending copy-on-write divergences ((B, block) each; rows with
        nothing to copy shuttle trash -> trash), or None."""
        Bk = self.block
        lane = np.arange(Bk, dtype=np.int64)
        src = np.empty((self.B, Bk), np.int64)
        dst = np.empty((self.B, Bk), np.int64)
        keep = np.zeros((self.B, Bk), bool)
        any_cow = False
        for i in range(self.B):
            src[i, :] = self.trash_row(i)
            dst[i, :] = self.trash_row(i)
            if i in slots and self._cow[i] is not None:
                cow_src, r = self._cow[i]
                dst_block = int(self.tables[i, len(self._shared[i])])
                src[i, :] = cow_src * Bk + lane
                dst[i, :] = dst_block * Bk + lane
                keep[i, :] = lane < r
                any_cow = True
        return (src, dst, keep) if any_cow else None

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
