"""Attention + MLP blocks of the dense family (port of
``repro/models/blocks.py``), written over the linears of
``core/linear3d.py``.

Layouts inside a block (3-D strategy, entry dirs (in_ax=y, out_ax=z)):

    x          (B, S, H)      split (batch, y, z)
    q/k/v      (B, S, n, d)   split (batch, z, y, -)   after the qkv linear
    out proj                  back to (batch, y, z)

Every block holds an even number of 3-D linears, so the direction state is
restored at block exit (paper §3.2).  At the 2-D baseline x is split
(batch, y, z) and q/k/v (batch, y, z, -); at the 1-D one x is whole and
q/k/v's heads split over z (``linear3d.act_axes``, ``out_axes``).
Tensors are each rank's local shards; the collectives go through
``core/comm.py``.  Training and prefill (``attention``) run on any
layout of the three strategies; the decode and extend paths, and the
other families' blocks, on one device.

Five attention paths: ``attention`` (prefill and training, K2; the
encoder's and the cross attention's non-causal form too),
``attention_decode_paged`` (one token against the paged pool, K4),
``attention_decode`` (one token against a contiguous per-slot cache, also
K4: the cache is K4's pool laid out flat under the identity block table),
``cross_decode`` (one token against the audio decoder's static encoder
k/v, K4 the same way) and ``attention_extend`` (fresh tokens continuing
past a cache view, plain PyTorch as the reference's is jnp outside any
kernel).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..core import comm
from ..core.linear3d import (act_axes, layernorm, norm_param, out_axes,
                             plinear, rmsnorm, weight_param)
from ..core.params import Param
from ..core.topology import Dirs, Layout, entry_dirs
from ..kernels.flash_attention import flash_attention
from ..kernels.paged_decode import (paged_flash_decode,
                                    paged_flash_decode_step)

F32 = torch.float32
NEG_INF = -1e30


def norm_params(cfg: ModelConfig, d: int, strategy: str = "3d"):
    """A norm at the block's entry, split like its hidden dim (reference
    ``blocks.py:make_norm_params``)."""
    p = {"g": norm_param(entry_dirs(), d, strategy=strategy)}
    if cfg.norm == "layernorm":
        p["b"] = norm_param(entry_dirs(), d, init="zeros", strategy=strategy)
    return p


def kv_sharded(layout: Layout, cfg: ModelConfig, dirs: Dirs) -> bool:
    """True when the kv heads split over the head axis (``out_axes``: in_ax
    after a 3-D qkv linear, 'z' at 1d and 2d); else they are replicated
    over it (reference ``blocks.py:144``; gemma-2b's one kv head)."""
    hx = layout.size(out_axes(layout, dirs)[1])
    return cfg.n_kv % hx == 0 and cfg.n_kv >= hx


def attn_params(cfg: ModelConfig, layout: Layout = None):
    """One attention sub-block with the reference's specs (reference
    ``blocks.py:578-591``) for ``layout``'s strategy (None: one device):
    wk and wv keep their features whole where the kv heads are replicated
    over the head axis."""
    d, nh, nkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    dirs = entry_dirs()
    st = "3d" if layout is None else layout.strategy
    kv_sf = layout is None or kv_sharded(layout, cfg, dirs)
    attn = {"wq": weight_param(dirs, d, nh * dh, strategy=st),
            "wk": weight_param(dirs, d, nkv * dh, shard_f=kv_sf, strategy=st),
            "wv": weight_param(dirs, d, nkv * dh, shard_f=kv_sf, strategy=st),
            "wo": weight_param(dirs.swap(), nh * dh, d, kind="second",
                               strategy=st)}
    if cfg.qk_norm:
        attn["q_norm"] = Param((dh,), init="ones", spec=(None,))
        attn["k_norm"] = Param((dh,), init="ones", spec=(None,))
    return attn


def mlp_params(cfg: ModelConfig, d_ff: int = 0, strategy: str = "3d"):
    """One MLP of width ``d_ff or cfg.d_ff`` (reference
    ``blocks.py:594-600``)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dirs = entry_dirs()
    mlp = {"w_up": weight_param(dirs, d, f, strategy=strategy),
           "w_down": weight_param(dirs.swap(), f, d, kind="second",
                                  strategy=strategy)}
    if cfg.act in ("silu", "gelu"):
        mlp["w_gate"] = weight_param(dirs, d, f, strategy=strategy)
    return mlp


def dense_block_params(cfg: ModelConfig, d_ff: int = 0,
                       layout: Layout = None):
    """One dense attention + MLP block (reference
    ``blocks.py:dense_block_params``); ``d_ff`` overrides the MLP's width,
    as the MoE family's leading dense layers take ``moe.dense_ff``
    (reference ``registry.py:281-283``).  ``layout`` sets the specs by its
    strategy and the kv projections' (None: one device)."""
    d = cfg.d_model
    st = "3d" if layout is None else layout.strategy
    return {"ln1": norm_params(cfg, d, st), "attn": attn_params(cfg, layout),
            "ln2": norm_params(cfg, d, st), "mlp": mlp_params(cfg, d_ff, st)}


def kv_cache_init(cfg: ModelConfig, batch: int, length: int):
    """Abstract contiguous KV cache of one layer (reference
    ``blocks.py:kv_cache_init``; length = the window for sliding-window
    configs): positions start at -1, every entry invalid."""
    nkv, dh = cfg.n_kv, cfg.head_dim
    return {"k": Param((batch, length, nkv, dh), init="zeros"),
            "v": Param((batch, length, nkv, dh), init="zeros"),
            "pos": Param((batch, length), init="neg_ones",
                         dtype=torch.int32)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(dh: int, base: float, device) -> torch.Tensor:
    return base ** (-torch.arange(0, dh, 2, dtype=F32, device=device) / dh)


def apply_rope(x, positions, base: float):
    """x: (..., S, n, d); positions broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], base, x.device)     # (d/2,)
    ang = positions[..., None].to(F32) * freqs          # (..., S, d/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention islands
# ---------------------------------------------------------------------------
def gather_axes(layout: Layout, dirs: Dirs):
    """The axes that split the post-qkv sequence, which the attention
    island gathers k/v over: ``seq_axes`` then the sequence axis of
    ``out_axes`` (3d out_ax, 2d 'y', 1d none), those above size 1
    (reference ``blocks.py:_gather_axes``)."""
    return layout.live((*layout.seq_axes, out_axes(layout, dirs)[0]))


def seq_offset(layout: Layout, dirs: Dirs, s: int) -> int:
    """The global position of the first of this rank's s post-qkv rows:
    the mixed-radix index over ``gather_axes`` times s (reference
    ``blocks.py:146-156``)."""
    return comm.axis_index(layout, gather_axes(layout, dirs)) * s


def local_positions(layout: Layout, dirs: Dirs, positions, s: int):
    """The columns of the global ``positions`` (B, S) that this rank's s
    post-qkv rows hold."""
    if not gather_axes(layout, dirs):
        return positions
    off = seq_offset(layout, dirs, s)
    return positions[:, off:off + s]


def attention(layout: Layout, cfg: ModelConfig, dirs: Dirs, q, k, v,
              *, causal=True, window=0):
    """Prefill and training attention island (reference
    ``blocks.py:131-195``).  q/k/v: (B, S, n, d) in the post-qkv layout,
    sequence split over ``gather_axes``, heads over the head axis of
    ``out_axes`` (3d in_ax, 1d and 2d 'z').  The island
    all-gathers k/v along the sequence split (its backward
    reduce-scatters their gradients) and runs K2
    (``kernels/flash_attention.py``), whose backward is a kernel too, on
    the rank's q rows at their global positions.  Where the kv heads are
    replicated over the head axis, each rank slices the kv groups its q
    heads read."""
    gax = gather_axes(layout, dirs)
    hax = out_axes(layout, dirs)[1]
    hx = layout.size(hax)
    sliced = hx > 1 and not kv_sharded(layout, cfg, dirs)
    if sliced:
        # replicated over the head axis, each rank reading its own kv
        # groups: their gradients sum there, before the wk/wv transpose,
        # as the reference's shard_map sums a replicated input's
        k = comm.grad_psum(layout, k, hax)
        v = comm.grad_psum(layout, v, hax)
    k = comm.all_gather_ad(layout, k, gax, dim=1)
    v = comm.all_gather_ad(layout, v, gax, dim=1)
    if sliced:
        group = cfg.n_heads // cfg.n_kv
        nloc = cfg.n_heads // hx
        kv0 = (comm.axis_index(layout, hax) * nloc) // group
        nkv_loc = max(1, nloc // group)
        k = k[:, :, kv0:kv0 + nkv_loc]
        v = v[:, :, kv0:kv0 + nkv_loc]
    b, sq = q.shape[0], q.shape[1]
    i32 = torch.int32
    q_pos = (seq_offset(layout, dirs, sq)
             + torch.arange(sq, device=q.device, dtype=i32)) \
        .expand(b, sq).contiguous()
    k_pos = torch.arange(k.shape[1], device=q.device, dtype=i32)
    out, _ = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             q_pos, k_pos, causal=causal, window=window)
    return out


class PageInfo(NamedTuple):
    """Decode-time paged-cache routing, threaded from the serving engine
    through ``transformer.forward(page=...)`` into the attention blocks."""
    tables: torch.Tensor       # (B, nb) int32 physical block id per view block
    active: torch.Tensor       # (B,) bool: inactive lanes write to trash
    block: int                 # block size


def attention_decode_paged(layout: Layout, cfg: ModelConfig, dirs: Dirs,
                           q, k_new, v_new, cache, pos, page: PageInfo,
                           *, window=0):
    """One-token decode straight against the paged KV pool (reference
    ``blocks.py:236-345``).

    The pool is READ-ONLY here: K4 (``paged_flash_decode_step``) streams
    the already-written past through the block table and folds the current
    token's (k, v), not yet in the pool, into the same online softmax (on
    the card in its combine pass).  The layer returns only its new entries;
    the engine writes every layer's entries back in one scatter
    (``kvcache.scatter_step``).

    q: (B, 1, nq, d); k_new/v_new: (B, 1, nkv, d); cache: this layer's pool
    slice {"k": (phys, nkv, d), "v": ..., "pos": (phys,)}; pos: (B,) int32.
    Returns (out, {"k": (B, nkv, d), "v": (B, nkv, d), "pos": (B,)})."""
    out = paged_flash_decode_step(
        q[:, 0].contiguous(), k_new[:, 0].contiguous(),
        v_new[:, 0].contiguous(), cache["k"], cache["v"], cache["pos"],
        page.tables, pos, block=page.block, window=window)
    return out[:, None], {"k": k_new[:, 0], "v": v_new[:, 0], "pos": pos}


def contiguous_block(length: int) -> int:
    """The K4 block that tiles a contiguous cache of ``length`` entries:
    16 (the serving pool's block) where it divides, else the largest power
    of two below it that does.  ``paged_decode.route`` takes the split
    route from 8 up."""
    return next(b for b in (16, 8, 4, 2, 1) if length % b == 0)


def attention_decode(layout: Layout, cfg: ModelConfig, dirs: Dirs,
                     q, k_new, v_new, cache, pos, *, window=0):
    """One-token decode against a contiguous per-slot cache (reference
    ``blocks.py:439-525`` at one device): write (k_new, v_new, pos) at
    slot ``pos % L``, then attend every entry with ``0 <= cpos <= pos``
    within the window.

    The write comes first, so that a ring slot being overwritten is never
    attended at its old position.  The cache (B, L, nkv, d) is then K4's
    pool laid out flat, (B * L, nkv, d), under the identity block table
    ``arange(B * L / blk).view(B, L / blk)``: no data moves, and
    ``paged_flash_decode`` with ``cur = pos`` computes exactly the
    reference's masked f32 softmax.

    q: (B, 1, nq, d); k_new/v_new: (B, 1, nkv, d); cache: {"k", "v":
    (B, L, nkv, d), "pos": (B, L) int32}, written in place; pos: (B,)
    int32.  Returns (out (B, 1, nq, d), cache)."""
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    b, L = cpos.shape
    rows = torch.arange(b, device=q.device)
    slot = (pos % L).long()
    ck[rows, slot] = k_new[:, 0].to(ck.dtype)
    cv[rows, slot] = v_new[:, 0].to(cv.dtype)
    cpos[rows, slot] = pos.to(cpos.dtype)
    blk = contiguous_block(L)
    tables = torch.arange(b * L // blk, dtype=torch.int32,
                          device=q.device).view(b, L // blk)
    out = paged_flash_decode(
        q[:, 0].contiguous(), ck.view(b * L, *ck.shape[2:]),
        cv.view(b * L, *cv.shape[2:]), cpos.view(b * L), tables,
        pos.to(torch.int32).contiguous(), block=blk, window=window)
    return out[:, None], cache


def cross_decode(layout: Layout, cfg: ModelConfig, dirs: Dirs, q, k, v):
    """Decode-time cross attention (reference ``blocks.py:664-693`` at one
    device): q (B, 1, nq, d) against the static encoder k/v (B, F, nkv, d),
    one unmasked f32 softmax over every frame.

    K4 computes it over the k/v laid out flat as a pool, (B * F, nkv, d),
    under the identity block table, as ``attention_decode`` reads a
    contiguous cache: the positions are the constant ``arange(F)`` of each
    row and ``cur = F - 1``, so every frame is valid and nothing is folded
    in.  The positions are built here, not kept in the cache, whose tree
    keeps the reference's leaves."""
    b, F = k.shape[0], k.shape[1]
    blk = contiguous_block(F)
    i32 = torch.int32
    tables = torch.arange(b * F // blk, dtype=i32,
                          device=q.device).view(b, F // blk)
    pos = torch.arange(F, dtype=i32, device=q.device).repeat(b)
    cur = torch.full((b,), F - 1, dtype=i32, device=q.device)
    out = paged_flash_decode(q[:, 0].contiguous(),
                             k.reshape(b * F, *k.shape[2:]),
                             v.reshape(b * F, *v.shape[2:]), pos, tables,
                             cur, block=blk)
    return out[:, None]


def attention_extend(layout: Layout, cfg: ModelConfig, dirs: Dirs,
                     q, k_new, v_new, cache, positions, *, window=0):
    """Multi-token continuation (reference ``blocks.py:348-436`` at one
    device): ``S`` fresh tokens per row at ``positions`` (B, S), -1 on
    padding, attend the cache entries with ``cpos < positions[:, 0]`` and
    each other causally by position, in one f32 softmax.  Nothing is
    written; the engine scatters the returned (k, v) itself.

    q/k_new/v_new: (B, S, n, d) rope'd; cache: one layer's view {"k", "v":
    (B, L, nkv, d), "pos": (B, L)}.  Returns (B, S, nq, d) in q's dtype."""
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    b, sq, nq, d = q.shape
    nkv = ck.shape[2]
    qf = (q.to(F32) * (1.0 / math.sqrt(d))).reshape(b, sq, nkv, nq // nkv, d)
    ka = torch.cat([ck.to(F32), k_new.to(F32)], dim=1)
    va = torch.cat([cv.to(F32), v_new.to(F32)], dim=1)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, ka)
    qpos = positions
    live = (qpos >= 0)[:, :, None]
    mc = ((cpos >= 0)[:, None, :] & (cpos[:, None, :] < qpos[:, :1, None])
          & live)
    ms = ((qpos >= 0)[:, None, :] & (qpos[:, None, :] <= qpos[:, :, None])
          & live)
    if window:
        mc = mc & (qpos[:, :, None] - cpos[:, None, :] < window)
        ms = ms & (qpos[:, :, None] - qpos[:, None, :] < window)
    mask = torch.cat([mc, ms], dim=2)
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, va)
    out = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, sq, nq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Dense attention + MLP block
# ---------------------------------------------------------------------------
def _act_fn(name: str):
    if name == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")   # gelu, gelu_mlp


def attn_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p, positions,
               *, causal=True, window=0, decode=False, cache=None,
               kv_override=None, return_kv=False, page=None):
    """Self (or cross) attention sub-block.  Returns (out, new_cache): with
    ``decode`` the layer's new entries (paged, ``page`` given) or its
    written cache (contiguous); else the rope'd (k, v) when ``return_kv``.
    A prefill with a ``cache`` view is an extend.

    ``kv_override`` (k, v) makes it a cross attention over those (the
    encoder's states' k/v, reference ``blocks.py:603-662``), with the
    reference's quirks: q is roped and qk-normed, the given k is neither;
    a decode attends it whole (``cross_decode``), else it runs K2 with
    ``causal``."""
    dh = cfg.head_dim
    kv_sf = kv_sharded(layout, cfg, dirs)
    if cfg.qk_norm and not kv_sf:
        # k_norm's gradient would come out whole on every head-axis rank
        # and the leaf sync would count it once a rank; no config of the
        # registry has qk-norm with kv heads replicated over that axis
        raise NotImplementedError(
            f"{cfg.arch}: qk-norm with kv heads replicated over the head "
            "axis above one device (ROADMAP.md, Queue 1 item 3)")
    hx = layout.size(out_axes(layout, dirs)[1])
    if cfg.n_heads % hx:
        # a rank would hold part of a head (gemma-2b's 8 heads over the
        # production 1-D layout's 16)
        raise NotImplementedError(
            f"{cfg.arch}: {cfg.n_heads} query heads do not split over a "
            f"head axis of {hx} devices (ROADMAP.md, Queue 1 item 3)")

    q, d2 = plinear(layout, dirs, x, p["wq"], kind="first", decode=decode)
    B, S = q.shape[0], q.shape[1]            # the post-qkv local rows
    q = q.reshape(B, S, -1, dh)
    if kv_override is None:
        k, _ = plinear(layout, dirs, x, p["wk"], kind="first", shard_f=kv_sf,
                       decode=decode)
        v, _ = plinear(layout, dirs, x, p["wv"], kind="first", shard_f=kv_sf,
                       decode=decode)
        k = k.reshape(B, S, -1, dh)
        v = v.reshape(B, S, -1, dh)
    else:
        k, v = kv_override
    if not decode:
        positions = local_positions(layout, dirs, positions, S)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        if kv_override is None:
            k = rmsnorm(k, p["k_norm"])
    if cfg.rope_base:
        q = apply_rope(q, positions, cfg.rope_base)
        if kv_override is None:
            k = apply_rope(k, positions, cfg.rope_base)

    new_cache = None
    if decode and kv_override is not None:
        out = cross_decode(layout, cfg, dirs, q, k, v)
    elif decode:
        pvec = (positions[:, 0] if positions.dim() > 1 else positions)
        pvec = pvec.to(torch.int32).contiguous()
        if page is not None:
            out, new_cache = attention_decode_paged(
                layout, cfg, dirs, q, k, v, cache, pvec, page, window=window)
        else:
            out, new_cache = attention_decode(layout, cfg, dirs, q, k, v,
                                              cache, pvec, window=window)
    elif cache is not None and kv_override is None:
        out = attention_extend(layout, cfg, dirs, q, k, v, cache, positions,
                               window=window)
        if return_kv:
            new_cache = (k, v)
    else:
        out = attention(layout, cfg, dirs, q, k, v, causal=causal,
                        window=window)
        if return_kv:
            new_cache = (k, v)
    y, _ = plinear(layout, d2, out.reshape(B, S, -1), p["wo"], kind="second",
                   decode=decode)
    return y, new_cache


def mlp_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p,
              decode=False):
    act = _act_fn(cfg.act)
    up, d2 = plinear(layout, dirs, x, p["w_up"], kind="first", decode=decode)
    if "w_gate" in p:
        gate, _ = plinear(layout, dirs, x, p["w_gate"], kind="first",
                          decode=decode)
        h = act(gate.to(F32)) * up.to(F32)
    else:
        h = act(up.to(F32))
    y, _ = plinear(layout, d2, h.to(x.dtype), p["w_down"], kind="second",
                   decode=decode)
    return y


def apply_norm(cfg: ModelConfig, x, p, layout: Layout = None,
               dirs: Dirs = None):
    """The config's norm over the hidden dim, which the hidden axis of
    ``act_axes`` splits where ``dirs`` is given (3d out_ax, 2d 'z': the
    norm then runs in two phases; 1d none: whole rows)."""
    ax = None if dirs is None else act_axes(layout, dirs)[1]
    if cfg.norm == "layernorm":
        return layernorm(x, p["g"], p["b"], layout=layout, axis=ax)
    return rmsnorm(x, p["g"], zero_centered=cfg.zero_centered_norm,
                   layout=layout, axis=ax)


def dense_block_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p,
                      positions, *, decode=False, cache=None, window=None,
                      causal=True, return_kv=False, page=None):
    w = cfg.window if window is None else window
    h = apply_norm(cfg, x, p["ln1"], layout, dirs)
    a, new_cache = attn_apply(layout, cfg, dirs, h, p["attn"], positions,
                              window=w, decode=decode, cache=cache,
                              causal=causal, return_kv=return_kv, page=page)
    x = x + a
    h = apply_norm(cfg, x, p["ln2"], layout, dirs)
    x = x + mlp_apply(layout, cfg, dirs, h, p["mlp"], decode=decode)
    return x, new_cache
