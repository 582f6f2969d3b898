"""Attention + MLP blocks of the dense family (port of
``repro/models/blocks.py``), written over the 3-D linears of
``core/linear3d.py``.

Layouts inside a block (entry dirs (in_ax=y, out_ax=z)):

    x          (B, S, H)      split (batch, y, z)
    q/k/v      (B, S, n, d)   split (batch, z, y, -)   after the qkv linear
    out proj                  back to (batch, y, z)

Every block holds an even number of 3-D linears, so the direction state is
restored at block exit (paper §3.2).  The attention islands are written for
one device: their collectives go through ``core/comm.py``, which raises
above axis size 1.

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
from ..core.linear3d import layernorm, plinear, rmsnorm
from ..core.params import Param
from ..core.topology import Dirs, Layout
from ..kernels.flash_attention import flash_attention
from ..kernels.paged_decode import (paged_flash_decode,
                                    paged_flash_decode_step)

F32 = torch.float32
NEG_INF = -1e30


def norm_params(cfg: ModelConfig, d: int):
    p = {"g": Param((d,), init="ones")}
    if cfg.norm == "layernorm":
        p["b"] = Param((d,), init="zeros")
    return p


def attn_params(cfg: ModelConfig):
    """One attention sub-block (reference ``blocks.py:attn_params``)."""
    d, nh, nkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    attn = {"wq": Param((d, nh * dh)), "wk": Param((d, nkv * dh)),
            "wv": Param((d, nkv * dh)), "wo": Param((nh * dh, d))}
    if cfg.qk_norm:
        attn["q_norm"] = Param((dh,), init="ones")
        attn["k_norm"] = Param((dh,), init="ones")
    return attn


def mlp_params(cfg: ModelConfig, d_ff: int = 0):
    """One MLP of width ``d_ff or cfg.d_ff`` (reference
    ``blocks.py:594-600``)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    mlp = {"w_up": Param((d, f)), "w_down": Param((f, d))}
    if cfg.act in ("silu", "gelu"):
        mlp["w_gate"] = Param((d, f))
    return mlp


def dense_block_params(cfg: ModelConfig, d_ff: int = 0):
    """One dense attention + MLP block (reference
    ``blocks.py:dense_block_params``); ``d_ff`` overrides the MLP's width,
    as the MoE family's leading dense layers take ``moe.dense_ff``
    (reference ``registry.py:281-283``)."""
    d = cfg.d_model
    return {"ln1": norm_params(cfg, d), "attn": attn_params(cfg),
            "ln2": norm_params(cfg, d), "mlp": mlp_params(cfg, d_ff)}


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
def attention(layout: Layout, cfg: ModelConfig, dirs: Dirs, q, k, v,
              *, causal=True, window=0):
    """Prefill and training attention island (reference
    ``blocks.py:131-195``).  q/k/v: (B, S, n, d) in the post-qkv layout,
    sequence split over out_ax.  The island all-gathers k/v along the
    sequence split and runs K2 (``kernels/flash_attention.py``), whose
    backward is a kernel too."""
    seq_ax = dirs.out_ax
    k = comm.all_gather(layout, k, seq_ax, dim=1)
    v = comm.all_gather(layout, v, seq_ax, dim=1)
    b, sq = q.shape[0], q.shape[1]
    off = comm.axis_index(layout, seq_ax)
    i32 = torch.int32
    q_pos = (off * sq + torch.arange(sq, device=q.device, dtype=i32)) \
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
    hx = layout.size(dirs.in_ax)
    kv_sf = cfg.n_kv % hx == 0 and cfg.n_kv >= hx
    B, S = x.shape[0], x.shape[1]

    q, d2 = plinear(layout, dirs, x, p["wq"], kind="first", decode=decode)
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


def apply_norm(cfg: ModelConfig, x, p):
    if cfg.norm == "layernorm":
        return layernorm(x, p["g"], p["b"])
    return rmsnorm(x, p["g"], zero_centered=cfg.zero_centered_norm)


def dense_block_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p,
                      positions, *, decode=False, cache=None, window=None,
                      causal=True, return_kv=False, page=None):
    w = cfg.window if window is None else window
    h = apply_norm(cfg, x, p["ln1"])
    a, new_cache = attn_apply(layout, cfg, dirs, h, p["attn"], positions,
                              window=w, decode=decode, cache=cache,
                              causal=causal, return_kv=return_kv, page=page)
    x = x + a
    h = apply_norm(cfg, x, p["ln2"])
    x = x + mlp_apply(layout, cfg, dirs, h, p["mlp"], decode=decode)
    return x, new_cache
