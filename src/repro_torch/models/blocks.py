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
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..core import comm
from ..core.linear3d import layernorm, plinear, rmsnorm
from ..core.topology import Dirs, Layout
from ..kernels.flash_attention import flash_attention
from ..kernels.paged_decode import paged_flash_decode

F32 = torch.float32


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

    The pool is READ-ONLY here: the K4 kernel streams the already-written
    past through the block table and returns its softmax residuals; the
    current token's (k, v), not yet in the pool, is folded into the same
    online softmax afterwards.  The layer returns only its new entries; the
    engine writes every layer's entries back in one scatter
    (``kvcache.scatter_step``).

    q: (B, 1, nq, d); k_new/v_new: (B, 1, nkv, d); cache: this layer's pool
    slice {"k": (phys, nkv, d), "v": ..., "pos": (phys,)}; pos: (B,) int32.
    Returns (out, {"k": (B, nkv, d), "v": (B, nkv, d), "pos": (B,)})."""
    q0 = q[:, 0].contiguous()
    acc, m, l = paged_flash_decode(q0, cache["k"], cache["v"], cache["pos"],
                                   page.tables, pos, block=page.block,
                                   window=window, return_residuals=True)
    # fold the current token (always valid: age 0) into the softmax
    B, nq, d = q0.shape
    hloc = cache["k"].shape[1]
    g = nq // hloc
    scale = 1.0 / math.sqrt(d)
    qf = q0.to(F32).reshape(B, hloc, g, d)
    s0 = torch.einsum("bhgd,bhd->bhg", qf, k_new[:, 0].to(F32)) * scale
    s0 = s0.reshape(B, nq)
    m2 = torch.maximum(m, s0)
    wp, wc = torch.exp(m - m2), torch.exp(s0 - m2)
    dv = v_new.shape[-1]
    vb = v_new[:, 0, :, None].to(F32).expand(B, hloc, g, dv).reshape(B, nq, dv)
    o = acc * wp[..., None] + vb * wc[..., None]
    ls = l * wp + wc
    out = o / ls.clamp_min(1e-30)[..., None]
    return out[:, None].to(q.dtype), {"k": k_new[:, 0], "v": v_new[:, 0],
                                      "pos": pos}


# ---------------------------------------------------------------------------
# Dense attention + MLP block
# ---------------------------------------------------------------------------
def _act_fn(name: str):
    if name == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")   # gelu, gelu_mlp


def attn_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p, positions,
               *, causal=True, window=0, decode=False, cache=None,
               return_kv=False, page=None):
    """Self-attention sub-block.  Returns (out, new_cache): the layer's new
    decode entries, or the rope'd (k, v) of a prefill when ``return_kv``."""
    dh = cfg.head_dim
    hx = layout.size(dirs.in_ax)
    kv_sf = cfg.n_kv % hx == 0 and cfg.n_kv >= hx
    B, S = x.shape[0], x.shape[1]

    q, d2 = plinear(layout, dirs, x, p["wq"], kind="first", decode=decode)
    k, _ = plinear(layout, dirs, x, p["wk"], kind="first", shard_f=kv_sf,
                   decode=decode)
    v, _ = plinear(layout, dirs, x, p["wv"], kind="first", shard_f=kv_sf,
                   decode=decode)
    q = q.reshape(B, S, -1, dh)
    k = k.reshape(B, S, -1, dh)
    v = v.reshape(B, S, -1, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if cfg.rope_base:
        q = apply_rope(q, positions, cfg.rope_base)
        k = apply_rope(k, positions, cfg.rope_base)

    new_cache = None
    if decode:
        if page is None:
            raise ValueError("decode runs against the paged pool only: pass "
                             "page=PageInfo(...)")
        pvec = positions[:, 0] if positions.dim() > 1 else positions
        out, new_cache = attention_decode_paged(
            layout, cfg, dirs, q, k, v, cache, pvec.contiguous(), page,
            window=window)
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
