"""Whisper-style encoder-decoder backbone, the audio family (port of
``repro/models/encdec.py``).

The mel-spectrogram + conv frontend is a stub (``models/frontend.py``):
the model consumes precomputed frame embeddings (B, n_frames, d_model).
From there everything runs: sinusoidal positions, a bidirectional encoder
of dense blocks (K2 with ``causal=False`` over every frame), and a causal
decoder whose blocks add a cross attention over the encoder's states
between their self attention and their MLP.  Every linear is the 3-D
linear (K1); whisper's norms are LayerNorm, PyTorch as the reference's
are jnp.

The decoder's cross attention takes its k/v from ``encoder_kv`` in
training and prefill, and in decode from the layer's cache leaves ``xk``
and ``xv`` (``registry._xdec_cache``), which it attends whole through K4
(``blocks.cross_decode``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..core.linear3d import plinear
from ..core.params import Param, stack_tree, unstack
from ..core.topology import Dirs, Layout
from .blocks import (apply_norm, attn_apply, attn_params, dense_block_apply,
                     dense_block_params, mlp_apply, norm_params)


def sin_positions(S: int, d: int, dtype=torch.bfloat16, device=None):
    """(S, d) sinusoidal positions: sin then cos of ``pos / 10000 **
    (2 i / d)``, computed in f32 (reference ``encdec.py:26-30``)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def cross_attn_params(cfg: ModelConfig, layout: Layout = None):
    """The cross attention's q/k/v/o: k and v consume encoder states."""
    return attn_params(cfg, layout)


def decoder_block_params(cfg: ModelConfig, layout: Layout = None):
    """A dense block plus ``ln_x`` and ``xattn`` (reference
    ``encdec.py:38-42``), with the specs of ``layout`` (None: one
    device)."""
    st = "3d" if layout is None else layout.strategy
    p = dense_block_params(cfg, layout=layout)
    p["ln_x"] = norm_params(cfg, cfg.d_model, st)
    p["xattn"] = cross_attn_params(cfg, layout)
    return p


def encoder_kv(layout: Layout, cfg: ModelConfig, dirs: Dirs, enc, p):
    """A layer's cross-attention k/v from the encoder's states (B, F, d):
    two (B, F, nkv, d_head) tensors, not roped (reference
    ``encdec.py:45-53``)."""
    dh = cfg.head_dim
    B, F = enc.shape[0], enc.shape[1]
    hx = layout.size(dirs.in_ax)
    kv_sf = cfg.n_kv % hx == 0 and cfg.n_kv >= hx
    k, _ = plinear(layout, dirs, enc, p["wk"], kind="first", shard_f=kv_sf)
    v, _ = plinear(layout, dirs, enc, p["wv"], kind="first", shard_f=kv_sf)
    return k.reshape(B, F, -1, dh), v.reshape(B, F, -1, dh)


def decoder_block_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p,
                        positions, enc_or_kv, *, decode=False, cache=None):
    """One decoder block (reference ``encdec.py:56-76``): causal self
    attention, cross attention, MLP.  ``enc_or_kv``: the encoder's states
    (train, prefill) or the cached (k, v) (decode).  Returns (x,
    new_cache), the self attention's cache."""
    h = apply_norm(cfg, x, p["ln1"])
    a, new_cache = attn_apply(layout, cfg, dirs, h, p["attn"], positions,
                              causal=True, decode=decode, cache=cache)
    x = x + a
    h = apply_norm(cfg, x, p["ln_x"])
    kv = enc_or_kv if decode else encoder_kv(layout, cfg, dirs, enc_or_kv,
                                             p["xattn"])
    a, _ = attn_apply(layout, cfg, dirs, h, p["xattn"], positions,
                      causal=False, decode=decode, kv_override=kv)
    x = x + a
    h = apply_norm(cfg, x, p["ln2"])
    x = x + mlp_apply(layout, cfg, dirs, h, p["mlp"], decode=decode)
    return x, new_cache


def encoder_params(cfg: ModelConfig, layout: Layout = None):
    """``blocks``: the encoder's dense blocks stacked (n_layers, ...);
    ``ln_post`` (reference ``encdec.py:79-85``), with the specs of
    ``layout`` (None: one device)."""
    st = "3d" if layout is None else layout.strategy
    return {"blocks": stack_tree(dense_block_params(cfg, layout=layout),
                                 cfg.encoder.n_layers),
            "ln_post": norm_params(cfg, cfg.d_model, st)}


def encoder_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, frames, p,
                  remat: bool = False):
    """frames (B, n_frames, d), the stub embeddings -> the encoder's states
    (reference ``encdec.py:87-103``): sinusoidal positions added in the
    frames' dtype, the blocks without a causal mask (each recomputed in
    the backward under ``remat``), then ``ln_post``."""
    B, S = frames.shape[0], frames.shape[1]
    x = frames + sin_positions(S, cfg.d_model, frames.dtype,
                               frames.device)[None]
    positions = torch.arange(S, device=frames.device).expand(B, S)

    def blk(x, bp):
        return dense_block_apply(layout, cfg, dirs, x, bp, positions,
                                 causal=False)[0]

    for bp in unstack(p["blocks"], cfg.encoder.n_layers):
        x = checkpoint(blk, x, bp, use_reentrant=False) if remat \
            else blk(x, bp)
    return apply_norm(cfg, x, p["ln_post"])


def cross_kv_cache_init(cfg: ModelConfig, batch: int):
    """Cached encoder k/v for decode, (n_layers, B, F, nkv, d_head) stacked
    per layer, zeros (reference ``encdec.py:106-115``)."""
    shape = (cfg.n_layers, batch, cfg.encoder.n_frames, cfg.n_kv,
             cfg.head_dim)
    return {"k": Param(shape, init="zeros"), "v": Param(shape, init="zeros")}
