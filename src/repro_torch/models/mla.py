"""DeepSeek-V3's Multi-head Latent Attention (port of
``repro/models/mla.py``) at one device, the 3-D branch.

The low-rank structure maps onto the cube as two chained linears: the
*down* projections (``w_dq`` 7168 -> 1536, ``w_dkv`` 7168 -> 512 + 64 at
full width) run ``ops3d.matmul3d_noswap``, the *up* projections (``w_uq``
1536 -> 128 x 192, ``w_ukv`` 512 -> 128 x 256) ``ops3d.matmul3d_repc``;
their local products are K1, ``q_ln`` and ``kv_ln`` are K3.

Training and prefill materialise k = (k_nope, k_rope broadcast over the
heads) at 192 and v at 128 and run K2 at that pair (the ``simt`` route,
``kernels/flash_attention.py``).  Decode keeps only the compressed latent
stream, ``c_kv`` (512) and the rope'd ``k_rope`` (64), and absorbs
``w_uk`` into the query and ``w_uv`` into the output (the reference's f32
einsums, outside any kernel there and here).  The latent cache is then MQA
with one kv head: q = (q_nope w_uk, q_rope) 576 wide in f32, k = (c_kv,
k_rope) 576 wide, v = c_kv 512 wide, a group of all the heads.  Both
decodes run K4 on that shape:

- ``_mla_decode_paged`` (the fused serving decode) reads the read-only
  pool through the block tables, K4 returns its f32 residuals, and the
  current latent token is folded in afterwards (``fold_current_token``),
  as the reference does (``mla.py:247-340``);
- ``_mla_decode`` (the contiguous cache: the gather-view decode) writes the
  new entry first, then runs K4 over the cache laid out flat under the
  identity block table.  The reference masks entries by ``0 <= cpos <=
  pos`` and by slot ``<= pos`` (a cache from ``mla_cache_init`` holds
  position 0 in its unwritten slots); the second mask is folded into the
  positions K4 reads (-1 where the slot is not yet written), so K4's
  position mask expresses both.

K4 concatenates nothing itself: the (c_kv, k_rope) pool it reads as k is
one ``torch.cat`` per layer and step, as in the reference.
"""
from __future__ import annotations

import math

import torch

from ..config import ModelConfig
from ..core import ops3d
from ..core.linear3d import plinear, rmsnorm, weight_param
from ..core.params import Param
from ..core.topology import Dirs, Layout, entry_dirs
from ..kernels.paged_decode import fold_current_token, paged_flash_decode
from . import blocks as B

F32 = torch.float32


def _m(cfg: ModelConfig):
    m = cfg.mla
    return m, cfg.n_heads, m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim


def mla_params(cfg: ModelConfig, layout: Layout = None):
    """One MLA sub-block (reference ``mla.py:40-62``) with the specs of
    ``layout``'s strategy (None: one device): the down projections' rows
    over out_ax (3d), 'z' (2d) or whole (1d); the up projections' columns
    over (in_ax, 'x') (3d) or 'z'; ``w_o`` the paper's second linear."""
    m, nh, dn, dr, dv = _m(cfg)
    d = cfg.d_model
    dirs = entry_dirs()
    st = "3d" if layout is None else layout.strategy
    down_ax, up_ax = {"3d": (dirs.out_ax, (dirs.in_ax, "x")),
                      "2d": ("z", "z"), "1d": (None, "z")}[st]
    return {
        "w_dq": Param((d, m.q_lora_rank), spec=(down_ax, None)),
        "q_ln": Param((m.q_lora_rank,), init="ones", spec=(None,)),
        "w_uq": Param((m.q_lora_rank, nh * (dn + dr)), spec=(None, up_ax)),
        "w_dkv": Param((d, m.kv_lora_rank + dr), spec=(down_ax, None)),
        "kv_ln": Param((m.kv_lora_rank,), init="ones", spec=(None,)),
        "w_ukv": Param((m.kv_lora_rank, nh * (dn + dv)),
                       spec=(None, up_ax)),
        "w_o": weight_param(dirs.swap(), nh * dv, d, kind="second",
                            strategy=st),
    }


def _down(layout: Layout, dirs: Dirs, x, w, decode: bool):
    if decode:
        return ops3d.matmul3d_decode(layout, dirs.in_ax, dirs.out_ax, x, w,
                                     shard_f=False)
    return ops3d.matmul3d_noswap(layout, dirs.in_ax, dirs.out_ax, x, w)


def _up(layout: Layout, dirs: Dirs, x, w, decode: bool):
    if decode:
        return ops3d.matmul3d_repc_decode(layout, dirs.in_ax, dirs.out_ax, x,
                                          w)
    return ops3d.matmul3d_repc(layout, dirs.in_ax, dirs.out_ax, x, w)


def mla_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p, positions,
              *, decode=False, cache=None, collect_kv=False, page=None):
    """x in block entry layout; returns (out, new_cache) (reference
    ``mla.py:85-146``).  ``new_cache``: with ``decode`` and ``page`` the
    step's latent entries {"c_kv", "k_rope", "pos"}; with ``decode`` alone
    the contiguous cache, written in place; else ``(c_kv, k_rope)`` when
    ``collect_kv`` (post-norm, post-rope: what decode caches)."""
    m, nh, dn, dr, dv = _m(cfg)
    b, s = x.shape[0], x.shape[1]

    # ---- q path ----
    qc = rmsnorm(_down(layout, dirs, x, p["w_dq"], decode), p["q_ln"])
    q = _up(layout, dirs, qc, p["w_uq"], decode).reshape(b, s, -1, dn + dr)
    q_nope = q[..., :dn]
    q_rope = B.apply_rope(q[..., dn:], positions, cfg.rope_base)

    # ---- kv path ----
    ckr = _down(layout, dirs, x, p["w_dkv"], decode)
    c_kv = rmsnorm(ckr[..., :m.kv_lora_rank], p["kv_ln"])
    k_rope = B.apply_rope(ckr[..., None, m.kv_lora_rank:], positions,
                          cfg.rope_base)[:, :, 0]

    if decode:
        pvec = positions[:, 0] if positions.dim() > 1 else positions
        pvec = pvec.to(torch.int32).contiguous()
        if page is not None:
            out, new_cache = _mla_decode_paged(cfg, q_nope, q_rope, c_kv,
                                               k_rope, p["w_ukv"], cache,
                                               pvec, page)
        else:
            out, new_cache = _mla_decode(cfg, q_nope, q_rope, c_kv, k_rope,
                                         p["w_ukv"], cache, pvec)
        out = out.reshape(b, s, -1)
    else:
        kv = _up(layout, dirs, c_kv, p["w_ukv"], decode)
        kv = kv.reshape(b, s, -1, dn + dv)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            *k_nope.shape[:3], dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        # materialised: every head has its own k and v (nkv = nh)
        out = B.attention(layout, cfg, dirs, q_full, k, v, causal=True)
        out = out.reshape(b, s, -1)
        new_cache = (c_kv, k_rope) if collect_kv else None

    y, _ = plinear(layout, dirs.swap(), out, p["w_o"], kind="second",
                   decode=decode)
    return y, new_cache


def mla_cache_init(cfg: ModelConfig, batch: int, length: int):
    """One layer's contiguous latent cache (reference ``mla.py:154-167``):
    positions start at 0, as there; ``_mla_decode`` masks the slots not yet
    written."""
    m = cfg.mla
    return {"c_kv": Param((batch, length, m.kv_lora_rank), init="zeros"),
            "k_rope": Param((batch, length, m.qk_rope_dim), init="zeros"),
            "pos": Param((batch, length), init="zeros", dtype=torch.int32)}


def _absorbed_q(cfg: ModelConfig, q_nope, q_rope, w_ukv):
    """(q (B, nh, R + dr) f32, w_uv (R, nh, dv) f32): the query with
    ``w_uk`` absorbed, beside its rope part, and the value up projection
    (reference ``mla.py:207-213``)."""
    m, nh, dn, dr, dv = _m(cfg)
    wk = w_ukv.float().reshape(m.kv_lora_rank, -1, dn + dv)
    qc = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), wk[..., :dn])
    q_cat = torch.cat([qc, q_rope[:, 0].float()], dim=-1).contiguous()
    return q_cat, wk[..., dn:]


def _mla_decode(cfg: ModelConfig, q_nope, q_rope, ckv_new, kr_new, w_ukv,
                cache, pos):
    """Absorbed-weight decode over the contiguous latent cache (reference
    ``mla.py:170-244`` at one device) through K4 under the identity table
    (module docstring).  cache: {"c_kv": (B, L, R), "k_rope": (B, L, dr),
    "pos": (B, L)}, written in place; pos (B,) int32."""
    m, nh, dn, dr, dv = _m(cfg)
    cc, ckr, cpos = cache["c_kv"], cache["k_rope"], cache["pos"]
    b, L = cpos.shape
    rows = torch.arange(b, device=cpos.device)
    slot = (pos % L).long()
    cc[rows, slot] = ckv_new[:, 0].to(cc.dtype)
    ckr[rows, slot] = kr_new[:, 0].to(ckr.dtype)
    cpos[rows, slot] = pos.to(cpos.dtype)
    q_cat, w_uv = _absorbed_q(cfg, q_nope, q_rope, w_ukv)
    written = torch.arange(L, device=cpos.device)[None, :] <= pos[:, None]
    kpos = torch.where(written, cpos, -1).to(torch.int32).reshape(b * L)
    blk = B.contiguous_block(L)
    tables = torch.arange(b * L // blk, dtype=torch.int32,
                          device=cpos.device).view(b, L // blk)
    k_pool = torch.cat([cc, ckr], dim=-1).reshape(b * L, 1, -1)
    oc = paged_flash_decode(q_cat, k_pool, cc.reshape(b * L, 1, -1), kpos,
                            tables, pos, block=blk,
                            scale=1.0 / math.sqrt(dn + dr))
    o = torch.einsum("bhr,rhd->bhd", oc, w_uv)
    return o[:, None].to(q_nope.dtype), cache


def _mla_decode_paged(cfg: ModelConfig, q_nope, q_rope, ckv_new, kr_new,
                      w_ukv, cache, pos, page):
    """Absorbed-weight decode straight against the paged latent pool
    (reference ``mla.py:247-340`` at one device): K4 over the read-only
    pool (q f32, the pools in the cache's dtype) with f32 residuals, then
    the current latent token folded in.  cache: this layer's pool slice
    {"c_kv": (phys, R), "k_rope": (phys, dr), "pos": (phys,)}; pos (B,)
    int32.  Returns (out, {"c_kv": (B, R), "k_rope": (B, dr), "pos":
    (B,)})."""
    m, nh, dn, dr, dv = _m(cfg)
    scale = 1.0 / math.sqrt(dn + dr)
    q_cat, w_uv = _absorbed_q(cfg, q_nope, q_rope, w_ukv)
    k_pool = torch.cat([cache["c_kv"], cache["k_rope"]], dim=-1)[:, None]
    acc, mx, ls = paged_flash_decode(
        q_cat, k_pool, cache["c_kv"][:, None], cache["pos"], page.tables,
        pos, block=page.block, scale=scale, return_residuals=True)
    cn = ckv_new[:, 0]
    k_cur = torch.cat([cn, kr_new[:, 0]], dim=-1)[:, None]
    oc = fold_current_token(q_cat, k_cur, cn[:, None], acc, mx, ls,
                            scale=scale)
    o = torch.einsum("bhr,rhd->bhd", oc, w_uv)
    return o[:, None].to(q_nope.dtype), {"c_kv": cn, "k_rope": kr_new[:, 0],
                                         "pos": pos}


def mla_block_params(cfg: ModelConfig, d_ff: int = 0,
                     layout: Layout = None):
    """A dense block with MLA attention (reference ``registry.py:231-237``):
    the MoE family's leading dense layers (``d_ff`` = ``moe.dense_ff``)
    and the mtp head's block, with the specs of ``layout``'s strategy
    (None: one device)."""
    d = cfg.d_model
    st = "3d" if layout is None else layout.strategy
    return {"ln1": B.norm_params(cfg, d, st), "ln2": B.norm_params(cfg, d, st),
            "mla": mla_params(cfg, layout), "mlp": B.mlp_params(cfg, d_ff, st)}


def mla_block_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p,
                    positions, *, decode=False, cache=None, return_kv=False,
                    page=None):
    """Its apply (reference ``registry.py:241-253``): (x, new_cache)."""
    h = B.apply_norm(cfg, x, p["ln1"])
    a, new_cache = mla_apply(layout, cfg, dirs, h, p["mla"], positions,
                             decode=decode, cache=cache,
                             collect_kv=return_kv, page=page)
    x = x + a
    h = B.apply_norm(cfg, x, p["ln2"])
    return x + B.mlp_apply(layout, cfg, dirs, h, p["mlp"],
                           decode=decode), new_cache
