"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``) and the MoE
family's block (reference ``registry.py:281-313``).

The reference shards the expert dim over the axes whose devices hold
different tokens and exchanges tokens by all-to-all (``ep_axes``); at one
device that group is empty and the island is the identity, so
``moe_apply`` runs every expert here.  It copies the reference step for
step, so that the same inputs route the same tokens:

  * the router in f32, softmax, top-k, the gates renormalised
    (``moe.py:124-129``);
  * a static capacity ``ceil(T * k * capacity_factor / E)`` per expert
    (``:132``), every token's k choices ranked within their expert by a
    stable argsort and ``searchsorted(side="left")`` (``:133-139``), and
    the choices past capacity dropped (``:141-144``);
  * the expert FFN chunked over the capacity by 2048/1024/512, each chunk
    recomputed in the backward (``:171-182``);
  * the combine, dropped choices reading 0, the gate product in the
    activations' dtype (``:189-194``);
  * the load-balance and router-z losses (``:197-206``);
  * the shared experts as one MLP of width ``n_shared * expert_ff``
    (``:215-217``).

Matrix products.  The expert products are ``jnp.einsum`` in the reference,
outside any Pallas kernel, so they stay batched ``torch.matmul`` here
(bf16 products accumulate in f32, as the Algorithm-2 dx/dw do).  The
router product is plain f32 there and ``torch.matmul`` here.  The shared
experts and the first dense layers' MLPs go through ``plinear``, that is
K1 (``kernels/matmul.py``), and the norms through K3.

``lax.top_k`` puts the lower index first among equal probabilities; the
port ranks by a stable descending sort, which does the same (``torch.topk``
leaves the order of ties unspecified, and the load-balance loss reads the
first choice).  A padding row or an inactive decode slot takes capacity as
in the reference, so the serving engine's batches must be the reference's
for its tokens to be.

``DROPS``: while it is a list, every call appends a (2,) int64 tensor,
(routed choices, choices dropped at capacity), left on the device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..core.params import Param
from ..core.topology import Dirs, Layout
from . import blocks as B
from . import mla

F32 = torch.float32
DROPS: Optional[list] = None


def ep_axes(layout: Layout, dirs: Dirs, n_experts: int) -> Tuple[str, ...]:
    """The expert-parallel group (reference ``moe.py:32-51``): the largest
    tuple out of ('dp', 'x', in_ax) whose size divides ``n_experts``;
    () at one device."""
    tok_ax = dirs.in_ax if layout.strategy == "3d" else (
        "y" if layout.strategy == "2d" else None)
    cands = [("dp", "x", tok_ax), ("dp", tok_ax), ("dp", "x"), ("dp",),
             ("x", tok_ax), (tok_ax,), ("x",)]
    for cand in cands:
        axes = tuple(a for a in cand if a is not None and layout.size(a) > 1)
        n = math.prod(layout.size(a) for a in axes)
        if axes and n > 1 and n_experts % n == 0:
            return axes
    return ()


def moe_params(cfg: ModelConfig):
    """One layer's experts (reference ``moe.py:60-90``): the f32 router
    (d, E), w1 and w3 (E, d, f), w2 (E, f, d), and the shared experts."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.expert_ff, m.n_experts
    p = {"w_router": Param((d, E), dtype=F32),
         "w1": Param((E, d, f)), "w2": Param((E, f, d))}
    if cfg.act in ("silu", "gelu"):
        p["w3"] = Param((E, d, f))
    if m.n_shared:
        p["shared"] = B.mlp_params(cfg, m.n_shared * f)
    return p


def _chunk(cap: int) -> int:
    """The capacity chunk of the expert FFN (reference ``moe.py:171-176``)."""
    for cand in (2048, 1024, 512):
        if cap % cand == 0 and cap > cand:
            return cand
    return cap


def _expert_ffn(act, buf, w1, w2, w3):
    """(E, c, h) -> (E, c, h): each expert's MLP on its capacity slice."""
    h1 = torch.matmul(buf, w1)
    if w3 is not None:
        h = (act(h1.to(F32)) * torch.matmul(buf, w3).to(F32)).to(buf.dtype)
    else:
        h = act(h1.to(F32)).to(buf.dtype)
    return torch.matmul(h, w2)


def route(t, w_router, k: int):
    """The router (reference ``moe.py:124-129``): t (T, H) -> (logits and
    probs (T, E) f32, the k chosen experts (T, k) in descending order, the
    lower index first among ties, and their renormalised gates)."""
    logits = torch.matmul(t.to(F32), w_router)
    probs = torch.softmax(logits, dim=-1)
    sel = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    gates = torch.gather(probs, 1, sel)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, sel, gates


def moe_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p,
              decode: bool = False):
    """x: (B, S, H) -> (y (B, S, H), aux f32 scalar)."""
    if ep_axes(layout, dirs, cfg.moe.n_experts):
        raise NotImplementedError(
            "expert parallelism over more than one device is not ported "
            "yet (ROADMAP.md, Queue 1 item 3)")
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    act = B._act_fn(cfg.act)
    b, s, hl = x.shape
    T = b * s
    t = x.reshape(T, hl)
    dev = x.device

    logits, probs, sel, gates = route(t, p["w_router"], k)

    # ---- dispatch (static capacity) ----
    cap = max(1, int(math.ceil(T * k * m.capacity_factor / E)))
    e_flat = sel.reshape(-1)                                    # (T*k,)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    rank_sorted = (torch.arange(T * k, device=dev)
                   - torch.searchsorted(sorted_e, sorted_e, side="left"))
    keep_sorted = rank_sorted < cap
    slot_sorted = sorted_e * cap + rank_sorted
    src_tok = order // k
    dst = torch.where(keep_sorted, slot_sorted, E * cap)        # E*cap: drop
    buf = torch.zeros(E * cap + 1, hl, dtype=x.dtype, device=dev)
    buf = buf.index_put((dst,), t[src_tok])[:E * cap].reshape(E, cap, hl)
    if DROPS is not None:
        DROPS.append(torch.stack([torch.full((), T * k, device=dev),
                                  (~keep_sorted).sum()]))

    # ---- expert FFN, chunked over the capacity dim ----
    w1, w2, w3 = p["w1"], p["w2"], p.get("w3")
    tc = _chunk(cap)
    if tc < cap:
        outs = []
        for i in range(0, cap, tc):
            bc = buf[:, i:i + tc]
            if torch.is_grad_enabled():
                outs.append(checkpoint(_expert_ffn, act, bc, w1, w2, w3,
                                       use_reentrant=False))
            else:
                outs.append(_expert_ffn(act, bc, w1, w2, w3))
        out = torch.cat(outs, dim=1)
    else:
        out = _expert_ffn(act, buf, w1, w2, w3)
    out = torch.cat([out.reshape(E * cap, hl),
                     torch.zeros(1, hl, dtype=out.dtype, device=dev)])

    # ---- combine ----
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(0, order, keep_sorted)
    slots = torch.where(keep, e_flat * cap + rank, E * cap)
    vals = out[slots].reshape(T, k, hl)
    y = (vals * gates[..., None].to(x.dtype)).sum(dim=1).reshape(b, s, hl)

    # ---- aux losses (load balance + router z) ----
    me = probs.mean(dim=0)
    ce = F.one_hot(sel[:, 0], E).to(F32).mean(dim=0)
    lb = E * torch.sum(me * ce) * m.router_aux_weight
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_weight

    if "shared" in p:
        y = y + B.mlp_apply(layout, cfg, dirs, x, p["shared"], decode=decode)
    return y, (lb + z).to(F32)


def moe_block_params(cfg: ModelConfig):
    """One MoE layer (reference ``registry.py:286-294``): MLA attention
    where the config has it (deepseek-v3), else the dense attention."""
    p = {"ln1": B.norm_params(cfg, cfg.d_model),
         "ln2": B.norm_params(cfg, cfg.d_model), "moe": moe_params(cfg)}
    if cfg.mla is not None:
        p["mla"] = mla.mla_params(cfg)
    else:
        p["attn"] = B.attn_params(cfg)
    return p


def moe_block_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p,
                    positions, *, decode=False, cache=None, return_kv=False,
                    page=None):
    """Attention then the experts (reference ``registry.py:297-313``).
    Returns (x, new_cache, aux), new_cache as ``blocks.attn_apply``'s or
    ``mla.mla_apply``'s."""
    h = B.apply_norm(cfg, x, p["ln1"])
    if "mla" in p:
        a, new_cache = mla.mla_apply(layout, cfg, dirs, h, p["mla"],
                                     positions, decode=decode, cache=cache,
                                     collect_kv=return_kv, page=page)
    else:
        a, new_cache = B.attn_apply(layout, cfg, dirs, h, p["attn"],
                                    positions, window=cfg.window,
                                    decode=decode, cache=cache,
                                    return_kv=return_kv, page=page)
    x = x + a
    h = B.apply_norm(cfg, x, p["ln2"])
    y, aux = moe_apply(layout, cfg, dirs, h, p["moe"], decode=decode)
    return x + y, new_cache, aux
