"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``) and the MoE
family's block (reference ``registry.py:281-313``).

The reference shards the expert dim over the axes whose devices hold
different tokens, the expert-parallel group ``ep_axes``, and moves the
tokens to their experts' devices by a tiled all-to-all over it and back
(``moe.py:147-149``, ``:183-185``).  The port copies it step for step, so
that the same inputs route the same tokens:

  * the router in f32, its logits summed over the contraction axis
    ``co`` (3d out_ax, else 'z'; whole at 1d), softmax, top-k, the gates
    renormalised (``moe.py:119-129``);
  * a static capacity ``ceil(T * k * capacity_factor / E)`` per expert on
    the rank's own T tokens (``:132``), every token's k choices ranked
    within their expert by a stable argsort and
    ``searchsorted(side="left")`` (``:133-139``), the choices past
    capacity dropped (``:141-144``);
  * the (E, cap, h) buffer exchanged over ``ep`` to (E / n_ep, cap * n_ep,
    h), ``comm.all_to_all_ad``;
  * the expert FFN chunked over ``cap * n_ep`` by 2048/1024/512, each
    chunk recomputed in the backward (``:171-182``); h1 and h3 summed over
    ``co`` (the cube's contraction split), or at 1d the output (Megatron's
    row split);
  * the exchange back, the combine, dropped choices reading 0, the gate
    product in the activations' dtype (``:183-194``);
  * the load-balance and router-z losses, their means over the token axes
    (``:197-206``);
  * the shared experts as one MLP of width ``n_shared * expert_ff`` on
    the layout's linears (``:215-217``).

Above one device the reference runs the body in a ``shard_map`` with
``check_vma=False`` (``:211-213``), whose transpose this module copies,
so that each rank's gradients are the reference's: every ``psum`` and
``pmean`` in the body transposes to a sum (``comm.psum_ad``); the
cotangent of an output is divided by the sizes of the axes its spec
leaves out (the router losses' P(): every axis; at 1d the block's output,
replicated over 'z'); an input's is summed over the axes its spec leaves
out (x at 1d over 'z'; the weights' by the train step's leaf sync).
Where expert parallelism leaves 'dp' out, the FFN dim of w1/w2/w3 is
stored over 'dp' (``sdp``, ``moe.py:71-73``) and gathered before the
FFN, its gradient reduce-scattered back.

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
(routed choices, choices dropped at capacity) of the rank's own tokens,
left on the device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..core import comm
from ..core.linear3d import act_axes
from ..core.params import Param
from ..core.topology import (AXES, Dirs, Layout, entry_dirs,
                              single_device_layout)
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


def _contract_ax(layout: Layout, dirs: Dirs) -> str:
    """The axis that splits the experts' contraction (reference
    ``moe.py:54-57``): out_ax at 3d, else 'z'."""
    return dirs.out_ax if layout.strategy == "3d" else "z"


def _e_spec(ep: Tuple[str, ...]):
    return ep if len(ep) > 1 else (ep[0] if ep else None)


def _sdp(layout: Layout, ep, f: int):
    """'dp' where expert parallelism leaves it out and it divides the FFN
    dim: the storage-only split of w1/w2/w3 (reference ``moe.py:71-73``);
    else None."""
    n = layout.size("dp")
    return "dp" if ("dp" not in ep and n > 1 and f % n == 0
                    and not layout.inference_opt) else None


def moe_params(cfg: ModelConfig, layout: Optional[Layout] = None):
    """One layer's experts with the reference's specs for ``layout`` (None:
    one device; reference ``moe.py:60-90``): the f32 router (d, E) split
    (co, None), whole at 1d; w1 and w3 (E, d, f) split (ep, co, sdp) and
    w2 (E, f, d) (ep, sdp, co), at 1d (ep, None, co[+sdp]) and (ep,
    co[+sdp], None); and the shared experts, an MLP on the layout's
    strategy."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.expert_ff, m.n_experts
    lay = layout or single_device_layout()
    dirs = entry_dirs()
    ep = ep_axes(lay, dirs, E)
    co = _contract_ax(lay, dirs)
    e = _e_spec(ep)
    sdp = _sdp(lay, ep, f)
    if lay.strategy == "1d":   # Megatron: the FFN dim split over co
        fs = (co, sdp) if sdp else co
        w1_spec, w2_spec, wr_spec = (e, None, fs), (e, fs, None), (None,
                                                                  None)
    else:                      # the cube: the contraction split over co
        w1_spec, w2_spec, wr_spec = (e, co, sdp), (e, sdp, co), (co, None)
    p = {"w_router": Param((d, E), dtype=F32, spec=wr_spec),
         "w1": Param((E, d, f), spec=w1_spec),
         "w2": Param((E, f, d), spec=w2_spec)}
    if cfg.act in ("silu", "gelu"):
        p["w3"] = Param((E, d, f), spec=w1_spec)
    if m.n_shared:
        p["shared"] = B.mlp_params(cfg, m.n_shared * f, lay.strategy)
    return p


def _chunk(t_e: int) -> int:
    """The chunk of the expert FFN over the exchanged capacity ``t_e =
    cap * n_ep`` (reference ``moe.py:171-176``)."""
    for cand in (2048, 1024, 512):
        if t_e % cand == 0 and t_e > cand:
            return cand
    return t_e


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward multiplies the gradient by ``c``."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return dy * ctx.c, None


def _out_ct(x, n: int):
    """An output of the reference's island whose spec leaves out axes of
    n devices in all: its cotangent is divided by n there
    (``shard_map``'s transpose with ``check_vma=False``)."""
    return x if n == 1 else _ScaleGrad.apply(x, 1.0 / n)


def _expert_ffn(layout, co, one_d, act, buf, w1, w2, w3):
    """(E, c, h) -> (E, c, h): each expert's MLP on its capacity slice; h1
    and h3 summed over ``co`` (the cube's split contraction), or the
    output at 1d (the FFN dim split over ``co``)."""
    def lin(w):
        h = torch.matmul(buf, w)
        return h if one_d else comm.psum_ad(layout, h, co)
    h1 = lin(w1)
    if w3 is not None:
        h = (act(h1.to(F32)) * lin(w3).to(F32)).to(buf.dtype)
    else:
        h = act(h1.to(F32)).to(buf.dtype)
    o = torch.matmul(h, w2)
    return comm.psum_ad(layout, o, co) if one_d else o


def route(t, w_router, k: int, layout: Optional[Layout] = None, co=None):
    """The router (reference ``moe.py:119-129``): t (T, h) -> (logits and
    probs (T, E) f32, the k chosen experts (T, k) in descending order, the
    lower index first among ties, and their renormalised gates).  With
    ``co`` the hidden dim is split over it and the logits summed there."""
    logits = torch.matmul(t.to(F32), w_router)
    if co is not None:
        logits = comm.psum_ad(layout, logits, co)
    probs = torch.softmax(logits, dim=-1)
    sel = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    gates = torch.gather(probs, 1, sel)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, sel, gates


def _pmean(layout: Layout, x, axes):
    return comm.psum_ad(layout, x, axes) / layout.size(axes) if axes else x


def moe_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p,
              decode: bool = False):
    """x: (B, S, H), the rank's shard in the block's entry layout -> (y
    (B, S, H) in the same layout, aux f32 scalar, the same on every
    rank)."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    ep = ep_axes(layout, dirs, E)
    co = _contract_ax(layout, dirs)
    one_d = layout.strategy == "1d"
    if layout.n_devices > 1 and decode:
        raise NotImplementedError(
            "MoE decode above one device: multi-rank serving is not ported "
            "yet (ROADMAP.md, Queue 1 item 3)")
    act = B._act_fn(cfg.act)
    # the island's specs: x (batch, seq, hidden) by ``act_axes``; the axes
    # they leave out carry x's and y's cotangents (1d: 'z'); the tokens
    # split over the batch and sequence axes (a decode runs on one device)
    seq_ax, hid_ax = act_axes(layout, dirs)
    tok_axes = layout.live((*layout.batch_axes, *layout.seq_axes, seq_ax))
    rest = layout.live(tuple(a for a in AXES
                             if a not in {*tok_axes, hid_ax}))
    xi = comm.grad_psum(layout, x, rest)
    b, s, hl = x.shape
    T = b * s
    t = xi.reshape(T, hl)
    dev = x.device

    logits, probs, sel, gates = route(
        t, p["w_router"], k, layout,
        None if one_d or not layout.live((co,)) else co)

    # ---- dispatch (static capacity, the rank's own tokens) ----
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

    # ---- the exchange over ep: (E, cap, h) -> (E / n_ep, cap * n_ep, h) ----
    buf = comm.all_to_all_ad(layout, buf, ep, split_dim=0, concat_dim=1)

    # ---- expert FFN, chunked over the exchanged capacity ----
    w1, w2, w3 = p["w1"], p["w2"], p.get("w3")
    sdp = _sdp(layout, ep, m.expert_ff)
    if sdp and layout.live((sdp,)):   # stored over dp: gathered for use
        w1 = comm.all_gather_ad(layout, w1, sdp, dim=2)
        w2 = comm.all_gather_ad(layout, w2, sdp, dim=1)
        if w3 is not None:
            w3 = comm.all_gather_ad(layout, w3, sdp, dim=2)
    t_e = buf.shape[1]
    tc = _chunk(t_e)
    ffn = (layout, co, one_d, act)
    if tc < t_e:
        outs = []
        for i in range(0, t_e, tc):
            bc = buf[:, i:i + tc]
            if torch.is_grad_enabled():
                outs.append(checkpoint(_expert_ffn, *ffn, bc, w1, w2, w3,
                                       use_reentrant=False))
            else:
                outs.append(_expert_ffn(*ffn, bc, w1, w2, w3))
        out = torch.cat(outs, dim=1)
    else:
        out = _expert_ffn(*ffn, buf, w1, w2, w3)
    out = comm.all_to_all_ad(layout, out, ep, split_dim=1, concat_dim=0)
    out = torch.cat([out.reshape(E * cap, hl),
                     torch.zeros(1, hl, dtype=out.dtype, device=dev)])

    # ---- combine ----
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(0, order, keep_sorted)
    slots = torch.where(keep, e_flat * cap + rank, E * cap)
    vals = out[slots].reshape(T, k, hl)
    y = (vals * gates[..., None].to(x.dtype)).sum(dim=1).reshape(b, s, hl)

    # ---- aux losses (load balance + router z), means over the tokens ----
    me = _pmean(layout, probs.mean(dim=0), tok_axes)
    ce = _pmean(layout, F.one_hot(sel[:, 0], E).to(F32).mean(dim=0),
                tok_axes)
    lb = E * torch.sum(me * ce) * m.router_aux_weight
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_weight
    aux = (lb + _pmean(layout, z, tok_axes)).to(F32)
    y = _out_ct(y, layout.size(rest))
    aux = _out_ct(aux, layout.n_devices)

    if "shared" in p:
        y = y + B.mlp_apply(layout, cfg, dirs, x, p["shared"], decode=decode)
    return y, aux


def moe_block_params(cfg: ModelConfig, layout: Optional[Layout] = None):
    """One MoE layer (reference ``registry.py:286-294``) with the specs of
    ``layout`` (None: one device): MLA attention where the config has it
    (deepseek-v3, trained on one device only), else the dense
    attention."""
    st = "3d" if layout is None else layout.strategy
    p = {"ln1": B.norm_params(cfg, cfg.d_model, st),
         "ln2": B.norm_params(cfg, cfg.d_model, st),
         "moe": moe_params(cfg, layout)}
    if cfg.mla is not None:
        p["mla"] = mla.mla_params(cfg, layout)
    else:
        p["attn"] = B.attn_params(cfg, layout)
    return p


def moe_block_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p,
                    positions, *, decode=False, cache=None, return_kv=False,
                    page=None):
    """Attention then the experts (reference ``registry.py:297-313``), the
    norms over the layout's split hidden dim as the dense block's.
    Returns (x, new_cache, aux), new_cache as ``blocks.attn_apply``'s or
    ``mla.mla_apply``'s."""
    h = B.apply_norm(cfg, x, p["ln1"], layout, dirs)
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
    h = B.apply_norm(cfg, x, p["ln2"], layout, dirs)
    y, aux = moe_apply(layout, cfg, dirs, h, p["moe"], decode=decode)
    return x + y, new_cache, aux
