"""The hooks of ``repro/models/registry.py`` that the port's paths need,
for every family (dense, MoE, hybrid, SSM, VLM and audio): the layer plan
and its segments, the decode-cache tree (``stack_cache``), and one table,
``STACKS``, of each family's frontend, loss labels and mask, microbatch
weight, label length, data stubs, serving cache, train-FLOPs estimate
(the MFU numerator, ``obs/telemetry.py``) and the dry run's activation
and pipeline-carry bytes (``launch/dryrun.memory_model``), as the
reference's ``get_stack`` keeps them; and at pp > 1 the stage tables
(``pipeline_info``), the stage slabs (``pipeline_stack_params``,
``repartition_stack``) and a stage's compute (``make_stage_fn``).  The reference
module imports jax, so the port keeps its own copies;
``tests/test_torch_train.py``, ``tests/test_torch_ssm.py``,
``tests/test_torch_moe.py``, ``tests/test_torch_vlm.py`` and
``tests/test_torch_encdec.py`` hold them equal to the originals.  The MoE
family includes deepseek-v3-671b: MLA attention (``models/mla.py``) and the
multi-token-prediction head.  The VLM family (internvl2) is the dense stack
behind a frontend that prepends patch embeddings outside decode; the audio
family (whisper) is a stack of ``xdec`` blocks (self attention, cross
attention over the encoder's states, MLP; ``models/encdec.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import Family, ModelConfig
from ..core.linear3d import embed_lookup
from ..core.params import stack_tree, tree_map, unstack
from ..core.topology import Dirs, Layout, stage_assignment
from . import encdec
from .blocks import kv_cache_init
from .frontend import audio_frames, vision_patches
from .mamba2 import MAMBA_HEAD_DIM, mamba_cache_init
from .mla import mla_cache_init
from .xlstm import mlstm_cache_init, slstm_cache_init


def _plan_xlstm(cfg: ModelConfig) -> Tuple[str, ...]:
    """mLSTM blocks with one sLSTM block per ``slstm_every`` positions
    (reference ``registry.py:399-411``)."""
    every = cfg.ssm.slstm_every
    if not every:
        return ("mlstm",) * cfg.n_layers
    plan, done = [], 0
    while done < cfg.n_layers:
        n = min(every - 1, cfg.n_layers - done)
        plan += ["mlstm"] * n
        done += n
        if done < cfg.n_layers:
            plan.append("slstm")
            done += 1
    return tuple(plan)


def _plan_hybrid(cfg: ModelConfig) -> Tuple[str, ...]:
    """zamba2: the one shared attention block ("attn") after every full
    ``attn_every`` Mamba layers (reference ``registry.py:385-397``)."""
    every = cfg.ssm.attn_every or (cfg.n_layers + 1)
    plan, done = [], 0
    while done < cfg.n_layers:
        n = min(every, cfg.n_layers - done)
        done += n
        plan += ["mamba"] * n
        if cfg.ssm.attn_every and n == every:
            plan.append("attn")
    return tuple(plan)


def _plan_moe(cfg: ModelConfig) -> Tuple[str, ...]:
    """``first_k_dense`` dense layers, then MoE layers (reference
    ``registry.py:380-382``)."""
    fk = cfg.moe.first_k_dense
    return ("dense",) * fk + ("moe",) * (cfg.n_layers - fk)


# The kind whose parameters are shared rather than stacked per layer: it
# reads params["shared"]["attn"] (reference registry.py:323-329, a
# BlockKind with params=None).
SHARED_KINDS = ("attn",)
# the kinds whose blocks attend through a kv cache that prefill and extend
# fill, in the paged pool and in the contiguous caches alike
KV_KINDS = ("dense", "moe")


def segments(plan) -> Tuple[Tuple[str, int], ...]:
    """Runs of one kind in plan order, ``(kind, count)`` (reference
    ``_segments``, ``registry.py:599-606``)."""
    segs = []
    for k in plan:
        if segs and segs[-1][0] == k:
            segs[-1][1] += 1
        else:
            segs.append([k, 1])
    return tuple((k, n) for k, n in segs)


def _attn_cache(cfg: ModelConfig, batch: int, length: int):
    """One attention layer's contiguous cache: ``L = min(length, window)``
    (reference ``registry.py:274-278``), MLA's latent cache where the
    config has MLA."""
    L = min(length, cfg.window) if cfg.window else length
    if cfg.mla is not None:
        return mla_cache_init(cfg, batch, L)
    return kv_cache_init(cfg, batch, L)


def _xdec_cache(cfg: ModelConfig, batch: int, length: int):
    """One audio decoder layer's cache (reference ``registry.py:362-370``):
    its self-attention kv, and the cross attention's static encoder k/v,
    one layer of ``encdec.cross_kv_cache_init``'s (batch, n_frames, nkv,
    d), zeros until something writes them (the reference's engine never
    does: ROADMAP.md, Queue 3 fault 5)."""
    L = min(length, cfg.window) if cfg.window else length
    cross = encdec.cross_kv_cache_init(cfg, batch)
    layer = {k: dataclasses.replace(v, shape=v.shape[1:])
             for k, v in cross.items()}
    return {"kv": kv_cache_init(cfg, batch, L),
            "xk": layer["k"], "xv": layer["v"]}


# the decode cache of one layer of each kind (reference registry.py:
# BlockKind.cache); zamba2's shared block has one per use
KIND_CACHES = {"dense": _attn_cache, "moe": _attn_cache, "attn": _attn_cache,
               "xdec": _xdec_cache,
               "mamba": lambda cfg, batch, length:
                   mamba_cache_init(cfg, batch),
               "mlstm": lambda cfg, batch, length:
                   mlstm_cache_init(cfg, batch),
               "slstm": lambda cfg, batch, length:
                   slstm_cache_init(cfg, batch)}


def stack_cache(cfg: ModelConfig, batch: int, length: int):
    """The decode-cache tree (reference ``registry.py:627-637``): one slab
    per kind in plan order, each leaf stacked (n, ...) over the kind's n
    layers, or its n uses for the shared "attn" kind; the ``xdec`` slab
    nests its self-attention cache under ``kv``."""
    plan = layer_plan(cfg)
    return {kind: stack_tree(KIND_CACHES[kind](cfg, batch, length),
                             plan.count(kind))
            for kind in dict.fromkeys(plan)}


def attn_step_flops(cfg: ModelConfig, s: int) -> float:
    """Train FLOPs per token at context s: 3x the forward (two backward
    products per forward one), 2 per active parameter plus the
    window-clamped attention products (reference ``registry.py:480-483``)."""
    ctx = min(s, cfg.window) if cfg.window else s
    attn = 4.0 * cfg.n_layers * ctx * cfg.n_heads * cfg.head_dim
    return 3.0 * (2.0 * cfg.n_active_params() + attn)


def ssm_step_flops(cfg: ModelConfig, s: int) -> float:
    """Train FLOPs per token of the SSM family (reference
    ``registry.py:486-489``): 3x the forward's 2 per active parameter, the
    recurrent state's work taken to ride inside the parameter MACs."""
    return 3.0 * 2.0 * cfg.n_active_params()


# ---------------------------------------------------------------------------
# Per-family activation and carry bytes (the dry run's memory model,
# reference registry.py:420-471).  b and s are the per-device microbatch
# batch and sequence; the hidden dim splits over the cube's out_ax ('z' at
# block entry), a projection's features over 'y'.
# ---------------------------------------------------------------------------
def _h_loc(cfg: ModelConfig, layout: Layout) -> float:
    return cfg.d_model / max(layout.size("z"), 1)


def _residual_act_bytes(cfg, layout, b, s) -> int:
    return int(b * s * _h_loc(cfg, layout) * 2)            # one bf16 residual


def _moe_act_bytes(cfg, layout, b, s) -> int:
    """The residual plus the capacity-padded dispatch and combine buffers,
    E * cap * h ~ tokens * top_k * capacity_factor * h."""
    res = _residual_act_bytes(cfg, layout, b, s)
    disp = int(b * s * cfg.moe.top_k * cfg.moe.capacity_factor
               * _h_loc(cfg, layout) * 2)
    return res + disp


def _mamba_act_bytes(cfg, layout, b, s) -> int:
    """The residual, the expanded conv channels (bf16) and the f32 SSD
    chunk state, the heads split over the projection's features ('y')."""
    d_in = cfg.ssm.expand * cfg.d_model
    nh = d_in // MAMBA_HEAD_DIM
    fsh = max(layout.size("y"), 1)
    res = _residual_act_bytes(cfg, layout, b, s)
    conv = int(b * s * (d_in / fsh) * 2)
    state = int(b * (nh / fsh) * MAMBA_HEAD_DIM * cfg.ssm.d_state * 4)
    return res + conv + state


def _xlstm_act_bytes(cfg, layout, b, s) -> int:
    """The residual, the q/k/v/z projections (expand 2) and the f32 mLSTM
    C state."""
    d_in = 2 * cfg.d_model
    dh = d_in // cfg.n_heads
    fsh = max(layout.size("y"), 1)
    res = _residual_act_bytes(cfg, layout, b, s)
    proj = int(4 * b * s * (d_in / fsh) * 2)
    state = int(b * (cfg.n_heads / fsh) * dh * dh * 4)
    return res + proj + state


def _audio_act_bytes(cfg, layout, b, s) -> int:
    """The self and cross attention residual streams."""
    return 2 * _residual_act_bytes(cfg, layout, b, s)


def _audio_carry_bytes(cfg, layout, b) -> int:
    """The encoder's states, which ride the pipeline with each
    microbatch."""
    return int(b * cfg.encoder.n_frames * _h_loc(cfg, layout) * 2)


def _no_carry(cfg, layout, b) -> int:
    return 0


def embed(layout: Layout, cfg: ModelConfig, dirs: Dirs, params, tokens,
          decode: bool = False):
    """The token embedding, scaled by sqrt(d) where the config says
    (reference ``registry.py:137-143``)."""
    x = embed_lookup(layout, dirs, tokens, params["embed"], decode=decode)
    if cfg.emb_scale_sqrt_d:
        x = x * math.sqrt(cfg.d_model)
    return x


def _text_frontend(layout, cfg, dirs, params, batch, *, mode):
    decode = mode == "decode"
    return embed(layout, cfg, dirs, params,
                 batch["token" if decode else "tokens"], decode=decode), {}


def _vlm_frontend(layout, cfg, dirs, params, batch, *, mode):
    """Patches prepended to the text outside decode only (reference
    ``registry.py:164-170``): served internvl2 never sees them (ROADMAP
    Queue 3, fault 5)."""
    x, ctx = _text_frontend(layout, cfg, dirs, params, batch, mode=mode)
    if mode != "decode":
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x, ctx


def _audio_frontend(layout, cfg, dirs, params, batch, *, mode):
    """The encoder over ``batch["frames"]`` outside decode, under remat in
    training, its states the decoder blocks' ``ctx["enc"]`` (reference
    ``registry.py:201-208``); a decode attends the cache's ``xk``/``xv``.
    The frames enter in the model's dtype, which the reference's bf16
    batches are for a bf16 model."""
    x, ctx = _text_frontend(layout, cfg, dirs, params, batch, mode=mode)
    if mode == "decode":
        return x, ctx
    frames = batch["frames"].to(params["embed"].dtype)
    return x, {"enc": encdec.encoder_apply(
        layout, cfg, dirs, frames, params["encoder"],
        remat=cfg.remat and mode == "train")}


def _text_labels(cfg, batch):
    labels = batch["labels"]
    return labels, (labels >= 0).float()


def _vlm_labels(cfg, batch):
    """Labels and mask padded by ``n_vision_tokens`` on the left, the mask
    0 on the vision positions and 1 on every text position, masked labels
    included (reference ``registry.py:173-182``)."""
    labels = batch["labels"]
    nv = cfg.n_vision_tokens
    mask = torch.nn.functional.pad(
        torch.ones(labels.shape, dtype=torch.float32, device=labels.device),
        (nv, 0))
    return torch.nn.functional.pad(labels, (nv, 0)), mask


def _text_mb_weight(cfg, batch):
    return (batch["labels"] >= 0).float().sum()


def _vlm_mb_weight(cfg, batch):
    labels = batch["labels"]
    return torch.tensor(float(labels.numel()), device=labels.device)


def _no_params(cfg, layout=None):
    return {}


def _no_stubs(cfg, b, rng):
    return {}


@dataclasses.dataclass(frozen=True)
class Stack:
    """One family's hooks (reference ``BlockStack``, ``registry.py:95-131``),
    those the port's one-device paths read: ``layer_plan(cfg)``, the block
    kind of each layer; ``frontend(layout, cfg, dirs, params, batch, *,
    mode) -> (x, ctx)``; ``frontend_params(cfg, layout)``, its parameter
    subtrees on the specs of ``layout`` (None: one device);
    ``labels(cfg, batch) -> (labels, mask)`` of the loss (the caller clamps
    the labels at 0); ``mb_weight(cfg, batch)``, a microbatch's weight,
    the sum of its loss mask; ``label_len(cfg, s)``, the text length of an
    ``s``-position shape; ``stubs(cfg, b, rng)``, the modality stubs of a
    batch, drawn after its tokens (``repro/data/pipeline.py:60-75``);
    ``step_flops(cfg, s)``, train FLOPs per token; ``act_bytes(cfg,
    layout, b, s)``, a block's activation and state bytes a device at a
    per-device microbatch of b x s, and ``carry_bytes(cfg, layout, b)``,
    the pipeline carry's (the dry run's memory model); ``serve_cache``,
    "paged" (the block-table kv pool) or "state"."""
    layer_plan: Callable
    frontend: Callable = _text_frontend
    frontend_params: Callable = _no_params
    labels: Callable = _text_labels
    mb_weight: Callable = _text_mb_weight
    label_len: Callable = lambda cfg, s: s
    stubs: Callable = _no_stubs
    step_flops: Callable = attn_step_flops
    act_bytes: Callable = _residual_act_bytes
    carry_bytes: Callable = _no_carry
    serve_cache: str = "state"


STACKS = {
    Family.DENSE: Stack(lambda cfg: ("dense",) * cfg.n_layers,
                        serve_cache="paged"),
    Family.MOE: Stack(_plan_moe, act_bytes=_moe_act_bytes,
                      serve_cache="paged"),
    Family.HYBRID: Stack(_plan_hybrid, act_bytes=_mamba_act_bytes),
    Family.SSM: Stack(_plan_xlstm, step_flops=ssm_step_flops,
                      act_bytes=_xlstm_act_bytes),
    # the dense stack behind the vision frontend (reference
    # registry.py:544-548)
    Family.VLM: Stack(
        lambda cfg: ("dense",) * cfg.n_layers, frontend=_vlm_frontend,
        labels=_vlm_labels, mb_weight=_vlm_mb_weight,
        label_len=lambda cfg, s: s - cfg.n_vision_tokens,
        stubs=lambda cfg, b, rng: {
            "patch_embeds": vision_patches(cfg, b, rng)}),
    # whisper's decoder: n_layers xdec blocks behind the encoder (reference
    # registry.py:415-416, 549-555)
    Family.AUDIO: Stack(
        lambda cfg: ("xdec",) * cfg.n_layers, frontend=_audio_frontend,
        frontend_params=lambda cfg, layout=None: {
            "encoder": encdec.encoder_params(cfg, layout)},
        stubs=lambda cfg, b, rng: {
            "frames": audio_frames(cfg, b, rng)},
        act_bytes=_audio_act_bytes, carry_bytes=_audio_carry_bytes),
}


def get_stack(family: Family) -> Stack:
    return STACKS[family]


def layer_plan(cfg: ModelConfig) -> Tuple[str, ...]:
    """The block kind of each layer in order (reference ``_plan_*``,
    ``registry.py:376-416``)."""
    return get_stack(cfg.family).layer_plan(cfg)


def serve_cache_mode(cfg: ModelConfig) -> str:
    """'paged' or 'state' (reference ``registry.serve_cache_mode``)."""
    return get_stack(cfg.family).serve_cache


def train_flops_per_token(cfg: ModelConfig, s: int) -> float:
    """Model FLOPs spent per trained token (reference
    ``registry.py:492-494``).  The reference gives the hybrid family no
    estimate of its own, so zamba2 takes ``attn_step_flops`` too, which
    counts its 38 layers as dense attention + MLP layers (``n_params``):
    2.68B parameters against the 1.18B of its real tree, so its MFU reads
    about 2.3x high.  The MoE family takes ``attn_step_flops`` with
    ``n_active_params``, which counts only the top-k experts of each MoE
    layer.  The SSM family takes ``ssm_step_flops``, whose
    ``n_active_params`` counts xlstm-350m's 24 layers as attention blocks
    with no MLP (d_ff 0): 0.204B parameters against the 0.342B of its real
    tree, and none of the mLSTM's chunk products, so its MFU reads low, at
    most 0.60x of what the tree's parameters give.  The VLM and audio
    families take ``attn_step_flops`` (the reference's default,
    ``registry.py:127``); for whisper ``n_active_params`` counts the 24
    decoder layers without their cross attention and no encoder, and the
    attention term the decoder's self attention alone, so its MFU leaves
    out the encoder's 24 layers over 1,504 frames and reads low.  All
    copied as they are."""
    return float(get_stack(cfg.family).step_flops(cfg, s))


# ---------------------------------------------------------------------------
# pp > 1: the stage tables, the stage slabs, a stage's compute (reference
# registry.py:720-895)
# ---------------------------------------------------------------------------
NOOP = -1                      # selector value of a padding slot (identity)


@dataclasses.dataclass(frozen=True)
class PipelineInfo:
    plan: Tuple[str, ...]
    bounds: Tuple[Tuple[int, int], ...]     # per-stage [start, end) into plan
    kind_order: Tuple[str, ...]             # selector index -> kind name
    slots: int                              # parameter slots per stage
    homogeneous: bool                       # single kind, equal stage sizes
    selectors: Tuple[Tuple[int, ...], ...]  # (pp, slots), NOOP pads


def pipeline_info(stack: Stack, cfg: ModelConfig,
                  n_stages: int) -> PipelineInfo:
    """The plan cut into ``n_stages`` contiguous stages
    (``stage_assignment``): one selector per slot, NOOP on the padding
    slots of the shorter stages (reference ``registry.py:732-745``)."""
    plan = stack.layer_plan(cfg)
    bounds = stage_assignment(len(plan), n_stages)
    kind_order = tuple(dict.fromkeys(plan))
    sizes = [e - s for s, e in bounds]
    homogeneous = len(kind_order) == 1 and len(set(sizes)) == 1
    slots = max(sizes)
    selectors = tuple(
        tuple([kind_order.index(plan[i]) for i in range(s, e)]
              + [NOOP] * (slots - (e - s)))
        for s, e in bounds)
    return PipelineInfo(plan, bounds, kind_order, slots, homogeneous,
                        selectors)


def pipeline_unsupported_reason(cfg: ModelConfig,
                                n_stages: int) -> Optional[str]:
    """None when the config pipelines at ``n_stages``, else the plan-time
    message (reference ``registry.py:748-764``, word for word)."""
    if n_stages <= 1:
        return None
    if cfg.mtp:
        return (f"{cfg.arch}: mtp=True is incompatible with "
                f"n_stages={n_stages} — the multi-token-prediction head "
                "needs the embedding table and the final hidden states on "
                "the same stage; train with n_stages=1 or disable mtp")
    plan = get_stack(cfg.family).layer_plan(cfg)
    if len(plan) < n_stages:
        return (f"{cfg.arch}: only {len(plan)} stackable blocks for "
                f"n_stages={n_stages} — every pipeline stage needs at least "
                "one block; lower n_stages or deepen the model")
    return None


def stage_slots(info: PipelineInfo, n_stages: int) -> int:
    """The slots of each stage's slab: ``len(plan) / pp`` when the plan is
    homogeneous, else ``info.slots`` (union slots)."""
    return (len(info.plan) // n_stages if info.homogeneous
            else info.slots)


def pipeline_stack_params(cfg: ModelConfig, n_stages: int, kind_params):
    """The ``stack`` subtree at pp = ``n_stages`` (reference
    ``registry.py:767-784``): per kind with stacked parameters (the trees
    of one layer's Params in ``kind_params``) a ``(pp, slots, ...)`` slab,
    the stage dim split over 'pp', so that each rank holds its stage's
    slots only."""
    info = pipeline_info(get_stack(cfg.family), cfg, n_stages)
    per = stage_slots(info, n_stages)
    return {k: stack_tree(stack_tree(kind_params[k], per), n_stages,
                          shard="pp")
            for k in info.kind_order if k in kind_params}


def make_stage_fn(info: PipelineInfo, stage: int, apply: Callable,
                  remat: bool = False) -> Callable:
    """``stage_fn(x, slab) -> x``: stage ``stage``'s slots in order, slot
    j applying ``apply(kind, x, p)`` with its kind's parameters, slot j of
    the rank's ``slab`` ({kind: leaves (1, slots, ...)}), recomputed in
    the backward under ``remat``.  A NOOP slot (a shorter stage's padding)
    is skipped: it computes nothing, and its parameters' gradient is 0, as
    the reference's ``jnp.where`` over a padding slot gives (reference
    ``make_stage_fn``, ``registry.py:787-837``)."""
    sels = info.selectors[stage]

    def stage_fn(x, slab):
        layers = {k: unstack(tree_map(lambda t: t.squeeze(0), t), len(sels))
                  for k, t in slab.items()}
        for j, sel in enumerate(sels):
            if sel == NOOP:
                continue
            kind = info.kind_order[sel]
            if remat:
                x = checkpoint(apply, kind, x, layers[kind][j],
                               use_reentrant=False)
            else:
                x = apply(kind, x, layers[kind][j])
        return x

    return stage_fn


def _n_stages(layout) -> int:
    return layout if isinstance(layout, int) else layout.size("pp")


def _stack(xs):
    return torch.stack(xs) if isinstance(xs[0], torch.Tensor) \
        else np.stack(xs)


def _zeros(a):
    return torch.zeros_like(a) if isinstance(a, torch.Tensor) \
        else np.zeros_like(a)


def repartition_stack(cfg: ModelConfig, stack_tree_in, src_layout,
                      dst_layout):
    """Re-cut a ``stack`` subtree from one pipeline depth to another
    (reference ``registry.py:840-895``): pp = 1's ``(count, ...)`` layer
    stacks to the ``(pp, slots, ...)`` stage slabs, or back, or between two
    pp.  Union slots the destination never selects are zero-filled.  The
    leaves are global tensors or numpy arrays; the layouts are Layouts or
    stage counts.  ``checkpoint/store.restore(cfg=...)`` applies it to a
    checkpoint saved at another pp."""
    stack = get_stack(cfg.family)
    plan = stack.layer_plan(cfg)
    n_src, n_dst = _n_stages(src_layout), _n_stages(dst_layout)

    def to_flat(tree):
        if n_src == 1:
            return tree
        info = pipeline_info(stack, cfg, n_src)
        out = {}
        for kname, slab in tree.items():
            idx = [(s, j) for s, (lo, hi) in enumerate(info.bounds)
                   for j, i in enumerate(range(lo, hi)) if plan[i] == kname]
            out[kname] = tree_map(
                lambda a, idx=idx: _stack([a[s, j] for s, j in idx]), slab)
        return out

    flat = to_flat(stack_tree_in)
    if n_dst == 1:
        return flat
    info = pipeline_info(stack, cfg, n_dst)
    per = stage_slots(info, n_dst)
    out = {}
    for kname, fl in flat.items():
        occ = 0
        place = [[None] * per for _ in range(n_dst)]
        for s, (lo, hi) in enumerate(info.bounds):
            for j, i in enumerate(range(lo, hi)):
                if plan[i] == kname:
                    place[s][j] = occ
                    occ += 1

        def build(a, place=place):
            return _stack([_stack([a[k] if k is not None else _zeros(a[0])
                                   for k in row]) for row in place])

        out[kname] = tree_map(build, fl)
    return out
