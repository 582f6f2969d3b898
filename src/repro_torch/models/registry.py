"""The hooks of ``repro/models/registry.py`` that the port's paths need,
for the dense, MoE, hybrid and SSM (xLSTM) families: the layer plan and its
segments, the
decode-cache tree (``stack_cache``), the loss labels and mask, the
microbatch weight, and the train-FLOPs estimate that is the MFU numerator
(``obs/telemetry.py``).  The reference module
imports jax, so the port keeps its own copies; ``tests/test_torch_train.py``,
``tests/test_torch_ssm.py`` and ``tests/test_torch_moe.py`` hold them equal
to the originals.  The MoE family includes deepseek-v3-671b: MLA
attention (``models/mla.py``) and the multi-token-prediction head.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import Family, ModelConfig
from .blocks import kv_cache_init
from .mamba2 import mamba_cache_init
from .mla import mla_cache_init
from .xlstm import mlstm_cache_init, slstm_cache_init

PORTED = (Family.DENSE, Family.MOE, Family.HYBRID, Family.SSM)


def unported_reason(cfg: ModelConfig):
    """Why the port cannot run ``cfg`` yet, or None."""
    if cfg.family not in PORTED:
        return (f"{cfg.arch}: family {cfg.family.value!r} is not ported yet; "
                "the port runs the dense, MoE, hybrid and SSM families "
                "(ROADMAP.md, Queue 1 item 10)")
    return None


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


def layer_plan(cfg: ModelConfig) -> Tuple[str, ...]:
    """The block kind of each layer in order (reference ``_plan_dense``,
    ``_plan_moe``, ``_plan_hybrid`` and ``_plan_xlstm``,
    ``registry.py:374-411``): the MoE family runs ``first_k_dense`` dense
    layers, then MoE layers; zamba2 runs the one shared attention block
    ("attn") after every full ``attn_every`` Mamba layers; xlstm-350m is 21
    mLSTM and 3 sLSTM layers."""
    reason = unported_reason(cfg)
    if reason:
        raise NotImplementedError(reason)
    if cfg.family == Family.DENSE:
        return ("dense",) * cfg.n_layers
    if cfg.family == Family.MOE:
        fk = cfg.moe.first_k_dense
        return ("dense",) * fk + ("moe",) * (cfg.n_layers - fk)
    if cfg.family == Family.SSM:
        return _plan_xlstm(cfg)
    every = cfg.ssm.attn_every or (cfg.n_layers + 1)
    plan, done = [], 0
    while done < cfg.n_layers:
        n = min(every, cfg.n_layers - done)
        done += n
        plan += ["mamba"] * n
        if cfg.ssm.attn_every and n == every:
            plan.append("attn")
    return tuple(plan)


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


# the decode cache of one layer of each kind (reference registry.py:
# BlockKind.cache); zamba2's shared block has one per use
KIND_CACHES = {"dense": _attn_cache, "moe": _attn_cache, "attn": _attn_cache,
               "mamba": lambda cfg, batch, length:
                   mamba_cache_init(cfg, batch),
               "mlstm": lambda cfg, batch, length:
                   mlstm_cache_init(cfg, batch),
               "slstm": lambda cfg, batch, length:
                   slstm_cache_init(cfg, batch)}


def stack_cache(cfg: ModelConfig, batch: int, length: int):
    """The decode-cache tree (reference ``registry.py:627-637``): one slab
    per kind in plan order, each leaf stacked (n, ...) over the kind's n
    layers, or its n uses for the shared "attn" kind."""
    plan = layer_plan(cfg)
    return {kind: {name: dataclasses.replace(p, shape=(plan.count(kind),
                                                       *p.shape))
                   for name, p in KIND_CACHES[kind](cfg, batch,
                                                    length).items()}
            for kind in dict.fromkeys(plan)}


def text_labels(batch):
    """(labels, mask): the mask is ``labels >= 0`` in f32 (reference
    ``registry.py:150-152``); the caller clamps the labels at 0."""
    labels = batch["labels"]
    return labels, (labels >= 0).float()


def text_mb_weight(batch) -> torch.Tensor:
    """A microbatch's valid-token count, its weight in the accumulated loss
    and gradient (reference ``registry.py:155-156``)."""
    return (batch["labels"] >= 0).float().sum()


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
    most 0.60x of what the tree's parameters give.  Both copied as they
    are."""
    reason = unported_reason(cfg)
    if reason:
        raise NotImplementedError(reason)
    if cfg.family == Family.SSM:
        return float(ssm_step_flops(cfg, s))
    return float(attn_step_flops(cfg, s))
