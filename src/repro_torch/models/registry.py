"""The dense family's hooks of ``repro/models/registry.py`` that the port's
training path needs: the loss labels and mask, the microbatch weight, and
the train-FLOPs estimate that is the MFU numerator (``obs/telemetry.py``).
The reference module imports jax, so the port keeps its own copies;
``tests/test_torch_train.py`` holds them equal to the originals.
"""
from __future__ import annotations

import torch

from ..config import Family, ModelConfig


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


def train_flops_per_token(cfg: ModelConfig, s: int) -> float:
    """Model FLOPs spent per trained token (reference
    ``registry.py:492-494``); the port trains the dense family only."""
    if cfg.family != Family.DENSE:
        raise NotImplementedError(
            f"{cfg.arch}: family {cfg.family.value!r} is not ported yet "
            "(ROADMAP.md, Queue 1 item 10)")
    return float(attn_step_flops(cfg, s))
