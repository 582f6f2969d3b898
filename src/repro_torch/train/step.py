"""The train step (port of ``repro/train/step.py:make_train_step`` at
pp = 1): one optimizer step per call,

  * microbatches == 1: one forward and backward over the whole batch;
  * microbatches  > 1: f32 gradient accumulation over equal microbatches,
    each weighted by its valid-token count (``registry.text_mb_weight``),
    so the loss and gradient equal the single-shot path's global token
    mean.

``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``;
the parameters are updated in place.  The gradient of every leaf comes from
``torch.autograd.grad`` over a detached view of it, so the caller's
parameters never carry autograd state.
"""
from __future__ import annotations

import torch

from ..config import ModelConfig, OptimConfig
from ..core.params import tree_leaves, tree_map
from ..core.plan import MULTI_RANK_TODO
from ..core.topology import Layout
from ..models import transformer
from ..models.registry import text_mb_weight
from ..optim import make_optimizer


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _split_microbatches(batch, m: int):
    """m consecutive slices of the batch dim, in order."""
    for a in batch.values():
        if a.shape[0] % m:
            raise ValueError(
                f"batch dim {a.shape[0]} not divisible by microbatches {m}")
    n = next(iter(batch.values())).shape[0] // m
    return [{k: a[i * n:(i + 1) * n] for k, a in batch.items()}
            for i in range(m)]


def make_train_step(cfg: ModelConfig, layout: Layout, opt_cfg: OptimConfig):
    if layout.n_devices != 1:
        raise NotImplementedError(MULTI_RANK_TODO)
    update = make_optimizer(opt_cfg, layout)
    m = max(layout.microbatches, 1)

    def value_and_grad(params, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = transformer.forward(cfg, layout, live, batch,
                                            mode="train")
        grads = torch.autograd.grad(loss, tree_leaves(live))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state, batch):
        if m == 1:
            loss, metrics, grads = value_and_grad(params, batch)
        else:
            gacc = lacc = wacc = None
            macc = {}
            for mb in _split_microbatches(batch, m):
                w = text_mb_weight(mb)
                loss_i, met, g = value_and_grad(params, mb)
                g = [w * gi.float() for gi in g]
                gacc = g if gacc is None else [a + b for a, b in zip(gacc, g)]
                lacc = w * loss_i if lacc is None else lacc + w * loss_i
                wacc = w if wacc is None else wacc + w
                macc = {k: macc.get(k, 0.0) + w * v for k, v in met.items()}
            wsum = wacc.clamp_min(1.0)
            loss = lacc / wsum
            metrics = {k: v / wsum for k, v in macc.items()}
            grads = [(g / wsum).to(p.dtype)
                     for g, p in zip(gacc, tree_leaves(params))]
        params, opt_state, opt_metrics = update(
            params, _unflatten(params, grads), opt_state)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step
