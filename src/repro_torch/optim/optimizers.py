"""AdamW (port of ``repro/optim/optimizers.py`` at ZeRO stage 0).

The update follows the reference's ``adamw_update`` (``optimizers.py:207-248``):
f32 moments, bias correction at ``step + 1``, decoupled weight decay on
leaves with ``ndim >= 2`` (the stacked norm gains included, as there), the
parameter updated in f32 and cast back.  The port updates parameters and
moments in place, one layer slice of a stacked leaf at a time, so the f32
temporaries live for one slice (the reference scans big leaves for the
same reason).  ZeRO above stage 0 and Adafactor are not ported
(ROADMAP.md, Queue 1 item 6).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..config import OptimConfig
from ..core.params import tree_leaves, tree_map
from ..core.topology import Layout


class OptState(NamedTuple):
    step: int       # optimizer steps taken (host counter)
    m: Any          # first moment, f32, the parameter tree's shape
    v: Any          # second moment


def make_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """Learning rate at a step: linear warm-up, then cosine, linear or
    constant decay (reference ``optimizers.py:58-73``)."""
    def sched(step: int) -> float:
        warm = min(step / max(cfg.warmup, 1), 1.0)
        t = min(max((step - cfg.warmup) / max(cfg.total_steps - cfg.warmup,
                                              1), 0.0), 1.0)
        if cfg.schedule == "cosine":
            decay = 0.5 * (1 + math.cos(math.pi * t))
        elif cfg.schedule == "linear":
            decay = 1 - t
        else:
            decay = 1.0
        return cfg.lr * warm * decay
    return sched


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / |g|); the norm is taken in
    f32 and the scale cast to each gradient's dtype (reference
    ``optimizers.py:76-82``).  Returns (clipped tree, global norm)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum((g.float() ** 2).sum() for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def adamw_init(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return OptState(0, tree_map(zeros, params), tree_map(zeros, params))


def make_optimizer(cfg: OptimConfig, layout: Layout) -> Callable:
    """``update(params, grads, state) -> (params, state, {"lr", "gnorm"})``;
    params and state are updated in place and returned."""
    if cfg.name != "adamw":
        raise NotImplementedError(
            f"optimizer {cfg.name!r}: only AdamW is ported (Adafactor: "
            "ROADMAP.md, Queue 1 item 6)")
    if layout.n_devices != 1:
        raise NotImplementedError(
            "AdamW over more than one device (ZeRO over dp) is not ported: "
            "ROADMAP.md, Queue 1 item 6")
    sched = make_schedule(cfg)
    b1, b2 = cfg.b1, cfg.b2

    def upd_one(p, g, m, v, lr, bc1, bc2, decay):
        gf = g.float()
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_(gf * gf * (1 - b2))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        if decay:
            delta = delta + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))

    @torch.no_grad()
    def update(params, grads, state: OptState):
        step = state.step + 1
        lr = sched(step)
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.m), tree_leaves(state.v)):
            decay = p.dim() >= 2 and bool(cfg.weight_decay)
            if p.dim() >= 3:        # a stacked leaf: one layer at a time
                for sl in zip(p.unbind(0), g.unbind(0), m.unbind(0),
                              v.unbind(0)):
                    upd_one(*sl, lr, bc1, bc2, decay)
            else:
                upd_one(p, g, m, v, lr, bc1, bc2, decay)
        return params, OptState(step, state.m, state.v), \
            {"lr": lr, "gnorm": gnorm}

    return update
