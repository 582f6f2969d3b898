"""The pipeline schedule over the pp stages (port of
``repro/core/pipeline.py``).

The reference runs every stage in one program: a ``lax.scan`` of ``m +
pp - 1`` ticks in which all stages compute at once (a ``vmap`` over the
stage dim, stage s on microbatch t - s at tick t) and a ``ppermute``
moves the state from stage s to s + 1; reverse-mode differentiation of
the scan is the backward pipeline, the synchronous "1F1B-equivalent"
schedule whose bubble is (pp - 1) / m.  Warm-up and flush ticks carry
garbage that a weight of 0 masks out.

Here each rank is one stage and runs only its own part of the same
ticks: in the forward, at tick t, microbatch i = t - s, received from
stage s - 1 (``comm.recv``; stage 0 takes its feed), run through the
stage's slots and sent on to stage s + 1 by ``comm.send_ad``, whose
backward receives the gradient back; the last stage hands each output to
the head (``collect_fn``).  Then every microbatch backward in reverse
order, the last stage first, each seeded by the caller's weight, and
the activation's gradient sent to stage s - 1.  A tick with no
microbatch for the stage computes nothing.  Every rank issues its sends
and receives in the order of the ticks, which its neighbours share, so
blocking point-to-point calls cannot deadlock.

A 1F1B interleaving (each stage alternating forwards and backwards once
warm) would hold fewer microbatches' activations at once; it is later
work, for speed.  The gradients equal the reference's either way.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from . import comm
from .topology import Layout, bubble_fraction, pipeline_efficiency


def pipeline_schedule(layout: Layout, *, m: int,
                      feed: Optional[Sequence[torch.Tensor]],
                      stage_fn: Callable, collect_fn: Callable, like,
                      leaves: Optional[Sequence[torch.Tensor]] = None,
                      seeds: Optional[Sequence] = None):
    """Run this rank's stage of the schedule over ``m`` microbatches.

    feed:       stage 0's microbatch activations (tensors requiring grad
                when there is a backward); None on the other stages
    stage_fn:   x -> y, the rank's stage slots
    collect_fn: (i, y) -> the 0-d loss of microbatch i (last stage)
    like:       (shape, dtype, device) of one microbatch's activation at
                the stage boundary
    leaves:     the parameter tensors to differentiate; None runs the
                forward only, without autograd
    seeds:      the last stage's seed of microbatch i's backward

    Returns (outs, grads, dfeed): the m losses on the last stage (else
    []), the f32 sum over the microbatches of each leaf's gradient (zeros
    for a leaf the stage does not read) or None, and stage 0's gradient
    of each feed tensor (else None)."""
    pp, s = layout.size("pp"), layout.index("pp")
    last, grad = s == pp - 1, leaves is not None
    xs: List = [None] * m
    roots: List = [None] * m
    outs: List = []
    for t in range(m + pp - 1):           # forward ticks
        i = t - s
        if not 0 <= i < m:
            continue
        if s == 0:
            x = feed[i]
        else:
            x = comm.recv(layout, *like).requires_grad_(grad)
        xs[i] = x
        with torch.set_grad_enabled(grad):
            y = stage_fn(x)
            roots[i] = collect_fn(i, y) if last else comm.send_ad(layout, y)
        if last:
            outs.append(roots[i])
    if not grad:
        return outs, None, None
    acc: List = [None] * len(leaves)
    dfeed: List = [None] * m
    for t in range(m + pp - 1):           # backward ticks, last stage first
        i = m - 1 - (t - (pp - 1 - s))
        if not 0 <= i < m:
            continue
        root = roots[i]
        seed = (torch.as_tensor(seeds[i], dtype=root.dtype,
                                device=root.device) if last
                else torch.ones_like(root))
        *gs, dx = torch.autograd.grad(root, [*leaves, xs[i]],
                                      grad_outputs=seed, allow_unused=True)
        for j, g in enumerate(gs):
            if g is not None:
                acc[j] = g.float() if acc[j] is None else acc[j] + g.float()
        if s > 0:
            comm.send(layout, dx, back=True)
        else:
            dfeed[i] = dx
        xs[i] = roots[i] = None
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             if a is None else a for a, p in zip(acc, leaves)]
    return [o.detach() for o in outs], grads, dfeed if s == 0 else None


def pipeline_report(n_stages: int, microbatches: int) -> dict:
    """The schedule's ticks, bubble and efficiency (reference
    ``pipeline.py:190-198``)."""
    m = max(microbatches, 1)
    return {
        "n_stages": n_stages,
        "microbatches": m,
        "ticks": m + n_stages - 1,
        "bubble_fraction": bubble_fraction(n_stages, m),
        "efficiency": pipeline_efficiency(n_stages, m),
    }
