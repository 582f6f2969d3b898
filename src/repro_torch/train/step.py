"""The train step (port of ``repro/train/step.py:make_train_step``): one
optimizer step per call,

  * pp > 1: one call of the pipelined forward and backward
    (``transformer.forward_pipelined``), which microbatches inside the
    schedule; no outer accumulation loop (reference ``step.py:42-43``,
    ``:77-80``);
  * microbatches == 1: one forward and backward over the whole batch;
  * microbatches  > 1: f32 gradient accumulation over equal microbatches,
    each weighted by the sum of its loss mask (the family's
    ``Stack.mb_weight``: its valid-token count; every text position for
    the VLM family), so the
    loss and gradient equal the single-shot path's global token mean; the
    metrics too, the MoE router losses (``aux``) among them, as
    the reference weights them (``step.py:87-112``).

``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``;
the parameters are updated in place.  The gradient of every leaf comes from
``torch.autograd.grad`` over a detached view of it, so the caller's
parameters never carry autograd state.

Above one device (the dense family, on a 3-D layout or a 1-D or 2-D
baseline's, in pp stages or not; the MoE family at pp 1) ``params``, the
optimizer state and ``batch`` are the rank's shards.  The linears sum
their weights' gradients themselves (``Param.synced``); every other leaf
(the norms' gains and biases, qk-norm, the router and the experts) has
its gradient summed over every axis but pp that its spec does not split
and its activations do not replicate (``leaf_sync_axes``), as GSPMD sums
it in the reference (for an expert leaf stored over 'dp', the FFN's
gather sums it over dp itself, and the spec names dp).  A leaf
replicated over the pp stages (the embedding, the head, ``ln_f``), whose
gradient each stage holds a part of (stage 0 the embedding's, the last
stage the head's), is summed over pp too; the stage slabs, split over
pp, are not.  The microbatch weights are summed
over the axes that split the labels, so that each is the microbatch's
global token count.

At ZeRO stage 2 (``Layout.effective_zero_stage()``) each microbatch's
summed gradient is narrowed onto the rank's ZeRO block (``optim.
zero_block``) before it is accumulated, so that the f32 buffer holds
1/(pod*dp) of the leaf, and the optimizer takes the gradients on those
blocks (reference ``step.py:46-66``, ``:94-97``).  The gradient is still
summed over the data axes whole, as the reference's islands sum it.
"""
from __future__ import annotations

import torch

from ..config import ModelConfig, OptimConfig
from ..core import comm
from ..core.params import spec_axes, tree_leaves, tree_map, tree_zip
from ..core.plan import multi_rank_refusal
from ..core.topology import AXES, Layout
from ..models import transformer
from ..models.registry import get_stack
from ..optim import make_optimizer
from ..optim.optimizers import zero_block, zero_dim


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


def leaf_sync_axes(p, layout: Layout):
    """The axes a leaf's gradient is summed over after the backward: pp
    for a leaf its spec does not split over pp (each stage holds a part of
    its gradient); besides, none for a leaf whose op syncs it
    (``Param.synced``), else every other axis of size > 1 that its spec
    does not split and over which its activations are not replicated
    (``Param.act_rep``: at 1d the norms' gains and the row linear's bias,
    whose gradient every rank of 'z' already holds whole)."""
    axes = spec_axes(p.spec)
    pp = () if "pp" in axes else ("pp",)
    if p.synced:
        return layout.live(pp)
    skip = {"pp", *axes, *p.act_rep}
    return layout.live(tuple(a for a in AXES if a not in skip
                             or a in pp))


def loss_and_grads(cfg: ModelConfig, layout: Layout, params, batch,
                   sync=None):
    """(loss, metrics, the gradient of every leaf in ``tree_leaves``
    order) of the rank's shard of a batch, each leaf's gradient summed over
    its ``leaf_sync_axes`` (``sync``: those axes per leaf, computed once by
    the caller; None computes them)."""
    if sync is None:
        sync = [leaf_sync_axes(p, layout) for p in
                tree_leaves(transformer.abstract_params(cfg, layout))]
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    if layout.size("pp") > 1:
        loss, metrics, grads = transformer.forward_pipelined(
            cfg, layout, live, batch, leaves=leaves)
        grads = [g.to(t.dtype) for g, t in zip(grads, leaves)]
    else:
        loss, metrics = transformer.forward(cfg, layout, live, batch,
                                            mode="train")
        grads = torch.autograd.grad(loss, leaves)
    grads = [comm.psum(layout, g, ax) if ax else g
             for g, ax in zip(grads, sync)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, layout: Layout, opt_cfg: OptimConfig):
    err = multi_rank_refusal(layout.n_devices, cfg=cfg,
                             n_stages=layout.size("pp"))
    if err:
        raise NotImplementedError(err)
    abstract = transformer.abstract_params(cfg, layout)
    update = make_optimizer(opt_cfg, layout, abstract)
    m = max(layout.microbatches, 1)
    sync = [leaf_sync_axes(p, layout) for p in tree_leaves(abstract)]
    label_axes = transformer.loss_axes(layout, transformer.entry_dirs())
    zero2 = layout.effective_zero_stage() >= 2
    zdim_tree = tree_map(lambda p: zero_dim(p, layout) if zero2 else None,
                         abstract)

    def value_and_grad(params, batch):
        return loss_and_grads(cfg, layout, params, batch, sync)

    pipelined = layout.size("pp") > 1

    def train_step(params, opt_state, batch):
        # each leaf's ZeRO dim at stage 2 (else None), in params' order
        zdims = [zd for _, zd in tree_zip(params, zdim_tree)]
        if m == 1 or pipelined:     # the pipeline microbatches inside
            loss, metrics, grads = value_and_grad(params, batch)
            grads = [g if zd is None else zero_block(g, zd, layout).clone()
                     for g, zd in zip(grads, zdims)]
        else:
            gacc = lacc = wacc = None
            macc = {}
            for mb in _split_microbatches(batch, m):
                w = comm.psum(layout, get_stack(cfg.family).mb_weight(
                    cfg, mb), label_axes)
                loss_i, met, g = value_and_grad(params, mb)
                g = [w * zero_block(gi, zd, layout).float()
                     for gi, zd in zip(g, zdims)]
                gacc = g if gacc is None else [a + b for a, b in zip(gacc, g)]
                lacc = w * loss_i if lacc is None else lacc + w * loss_i
                wacc = w if wacc is None else wacc + w
                macc = {k: macc.get(k, 0.0) + w * v for k, v in met.items()}
            wsum = wacc.clamp_min(1.0)
            loss = lacc / wsum
            metrics = {k: v / wsum for k, v in macc.items()}
            grads = [(g / wsum).to(p.dtype)
                     for g, p in zip(gacc, tree_leaves(params))]
        # a profiler range, so that a trace tells the update's kernels
        # from the backward's (chip_smoke.py phase 22)
        with torch.profiler.record_function("optimizer"):
            params, opt_state, opt_metrics = update(
                params, _unflatten(params, grads), opt_state)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step
