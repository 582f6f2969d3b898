"""AdamW with ZeRO over the data axes, and Adafactor (port of
``repro/optim/optimizers.py``).

AdamW follows the reference's ``adamw_update`` (``optimizers.py:207-248``):
f32 moments, bias correction at ``step + 1``, decoupled weight decay on
leaves with ``ndim >= 2`` (the stacked norm gains included, as there), the
parameter updated in f32 and cast back.  The port updates parameters and
moments in place, one layer slice of a stacked leaf at a time, so the f32
temporaries live for one slice (the reference scans big leaves for the
same reason).  The global norm of the clip sums each leaf's squares over
the axes its spec splits it on, so that a replicated leaf counts once.

ZeRO (``Layout.effective_zero_stage()``), the reference's contract:

  * stage 0: every rank updates its parameter shards and holds their
    moments, every replica of a shard alike;
  * stage >= 1: each moment lives on ``zero_partition_spec``, the
    parameter's spec with the data axes (pod, dp) appended to the largest
    dim they divide, after the dim's own axes, so that the rank's block is
    block ``index(("pod", "dp"))`` of its parameter shard along that dim.
    Each rank updates that block of the parameter and of the moments, then
    all-gathers the parameter over the data axes back to its own spec; the
    moments never leave their shard.  A leaf no dim of which divides stays
    on its own spec, its state replicated;
  * stage 2: the gradients arrive on those shards already (the train
    step accumulates them there, ``train/step.py``).

Adafactor (``optimizers.py:250-293``) keeps no first moment and, for a
leaf of 2 or more dims and 4096 or more values, the means of the squared
gradient over its last and second-to-last dims (``row``, ``col``) in place
of the second moment; smaller leaves keep it whole.  Its stats stay on the
parameter's specs at every stage.  Whether a leaf is factored, and whether
it is updated one layer slice at a time (a stacked leaf of more than
``_BIG_LEAF_BYTES`` in f32, which then takes its rms clip per slice), are
decided from the leaf's global shape.  Above one device each mean is a
local sum, summed over the axes that split the dims it runs over and
divided by the global count.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..config import OptimConfig
from ..core import comm
from ..core.params import (Param, local_shape, spec_axes, tree_leaves,
                           tree_map, tree_zip)
from ..core.topology import Layout

F32 = torch.float32
# stacked leaves above this many bytes in f32 take Adafactor's update (and
# its rms clip) one layer slice at a time (reference optimizers.py:169)
_BIG_LEAF_BYTES = 2 ** 28


class OptState(NamedTuple):
    step: int       # optimizer steps taken (host counter)
    m: Any          # AdamW's first moment, f32; None for Adafactor
    v: Any          # AdamW's second moment; Adafactor's stats


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


def clip_by_global_norm(grads, max_norm: float, layout: Layout = None,
                        split=None):
    """Scale every gradient by min(1, max_norm / |g|); the norm is taken in
    f32 and the scale cast to each gradient's dtype (reference
    ``optimizers.py:76-82``).  Above one device the gradients are the
    rank's shards and ``split``, a tree of the gradients' keys, holds for
    each leaf the axes that split it: the squares of the leaves split
    alike are summed over those axes, in one ``psum`` a group.  Returns
    (clipped tree, global norm)."""
    if layout is None or layout.n_devices == 1:
        gn = torch.sqrt(sum((g.float() ** 2).sum()
                            for g in tree_leaves(grads)))
    else:
        groups = {}
        for g, ax in tree_zip(grads, split):
            groups.setdefault(layout.live(ax), []).append(
                (g.float() ** 2).sum())
        gn = torch.sqrt(sum(comm.psum(layout, torch.stack(sq).sum(), ax)
                            for ax, sq in groups.items()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


# ---------------------------------------------------------------------------
# state specs (ZeRO: the param's spec extended by the data axes)
# ---------------------------------------------------------------------------
def _padded(p: Param) -> list:
    spec = list(p.spec or ())
    return spec + [None] * (len(p.shape) - len(spec))


def zero_dim(p: Param, layout: Layout) -> Optional[Tuple[int,
                                                         Tuple[str, ...]]]:
    """(dim, data axes) of a leaf's ZeRO shard: the largest dim that the
    data axes of size > 1 divide evenly after the dim's own axes (the
    first of equal dims); None when the data degree is 1, when the spec
    already names a data axis, or when no dim divides (reference
    ``optimizers.py:88-123``)."""
    data_axes = tuple(a for a in ("pod", "dp") if layout.size(a) > 1)
    d = layout.size(data_axes)
    spec = _padded(p)
    if d <= 1 or set(spec_axes(spec)) & set(data_axes):
        return None
    for i in sorted(range(len(p.shape)), key=lambda i: -p.shape[i]):
        if p.shape[i] % (layout.size(spec[i]) * d) == 0:
            return i, data_axes
    return None


def zero_partition_spec(p: Param, layout: Layout):
    """The ZeRO shard spec of one parameter's optimizer state: its own
    spec with the data axes attached to ``zero_dim`` (after the dim's own
    axes), or its own spec when ``zero_dim`` is None."""
    zd = zero_dim(p, layout)
    if zd is None:
        return p.spec
    i, axes = zd
    spec = _padded(p)
    e = spec[i]
    if e is None:
        spec[i] = axes if len(axes) > 1 else axes[0]
    elif isinstance(e, str):
        spec[i] = (e, *axes)
    else:
        spec[i] = tuple(e) + axes
    return tuple(spec)


def zero_block(t: torch.Tensor, zd, layout: Layout) -> torch.Tensor:
    """The rank's ZeRO block (a view) of its shard ``t`` of a leaf whose
    ``zero_dim`` is ``zd``: block ``index(data axes)`` along that dim."""
    if zd is None:
        return t
    dim, axes = zd
    n = t.shape[dim] // layout.size(axes)
    return t.narrow(dim, layout.index(axes) * n, n)


def _factored(shape) -> bool:
    return len(shape) >= 2 and math.prod(shape) >= 4096


def _scanned(shape) -> bool:
    return (len(shape) >= 3 and shape[0] > 1
            and math.prod(shape) * 4 > _BIG_LEAF_BYTES)


def opt_state_abstract(param_tree, layout: Layout,
                       cfg: OptimConfig) -> OptState:
    """The optimizer state as a tree of Params (f32 zeros) on the specs of
    the layout's ZeRO stage (reference ``optimizers.py:126-154``): AdamW's
    moments on ``zero_partition_spec`` at stage >= 1, else on the
    parameter's spec; Adafactor's stats on the parameter's spec, a
    factored leaf's ``row`` and ``col`` on the spec without its last and
    second-to-last entries.  The step is the host's int 0."""
    zero = layout.effective_zero_stage() >= 1

    def zeros(shape, spec):
        return Param(tuple(shape), init="zeros", dtype=F32, spec=spec)

    if cfg.name == "adafactor":
        def vstat(p: Param):
            if not _factored(p.shape):
                return zeros(p.shape, p.spec)
            spec = _padded(p) if p.spec is not None else None
            return {"row": zeros(p.shape[:-1],
                                 spec and tuple(spec[:-1])),
                    "col": zeros(p.shape[:-2] + p.shape[-1:],
                                 spec and tuple(spec[:-2] + spec[-1:]))}
        return OptState(0, None, tree_map(vstat, param_tree))

    def moment(p: Param):
        return zeros(p.shape, zero_partition_spec(p, layout) if zero
                     else p.spec)
    return OptState(0, tree_map(moment, param_tree),
                    tree_map(moment, param_tree))


def adamw_init(params, layout: Layout, param_tree,
               cfg: Optional[OptimConfig] = None) -> OptState:
    """The optimizer's zero state on ``params``' device: the rank's block
    of every leaf of ``opt_state_abstract(param_tree, layout, cfg)``
    (AdamW when ``cfg`` is None), ``param_tree`` being the model's tree
    of Params under ``layout``."""
    device = tree_leaves(params)[0].device
    abstract = opt_state_abstract(param_tree, layout, cfg or OptimConfig())

    def zeros(p: Param):        # the rank's block of the leaf
        return torch.zeros(local_shape(p.shape, p.spec, layout),
                           dtype=p.dtype, device=device)
    return OptState(abstract.step, None if abstract.m is None else
                    tree_map(zeros, abstract.m), tree_map(zeros, abstract.v))


# ---------------------------------------------------------------------------
# updates
# ---------------------------------------------------------------------------
def make_optimizer(cfg: OptimConfig, layout: Layout,
                   param_tree) -> Callable:
    """``update(params, grads, state) -> (params, state, {"lr", "gnorm"})``;
    params and state are updated in place and returned: Adafactor when
    ``cfg.name`` is "adafactor", else AdamW, as the reference chooses.
    ``param_tree``, the model's tree of Params under ``layout``, gives the
    leaves' global shapes and specs; the state comes from ``adamw_init``
    on the same tree.  At ZeRO stage 2 the gradient of each leaf with a
    ``zero_dim`` arrives on its ZeRO block."""
    stage = layout.effective_zero_stage()
    # per leaf, by the parameters' keys: (its Param, its zero_dim)
    info = tree_map(lambda p: (p, zero_dim(p, layout) if stage >= 1
                               else None), param_tree)
    split = None
    if layout.n_devices != 1:       # the axes that split each gradient
        split = tree_map(lambda p: spec_axes(
            zero_partition_spec(p, layout) if stage >= 2 else p.spec),
            param_tree)
    sched = make_schedule(cfg)
    if cfg.name == "adafactor":
        return _adafactor(cfg, layout, info, stage, split, sched)
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
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, layout,
                                           split)
        bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
        for p, g, m, v, (_, zd) in tree_zip(params, grads, state.m, state.v,
                                            info):
            decay = p.dim() >= 2 and bool(cfg.weight_decay)
            pz = zero_block(p, zd, layout)
            gz = g if stage >= 2 else zero_block(g, zd, layout)
            if m.shape != pz.shape:
                raise ValueError(
                    f"optimizer state of shape {tuple(m.shape)} for a "
                    f"parameter block of {tuple(pz.shape)} at ZeRO stage "
                    f"{stage}: the state was built for another layout")
            if p.dim() >= 3:        # a stacked leaf: one layer at a time
                for sl in zip(pz.unbind(0), gz.unbind(0), m.unbind(0),
                              v.unbind(0)):
                    upd_one(*sl, lr, bc1, bc2, decay)
            else:
                upd_one(pz, gz, m, v, lr, bc1, bc2, decay)
            if zd is not None:      # the updated blocks back to the shard
                p.copy_(comm.all_gather(layout, pz, zd[1], zd[0]))
        return params, OptState(step, state.m, state.v), \
            {"lr": lr, "gnorm": gnorm}

    return update


def _adafactor(cfg: OptimConfig, layout: Layout, info, stage: int, split,
               sched) -> Callable:
    """Adafactor's update (reference ``optimizers.py:250-293``) over the
    rank's parameter shards; see the module docstring."""
    b2, d = cfg.b2, 1 - cfg.b2

    def axes(e):
        return layout.live((e,) if isinstance(e, str) else (e or ()))

    def upd_one(p, g, v, decay, lr, ax_r, ax_c, n_r, n_c, ax_all, n_all):
        """One leaf or layer slice: ``ax_c``/``n_c`` split and count its
        last dim, ``ax_r``/``n_r`` its second-to-last, ``ax_all``/``n_all``
        the whole."""
        gf = g.float()
        if isinstance(v, dict):
            g2 = gf * gf + 1e-30
            row = v["row"].mul_(b2).add_(
                comm.psum(layout, g2.sum(-1), ax_c) * (d / n_c))
            col = v["col"].mul_(b2).add_(
                comm.psum(layout, g2.sum(-2), ax_r) * (d / n_r))
            del g2
            rmean = comm.psum(layout, row.sum(-1, keepdim=True), ax_r) / n_r
            inv = torch.rsqrt((row / rmean)[..., None] * col[..., None, :]
                              + cfg.eps)
        else:
            v.mul_(b2).add_((gf * gf + 1e-30) * d)
            inv = torch.rsqrt(v + cfg.eps)
        u = gf.mul_(inv)
        del inv
        rms = torch.sqrt(comm.psum(layout, (u * u).sum(), ax_all) / n_all
                         + 1e-30)
        u.mul_(lr / torch.clamp(rms, min=1.0))
        pf = p.float()
        if decay:
            pf.mul_(1 - decay)
        p.copy_((pf - u).to(p.dtype))

    @torch.no_grad()
    def update(params, grads, state: OptState):
        step = state.step + 1
        lr = sched(step)
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, layout,
                                           split)
        for p, g, v, (pa, zd) in tree_zip(params, grads, state.v, info):
            if stage >= 2 and zd is not None:   # back to the whole shard
                g = comm.all_gather(layout, g, zd[1], zd[0])
            spec, shape = _padded(pa), pa.shape
            decay = (cfg.weight_decay * lr
                     if len(shape) >= 2 and cfg.weight_decay else 0.0)
            ax_r = axes(spec[-2]) if len(shape) >= 2 else ()
            ax_c = axes(spec[-1]) if shape else ()
            n_r = shape[-2] if len(shape) >= 2 else 1
            n_c = shape[-1] if shape else 1
            if _scanned(shape):
                ax_all = layout.live(spec_axes(spec[1:]))
                n_all = math.prod(shape[1:])
                for j in range(p.shape[0]):
                    vj = ({k: t[j] for k, t in v.items()}
                          if isinstance(v, dict) else v[j])
                    upd_one(p[j], g[j], vj, decay, lr, ax_r, ax_c, n_r, n_c,
                            ax_all, n_all)
            else:
                upd_one(p, g, v, decay, lr, ax_r, ax_c, n_r, n_c,
                        layout.live(spec_axes(spec)), math.prod(shape))
        return params, OptState(step, None, state.v), \
            {"lr": lr, "gnorm": gnorm}

    return update

