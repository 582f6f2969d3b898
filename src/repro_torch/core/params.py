"""Parameter leaves and their native init (port of ``repro/core/params.py``).

A ``Param`` describes one leaf: its global shape, init rule, where the
reference pins one its dtype, and its ``spec``, the reference's
``PartitionSpec`` as a tuple: per dim an axis name, a tuple of names
(first axis major) or None.  The model's tree of Params is
``models.transformer.abstract_params(cfg, layout)``; ``init_params`` turns
such a tree into tensors, each rank's local shard of every leaf
(``shard``); ``gather`` is its inverse, a leaf's global value from the
rank's shard.  It follows the reference's init rules
(``repro/core/params.py:44-66``) in distribution only: its random numbers
come from a ``torch.Generator``, not from ``jax.random``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

from .topology import Layout

import torch

# leaves of more values than this are drawn a leading slice at a time
DRAW_SLICE = 1 << 30


@dataclasses.dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    init: str = "fan_in"        # fan_in | zeros | ones | neg_ones | embed
    fan_axis: int = -2          # contraction axis for fan_in scaling
    scale: float = 1.0
    dtype: Optional[torch.dtype] = None   # None: the model's dtype
    spec: Optional[tuple] = None    # None: replicated on every rank
    # True where the op that reads the leaf sums its gradient over every
    # axis itself (a 3-D island's weight, the embedding table); the train
    # step sums the others' over the axes their spec leaves out
    synced: bool = False
    # model axes over which the activations that read the leaf are
    # replicated (the 1-D baseline's residual stream over 'z'): every rank
    # there already holds the leaf's whole gradient, so the train step
    # does not sum over them
    act_rep: Tuple[str, ...] = ()


def spec_axes(spec) -> Tuple[str, ...]:
    """Every axis name a spec splits a dim over, in order."""
    out = []
    for e in spec or ():
        out.extend((e,) if isinstance(e, str) else (e or ()))
    return tuple(out)


def shard(t: torch.Tensor, spec, layout: Layout) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec``: each
    dim split over its entry's axes, the block at the rank's mixed-radix
    index over them (JAX's ``NamedSharding`` order).  ``t`` itself when
    nothing splits; otherwise a copy, so that the global can be freed."""
    out = t
    for dim, e in enumerate(spec or ()):
        axes = layout.live((e,) if isinstance(e, str) else (e or ()))
        if not axes:
            continue
        n = layout.size(axes)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {axes} of size {n}")
        step = out.shape[dim] // n
        out = out.narrow(dim, layout.index(axes) * step, step)
    return out if out is t else out.clone()


def local_shape(shape, spec, layout: Layout) -> Tuple[int, ...]:
    """The shape of a rank's block of a global ``shape`` under ``spec``
    (what ``shard`` returns, without the global tensor)."""
    out = list(shape)
    for dim, e in enumerate(spec or ()):
        out[dim] //= layout.size(layout.live(
            (e,) if isinstance(e, str) else (e or ())))
    return tuple(out)


def gather(t: torch.Tensor, spec, layout: Layout, dst: int = 0):
    """The global tensor whose block under ``spec`` is this rank's ``t``
    (the inverse of ``shard``), on rank ``dst`` only: every rank sends its
    block there (``comm.gather_to``), which places each at its rank's
    mixed-radix index over each dim's axes; None on the other ranks.
    Every rank of the world calls it."""
    from . import comm
    split = [layout.live((e,) if isinstance(e, str) else (e or ()))
             for e in spec or ()]
    split += [()] * (t.dim() - len(split))
    if not any(split):
        return t if layout.rank == dst else None
    blocks = comm.gather_to(layout, t, dst)
    if blocks is None:
        return None
    out = torch.empty([n * layout.size(axes) for n, axes in
                       zip(t.shape, split)], dtype=t.dtype,
                      device=blocks[0].device)
    for r, b in enumerate(blocks):
        c = layout.coords_of(r)
        at = []
        for n, axes in zip(t.shape, split):
            i = 0
            for a in axes:
                i = i * layout.sizes[a] + c[a]
            at.append(slice(i * n, (i + 1) * n))
        out[tuple(at)] = b
    return out


def sharded_bytes(tree, layout: Layout,
                  dtype: torch.dtype = torch.bfloat16) -> int:
    """Per-rank bytes of a tree of Params under their specs: each leaf's
    global bytes over the product of the sizes of the axes its spec names,
    rounded up (reference ``core/params.py:sharded_bytes``); a leaf that
    pins no dtype counts in ``dtype``.  A host int (an ``OptState``'s
    step, a 0-d int32 Param in the reference and on disk) counts 4 bytes;
    any other leaf none."""
    total = 0
    for p in tree_leaves(tree):
        if isinstance(p, int) and not isinstance(p, bool):
            total += 4
            continue
        if not isinstance(p, Param):
            continue
        n = -(-math.prod(p.shape) // layout.size(spec_axes(p.spec)))
        total += n * (p.dtype or dtype).itemsize
    return total


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_zip(tree, *others):
    """(leaf, *the others' entries at its path) for every leaf of ``tree``
    (nested dicts), in ``tree_leaves`` order; each other tree is indexed
    by the same keys, so that its own key order does not matter, and may
    hold anything at a leaf's path (a dict of Adafactor's stats)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_zip(v, *(o[k] for o in others))
    else:
        yield (tree, *others)


def tree_leaves(tree):
    """The leaves of a tree as JAX flattens one: dicts, lists, tuples and
    NamedTuples (an ``OptState``) are nodes, None an empty subtree, and
    anything else (a Param, a tensor, the optimizer's step) a leaf; in
    insertion order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def stack_tree(tree, n: int, shard: Optional[str] = None):
    """A tree of Params with a leading dim of ``n`` on every leaf: ``n``
    layers' stacked slab (reference ``core/params.py:stack_tree``), the
    new dim split over the axis ``shard`` (``"pp"``: the pipeline's
    stages), or unsplit."""
    def one(p):
        spec = p.spec
        if shard is not None or spec is not None:
            spec = (shard, *(spec or ()))
        return dataclasses.replace(p, shape=(n, *p.shape), spec=spec)
    return tree_map(one, tree)


def unstack(tree, n: int):
    """The ``n`` per-layer trees of a stacked tree of tensors, one unbind
    per leaf, whose backward is a single stack (indexing a layer out of a
    stack would build a full-size zero gradient per layer)."""
    parts = tree_map(torch.unbind, tree)
    return [tree_map(lambda t, i=i: t[i], parts) for i in range(n)]


def init_params(abstract, generator: torch.Generator, device,
                dtype: torch.dtype = torch.bfloat16,
                layout: Optional[Layout] = None):
    """Random weights for a tree of Params, such as
    ``transformer.abstract_params(cfg)``, drawn from ``generator``
    (which must live on ``device``; None for a tree of constants, such as
    a decode cache): N(0, scale) for embeddings, N(0, scale / sqrt(fan_in))
    for weights, ones and zeros for norms, -1 for cache positions.  Leaves
    are in ``dtype`` except those whose Param pins its own.  A leaf of more
    than ``DRAW_SLICE`` values is drawn one slice of its first dim at a
    time.  With a ``layout``, every global leaf is drawn in turn and the
    rank keeps its shard, so that every world size holds one model."""
    def one(p: Param) -> torch.Tensor:
        t = full(p)
        return t if layout is None else shard(t, p.spec, layout)

    def full(p: Param) -> torch.Tensor:
        dt = p.dtype or dtype
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dt, device=device)
        if p.init == "neg_ones":
            return torch.full(p.shape, -1, dtype=dt, device=device)
        std = p.scale
        if p.init == "fan_in":
            std = p.scale / math.sqrt(max(p.shape[p.fan_axis], 1))
        return _draw(p.shape, std, dt, generator, device)
    return tree_map(one, abstract)


def _draw(shape, std: float, dt, generator, device):
    """N(0, std) of ``shape`` in ``dt``: a leaf of more than ``DRAW_SLICE``
    values is drawn one leading slice at a time, recursively, so the f32
    draw never holds more than a slice (mixtral's 16-layer w1 is 7.5G
    values, 30 GB in f32 at once; one deepseek-v3 MoE layer's is 3.76G)."""
    if math.prod(shape) <= DRAW_SLICE or len(shape) < 2:
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * std).to(dt)
    out = torch.empty(shape, dtype=dt, device=device)
    for i in range(shape[0]):
        out[i] = _draw(shape[1:], std, dt, generator, device)
    return out
