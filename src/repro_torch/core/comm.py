"""The 3-D islands' collectives over named mesh axes (the port's stand-in
for ``lax.all_gather`` / ``lax.psum`` / ``lax.psum_scatter`` /
``lax.pmax`` / ``lax.axis_index`` inside the reference's ``shard_map``
islands), over ``torch.distributed`` process groups.

``axis`` is one name of ``topology.AXES``, a tuple of them, or None.  At
axis size 1 each collective is the identity (the tiled all-gather and
reduce-scatter of one shard are that shard) and touches no process group,
so the one-device paths never call ``torch.distributed``.

Above size 1 the layout must carry the ``Groups`` that ``init`` builds:
for every set of the layout's axes of size > 1, the group of the ranks
that share this rank's coordinates on every other axis.  Every rank
creates every group, in one order, as ``new_group`` requires.  A group's
members are ordered by global rank; JAX orders a tiled collective over an
axis tuple by the mixed-radix index with the first axis major, so a gather
over ``("y", "x")`` (y major, while the global rank has x major) permutes
the gathered blocks, and a reduce-scatter the blocks it sends.

Backends: NCCL when each rank has a card of its own; gloo for CPU tensors,
and for ranks that share one card (NCCL refuses two ranks on a device), in
which case each CUDA tensor is copied to the host for the collective and
back (``Groups.staged``).  The backend is the caller's choice and is never
switched on failure.

``all_gather_start`` and ``psum_scatter_start`` start the two island
collectives and return a ``Pending`` whose ``wait()`` gives their result
(``async_op=True``; over NCCL ``wait`` orders the consumer's stream
after the collective's), so that the async-TP chunks of ``ops3d`` keep a
collective in flight while a product runs; their bytes are counted when
they start.

The plain functions carry no autograd.  ``all_gather_ad``, ``psum_ad``,
``psum_id`` and ``grad_psum`` are differentiable, with the transposes the
islands need: a gather's is a reduce-scatter; a sum whose result each
rank uses in its own way (a norm's moments over the split hidden dim) has
a sum as its transpose; a sum whose result every rank then uses
identically (the loss and the vocab-parallel softmax's sums) has the
identity, since each rank already seeds the gradient of the whole; and a
replicated tensor that each rank reads in its own way (the kv heads that
the attention island slices) sums its gradient.

``all_to_all`` is ``lax.all_to_all(..., tiled=True)``: the expert
exchange of ``models/moe.py``, over one axis or a tuple (JAX's order,
permuted as the gather's); ``all_to_all_ad``'s backward is the reverse
exchange.

Point to point, ``send`` and ``recv`` move a tensor between neighbouring
pipeline stages over the pp group (the ``("pp",)`` key of ``Groups``),
staged through the host like the collectives; ``send_ad`` is the
differentiable boundary of a stage, whose forward sends the activation
to the next stage and whose backward receives its gradient from there.
A failed send or receive raises.

Every collective issued adds the bytes that the ring model says it moves
per device, by kind, to a counter (the reference's
``launch/hlo_cost.py:230-239``, n the group's size): an all-gather
out·(n−1)/n, an all-reduce 2·bytes·(n−1)/n, a reduce-scatter out·(n−1)
with out the scattered shard, an all-to-all out·(n−1)/n (the reference's
``launch/dryrun.py:48-88``), a collective-permute (``send``) the bytes
sent, all in the tensor's dtype.  The host
staging of a shared card is not counted; a collective over axes of size
1 issues nothing and counts nothing.  ``bytes_moved`` reads the counter
and ``reset_bytes`` zeroes it (``obs/commcheck.py``).
"""
from __future__ import annotations

import itertools
import warnings
from typing import Dict, FrozenSet, List, Tuple

import torch

from .topology import AXES, Layout


KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
# ring-model bytes per device and collectives issued since the last reset
_moved = dict.fromkeys(KINDS, 0.0)
_counts = dict.fromkeys(KINDS, 0)


def _count(kind: str, nbytes: float) -> None:
    _moved[kind] += nbytes
    _counts[kind] += 1


def bytes_moved() -> dict:
    """{"bytes_per_device", "by_kind", "counts"}: the ring-model bytes this
    rank's collectives moved since the last ``reset_bytes``, in all and by
    kind, and how many of each it issued."""
    return {"bytes_per_device": sum(_moved.values()),
            "by_kind": dict(_moved), "counts": dict(_counts)}


def reset_bytes() -> None:
    for k in KINDS:
        _moved[k], _counts[k] = 0.0, 0


def _axes(ax) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


class Groups:
    """The process groups of one layout (see the module docstring)."""

    def __init__(self, layout: Layout, staged: bool):
        import torch.distributed as dist
        self.staged = staged
        live = [a for a in AXES if layout.size(a) > 1]
        world = layout.n_devices
        coords = [layout.coords_of(r) for r in range(world)]
        self.group: Dict[FrozenSet[str], object] = {}
        self.members: Dict[FrozenSet[str], List[int]] = {}
        for n in range(1, len(live) + 1):
            for axes in itertools.combinations(live, n):
                key = frozenset(axes)
                rest = [a for a in AXES if a not in key]
                parts: Dict[tuple, List[int]] = {}
                for r in range(world):
                    parts.setdefault(tuple(coords[r][a] for a in rest),
                                     []).append(r)
                for ranks in parts.values():     # in order of first rank
                    g = dist.new_group(ranks)
                    if layout.rank in ranks:
                        self.group[key] = g
                        self.members[key] = ranks
        self._coords, self._sizes = coords, dict(layout.sizes)
        self._orders: Dict[Tuple[str, ...], tuple] = {}

    def order(self, axes: Tuple[str, ...]):
        """(group, perm): ``perm[j]`` is the group position (the members in
        global-rank order) of the member whose mixed-radix index over
        ``axes``, first axis major, is j; None when the two orders agree."""
        if axes not in self._orders:
            key = frozenset(axes)
            members = self.members[key]
            perm = [0] * len(members)
            for pos, r in enumerate(members):
                perm[_mixed(self._coords[r], axes, self._sizes)] = pos
            self._orders[axes] = (self.group[key],
                                  None if perm == sorted(perm) else perm)
        return self._orders[axes]


def _mixed(coords: Dict[str, int], axes, sizes: Dict[str, int]) -> int:
    i = 0
    for a in axes:
        i = i * sizes[a] + coords[a]
    return i


def init(layout: Layout, backend: str = "gloo") -> Layout:
    """``layout`` with its ``Groups`` attached; every rank of the world
    calls it with its own layout, after
    ``torch.distributed.init_process_group``.  ``backend`` is the world's:
    with "gloo" CUDA tensors are staged through the host; "nccl" needs a
    card for each rank; "fake" is the dry run's world of one process
    (``torch.distributed``'s fake backend, ``launch/dryrun.py``), whose
    groups are built as gloo's and whose collectives move no data and
    stage nothing, each counted as any other.  A one-device layout is
    returned as it is."""
    import dataclasses

    import torch.distributed as dist
    if layout.n_devices == 1:
        return layout
    if not dist.is_initialized():
        raise RuntimeError("comm.init: torch.distributed is not initialised")
    if dist.get_world_size() != layout.n_devices or \
            dist.get_rank() != layout.rank:
        raise ValueError(
            f"comm.init: rank {dist.get_rank()} of {dist.get_world_size()} "
            f"for a layout of rank {layout.rank} of {layout.n_devices}")
    if backend not in ("gloo", "nccl", "fake"):
        raise ValueError(f"backend {backend!r} not in ('gloo', 'nccl', "
                         "'fake')")
    # all_gather_into_tensor / reduce_scatter_tensor are the calls every
    # supported PyTorch has; newer ones flag them as deprecated
    warnings.filterwarnings("ignore", category=FutureWarning,
                            message=r".*(all_gather_into_tensor|"
                                    r"reduce_scatter_tensor).*")
    return dataclasses.replace(layout,
                               groups=Groups(layout, backend == "gloo"))


def _prep(layout: Layout, axis):
    """(live axes, groups) of a collective; live axes () = identity."""
    axes = layout.live(_axes(axis))
    if not axes:
        return (), None
    if layout.groups is None:
        raise RuntimeError(
            f"collective over {axes} of size {layout.size(axes)}: the layout "
            "has no process groups (comm.init)")
    return axes, layout.groups


def _to_host(g: Groups, x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, or for a staged CUDA tensor its copy on the host
    (pinned buffers with asynchronous copies were no faster on an H100:
    PERF.md §6)."""
    return x.cpu() if (g.staged and x.is_cuda) else x



class Pending:
    """A collective started now and read later (``all_gather_start``,
    ``psum_scatter_start``): ``wait()`` gives what the synchronous form
    gives.  It holds the send and receive buffers until then; over gloo
    its host copy was made before it started."""

    def __init__(self, work, finish, *keep):
        self._work, self._finish, self._keep = work, finish, keep

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        out = self._finish()
        self._work = self._finish = self._keep = None
        return out


def ready(x: torch.Tensor) -> Pending:
    """A ``Pending`` whose result is ``x`` itself (no collective)."""
    return Pending(None, lambda: x)


def _gather_post(layout: Layout, x: torch.Tensor, axis, dim: int,
                 async_op: bool) -> Pending:
    axes, g = _prep(layout, axis)
    if not axes:
        return ready(x)
    import torch.distributed as dist
    group, perm = g.order(axes)
    n = layout.size(axes)
    src = _to_host(g, x.movedim(dim, 0).contiguous())
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    work = dist.all_gather_into_tensor(out, src, group=group,
                                       async_op=async_op)
    _count("all-gather", out.nbytes * (n - 1) / n)

    def finish():
        o = out
        if perm is not None:
            blocks = o.chunk(n)
            o = torch.cat([blocks[p] for p in perm])
        return o.to(x.device).movedim(0, dim)
    return Pending(work, finish, src)


def _scatter_post(layout: Layout, x: torch.Tensor, axis, dim: int,
                  async_op: bool) -> Pending:
    axes, g = _prep(layout, axis)
    if not axes:
        return ready(x)
    import torch.distributed as dist
    group, perm = g.order(axes)
    n = layout.size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does "
                         f"not split over {axes} of size {n}")
    src = x.movedim(dim, 0)
    if perm is not None:
        # position p of the group receives block j = its own index
        blocks = src.chunk(n)
        inv = [0] * n
        for j, p in enumerate(perm):
            inv[p] = j
        src = torch.cat([blocks[inv[p]] for p in range(n)])
    src = _to_host(g, src.contiguous())
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    work = dist.reduce_scatter_tensor(out, src, group=group,
                                      async_op=async_op)
    _count("reduce-scatter", out.nbytes * (n - 1))
    return Pending(work, lambda: out.to(x.device).movedim(0, dim), src)


def all_gather(layout: Layout, x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Tiled all-gather of ``x`` along tensor dim ``dim`` over ``axis``."""
    return _gather_post(layout, x, axis, dim, False).wait()


def psum_scatter(layout: Layout, x: torch.Tensor, axis,
                 dim: int) -> torch.Tensor:
    """Tiled reduce-scatter of ``x`` along tensor dim ``dim`` over ``axis``:
    the sum over the axis of block ``index(axis)`` of dim ``dim``."""
    return _scatter_post(layout, x, axis, dim, False).wait()


def all_gather_start(layout: Layout, x: torch.Tensor, axis,
                     dim: int) -> Pending:
    """``all_gather`` started now (``async_op=True``) and read by the
    returned ``Pending``'s ``wait()``: the async-TP chunks of
    ``core/ops3d.py``.  Every rank of the group starts it in the same
    order."""
    return _gather_post(layout, x, axis, dim, True)


def psum_scatter_start(layout: Layout, x: torch.Tensor, axis,
                       dim: int) -> Pending:
    """``psum_scatter`` started now, read by ``wait()`` (see
    ``all_gather_start``)."""
    return _scatter_post(layout, x, axis, dim, True)


def all_to_all(layout: Layout, x: torch.Tensor, axis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all over ``axis`` (``lax.all_to_all(..., tiled=True)``):
    dim ``split_dim`` of ``x`` cut into n blocks, block j sent to the
    member at index j over ``axis`` (mixed radix, first axis major), and
    the n blocks received laid side by side along ``concat_dim`` in the
    order of their senders' indices."""
    axes, g = _prep(layout, axis)
    if not axes:
        return x
    import torch.distributed as dist
    group, perm = g.order(axes)
    n = layout.size(axes)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {axes} of size {n}")
    blocks = x.movedim(split_dim, 0).chunk(n)
    if perm is not None:        # group position perm[j] receives block j
        inv = [0] * n
        for j, p in enumerate(perm):
            inv[p] = j
        blocks = [blocks[inv[p]] for p in range(n)]
    src = _to_host(g, torch.cat(blocks).contiguous())
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _count("all-to-all", out.nbytes * (n - 1) / n)
    got = out.to(x.device).chunk(n)          # by sender's group position
    if perm is not None:
        got = [got[p] for p in perm]
    return torch.cat([b.movedim(0, split_dim) for b in got], dim=concat_dim)


def _all_reduce(layout: Layout, x: torch.Tensor, axis, op) -> torch.Tensor:
    axes, g = _prep(layout, axis)
    if not axes:
        return x
    import torch.distributed as dist
    group, _ = g.order(axes)
    buf = _to_host(g, x.contiguous())
    if buf is x:
        buf = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=getattr(dist.ReduceOp, op), group=group)
    n = layout.size(axes)
    _count("all-reduce", 2 * buf.nbytes * (n - 1) / n)
    return buf.to(x.device)


def psum(layout: Layout, x: torch.Tensor, axis) -> torch.Tensor:
    """Sum of ``x`` over ``axis`` (a new tensor; ``x`` is not written)."""
    return _all_reduce(layout, x, axis, "SUM")


def pmax(layout: Layout, x: torch.Tensor, axis) -> torch.Tensor:
    """Elementwise max of ``x`` over ``axis``."""
    return _all_reduce(layout, x, axis, "MAX")


def gather_to(layout: Layout, x: torch.Tensor, dst: int = 0):
    """Every rank's ``x`` (one shape on all ranks), in rank order, on rank
    ``dst``; None on the others.  Over the whole world, one send a rank:
    for a checkpoint's save, which needs each leaf's global value on one
    rank only.  Not counted in ``bytes_moved``."""
    import torch.distributed as dist
    if layout.n_devices == 1:
        return [x]
    staged = layout.groups is not None and layout.groups.staged and x.is_cuda
    src = x.detach().contiguous()
    src = src.cpu() if staged else src
    bufs = [torch.empty_like(src) for _ in range(layout.n_devices)] \
        if layout.rank == dst else None
    dist.gather(src, bufs, dst=dst)
    return bufs


def _pp_peer(layout: Layout, back: bool):
    """(groups, the pp group, the global rank of the next stage, or of
    the previous one when ``back``)."""
    axes, g = _prep(layout, "pp")
    s = layout.index("pp") + (-1 if back else 1)
    if not axes or not 0 <= s < layout.size("pp"):
        raise ValueError(f"no pipeline stage {s} from stage "
                         f"{layout.index('pp')} of pp={layout.size('pp')}")
    key = frozenset(("pp",))
    return g, g.group[key], g.members[key][s]


def send(layout: Layout, x: torch.Tensor, back: bool = False) -> None:
    """Send ``x`` to the next stage along pp (same coordinates on every
    other axis), or to the previous one when ``back``; blocks until it is
    received."""
    import torch.distributed as dist
    g, group, dst = _pp_peer(layout, back)
    buf = _to_host(g, x.detach().contiguous())
    dist.send(buf, dst, group=group)
    _count("collective-permute", buf.nbytes)


def recv(layout: Layout, shape, dtype: torch.dtype, device,
         back: bool = False) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on ``device`` from the previous
    stage along pp, or from the next one when ``back`` (its ``send``)."""
    import torch.distributed as dist
    g, group, src = _pp_peer(layout, not back)
    device = torch.device(device)
    staged = g.staged and device.type == "cuda"
    buf = torch.empty(tuple(shape), dtype=dtype,
                      device="cpu" if staged else device)
    dist.recv(buf, src, group=group)
    return buf.to(device)


class _SendAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout):
        send(layout, x)
        ctx.cfg = (layout, x.shape, x.dtype, x.device)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        layout, shape, dtype, device = ctx.cfg
        return recv(layout, shape, dtype, device, back=True), None


def send_ad(layout: Layout, x):
    """Send ``x`` to the next stage; returns a 0-d anchor whose backward
    (seed it with 1) receives x's gradient from that stage.  Without grad
    it only sends."""
    return _SendAD.apply(x, layout)


def axis_index(layout: Layout, axis) -> int:
    """This rank's index on ``axis`` (mixed radix over a tuple, the first
    axis major); no communication."""
    return layout.index(layout.live(_axes(axis)))


# ---------------------------------------------------------------------------
# Differentiable forms
# ---------------------------------------------------------------------------
class _GatherAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axis, dim):
        ctx.cfg = (layout, axis, dim)
        return all_gather(layout, x, axis, dim)

    @staticmethod
    def backward(ctx, dy):
        layout, axis, dim = ctx.cfg
        return psum_scatter(layout, dy, axis, dim), None, None, None


class _AllToAllAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axis, split_dim, concat_dim):
        ctx.cfg = (layout, axis, split_dim, concat_dim)
        return all_to_all(layout, x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, dy):
        layout, axis, split_dim, concat_dim = ctx.cfg
        return (all_to_all(layout, dy, axis, concat_dim, split_dim), None,
                None, None, None)


class _PsumAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axis):
        ctx.cfg = (layout, axis)
        return psum(layout, x, axis)

    @staticmethod
    def backward(ctx, dy):
        layout, axis = ctx.cfg
        return psum(layout, dy, axis), None, None


class _PsumID(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axis):
        return psum(layout, x, axis)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _GradPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axis):
        ctx.cfg = (layout, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        layout, axis = ctx.cfg
        return psum(layout, dy, axis), None, None


def grad_psum(layout: Layout, x, axis):
    """The identity, whose backward sums the gradient over ``axis``: for a
    tensor replicated over the axis whose copies each rank reads in its
    own way (the cotangent of a replicated input to a ``shard_map``
    island)."""
    if not layout.live(_axes(axis)):
        return x
    return _GradPsum.apply(x, layout, axis)


def all_gather_ad(layout: Layout, x, axis, dim: int):
    """``all_gather``, whose backward reduce-scatters the gradient."""
    if not layout.live(_axes(axis)):
        return x
    return _GatherAD.apply(x, layout, axis, dim)


def all_to_all_ad(layout: Layout, x, axis, split_dim: int,
                  concat_dim: int):
    """``all_to_all``, whose backward is the reverse exchange (split and
    concat dims swapped)."""
    if not layout.live(_axes(axis)):
        return x
    return _AllToAllAD.apply(x, layout, axis, split_dim, concat_dim)


def psum_ad(layout: Layout, x, axis):
    """``psum`` whose backward sums the gradient over ``axis``: for a sum
    that each rank uses in its own way."""
    if not layout.live(_axes(axis)):
        return x
    return _PsumAD.apply(x, layout, axis)


def psum_id(layout: Layout, x, axis):
    """``psum`` whose backward is the identity: for a sum that every rank
    of ``axis`` then uses identically, each seeding the whole gradient."""
    if not layout.live(_axes(axis)):
        return x
    return _PsumID.apply(x, layout, axis)
