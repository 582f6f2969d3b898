"""Parallel layout for 3-D tensor model parallelism (port of
``repro/core/topology.py``).

The framework's six mesh axes are ``("pod", "dp", "pp", "x", "y", "z")``:
``pod``/``dp`` carry data parallelism, ``pp`` the pipeline stages and
(x, y, z) the paper's model cube.  Activations alternate between the two
layouts of the paper's direction exchange (section 3.2):

    X  : (B, S, H)  split  (BATCH, in_ax, out_ax)
    Y  : (B, S, F)  split  (BATCH, out_ax, in_ax)     after a 3-D linear

with in_ax/out_ax swapping between 'y' and 'z' after every linear, while
weights stay attached to 'x'.  BATCH is ``Layout.batch_axes``, by default
("pod", "dp", "x"); ``Layout.seq_axes`` (default none) split the sequence
beside in_ax.  A ``Layout`` names sizes, directions and this process's
rank; the collectives that move data live in ``core/comm.py``, over the
process groups that ``comm.init`` builds for a layout.

Rank r sits at the coordinates of r written row-major over
``(pod, dp, pp, x, y, z)``, the order in which the reference's
``make_mesh`` reshapes its device list.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

AXES = ("pod", "dp", "pp", "x", "y", "z")


def bubble_fraction(n_stages: int, microbatches: int) -> float:
    """Idle fraction (pp-1)/m of the synchronous 1F1B/GPipe schedule."""
    if n_stages <= 1:
        return 0.0
    return (n_stages - 1) / max(microbatches, 1)


def pipeline_efficiency(n_stages: int, microbatches: int) -> float:
    """m / (m + pp - 1): useful-tick fraction of the schedule."""
    m = max(microbatches, 1)
    return m / (m + n_stages - 1)


def stage_assignment(n_items: int,
                     n_stages: int) -> Tuple[Tuple[int, int], ...]:
    """Contiguous [start, end) ranges assigning ``n_items`` layer slots to
    ``n_stages`` pipeline stages; the first ``n_items % n_stages`` stages
    take one extra slot (the head lives on the last stage) (reference
    ``topology.py:63-79``)."""
    if n_items < n_stages:
        raise ValueError(
            f"cannot split {n_items} blocks over pp={n_stages} stages: "
            "every stage needs at least one block")
    base, rem = divmod(n_items, n_stages)
    bounds, start = [], 0
    for s in range(n_stages):
        end = start + base + (1 if s < rem else 0)
        bounds.append((start, end))
        start = end
    return tuple(bounds)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Axis sizes plus the paper's direction bookkeeping.

    ``sizes`` maps every name in ``AXES`` to its size.  ``inference_opt``
    selects the x-replicated decode weight layout (no per-token weight
    all-gather), as in the reference.  ``microbatches`` is the plan's
    gradient-accumulation count, read by the train step.  ``batch_axes``
    and ``seq_axes`` name the axes that split the batch and (beside in_ax)
    the sequence of the activations, as the reference's fields do.
    ``zero_stage`` is the ZeRO stage of the optimizer state over the data
    axes (``optim/optimizers.py``; default 1, the reference's), in force
    only above a data degree of 1 (``effective_zero_stage``).
    ``overlap`` turns on the async-TP chunking of the 3-D islands
    (``core/ops3d.py``, the reference's ``topology.py:115-122``): each
    ``matmul3d`` splits its local contraction dim into ``overlap_chunks``
    chunks (the largest divisor of that dim up to it), so that chunk t+1's
    all-gathers are in flight while chunk t's product runs; only the 3-D
    islands read these two fields.
    ``rank`` is this process's rank in the world of ``n_devices`` ranks;
    ``groups`` is the ``comm.Groups`` that ``comm.init`` attached, None
    until then (and at one device, where no collective is issued).
    """
    sizes: Dict[str, int]
    strategy: str = "3d"
    inference_opt: bool = False
    microbatches: int = 1
    batch_axes: Tuple[str, ...] = ("pod", "dp", "x")
    seq_axes: Tuple[str, ...] = ()
    zero_stage: int = 1
    overlap: bool = False
    overlap_chunks: int = 4
    rank: int = 0
    groups: Optional[Any] = dataclasses.field(default=None, compare=False,
                                              repr=False)

    def size(self, ax) -> int:
        if ax is None:
            return 1
        if isinstance(ax, (tuple, list)):
            return math.prod(self.size(a) for a in ax)
        return self.sizes[ax]

    @property
    def cube(self) -> Tuple[int, int, int]:
        return (self.sizes["x"], self.sizes["y"], self.sizes["z"])

    @property
    def n_data(self) -> int:
        return self.size(("pod", "dp"))

    def effective_zero_stage(self) -> int:
        """The ZeRO stage in force: ``zero_stage``, or 0 when there is no
        data degree to shard over (pod*dp == 1)."""
        return self.zero_stage if self.n_data > 1 else 0

    @property
    def n_devices(self) -> int:
        return math.prod(self.sizes.values())

    def stage_bounds(self, n_layers: int) -> Tuple[Tuple[int, int], ...]:
        """[start, end) layer ranges of the pp stages (``stage_assignment``;
        reference ``Layout.stage_bounds``)."""
        return stage_assignment(n_layers, self.size("pp"))

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of ``rank`` on every axis (row-major over
        AXES)."""
        out = {}
        for a in reversed(AXES):
            rank, out[a] = divmod(rank, self.sizes[a])
        return {a: out[a] for a in AXES}

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis."""
        return self.coords_of(self.rank)

    def index(self, ax) -> int:
        """This rank's index along ``ax``, a name or a tuple of names: for
        a tuple the mixed-radix index with the first axis major, the order
        of JAX's tiled collectives over an axis tuple."""
        if ax is None:
            return 0
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        c, i = self.coords, 0
        for a in axes:
            i = i * self.sizes[a] + c[a]
        return i

    def live(self, axes) -> Tuple[str, ...]:
        """The axes of ``axes`` (names, None entries skipped) whose size is
        above 1, in order."""
        return tuple(a for a in axes if a is not None and self.size(a) > 1)


@dataclasses.dataclass
class Dirs:
    """Mutable direction state threaded through the layer stack (paper §3.2)."""
    in_ax: str = "y"
    out_ax: str = "z"

    def swap(self) -> "Dirs":
        return Dirs(self.out_ax, self.in_ax)


def entry_dirs() -> Dirs:
    """The directions at every block's entry and exit, and of the
    embedding's output and the head's input (reference
    ``transformer.entry_dirs``)."""
    return Dirs("y", "z")


def factor_model_axis(n_model: int, strategy: str) -> Tuple[int, int, int]:
    """Factor the model-parallel degree into the (x, y, z) cube.

    3d: as close to a cube as possible (16 -> (2,2,4); 8 -> (2,2,2); 64 -> (4,4,4)).
    2d: (1, q, q) SUMMA grid.
    1d: (1, 1, n) Megatron.
    """
    if strategy == "1d":
        return (1, 1, n_model)
    if strategy == "2d":
        q = int(round(math.sqrt(n_model)))
        if q * q != n_model:
            raise ValueError(f"2d strategy needs a square model degree, got {n_model}")
        return (1, q, q)
    if strategy != "3d":
        raise ValueError(f"unknown strategy {strategy}")
    # 3d: greedy near-cube factorisation, px <= py <= pz
    best = None
    for px in range(1, n_model + 1):
        if n_model % px:
            continue
        rem = n_model // px
        for py in range(px, rem + 1):
            if rem % py:
                continue
            pz = rem // py
            if pz < py:
                continue
            spread = pz - px
            if best is None or spread < best[0]:
                best = (spread, (px, py, pz))
    return best[1]


def make_layout(n_pod: int = 1, n_dp: int = 1, n_model: int = 1,
                strategy: str = "3d",
                cube: Optional[Tuple[int, int, int]] = None,
                batch_axes=("pod", "dp", "x"), seq_axes=(), rank: int = 0,
                n_pp: int = 1, microbatches: int = 1,
                zero_stage: int = 1, overlap: bool = False,
                overlap_chunks: int = 4) -> Layout:
    """The layout of rank ``rank`` on the mesh (n_pod, n_dp, n_pp, cube)
    (reference ``topology.py:make_layout``, with the rank in place of the
    device list)."""
    px, py, pz = cube or factor_model_axis(n_model, strategy)
    if px * py * pz != n_model:
        raise ValueError(f"cube {(px, py, pz)} != n_model {n_model}")
    sizes = dict(zip(AXES, (n_pod, n_dp, n_pp, px, py, pz)))
    n = math.prod(sizes.values())
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a mesh of {n} devices")
    return Layout(sizes=sizes, strategy=strategy, microbatches=microbatches,
                  batch_axes=tuple(batch_axes), seq_axes=tuple(seq_axes),
                  zero_stage=zero_stage, overlap=overlap,
                  overlap_chunks=overlap_chunks, rank=rank)


def single_device_layout(strategy: str = "3d") -> Layout:
    """Degenerate layout: every axis has size 1."""
    return Layout(sizes={a: 1 for a in AXES}, strategy=strategy)
