"""Parallel layout for 3-D tensor model parallelism (port of
``repro/core/topology.py``).

The framework's six mesh axes are ``("pod", "dp", "pp", "x", "y", "z")``:
``pod``/``dp`` carry data parallelism, ``pp`` the pipeline stages and
(x, y, z) the paper's model cube.  Activations alternate between the two
layouts of the paper's direction exchange (section 3.2):

    X  : (B, S, H)  split  (BATCH, in_ax, out_ax)
    Y  : (B, S, F)  split  (BATCH, out_ax, in_ax)     after a 3-D linear

with in_ax/out_ax swapping between 'y' and 'z' after every linear, while
weights stay attached to 'x'.  A ``Layout`` only names sizes and directions;
the collectives that move data live in ``core/comm.py``.

This slice runs one device, the cube (1, 1, 1): every axis has size 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

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


@dataclasses.dataclass(frozen=True)
class Layout:
    """Axis sizes plus the paper's direction bookkeeping.

    ``sizes`` maps every name in ``AXES`` to its size.  ``inference_opt``
    selects the x-replicated decode weight layout (no per-token weight
    all-gather), as in the reference.  ``microbatches`` is the plan's
    gradient-accumulation count, read by the train step.
    """
    sizes: Dict[str, int]
    strategy: str = "3d"
    inference_opt: bool = False
    microbatches: int = 1

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
    def n_devices(self) -> int:
        return math.prod(self.sizes.values())


@dataclasses.dataclass
class Dirs:
    """Mutable direction state threaded through the layer stack (paper §3.2)."""
    in_ax: str = "y"
    out_ax: str = "z"

    def swap(self) -> "Dirs":
        return Dirs(self.out_ax, self.in_ax)


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


def single_device_layout(strategy: str = "3d") -> Layout:
    """Degenerate layout: every axis has size 1."""
    return Layout(sizes={a: 1 for a in AXES}, strategy=strategy)
