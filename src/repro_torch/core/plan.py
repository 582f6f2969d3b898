"""ParallelPlan: data x 3-D tensor x pipeline parallelism in one object
(port of ``repro/core/plan.py``).

``ParallelPlan(...).validate(mode="serve").build()`` yields the ``Layout``
everything downstream reads.  The serving slice validates and builds plans
exactly as the reference does for ``mode="serve"``, but ``build`` accepts
one device only, the cube (1, 1, 1): the islands' collectives above axis
size 1 arrive with the multi-rank slice (ROADMAP.md, "Multi-rank islands").
Optimizer-state partitioning (``zero_stage``), async-TP overlap and the
other training fields of the reference plan arrive with the training
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from . import topology
from .topology import AXES, Layout, factor_model_axis

MULTI_RANK_TODO = ("multi-rank islands are not ported yet: this slice runs "
                   "one device, the cube (1, 1, 1); see ROADMAP.md, "
                   "'Multi-rank islands'")


def pipeline_mode_error(n_stages: int, mode: str) -> Optional[str]:
    """Plan-time message for pp with a non-train mode; None when legal."""
    if n_stages > 1 and mode != "train":
        return (
            f"n_stages={n_stages} with mode={mode!r}: the 1F1B pipeline is a "
            "training-only schedule (microbatches stream through the "
            "stages); serving — prefill, decode, and the continuous-"
            "batching engine — supports every family at n_stages=1: "
            "rebuild the plan with n_stages=1 and fold those devices into "
            "n_model or n_dp")
    return None


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    n_pod: int = 1
    n_dp: int = 1
    n_model: int = 1
    n_stages: int = 1               # pipeline-parallel degree (pp axis)
    microbatches: int = 1           # grad-accumulation / pipeline m
    strategy: str = "3d"            # 3d | 2d | 1d tensor strategy per stage
    cube: Optional[Tuple[int, int, int]] = None

    @property
    def n_devices(self) -> int:
        return self.n_pod * self.n_dp * self.n_stages * self.n_model

    @property
    def cube_dims(self) -> Tuple[int, int, int]:
        return self.cube or factor_model_axis(self.n_model, self.strategy)

    def bubble_fraction(self) -> float:
        return topology.bubble_fraction(self.n_stages, self.microbatches)

    def pipeline_efficiency(self) -> float:
        return topology.pipeline_efficiency(self.n_stages, self.microbatches)

    def validate(self, n_layers: Optional[int] = None,
                 global_batch: Optional[int] = None, model=None,
                 mode: str = "serve", draft=None) -> "ParallelPlan":
        """Raise ValueError on illegal compositions, naming the offending
        fields, as the reference does.  ``mode='train'`` raises
        NotImplementedError until the training slice lands; a ``draft``
        raises ValueError until speculative decoding is ported."""
        if mode == "train":
            raise NotImplementedError(
                "mode='train': the training slice of the port is not "
                "written yet (ROADMAP.md, Queue 1)")
        if self.n_stages < 1 or self.microbatches < 1:
            raise ValueError("n_stages and microbatches must be >= 1")
        err = pipeline_mode_error(self.n_stages, mode)
        if err:
            raise ValueError(err)
        if draft is not None:
            raise ValueError(
                "draft model given: speculative decoding arrives with a "
                "later serving slice of the port")
        if global_batch is not None and global_batch % self.microbatches:
            raise ValueError(
                f"global_batch={global_batch} not divisible by "
                f"microbatches={self.microbatches}")
        px, py, pz = self.cube_dims
        if px * py * pz != self.n_model:
            raise ValueError(f"cube {self.cube_dims} != n_model {self.n_model}")
        return self

    def build(self) -> Layout:
        """The plan's Layout.  One device only in this slice."""
        if self.n_devices != 1:
            raise NotImplementedError(
                f"plan with {self.n_devices} devices: {MULTI_RANK_TODO}")
        px, py, pz = self.cube_dims
        shape = (self.n_pod, self.n_dp, self.n_stages, px, py, pz)
        return Layout(sizes=dict(zip(AXES, shape)), strategy=self.strategy)

    def describe(self) -> dict:
        px, py, pz = self.cube_dims
        return {
            "devices": self.n_devices,
            "data": self.n_pod * self.n_dp,
            "cube": f"{px}x{py}x{pz}",
            "pp": self.n_stages,
            "microbatches": self.microbatches,
            "bubble_fraction": round(self.bubble_fraction(), 4),
            "pipeline_efficiency": round(self.pipeline_efficiency(), 4),
            "strategy": self.strategy,
        }
