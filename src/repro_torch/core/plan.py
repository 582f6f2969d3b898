"""ParallelPlan: data x 3-D tensor x pipeline parallelism in one object
(port of ``repro/core/plan.py``).

``ParallelPlan(...).validate(mode=...).build(rank=r)`` yields rank r's
``Layout``, which everything downstream reads; ``comm.init`` then attaches
the layout's process groups, one for every set of its axes of size > 1
(``comm.Groups``).  Plans validate as the reference's do, for
``mode="train"`` and ``mode="serve"``, with the family-aware pipeline
checks and a speculative ``draft``'s pairing.  Above one device ``build``
takes each strategy (3d, 2d, 1d) and pp stages for the dense family, each
strategy at pp 1 for the MoE family, and ``validate`` refuses serving (decode's psum-combined residuals, ROADMAP.md
Queue 1 item 3); ``multi_rank_refusal`` names what else the port refuses
above one device.  ``zero_stage`` is
the ZeRO stage of the optimizer state over the data axes (pod, dp): 0
replicates it, 1 shards AdamW's moments 1/(pod*dp), 2 also keeps the f32
gradient accumulation on those shards; None resolves to 1 when the data
degree is above 1, else 0 (``resolved_zero_stage``).  ``overlap`` and
``overlap_chunks`` carry the async-TP chunking of the 3-D islands into
the layout (``core/ops3d.py``), at the 3d strategy only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from . import topology
from .topology import Layout, factor_model_axis, make_layout

# what the port does not carry above one rank
MULTI_RANK_TODO = ("above one rank the port trains the dense family and, "
                   "at pp 1, the MoE family; MoE in pipeline stages, MLA "
                   "(deepseek-v3) and the hybrid, SSM, VLM and audio "
                   "families run on one device (ROADMAP.md, Queue 1 item 3)")


def multi_rank_refusal(n_devices: int, *, cfg=None, mode: str = "train",
                       n_stages: int = 1):
    """What the port refuses of a plan of ``n_devices`` devices in
    ``n_stages`` pipeline stages, or None: serving above one device, and
    every family but the dense one and the MoE one without MLA, the MoE
    one in pipeline stages too (item 3).  The dense family trains on
    every strategy, the 3-D cube and the 1-D and 2-D baselines, and in
    pipeline stages; the MoE family on every strategy at pp 1."""
    if n_devices == 1:
        return None
    if mode != "train":
        return ("multi-rank serving (decode's psum-combined residuals) is "
                "not ported yet: serve on one device (ROADMAP.md, Queue 1 "
                "item 3)")
    if cfg is None:
        return None
    fam = cfg.family.value
    if cfg.mla or fam not in ("dense", "moe") or (fam == "dense"
                                                  and cfg.moe):
        return f"{cfg.arch} on {n_devices} devices: {MULTI_RANK_TODO}"
    if fam == "moe" and n_stages > 1:
        return (f"{cfg.arch} at pp={n_stages}: MoE in pipeline stages is "
                f"not ported yet; {MULTI_RANK_TODO}")
    return None


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
    batch_axes: Tuple[str, ...] = ("pod", "dp", "x")
    seq_axes: Tuple[str, ...] = ()
    # ZeRO over (pod, dp); None = auto: 1 when the data degree > 1, else 0
    zero_stage: Optional[int] = None
    # async-TP: chunk the 3-D island collectives so communication overlaps
    # the partial matmuls (3d strategy only; see core/ops3d.py)
    overlap: bool = False
    overlap_chunks: int = 4

    @property
    def n_devices(self) -> int:
        return self.n_pod * self.n_dp * self.n_stages * self.n_model

    @property
    def n_data(self) -> int:
        return self.n_pod * self.n_dp

    @property
    def resolved_zero_stage(self) -> int:
        """The ZeRO stage the plan runs (auto -> 1 iff pod*dp > 1)."""
        if self.zero_stage is None:
            return 1 if self.n_data > 1 else 0
        return self.zero_stage

    @property
    def cube_dims(self) -> Tuple[int, int, int]:
        return self.cube or factor_model_axis(self.n_model, self.strategy)

    def bubble_fraction(self) -> float:
        return topology.bubble_fraction(self.n_stages, self.microbatches)

    def pipeline_efficiency(self) -> float:
        return topology.pipeline_efficiency(self.n_stages, self.microbatches)

    def validate(self, n_layers: Optional[int] = None,
                 global_batch: Optional[int] = None, model=None,
                 mode: str = "train", draft=None) -> "ParallelPlan":
        """Raise ValueError on illegal compositions, naming the offending
        fields, as the reference does (``plan.py:112-201``): ``model`` (a
        ModelConfig) enables the family-aware pipeline checks, which accept
        every family; ``draft`` (a ModelConfig, ``mode="serve"`` only)
        validates a speculative pairing by
        ``serve/speculate.draft_unsupported_reason``.  A serving plan above
        one device raises NotImplementedError."""
        if self.n_stages < 1 or self.microbatches < 1:
            raise ValueError("n_stages and microbatches must be >= 1")
        err = pipeline_mode_error(self.n_stages, mode)
        if err:
            raise ValueError(err)
        if draft is not None:
            if mode != "serve":
                raise ValueError(
                    f"draft model given with mode={mode!r}: speculative "
                    "decoding is a serving composition (mode='serve')")
            if model is None:
                raise ValueError("draft model given without the target "
                                 "model config")
            # lazy: speculate imports the models
            from ..serve.speculate import draft_unsupported_reason
            reason = draft_unsupported_reason(model, draft)
            if reason:
                raise ValueError(reason)
        if model is not None and self.n_stages > 1:
            from ..models.registry import pipeline_unsupported_reason
            reason = pipeline_unsupported_reason(model, self.n_stages)
            if reason:
                raise ValueError(reason)
        if self.n_stages > 1 and self.microbatches < self.n_stages:
            import warnings
            warnings.warn(
                f"microbatches={self.microbatches} < pp={self.n_stages}: "
                f"bubble fraction {self.bubble_fraction():.2f} >= 1; "
                "raise --microbatch for pipeline efficiency")
        if n_layers is not None and self.n_stages > 1:
            if n_layers < self.n_stages:
                raise ValueError(
                    f"n_layers={n_layers} < n_stages={self.n_stages}: every "
                    "pipeline stage needs at least one layer")
            if n_layers % self.n_stages:
                import warnings
                r = n_layers % self.n_stages
                warnings.warn(
                    f"n_layers={n_layers} not divisible by "
                    f"pp={self.n_stages}: the first {r} stage(s) take one "
                    "extra layer (non-uniform stages; padding slots idle on "
                    "the shorter stages)")
        if global_batch is not None and global_batch % self.microbatches:
            raise ValueError(
                f"global_batch={global_batch} not divisible by "
                f"microbatches={self.microbatches}")
        px, py, pz = self.cube_dims
        if px * py * pz != self.n_model:
            raise ValueError(f"cube {self.cube_dims} != n_model {self.n_model}")
        if self.zero_stage is not None:
            if self.zero_stage not in (0, 1, 2):
                raise ValueError(
                    f"zero_stage={self.zero_stage} not in (0, 1, 2): 0 = "
                    "replicated opt state, 1 = sharded m/v, 2 = + sharded "
                    "grad accumulation (ZeRO-3 param sharding not supported)")
            if self.zero_stage > 0 and self.n_data == 1:
                raise ValueError(
                    f"zero_stage={self.zero_stage} requires a data-parallel "
                    f"degree > 1 to shard over, got pod*dp={self.n_data}; "
                    "grow --dp or drop --zero")
        if self.overlap_chunks < 1:
            raise ValueError(
                f"overlap_chunks={self.overlap_chunks} must be >= 1")
        if self.overlap and self.strategy != "3d":
            raise ValueError(
                f"overlap=True is only wired into the 3-D islands, got "
                f"strategy={self.strategy!r}; drop --overlap or use "
                "strategy='3d'")
        # the reference's third check (overlap against gspmd_linears) has
        # no counterpart: the port has no GSPMD path
        if mode != "train" and self.n_devices > 1:
            raise NotImplementedError(multi_rank_refusal(self.n_devices,
                                                         mode=mode))
        return self

    def build(self, rank: int = 0) -> Layout:
        """Rank ``rank``'s Layout (reference ``ParallelPlan.build``, with
        the rank in place of the device list)."""
        return make_layout(self.n_pod, self.n_dp, self.n_model,
                           self.strategy, self.cube,
                           batch_axes=self.batch_axes,
                           seq_axes=self.seq_axes, rank=rank,
                           n_pp=self.n_stages,
                           microbatches=self.microbatches,
                           zero_stage=self.resolved_zero_stage,
                           overlap=self.overlap,
                           overlap_chunks=self.overlap_chunks)

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
            "zero_stage": self.resolved_zero_stage,
            "overlap": self.overlap,
            "overlap_chunks": self.overlap_chunks if self.overlap else 0,
        }
