"""The production layouts as plain arithmetic (port of
``repro/launch/mesh.py``, with no devices).

The reference's prescribed mesh is (data 16, model 16) on a pod, (pod 2,
data 16, model 16) on two; its framework view factors the model axis into
the paper's (x, y, z) cube over the same row-major device order, so rank r
of the port's layout is device r of that mesh.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..core.topology import Layout, make_layout


def production_mesh_shape(*, multi_pod: bool = False) -> Dict[str, int]:
    """The prescribed mesh's axes and sizes (reference
    ``make_production_mesh``): (data 16, model 16) on a pod, (pod 2,
    data 16, model 16) on two."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))


def make_framework_layout(*, multi_pod: bool = False, strategy: str = "3d",
                          cube: Optional[Tuple[int, int, int]] = None,
                          batch_axes=("pod", "dp", "x"), seq_axes=(),
                          n_dp: int = 16, n_model: int = 16,
                          n_pp: int = 1, microbatches: int = 1,
                          zero_stage: int = 1, rank: int = 0) -> Layout:
    """Rank ``rank``'s layout over the production devices (reference
    ``make_framework_layout``): with n_pp > 1 the pipeline axis is carved
    out of the data axis (n_dp must divide by it); ``zero_stage`` is the
    layout's ZeRO stage (in force above a data degree of 1)."""
    if n_pp > 1:
        if n_dp % n_pp:
            raise ValueError(f"n_dp={n_dp} not divisible by pp={n_pp}")
        n_dp //= n_pp
    return make_layout(n_pod=2 if multi_pod else 1, n_dp=n_dp,
                       n_model=n_model, strategy=strategy, cube=cube,
                       batch_axes=batch_axes, seq_axes=seq_axes, rank=rank,
                       n_pp=n_pp, microbatches=microbatches,
                       zero_stage=zero_stage)


def shape_layout_args(shape_name: str, multi_pod: bool):
    """Per-input-shape batch/sequence axis policy (reference
    ``shape_layout_args``)."""
    if shape_name == "train_4k":        # B=256
        return dict(batch_axes=("pod", "dp", "x"), seq_axes=())
    if shape_name == "prefill_32k":     # B=32 < pod*dp*x on multipod
        if multi_pod:
            return dict(batch_axes=("dp", "x"), seq_axes=("pod",))
        return dict(batch_axes=("dp", "x"), seq_axes=())
    if shape_name == "decode_32k":      # B=128
        return dict(batch_axes=("pod", "dp", "x"), seq_axes=())
    if shape_name == "long_500k":       # B=1: context-parallel KV over dp
        return dict(batch_axes=(), seq_axes=("pod", "dp") if multi_pod
                    else ("dp",))
    raise ValueError(shape_name)
