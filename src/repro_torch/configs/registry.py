"""Architecture registry: the 10 assigned architectures (+ the paper's own
transformer), copied from ``repro/configs/registry.py``.  Every config cites
its source in ``source``.  ``ARCH_CUBE`` and ``cube_for`` give the
production layout's per-arch cube, ``LONG_OK`` the archs that take
long_500k (the reference's ``registry.py:26-52``)."""
from __future__ import annotations

import importlib
from typing import Dict, Optional, Tuple

from ..config import ModelConfig

ARCH_IDS = [
    "gemma-2b", "qwen3-4b", "internvl2-2b", "tinyllama-1.1b",
    "whisper-medium", "zamba2-1.2b", "mixtral-8x7b", "xlstm-350m",
    "moonshot-v1-16b-a3b", "deepseek-v3-671b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}
_MODULES["paper-transformer"] = "paper_transformer"

# per-arch (x, y, z) cube for a 16-wide model axis (single pod); default
# (2, 2, 4).  deepseek-v3's routed experts need the widest expert
# sharding, so its cube drops the x axis for dp-based expert parallelism
ARCH_CUBE: Dict[str, Tuple[int, int, int]] = {
    "deepseek-v3-671b": (1, 4, 4),
    "moonshot-v1-16b-a3b": (1, 4, 4),
    "xlstm-350m": (2, 2, 4),
}

# long_500k applicability (sub-quadratic attention required)
LONG_OK = {"zamba2-1.2b", "xlstm-350m", "mixtral-8x7b"}


def get(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def cube_for(arch: str, n_model: int = 16,
             strategy: str = "3d") -> Optional[Tuple[int, int, int]]:
    """The arch's cube at the 3d strategy and a 16-wide model axis; None
    (the near-cube factors) otherwise."""
    if strategy != "3d":
        return None
    if n_model == 16 and arch in ARCH_CUBE:
        return ARCH_CUBE[arch]
    return None


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCH_IDS}
