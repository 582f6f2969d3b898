"""Architecture registry: the 10 assigned architectures (+ the paper's own
transformer), copied from ``repro/configs/registry.py``.  Every config cites
its source in ``source``."""
from __future__ import annotations

import importlib

from ..config import ModelConfig

ARCH_IDS = [
    "gemma-2b", "qwen3-4b", "internvl2-2b", "tinyllama-1.1b",
    "whisper-medium", "zamba2-1.2b", "mixtral-8x7b", "xlstm-350m",
    "moonshot-v1-16b-a3b", "deepseek-v3-671b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}
_MODULES["paper-transformer"] = "paper_transformer"


def get(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG
