"""Token batches for training (port of ``repro/data/pipeline.py``).

``TokenStream`` draws the same batches as the reference's from the same
seed: the synthetic stream is the same numpy Zipf generator, and the
``file`` kind reads the same packed ``.npy`` token file.  Batches are
{"tokens": (B, S), "labels": (B, S)} (labels are the tokens shifted by one)
and land on the stream's device as int64 through ``to_device``, in place of
the reference's ``shard_batch``.  The port trains the text families (dense,
MoE, hybrid and SSM), so the modality stubs of the VLM and audio families
are not drawn.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import Family, ModelConfig, ShapeConfig


@dataclasses.dataclass
class DataConfig:
    kind: str = "synthetic"         # synthetic | file
    path: str = ""                  # packed .npy token file
    seed: int = 0


def to_device(batch: dict, device) -> dict:
    """A host batch of numpy int arrays -> int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long().to(device)
            for k, v in batch.items()}


class TokenStream:
    """Iterator of train batches {"tokens", "labels"} on ``device``."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data: Optional[DataConfig] = None, device="cpu"):
        if cfg.family in (Family.VLM, Family.AUDIO):
            raise NotImplementedError(
                f"{cfg.arch}: family {cfg.family.value!r} is not ported yet "
                "(ROADMAP.md, Queue 1 item 10)")
        self.cfg, self.shape, self.device = cfg, shape, device
        self.data = data or DataConfig()
        if self.data.kind not in ("synthetic", "file"):
            raise ValueError(f"data kind {self.data.kind!r} not in "
                             "('synthetic', 'file')")
        self.rng = np.random.default_rng(self.data.seed)
        self._file_tokens = None
        if self.data.kind == "file":
            self._file_tokens = np.load(self.data.path, mmap_mode="r")
            self._pos = 0

    def _next_tokens(self, b: int, s: int) -> np.ndarray:
        if self._file_tokens is not None:
            need = b * (s + 1)
            total = len(self._file_tokens)
            if self._pos + need > total:
                self._pos = 0
            flat = np.asarray(self._file_tokens[self._pos:self._pos + need])
            self._pos += need
            return flat.reshape(b, s + 1).astype(np.int32) % self.cfg.vocab
        # synthetic: zipf-ish distribution so losses are non-trivial
        z = self.rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        return (z % self.cfg.vocab).astype(np.int32)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        toks = self._next_tokens(self.shape.global_batch, self.shape.seq_len)
        return to_device({"tokens": toks[:, :-1], "labels": toks[:, 1:]},
                         self.device)
