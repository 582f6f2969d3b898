"""Token batches for training (port of ``repro/data/pipeline.py``).

``TokenStream`` draws the same batches as the reference's from the same
seed: the synthetic stream is the same numpy Zipf generator, and the
``file`` kind reads the same packed ``.npy`` token file.  Batches are
{"tokens": (B, S), "labels": (B, S)} (labels are the tokens shifted by one)
and land on the stream's device through ``to_device``, in place of the
reference's ``shard_batch``: the tokens as int64, the modality stubs in
bf16, as ``shard_batch`` casts them.  The VLM family's batches carry
``patch_embeds`` (B, n_vision_tokens, d) and text of ``seq_len -
n_vision_tokens`` tokens; the audio family's carry ``frames`` (B,
n_frames, d) beside ``seq_len`` text tokens.  Both stubs are drawn from the
stream's generator after the tokens, in the reference's order
(``repro/data/pipeline.py:60-75``), by ``models/frontend.py``.

Above one device every rank draws the same global batch from the seed and
keeps its shard (``shard_batch``), the placement of the reference's
``shard_batch`` and of the head's logits.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import ModelConfig, ShapeConfig
from ..core.linear3d import act_axes, out_axes
from ..core.params import shard
from ..core.topology import Layout, entry_dirs
from ..models.registry import get_stack


@dataclasses.dataclass
class DataConfig:
    kind: str = "synthetic"         # synthetic | file
    path: str = ""                  # packed .npy token file
    seed: int = 0


# the float modality stubs; shard_batch casts them to bf16
# (reference data/pipeline.py:94-97)
STUBS = ("frames", "patch_embeds")


def to_device(batch: dict, device) -> dict:
    """A host batch of numpy arrays -> tensors on ``device``: the token
    arrays as int64, the modality stubs (``STUBS``) in bf16."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.to(torch.bfloat16) if k in STUBS else t.long()).to(
            device)
    return out


def shard_batch(batch: dict, layout: Layout) -> dict:
    """This rank's shard of a global host batch: the batch dim of every
    array over ``layout.batch_axes``; the tokens' sequence over
    ``seq_axes`` and the entry layout's sequence axis (``act_axes``: 3d
    in_ax, 2d 'y', 1d none), the labels' over ``seq_axes`` and the
    logits' (``out_axes``: 3d out_ax, 2d 'y', 1d none), the layout of
    the head's logits (``transformer.chunked_head_loss``).  At one
    device the batch itself.  The modality stubs have no multi-rank
    layout in the port yet."""
    if layout.n_devices == 1:
        return batch
    dirs = entry_dirs()
    seq = {"tokens": act_axes(layout, dirs)[0],
           "labels": out_axes(layout, dirs)[0]}
    bad = set(batch) - set(seq)
    if bad:
        raise NotImplementedError(
            f"batch entries {sorted(bad)} above one device: only the dense "
            "family's tokens and labels are split (ROADMAP.md, Queue 1 "
            "item 3)")
    return {k: shard(torch.from_numpy(np.ascontiguousarray(a)),
                     (layout.batch_axes, (*layout.seq_axes, seq[k])),
                     layout).numpy()
            for k, a in batch.items()}


class TokenStream:
    """Iterator of train batches {"tokens", "labels"} (+ the modality
    stubs) on ``device``: with a ``layout``, the rank's shard of each."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data: Optional[DataConfig] = None, device="cpu",
                 layout: Optional[Layout] = None):
        self.cfg, self.shape, self.device = cfg, shape, device
        self.layout = layout
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
        batch = self.next_host()
        if self.layout is not None:
            batch = shard_batch(batch, self.layout)
        return to_device(batch, self.device)

    def next_host(self) -> dict:
        """The next batch as numpy arrays (reference
        ``TokenStream.__next__`` before ``shard_batch``): the tokens of the
        family's text length, then its stubs (``registry.Stack``)."""
        b, s = self.shape.global_batch, self.shape.seq_len
        stack = get_stack(self.cfg.family)
        toks = self._next_tokens(b, stack.label_len(self.cfg, s))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        batch.update(stack.stubs(self.cfg, b, self.rng))
        return batch
