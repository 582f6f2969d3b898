"""Stub modality frontends (port of ``repro/models/frontend.py``, which
imports no jax but lives in the reference package, so the port keeps its
own copy; ``tests/test_torch_vlm.py`` holds the two equal bit for bit).

The audio and vision architectures specify the transformer backbone; the
mel-spectrogram + conv feature extractor (whisper) and the ViT/InternViT +
projector (internvl2) are stubs: these helpers produce frame and patch
embeddings of the right shape from numpy's generator.  Everything
downstream of these arrays runs for real.
"""
from __future__ import annotations

import numpy as np

from ..config import ModelConfig


def audio_frames(cfg: ModelConfig, batch: int, rng=None) -> np.ndarray:
    """Stand-in for log-mel + 2x conv subsampling: (B, n_frames, d_model)."""
    rng = rng or np.random.default_rng(0)
    enc = cfg.encoder
    return rng.standard_normal((batch, enc.n_frames, cfg.d_model)).astype(
        np.float32)


def vision_patches(cfg: ModelConfig, batch: int, rng=None) -> np.ndarray:
    """Stand-in for InternViT + pixel-shuffle + MLP projector:
    (B, n_vision_tokens, d_model), already in the LM's embedding space."""
    rng = rng or np.random.default_rng(0)
    return rng.standard_normal((batch, cfg.n_vision_tokens,
                                cfg.d_model)).astype(np.float32)
