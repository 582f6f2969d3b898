"""On-device token sampling for the serving engine (port of
``repro/serve/sampling.py``).

``make_sampler`` closes over the sampling configuration and returns
``sample(logits (B, V), generator) -> (B,) token ids`` that runs on the
logits' device.  The engine owns one seeded ``torch.Generator`` on that
device, so temperature = 0 (greedy, generator unused) is deterministic and
temperature > 0 is reproducible from the seed.  The draws differ from the
reference's ``jax.random`` ones; greedy output is the same.

Filters compose the standard way: logits are divided by the temperature,
then truncated to the top-k ids, then to the top-p (nucleus) mass, and the
survivor set is sampled.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def top_k_mask(logits, k: int):
    """Keep the k largest logits per row (ties keep extras)."""
    kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
    return torch.where(logits < kth, NEG_INF, logits)


def top_p_mask(logits, p: float):
    """Nucleus filter: keep the smallest prefix of the probability-sorted
    vocab whose cumulative mass reaches ``p`` (always >= 1 token)."""
    sl = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sl.float(), dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    cut = (csum < p).sum(dim=-1, keepdim=True)                # prefix size - 1
    cut = cut.clamp(max=logits.shape[-1] - 1)
    thresh = torch.gather(sl, -1, cut)
    return torch.where(logits < thresh, NEG_INF, logits)


def make_sampler(temperature: float, top_k: int = 0, top_p: float = 0.0):
    """-> sample(logits (B, V), generator) -> (B,) int64 token ids."""
    if temperature <= 0:
        def greedy(logits, generator):
            return torch.argmax(logits, dim=-1)
        return greedy

    def sample(logits, generator):
        l = logits.float() / temperature
        if top_k and top_k < l.shape[-1]:
            l = top_k_mask(l, top_k)
        if 0.0 < top_p < 1.0:
            l = top_p_mask(l, top_p)
        probs = torch.softmax(l, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return sample
