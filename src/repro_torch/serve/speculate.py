"""Speculative decoding over the paged pool (port of
``repro/serve/speculate.py``): a small draft model proposes γ tokens per
engine step, the target verifies them in ONE batched ``transformer.extend``
call, and rejection sampling keeps the emitted distribution exactly the
target's.

Exactness argument (Leviathan et al. 2211.17192)
------------------------------------------------
Per row the engine feeds ``[t0, d_1..d_γ]`` (the last emitted token plus
the draft chain) through the target at positions ``pos..pos+γ``; the
target's logits at index j are its distribution p_j for the token AFTER
the j-th fed token.

  * temperature 0: ``d_{j+1}`` is accepted iff it equals ``argmax p_j``
    and every earlier draft was accepted; with ``a`` accepted the bonus
    token is ``argmax p_a`` (``accept_greedy``).  Every emitted token is
    the one greedy target decoding would produce: the output equals the
    non-speculative engine's.
  * temperature > 0 (plain temperature; top-k / top-p stay on the
    non-speculative path): the draft proposes ``d_{j+1} ~ q_j``; it is
    accepted with probability ``min(1, p_j(d)/q_j(d))``; on the first
    rejection the bonus is drawn from the residual
    ``norm(max(0, p_j - q_j))``; with all γ accepted from ``p_γ``
    (``accept_sampled``, which takes its uniforms as an argument).  The
    emitted marginal is p at every step.

The accepted count is clamped to a per-row ``limit`` (``max_new`` and
``max_len``); where the clamp, not a rejection, stopped the chain, the
bonus is drawn from plain ``p_a``.

State discipline
----------------
The draft holds a private contiguous cache of ``max_len + γ`` entries
(rounded up to a multiple of 16, so that its decode attention takes K4's
split route; the ring never wraps either way).  Rejected drafts leave
stale kv on both sides: the draft rewinds its cache (positions at or past
the feed point are invalidated) before every burst, and the target's
``attention_extend`` masks cached entries at or past each row's first
fresh position.  Verify writes land through a host-built physical map, so
positions beyond a slot's allocated blocks (or ``max_len``) fall to the
trash block, and the clamp on the accepted count never emits such tokens.
Random numbers come from the engine's ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import ModelConfig
from ..core.params import init_params
from ..core.topology import Layout
from ..models import transformer
from . import kvcache

F32 = torch.float32
DRAFT_CACHE_ALIGN = 16


def draft_unsupported_reason(target_cfg: ModelConfig,
                             draft_cfg: ModelConfig) -> Optional[str]:
    """Why this (target, draft) pair cannot speculate, or None (reference
    ``speculate.py:55-75``)."""
    for name, cfg in (("target", target_cfg), ("draft", draft_cfg)):
        if transformer.serve_cache_mode(cfg) != "paged":
            return (f"speculative decoding: {name} {cfg.arch} serves with "
                    "recurrent state; both models need kv attention")
        if cfg.mla is not None:
            return (f"speculative decoding: {name} {cfg.arch} uses MLA "
                    "latents — the extend/verify path only covers dense kv")
    if target_cfg.vocab != draft_cfg.vocab:
        return (f"speculative decoding: vocab mismatch — target "
                f"{target_cfg.arch} has {target_cfg.vocab}, draft "
                f"{draft_cfg.arch} has {draft_cfg.vocab}; drafted token ids "
                "must index the target's distribution")
    if target_cfg.window:
        return (f"speculative decoding: target {target_cfg.arch} uses a "
                "sliding-window ring; multi-token verify would wrap onto "
                "live blocks")
    return None


@dataclasses.dataclass
class DraftSpec:
    """A draft model bound to an engine: config, layout and parameters,
    plus the contiguous cache that ``build`` makes."""
    cfg: ModelConfig
    layout: Layout
    params: object
    gamma: int = 4
    cache_len: int = 0              # set by build(): max_len + gamma, aligned
    cache: object = None
    temperature: float = 0.0

    def build(self, batch_size: int, max_len: int, temperature: float):
        a = DRAFT_CACHE_ALIGN
        self.cache_len = -(-(max_len + self.gamma) // a) * a
        self.temperature = temperature
        emb = self.params["embed"]
        tree = kvcache.cache_with_dtype(
            transformer.abstract_cache(self.cfg, self.layout, batch_size,
                                       self.cache_len), emb.dtype)
        self.cache = init_params(tree, None, emb.device)
        return self

    def prefill(self, tokens, length):
        """Whole prompts into the draft's cache (positions < length)."""
        _, kv = transformer.prefill(self.cfg, self.layout, self.params,
                                    {"tokens": tokens, "length": length})
        p = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        pos2d = torch.where(p < length[:, None], p, -1)
        updates = transformer.pack_prefill_cache(self.cfg, kv, pos2d)
        idx = torch.where(pos2d >= 0, pos2d, self.cache_len)
        kvcache.scatter_prefill_state(self.cache, updates, idx)

    def reset(self, mask):
        """Invalidate every entry of the rows in ``mask`` (B,) bool."""
        for leaves in self.cache.values():
            leaf = leaves["pos"]
            leaf.masked_fill_(mask.view(1, -1, 1), -1)

    def _rewind(self, cutoff):
        # kv of drafts a previous verify rejected must never be attended
        for leaves in self.cache.values():
            leaf = leaves["pos"]
            leaf.masked_fill_(leaf >= cutoff.view(1, -1, 1), -1)

    def propose(self, tprev, t0, pos, generator):
        """Burst γ + 1 draft steps: re-feed the previous token at ``pos -
        1``, then ``t0`` at ``pos`` (a fully accepted verify leaves the
        last accepted draft's kv missing; re-feeding the last two emitted
        tokens covers that hole), then propose γ tokens.  Returns (drafts
        (B, γ) int64, qprobs (B, γ, V) f32, the draft's temperature-scaled
        distributions, or None at temperature 0)."""
        self._rewind(pos - 1)
        tok, drafts, qs = tprev, [], []
        for j in range(self.gamma + 1):
            logits, _ = transformer.forward(
                self.cfg, self.layout, self.params,
                {"token": tok[:, None], "pos": pos - 1 + j}, mode="decode",
                cache=self.cache)
            if j == 0:
                # the token after tprev is known: feed t0 itself next
                tok = t0
                continue
            lf = logits.float()
            if self.temperature > 0:
                q = torch.softmax(lf / self.temperature, dim=-1)
                tok = torch.multinomial(q, 1, generator=generator)[:, 0]
                qs.append(q)
            else:
                tok = torch.argmax(lf, dim=-1)
            drafts.append(tok)
        return (torch.stack(drafts, dim=1),
                torch.stack(qs, dim=1) if qs else None)


def accept_greedy(lf, drafts, limit):
    """Temperature-0 acceptance: lf (B, γ+1, V) the target's logits,
    drafts (B, γ), limit (B,).  Returns (accepted (B,) clamped to limit,
    bonus (B,) = argmax p_accepted)."""
    gamma = drafts.shape[1]
    g = torch.argmax(lf, dim=-1)                          # (B, γ+1)
    ok = drafts == g[:, :gamma]
    a = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    a = torch.minimum(a, limit.long())
    return a, torch.gather(g, 1, a[:, None])[:, 0]


def accept_sampled(p, drafts, qprobs, limit, u):
    """Temperature > 0 acceptance (reference ``speculate.py:219-245``) on
    given uniforms: p (B, γ+1, V) the target's distributions, drafts (B,
    γ), qprobs (B, γ, V) the draft's, limit (B,), u (B, γ) uniforms in [0,
    1).  Draft j is accepted iff ``u_j q_j(d_j) < p_j(d_j)`` and every
    earlier one was.  Returns (accepted (B,) clamped to limit, the bonus
    distribution (B, V): the normalised residual max(0, p_a - q_a) after a
    rejection, plain p_a where all γ were accepted or the clamp stopped
    the chain)."""
    gamma = drafts.shape[1]
    d = drafts.long()[..., None]
    p_d = torch.gather(p[:, :gamma], 2, d)[..., 0]
    q_d = torch.gather(qprobs, 2, d)[..., 0]
    ok = u * q_d.clamp_min(1e-30) < p_d
    a_raw = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    a = torch.minimum(a_raw, limit.long())
    rows = torch.arange(p.shape[0], device=p.device)
    p_a = p[rows, a]                                      # (B, V)
    q_a = torch.cat([qprobs, torch.zeros_like(p[:, :1])], dim=1)[rows, a]
    q_a = torch.where((a_raw > limit)[:, None], 0.0, q_a)
    res = (p_a - q_a).clamp_min(0.0)
    res = res / res.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return a, res


def make_verify(cfg: ModelConfig, layout: Layout, block: int, gamma: int,
                s_pad: int, temperature: float):
    """The target-side verify step: one ``extend`` over ``[t0, d_1..d_γ]``
    padded to ``s_pad`` against the pool's gathered view, its kv scattered
    into the pool, then the acceptance and the bonus draw.

    ``verify(params, pool, tokens, drafts, qprobs, offset, length, tables,
    phys_map, limit, generator)`` returns ``(accepted (B,), emit (B, γ+1),
    bad (B,))``: ``emit`` holds ``d_1..d_a`` then the bonus, of which the
    first ``accepted + 1`` per row are valid; ``bad`` flags rows whose
    verify logits held a non-finite value."""

    def verify(params, pool, tokens, drafts, qprobs, offset, length, tables,
               phys_map, limit, generator):
        view = kvcache.gather_view(pool, tables, block)
        logits, kv, positions = transformer.extend(
            cfg, layout, params,
            {"tokens": tokens, "offset": offset, "length": length}, view)
        updates = transformer.pack_prefill_cache(cfg, kv, positions)
        kvcache.scatter_prefill(pool, updates, phys_map)
        lf = logits[:, :gamma + 1].float()
        if temperature > 0:
            p = torch.softmax(lf / temperature, dim=-1)
            u = torch.rand(drafts.shape, generator=generator,
                           device=lf.device)
            a, res = accept_sampled(p, drafts, qprobs, limit, u)
            bonus = torch.multinomial(res.clamp_min(1e-30), 1,
                                      generator=generator)[:, 0]
        else:
            a, bonus = accept_greedy(lf, drafts, limit)
        emit = torch.cat([drafts.long(), torch.zeros_like(drafts[:, :1],
                                                         dtype=torch.long)],
                         dim=1)
        emit.scatter_(1, a[:, None], bonus[:, None])
        bad = ~torch.isfinite(lf).all(dim=2).all(dim=1)
        return a, emit, bad

    return verify
