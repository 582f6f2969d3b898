"""The port's other serving paths against the JAX package, on the CPU:
the view and prefix machinery of ``serve/kvcache.py``, ``attention_extend``
and ``transformer.extend``, the prefix cache with copy-on-write, the
gather-view decode and speculative decoding.

Reduced qwen3-4b (qk-norm) and tinyllama-1.1b in f32, weights carried
over from the reference by ``convert.params_from_jax``; inputs from numpy
with a seed.  The device functions match the reference's exactly (the
attention within 1e-5, extend within 1e-4 of JAX and of a full prefill);
the prefix, speculative (temperature 0) and gather-view engines give the
plain engine's tokens and the JAX engine's; the temperature > 0
acceptance matches the reference's arithmetic, transcribed in numpy, and
emits the target's distribution (chi-square over 20k draws).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced as jreduced
from repro.configs.registry import get as jget
from repro.core.params import init_params as jinit_params
from repro.core.topology import single_device_layout
from repro.models import blocks as jblocks
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.serve import kvcache as jkvcache
from repro.serve import speculate as jspeculate
from repro_torch.config import reduced
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core.params import tree_map
from repro_torch.core.plan import ParallelPlan
from repro_torch.core.topology import Dirs
from repro_torch.models import blocks, transformer
from repro_torch.serve import Engine, Request, kvcache, speculate
from repro_torch.serve.kvcache import PagedKVCache, PrefixIndex

DIRS = Dirs("y", "z")


def _np(a):
    return np.asarray(jax.device_get(a), np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.fixture(scope="module")
def tlayout():
    return ParallelPlan().validate(mode="serve").build()


@functools.cache
def _model(arch):
    """(jax cfg, port cfg, jax layout, jax params, port params), f32."""
    jcfg, tcfg = jreduced(jget(arch)), reduced(get(arch))
    jlay = single_device_layout("3d")
    jp = jinit_params(jtransformer.abstract_params(jcfg, jlay),
                      jax.random.key(0), dtype=jnp.float32)
    return jcfg, tcfg, jlay, jp, params_from_jax(jax.device_get(jp), "cpu")


def _pool(rng, n, phys, nkv, d):
    return {"dense": {
        "k": rng.standard_normal((n, phys, nkv, d)).astype(np.float32),
        "v": rng.standard_normal((n, phys, nkv, d)).astype(np.float32),
        "pos": rng.integers(-1, 40, (n, phys)).astype(np.int32)}}


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _tt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Device functions of serve/kvcache.py
# ---------------------------------------------------------------------------
def test_gather_view_and_scatter_decode_match_reference():
    rng = np.random.default_rng(0)
    blk, B = 4, 3
    pool = _pool(rng, 2, 10 * blk, 2, 8)
    tables = np.array([[2, 5, 0], [7, 3, 9], [4, 0, 0]], np.int32)
    jview = jkvcache.gather_view(_to(pool, jnp.asarray), jnp.asarray(tables),
                                 blk)
    tview = kvcache.gather_view(_to(pool, _tt), _tt(tables), blk)
    for leaf in ("k", "v", "pos"):
        assert _maxerr(tview["dense"][leaf], jview["dense"][leaf]) == 0.0
    # one new entry per slot, written back at phys (slot 2 to the trash)
    new = _pool(rng, 2, B * 3 * blk, 2, 8)
    new = {"dense": {k: v.reshape(2, B, 3 * blk, *v.shape[2:])
                     for k, v in new["dense"].items()}}
    slot = np.array([1, 6, 11], np.int32)
    phys = np.array([9, 30, blk + 2], np.int64)
    want = jkvcache.scatter_decode(_to(pool, jnp.asarray),
                                   _to(new, jnp.asarray), jnp.asarray(slot),
                                   jnp.asarray(phys))
    got = kvcache.scatter_decode(_to(pool, _tt), _to(new, _tt),
                                 _tt(slot).long(), _tt(phys))
    for leaf in ("k", "v", "pos"):
        assert _maxerr(got["dense"][leaf], want["dense"][leaf]) == 0.0


def test_copy_block_matches_reference():
    rng = np.random.default_rng(1)
    blk = 4
    pool = _pool(rng, 2, 8 * blk, 2, 8)
    lane = np.arange(blk)
    src = np.stack([5 * blk + lane, np.full(blk, blk + 1)])
    dst = np.stack([6 * blk + lane, np.full(blk, blk + 1)])
    keep = np.stack([lane < 3, np.zeros(blk, bool)])
    want = jkvcache.copy_block(_to(pool, jnp.asarray), jnp.asarray(src),
                               jnp.asarray(dst), jnp.asarray(keep))
    got = kvcache.copy_block(_to(pool, _tt), _tt(src), _tt(dst), _tt(keep))
    for leaf in ("k", "v", "pos"):
        assert _maxerr(got["dense"][leaf], want["dense"][leaf]) == 0.0
    assert (got["dense"]["pos"][:, 6 * blk + 3] == -1).all()


def test_scatter_prefill_state_matches_reference():
    rng = np.random.default_rng(2)
    n, B, L, S = 2, 3, 12, 8
    cache = {"dense": {
        "k": rng.standard_normal((n, B, L, 2, 8)).astype(np.float32),
        "v": rng.standard_normal((n, B, L, 2, 8)).astype(np.float32),
        "pos": np.full((n, B, L), -1, np.int32)}}
    upd = {"dense": {
        "k": rng.standard_normal((n, B, S, 2, 8)).astype(np.float32),
        "v": rng.standard_normal((n, B, S, 2, 8)).astype(np.float32),
        "pos": np.broadcast_to(np.arange(S, dtype=np.int32),
                               (n, B, S)).copy()}}
    lens = np.array([8, 3, 0])
    idx = np.where(np.arange(S)[None] < lens[:, None], np.arange(S), L)
    want = jkvcache.scatter_prefill_state(_to(cache, jnp.asarray),
                                          _to(upd, jnp.asarray),
                                          jnp.asarray(idx))
    got = kvcache.scatter_prefill_state(_to(cache, _tt), _to(upd, _tt),
                                        _tt(idx))
    for leaf in ("k", "v", "pos"):
        assert _maxerr(got["dense"][leaf], want["dense"][leaf]) == 0.0


# ---------------------------------------------------------------------------
# Extend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nkv,window", [(4, 0), (2, 0), (2, 6)],
                         ids=["mha", "gqa", "window"])
def test_attention_extend_matches_reference(nkv, window, tlayout):
    """Fresh tokens at per-row offsets over a view holding valid, invalid
    and stale (at or past the first fresh position) entries, with a
    padded row and an inactive one."""
    cfg = dataclasses.replace(jreduced(jget("tinyllama-1.1b")), n_kv=nkv)
    tcfg = dataclasses.replace(reduced(get("tinyllama-1.1b")), n_kv=nkv)
    rng = np.random.default_rng(nkv + window)
    b, S, L, nq, d = 3, 5, 16, cfg.n_heads, cfg.head_dim
    q = rng.standard_normal((b, S, nq, d)).astype(np.float32)
    kn = rng.standard_normal((b, S, nkv, d)).astype(np.float32)
    vn = rng.standard_normal((b, S, nkv, d)).astype(np.float32)
    ck = rng.standard_normal((b, L, nkv, d)).astype(np.float32)
    cv = rng.standard_normal((b, L, nkv, d)).astype(np.float32)
    cpos = np.full((b, L), -1, np.int32)
    cpos[0, :12] = np.arange(12)          # 2 stale entries past offset 10
    cpos[1, :4] = np.arange(4)
    offset, length = np.array([10, 4, 0]), np.array([5, 3, 0])
    i = np.arange(S)
    positions = np.where(i[None] < length[:, None], offset[:, None] + i, -1)
    positions = positions.astype(np.int32)
    cache = {"k": ck, "v": cv, "pos": cpos}
    jfn = jax.jit(functools.partial(
        jblocks.attention_extend, single_device_layout("3d"), cfg,
        jtransformer.entry_dirs(), window=window))
    want = jfn(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
               _to(cache, jnp.asarray), jnp.asarray(positions))
    got = blocks.attention_extend(tlayout, tcfg, DIRS, _t(q), _t(kn),
                                  _t(vn), _to(cache, _tt), _tt(positions),
                                  window=window)
    assert _maxerr(got, want) <= 1e-5


def test_extend_matches_reference(tlayout):
    """transformer.extend over a prefilled view, ragged: logits, kv and
    positions against the reference's."""
    jcfg, tcfg, jlay, jp, tp = _model("qwen3-4b")
    B, L, S = 2, 16, 8
    toks = np.random.default_rng(3).integers(2, jcfg.vocab, (B, L + S))
    lens = np.array([S, 5], np.int32)
    batch = {"tokens": toks[:, L:], "offset": np.full(B, L, np.int32),
             "length": lens}
    _, jkv = jax.jit(lambda p, b: jtransformer.prefill(jcfg, jlay, p, b))(
        jp, {"tokens": jnp.asarray(toks[:, :L], jnp.int32),
             "length": jnp.full((B,), L, jnp.int32)})
    pos2d = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L))
    jview = jregistry.pack_prefill_cache(jcfg, jkv, jnp.asarray(pos2d))
    jl, jk, jpos = jax.jit(lambda p, b, v: jtransformer.extend(
        jcfg, jlay, p, b, v))(jp, _to(batch, jnp.asarray), jview)
    tview = transformer.pack_prefill_cache(
        tcfg, {"dense": tuple(_t(a) for a in jkv["dense"])}, _tt(pos2d))
    tl, tk, tpos = transformer.extend(
        tcfg, tlayout, tp, {"tokens": _tt(toks[:, L:]).long(),
                            "offset": _tt(batch["offset"]),
                            "length": _tt(lens)}, tview)
    assert (tpos.numpy() == np.asarray(jpos)).all()
    valid = tpos.numpy() >= 0
    assert _maxerr(tl.numpy()[valid], _np(jl)[valid]) <= 1e-4
    for got, want in zip(tk["dense"], jk["dense"]):
        assert _maxerr(got.numpy()[:, valid], _np(want)[:, valid]) <= 1e-4


def test_extend_matches_prefill(tlayout):
    """Port of the reference's ``test_extend_matches_prefill``: a ragged
    extend's last logits against a full prefill of the same tokens."""
    _, cfg, _, _, params = _model("tinyllama-1.1b")
    B, L, S = 2, 16, 8
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(2, cfg.vocab, (B, L + S)))
    _, kv = transformer.prefill(cfg, tlayout, params,
                                {"tokens": toks[:, :L],
                                 "length": torch.full((B,), L)})
    pos2d = torch.arange(L, dtype=torch.int32).expand(B, L)
    view = transformer.pack_prefill_cache(cfg, kv, pos2d)
    lens = torch.tensor([S, 5], dtype=torch.int32)
    logits, _, _ = transformer.extend(
        cfg, tlayout, params,
        {"tokens": toks[:, L:], "offset": torch.full((B,), L,
                                                     dtype=torch.int32),
         "length": lens}, view)
    last = logits[torch.arange(B), lens.long() - 1]
    ref, _ = transformer.prefill(cfg, tlayout, params,
                                 {"tokens": toks, "length": L + lens})
    assert _maxerr(last, ref) < 1e-4


# ---------------------------------------------------------------------------
# The prefix index and the paged cache's prefix side
# ---------------------------------------------------------------------------
def test_prefix_index_chain_match_and_deregister():
    ix = PrefixIndex()
    t = list(range(40))
    b0 = ix.register(-1, tuple(t[0:4]), 10)
    b1 = ix.register(b0, tuple(t[4:8]), 11)
    assert (b0, b1) == (10, 11)
    assert ix.register(-1, tuple(t[0:4]), 99) == 10   # duplicate: existing wins
    assert len(ix) == 2
    chain, partial = ix.match(t[:10], 4)
    assert chain == [10, 11] and partial is None
    # a child extends the chain partially
    ix.register(11, tuple(t[8:12]), 12)
    chain, partial = ix.match(t[:8] + [8, 9, 77, 78], 4)
    assert chain == [10, 11] and partial == (12, 2)
    # divergence inside the chain stops the walk
    chain, _ = ix.match([0, 1, 2, 3, 4, 99, 6, 7], 4)
    assert chain == [10]
    # deregister is recursive: the whole subtree under 10 is forgotten
    ix.deregister(10)
    assert len(ix) == 0
    assert ix.match(t[:10], 4) == ([], None)


def test_paged_cache_prefix_sharing_and_cow():
    cfg = reduced(get("tinyllama-1.1b"))
    kv = PagedKVCache(cfg, batch_size=2, max_len=64, block=16,
                      prefix_cache=True)
    prompt = [3 + j % 13 for j in range(50)]
    assert kv.admit(0, 64, prompt)
    assert kv.hit_len(0) == 0 and kv.cow_info(0) is None
    kv.register_prefix(0)                       # 50 tokens -> 3 full blocks
    assert len(kv.prefix) == 3
    kv.release(0)                               # indexed blocks park on LRU
    kv.allocator.check()
    # identical prompt: hits 48 of 50 (one tail token must stay fresh)
    assert kv.admit(1, 64, prompt)
    assert kv.hit_len(1) == 48 and len(kv._shared[1]) == 3
    assert kv.cow_info(1) is None
    shared = list(kv._shared[1])
    assert all(kv.allocator.refcount(b) == 1 for b in shared)
    # divergence inside block 3: chain match 2 blocks + partial COW of 8
    p2 = prompt[:40] + [201, 202, 203, 204]
    assert kv.admit(0, 64, p2)
    assert len(kv._shared[0]) == 2
    src, n = kv.cow_info(0)
    assert n == 8 and src == shared[2]          # 40 - 2*16 = 8 reused tokens
    assert kv.hit_len(0) == 40
    assert kv.allocator.refcount(src) == 2      # slot 1's table + COW pin
    rows = kv.cow_rows([0])
    assert rows is not None
    s, d, keep = rows
    assert keep[0].sum() == 8 and not keep[1].any()
    kv.cow_done(0)
    assert kv.allocator.refcount(src) == 1 and kv.cow_info(0) is None
    assert kv.lookups == 3 and kv.hits == 2 and kv.tokens_reused == 88
    kv.release(0)
    kv.release(1)
    # exhaustive reallocation evicts every cached block and empties the index
    assert kv.admit(0, 64) and kv.admit(1, 64)
    assert len(kv.prefix) == 0 and kv.allocator.n_free == 0
    assert kv.allocator.evictions >= 3
    kv.allocator.check()


def test_prefix_cache_refuses_a_wrapping_view():
    cfg = dataclasses.replace(reduced(get("tinyllama-1.1b")), window=32)
    with pytest.raises(ValueError, match="non-wrapping view"):
        PagedKVCache(cfg, batch_size=2, max_len=64, prefix_cache=True)


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------
SHARED = list(range(7, 7 + 32))             # two full blocks at block 16
PROMPTS = [SHARED + [100 + i, 101 + i] for i in range(3)] \
    + [SHARED[:20] + [55, 56]]               # a partial-block COW divergence


def _run(eng, req_cls):
    reqs = [req_cls(uid=i, prompt=list(p), max_new=5)
            for i, p in enumerate(PROMPTS)]
    stats = eng.run(reqs)
    assert all(r.done and not r.error for r in reqs), [r.error for r in reqs]
    return [r.out for r in reqs], stats


@pytest.mark.parametrize("arch", ["qwen3-4b", "tinyllama-1.1b"])
def test_engine_prefix_and_speculative_match_baseline(arch, tlayout):
    """Port of the reference's test of the same name, and against the JAX
    engines on the same weights: the prefix engine (a cold index, then a
    warm one) and the speculative engine (γ = 3, the target as its own
    draft) give the plain engine's tokens, which are the JAX engine's; the
    prefix hits are the reference's."""
    from repro.serve import Engine as JEngine, Request as JRequest
    jcfg, tcfg, jlay, jp, tp = _model(arch)
    kw = dict(batch_size=2, max_len=64)
    jbase, _ = _run(JEngine(jcfg, jlay, jp, **kw), JRequest)
    jpfx = JEngine(jcfg, jlay, jp, prefix_cache=True, **kw)
    _, jst = _run(jpfx, JRequest)
    _, jst2 = _run(jpfx, JRequest)

    base, _ = _run(Engine(tcfg, tlayout, tp, **kw), Request)
    assert base == jbase
    pfx = Engine(tcfg, tlayout, tp, prefix_cache=True, **kw)
    out, st = _run(pfx, Request)
    assert out == base, "prefix-cache engine diverged from baseline"
    assert st["prefix_hits"] == jst["prefix_hits"] >= 2
    assert st["prefix_tokens_reused"] == jst["prefix_tokens_reused"] > 0
    out2, st2 = _run(pfx, Request)              # warm index: every prompt hits
    assert out2 == base
    assert st2["prefix_hits"] == jst2["prefix_hits"] == len(PROMPTS)
    pfx.kv.allocator.check()

    spec = Engine(tcfg, tlayout, tp,
                  draft=speculate.DraftSpec(tcfg, tlayout, tp, gamma=3), **kw)
    out3, st3 = _run(spec, Request)
    assert out3 == base, "speculative engine diverged at temperature 0"
    assert st3["spec_steps"] > 0 and st3["accepted_mean"] >= 1.0
    assert st3["nonfinite_rows"] == 0


def test_speculative_with_a_weaker_draft_matches_baseline(tlayout):
    """A draft that agrees with the target in part (the target cut to one
    layer, sharing embed and head): some chains are rejected after an
    accepted draft, so the draft's rewind and the verify's masking of the
    stale entries past the rejection are exercised, and the tokens stay
    the plain engine's."""
    _, tcfg, _, _, tp = _model("tinyllama-1.1b")
    dcfg = dataclasses.replace(tcfg, n_layers=1)
    dp = dict(tp, stack=tree_map(lambda v: v[:1], tp["stack"]))
    kw = dict(batch_size=2, max_len=64)
    base, _ = _run(Engine(tcfg, tlayout, tp, **kw), Request)
    eng = Engine(tcfg, tlayout, tp,
                 draft=speculate.DraftSpec(dcfg, tlayout, dp, gamma=4), **kw)
    chains, verify = [], eng._verify

    def recording(*args):                     # (accepted, limit) per row
        a, emit, bad = verify(*args)
        chains.extend((int(n), int(lim)) for n, lim, live in
                      zip(a, args[9], args[6]) if live)
        return a, emit, bad
    eng._verify = recording
    out, st = _run(eng, Request)
    assert out == base
    assert 0.0 < st["accepted_mean"] < 4.0
    assert any(0 < n < min(4, lim) for n, lim in chains), chains


def test_gather_view_decode_matches_fused_and_reference(tlayout):
    """fused_decode=False: the same greedy tokens as the fused decode, and
    every step's logits within 1e-4 of the JAX engine's gather-view path."""
    from repro.serve import Engine as JEngine, Request as JRequest
    jcfg, tcfg, jlay, jp, tp = _model("tinyllama-1.1b")
    kw = dict(batch_size=2, max_len=64)
    jeng = JEngine(jcfg, jlay, jp, fused_decode=False, **kw)
    jlog = []
    base_sampler = jeng.sampler

    def recording(logits, key):
        jax.debug.callback(lambda x: jlog.append(np.array(x)), logits)
        return base_sampler(logits, key)
    jeng.sampler = recording
    jeng._build_paged()
    jout, _ = _run(jeng, JRequest)

    fused, _ = _run(Engine(tcfg, tlayout, tp, **kw), Request)
    teng = Engine(tcfg, tlayout, tp, fused_decode=False, **kw)
    assert not teng.fused
    tlog = []
    sample = teng._sample

    def tsample(logits):
        tlog.append(logits.detach().float().numpy().copy())
        return sample(logits)
    teng._sample = tsample
    out, _ = _run(teng, Request)
    assert out == fused == jout
    assert len(tlog) == len(jlog)
    assert max(_maxerr(t, j) for t, j in zip(tlog, jlog)) <= 1e-4


def test_engine_speculative_sampled_runs(tlayout):
    """Temperature > 0 with a draft: every request completes, draws come
    from the engine's generator, and a seed repeats its tokens."""
    _, tcfg, _, _, tp = _model("tinyllama-1.1b")
    outs = []
    for _ in range(2):
        eng = Engine(tcfg, tlayout, tp, batch_size=2, max_len=64,
                     temperature=0.8, seed=5,
                     draft=speculate.DraftSpec(tcfg, tlayout, tp, gamma=3))
        out, st = _run(eng, Request)
        assert all(len(o) == 5 for o in out) and st["nonfinite_rows"] == 0
        outs.append(out)
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# The acceptance
# ---------------------------------------------------------------------------
def _reference_acceptance(p, drafts, qprobs, limit, u):
    """The reference's temperature > 0 arithmetic (speculate.py:219-245),
    transcribed in numpy: (accepted, the bonus distribution)."""
    B, gamma = drafts.shape
    rows = np.arange(B)[:, None]
    p_d = p[:, :gamma][rows, np.arange(gamma), drafts]
    q_d = qprobs[rows, np.arange(gamma), drafts]
    ok = u * np.maximum(q_d, 1e-30) < p_d
    a_raw = np.cumprod(ok.astype(np.int64), axis=1).sum(axis=1)
    a = np.minimum(a_raw, limit)
    p_a = p[np.arange(B), a]
    q_a = np.concatenate([qprobs, np.zeros_like(p[:, :1])], axis=1)[
        np.arange(B), a]
    q_a = np.where((a_raw > limit)[:, None], 0.0, q_a)
    res = np.maximum(p_a - q_a, 0.0)
    res = res / np.maximum(res.sum(-1, keepdims=True), 1e-30)
    return a, res


def _dists(rng, *shape):
    x = rng.standard_normal(shape) * 2
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_acceptance_matches_reference_arithmetic(temperature):
    """On the same (p, q, drafts, uniforms): the accepted count, clamped to
    limit, and the bonus (greedy) or the bonus distribution (sampled)."""
    rng = np.random.default_rng(4)
    B, gamma, V = 64, 4, 16
    p = _dists(rng, B, gamma + 1, V)
    q = _dists(rng, B, gamma, V)
    limit = rng.integers(0, gamma + 1, B)
    if temperature == 0:
        drafts = p[:, :gamma].argmax(-1)
        flip = rng.random((B, gamma)) < 0.2          # some drafts wrong
        drafts = np.where(flip, (drafts + 1) % V, drafts)
        a, bonus = speculate.accept_greedy(_t(p), _tt(drafts), _tt(limit))
        g = p.argmax(-1)
        ok = drafts == g[:, :gamma]
        want = np.minimum(np.cumprod(ok, 1).sum(1), limit)
        assert (a.numpy() == want).all()
        assert (bonus.numpy() == g[np.arange(B), want]).all()
        return
    drafts = np.stack([[rng.choice(V, p=q[b, j] / q[b, j].sum())
                        for j in range(gamma)] for b in range(B)])
    u = rng.random((B, gamma)).astype(np.float32)
    a, res = speculate.accept_sampled(_t(p), _tt(drafts), _t(q), _tt(limit),
                                      _t(u))
    wa, wres = _reference_acceptance(p, drafts, q, limit, u)
    assert (a.numpy() == wa).all() and len(set(wa)) > 2
    assert _maxerr(res, wres) <= 1e-6


def test_sampled_acceptance_emits_the_target_distribution():
    """Vocabulary 16, 20k draws: the first emitted token (the first draft
    where accepted, else the bonus from the residual) is distributed as
    the target's p_0 (chi-square p-value > 1e-3, seed fixed)."""
    from scipy.stats import chisquare
    rng = np.random.default_rng(9)
    n, gamma, V = 20000, 3, 16
    p1 = _dists(rng, 1, gamma + 1, V)
    q1 = _dists(rng, 1, gamma, V)
    p = torch.from_numpy(p1).expand(n, -1, -1)
    q = torch.from_numpy(q1).expand(n, -1, -1)
    gen = torch.Generator().manual_seed(9)
    drafts = torch.stack([torch.multinomial(q[:, j], 1, generator=gen)[:, 0]
                          for j in range(gamma)], dim=1)
    u = torch.rand((n, gamma), generator=gen)
    a, res = speculate.accept_sampled(p, drafts, q,
                                      torch.full((n,), gamma), u)
    bonus = torch.multinomial(res.clamp_min(1e-30), 1, generator=gen)[:, 0]
    first = torch.where(a >= 1, drafts[:, 0], bonus)
    counts = np.bincount(first.numpy(), minlength=V)
    assert 0 < (a == 0).sum() < n                # both branches taken
    p0 = p1[0, 0].astype(np.float64)
    assert chisquare(counts, p0 / p0.sum() * n).pvalue > 1e-3


@pytest.mark.parametrize("pair", [
    ("tinyllama-1.1b", "tinyllama-1.1b"), ("tinyllama-1.1b", "zamba2-1.2b"),
    ("zamba2-1.2b", "tinyllama-1.1b"), ("qwen3-4b", "tinyllama-1.1b"),
    ("gemma-2b", "gemma-2b")])
def test_draft_unsupported_reason_matches_reference(pair):
    target, draft = pair
    want = jspeculate.draft_unsupported_reason(jget(target), jget(draft))
    assert speculate.draft_unsupported_reason(get(target), get(draft)) == want
