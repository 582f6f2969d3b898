"""The port's state-family serving against the JAX package, on the CPU.

zamba2 (reduced: 2 Mamba2 layers and one use of the shared attention
block, d_model 256, window 64) in f32: ``ssd_step`` and one Mamba2 decode
step over the output and all three cache leaves (<= 1e-5), the contiguous
``attention_decode`` through K4's plain version under the identity block
table (GQA and MHA, a window, a wrapped ring, fresh rows; <= 1e-5), the
port's engine against the JAX ``Engine`` (3 requests in 2 slots, so that
a slot is reset and reused: identical greedy tokens, decode logits <=
1e-4 at every step), and token-by-token decode against the full-sequence
forward (<= 1e-4 at every position).  Inputs come from numpy with a seed;
weights cross by ``convert.params_from_jax``.
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
from repro.models import mamba2 as jmamba2
from repro.models import transformer as jtransformer
from repro_torch.config import reduced
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core.params import init_params
from repro_torch.core.plan import ParallelPlan
from repro_torch.core.topology import Dirs
from repro_torch.kernels import paged_decode as k4
from repro_torch.models import blocks, mamba2, transformer
from repro_torch.serve import Engine, Request, kvcache

DIRS = Dirs("y", "z")


def _np(a):
    return np.asarray(jax.device_get(a), np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.fixture(scope="module")
def tlayout():
    return ParallelPlan().validate(mode="serve").build()


@pytest.fixture(scope="module")
def zamba():
    """(jax cfg, port cfg, jax layout, jax params, port params) of reduced
    zamba2 in f32, its dt_bias, A_log and D moved off their init."""
    jcfg = jreduced(jget("zamba2-1.2b"))
    tcfg = reduced(get("zamba2-1.2b"))
    jlay = single_device_layout("3d")
    jp = jinit_params(jtransformer.abstract_params(jcfg, jlay),
                      jax.random.key(3), dtype=jnp.float32)
    rng = np.random.default_rng(3)
    m = dict(jp["stack"]["mamba"])
    for k in ("dt_bias", "A_log", "D"):
        m[k] = m[k] + jnp.asarray(0.3 * rng.standard_normal(m[k].shape),
                                  jnp.float32)
    jp = dict(jp, stack=dict(jp["stack"], mamba=m))
    tp = params_from_jax(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jlay, jp, tp


def test_plan_has_a_shared_block_use(zamba):
    _, tcfg, _, _, _ = zamba
    from repro_torch.models.registry import layer_plan
    assert layer_plan(tcfg) == ("mamba", "mamba", "attn")


# ---------------------------------------------------------------------------
# The Mamba2 decode step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_step_matches_reference(groups):
    rng = np.random.default_rng(groups)
    b, nh, dh, N = 3, 8, 64, 16
    state = rng.standard_normal((b, nh, dh, N)).astype(np.float32)
    x = rng.standard_normal((b, nh, dh)).astype(np.float32)
    dt = rng.standard_normal((b, nh)).astype(np.float32)
    A_log = (0.5 * rng.standard_normal(nh)).astype(np.float32)
    Bt = rng.standard_normal((b, groups, N)).astype(np.float32)
    Ct = rng.standard_normal((b, groups, N)).astype(np.float32)
    D = rng.standard_normal(nh).astype(np.float32)
    jy, js = jmamba2.ssd_step(*(jnp.asarray(a) for a in
                                (state, x, dt, A_log, Bt, Ct, D)))
    ty, ts = mamba2.ssd_step(*(_t(a) for a in
                               (state, x, dt, A_log, Bt, Ct, D)))
    assert ty.dtype == ts.dtype == torch.float32
    assert _maxerr(ty, jy) <= 1e-5 and _maxerr(ts, js) <= 1e-5


def test_mamba_decode_step_matches_reference(zamba, tlayout):
    """One ``mamba_apply(decode=True)`` step from a random cache: the
    block's output and the new state and conv tails."""
    jcfg, tcfg, jlay, jp, tp = zamba
    rng = np.random.default_rng(5)
    b = 3
    shapes = {k: p.shape for k, p in mamba2.mamba_cache_init(tcfg, b).items()}
    cache = {k: (0.5 * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    jlayer = jax.tree.map(lambda a: a[1], jp["stack"]["mamba"])
    tlayer = {k: v[1] for k, v in tp["stack"]["mamba"].items()}
    jy, jc = jax.jit(functools.partial(
        jmamba2.mamba_apply, jlay, jcfg, jtransformer.entry_dirs(),
        decode=True))(jnp.asarray(x), jlayer, None,
                      cache={k: jnp.asarray(v) for k, v in cache.items()})
    ty, tc = mamba2.mamba_decode(tlayout, tcfg, DIRS, _t(x), tlayer,
                                 {k: _t(v) for k, v in cache.items()})
    assert _maxerr(ty, jy) <= 1e-5
    for k in ("state", "conv", "conv_bc"):
        assert tuple(tc[k].shape) == jc[k].shape
        assert _maxerr(tc[k], jc[k]) <= 1e-5, k


# ---------------------------------------------------------------------------
# The contiguous decode attention
# ---------------------------------------------------------------------------
# (label, n_kv, window, L, pos per row): fresh rows have an empty cache, a
# wrapped ring has pos >= L (its slot's old entry must not be attended)
DECODE_CASES = [("mha", 4, 0, 32, [5, 17, 31]),
                ("gqa", 2, 0, 32, [5, 17, 31]),
                ("window", 2, 8, 32, [5, 17, 31]),
                ("wrapped ring", 2, 0, 16, [16, 23, 40]),
                ("wrapped window", 4, 12, 16, [20, 33, 47]),
                ("fresh rows", 2, 0, 32, [0, 0, 9])]


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in
                                                    DECODE_CASES])
def test_attention_decode_matches_reference(case, tlayout):
    label, nkv, window, L, pos = case
    cfg = dataclasses.replace(jreduced(jget("tinyllama-1.1b")), n_kv=nkv)
    tcfg = dataclasses.replace(reduced(get("tinyllama-1.1b")), n_kv=nkv)
    rng = np.random.default_rng(len(label))
    b, nq, d = len(pos), cfg.n_heads, cfg.head_dim
    q = rng.standard_normal((b, 1, nq, d)).astype(np.float32)
    k_new = rng.standard_normal((b, 1, nkv, d)).astype(np.float32)
    v_new = rng.standard_normal((b, 1, nkv, d)).astype(np.float32)
    ck = rng.standard_normal((b, L, nkv, d)).astype(np.float32)
    cv = rng.standard_normal((b, L, nkv, d)).astype(np.float32)
    # the ring as a decode leaves it: entry p at slot p % L for the last L
    # positions before pos; a fresh row (pos 0) holds nothing valid
    cpos = np.full((b, L), -1, np.int32)
    for i, p in enumerate(pos):
        for t in range(max(0, p - L), p):
            cpos[i, t % L] = t
    pvec = np.asarray(pos, np.int32)
    jfn = jax.jit(functools.partial(
        jblocks.attention_decode, single_device_layout("3d"), cfg,
        jtransformer.entry_dirs(), window=window))
    jout, jc = jfn(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
                   {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
                    "pos": jnp.asarray(cpos)}, jnp.asarray(pvec))
    before = k4.launches
    tcache = {"k": _t(ck), "v": _t(cv), "pos": torch.from_numpy(cpos)}
    tout, tc = blocks.attention_decode(
        tlayout, tcfg, DIRS, _t(q), _t(k_new), _t(v_new), tcache,
        torch.from_numpy(pvec), window=window)
    assert k4.launches == before               # CPU: K4's plain version
    assert tc is tcache                        # written in place
    assert _maxerr(tout, jout) <= 1e-5
    for leaf in ("k", "v", "pos"):
        assert _maxerr(tc[leaf], jc[leaf]) == 0.0, leaf


def test_contiguous_block_tiles_the_cache():
    assert blocks.contiguous_block(512) == 16
    assert blocks.contiguous_block(520) == 8
    assert blocks.contiguous_block(66) == 2
    assert blocks.contiguous_block(63) == 1


# ---------------------------------------------------------------------------
# zamba2 served
# ---------------------------------------------------------------------------
def test_stack_cache_matches_reference(zamba):
    """One slab per kind: the Mamba state and tails per layer, and one kv
    cache per use of the shared block at L = min(length, window)."""
    jcfg, tcfg, jlay, _, _ = zamba
    want = jtransformer.abstract_cache(jcfg, jlay, 3, 80)
    got = transformer.abstract_cache(tcfg, None, 3, 80)
    assert sorted(got) == sorted(want)
    for kind in want:
        for leaf, p in want[kind].items():
            assert got[kind][leaf].shape == tuple(p.shape), (kind, leaf)
    assert got["attn"]["k"].shape[2] == tcfg.window == 64
    tree = kvcache.cache_with_dtype(got, torch.bfloat16)
    assert tree["mamba"]["state"].dtype == torch.float32
    assert tree["attn"]["k"].dtype == torch.bfloat16
    assert tree["attn"]["pos"].dtype == torch.int32


def _recording_engines(zamba, tlayout, max_len):
    """The JAX and the port's engines, each recording its decode logits."""
    from repro.serve import Engine as JEngine
    jcfg, tcfg, jlay, jp, tp = zamba
    jeng = JEngine(jcfg, jlay, jp, batch_size=2, max_len=max_len)
    teng = Engine(tcfg, tlayout, tp, batch_size=2, max_len=max_len)
    jlogits, tlogits = [], []
    fwd = jax.jit(lambda p, c, t, s: jtransformer.forward(
        jcfg, jlay, p, {"token": t, "pos": s}, mode="decode", cache=c))

    def jdecode(params, cache, tok, pos, key):
        logits, cache = fwd(params, cache, tok, pos)
        jlogits.append(_np(logits))
        return jnp.argmax(logits, axis=-1), cache
    jeng._decode = jdecode
    sample = teng._sample

    def tsample(logits):
        tlogits.append(logits.detach().float().numpy().copy())
        return sample(logits)
    teng._sample = tsample
    return jeng, teng, jlogits, tlogits


def test_zamba2_engine_matches_reference(zamba, tlayout):
    """3 requests in 2 slots (a slot is reset and reused), sequential
    prefill, max_len 96 > window 64 (the shared block's ring wraps):
    identical greedy tokens, decode logits within 1e-4 at every step."""
    from repro.serve import Request as JRequest
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, 512, n).tolist() for n in (9, 30, 5)]
    news = (6, 40, 8)
    jeng, teng, jlog, tlog = _recording_engines(zamba, tlayout, 96)
    assert not teng.paged and not teng.chunked
    jreqs = [JRequest(uid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, news))]
    treqs = [Request(uid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, news))]
    jeng.run(jreqs)
    stats = teng.run(treqs)
    assert all(r.done and len(r.out) == m for r, m in zip(treqs, news))
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert stats["nonfinite_rows"] == 0 and stats["prefill_steps"] == 0
    assert len(tlog) == len(jlog) == stats["decode_steps"]
    assert max(_maxerr(t, j) for t, j in zip(tlog, jlog)) <= 1e-4


def test_zamba2_decode_matches_full_forward(zamba, tlayout):
    """A sequence decoded token by token (K4 in the shared block, the
    recurrence in the Mamba layers) against the whole-sequence forward
    (K5's plain version): logits within 1e-4 at every position."""
    _, tcfg, _, _, tp = zamba
    T = 48
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(2, tcfg.vocab, (2, T)))
    tree = kvcache.cache_with_dtype(
        transformer.abstract_cache(tcfg, tlayout, 2, 64), torch.float32)
    cache = init_params(tree, None, "cpu")
    steps = []
    for t in range(T):
        logits, cache = transformer.forward(
            tcfg, tlayout, tp, {"token": toks[:, t:t + 1],
                                "pos": torch.full((2,), t,
                                                  dtype=torch.int32)},
            mode="decode", cache=cache)
        steps.append(logits)
    dec = torch.stack(steps, dim=1)
    dirs = transformer.entry_dirs()
    x = transformer.embed(tlayout, tcfg, dirs, tp, toks)
    pos = torch.arange(T).expand(2, T)
    x, _, _ = transformer.run_stack(tlayout, tcfg, dirs, x, tp, pos,
                                    mode="train")
    x = blocks.apply_norm(tcfg, x, tp["ln_f"])
    full = x @ tp["head"]
    assert _maxerr(dec, full) <= 1e-4


def test_zamba2_refuses_prefill_and_extend(zamba, tlayout):
    _, tcfg, _, _, tp = zamba
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="recurrent state"):
        transformer.prefill(tcfg, tlayout, tp,
                            {"tokens": toks,
                             "length": torch.tensor([8], dtype=torch.int32)})
    with pytest.raises(ValueError, match="recurrent state"):
        transformer.extend(tcfg, tlayout, tp, {}, {})
