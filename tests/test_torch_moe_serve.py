"""The port's serving engine on the MoE family against the JAX engine, on
the CPU.

Reduced mixtral-8x7b (4 experts top-2, attention window 64) and reduced
moonshot-v1-16b-a3b (a dense first layer, a shared expert) in f32, weights
carried over by ``convert.params_from_jax``.  A MoE layer's capacity
depends on the whole batch, padding rows and idle slots included, so each
engine is held against the JAX engine run the same way:

  * mixtral with prompts and new tokens past its window of 64 (the decode
    ring wraps): the fused paged decode and the gather-view decode give
    the JAX engine's greedy tokens, and every step's logits are within
    1e-4 of the JAX engine's;
  * Moonlight with chunked and with sequential prefill: the JAX engine's
    tokens in each mode (its prefix cache and speculative decoding are in
    ``test_torch_moe_serve_fast.py``);
  * the speculative refusals, mixtral's sliding window among them, worded
    as the reference's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.configs.registry import get as jget
from repro.core.topology import single_device_layout
from repro.serve import Engine as JEngine, Request as JRequest
from repro.serve import speculate as jspeculate
from repro_torch import config
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core.params import init_params, tree_map
from repro_torch.core.plan import ParallelPlan
from repro_torch.models import transformer
from repro_torch.serve import Engine, Request, speculate


@pytest.fixture(scope="module")
def tlayout():
    return ParallelPlan().validate(mode="serve").build()


def _draw(abstract, seed):
    """Seeded f32 weights drawn by the port's init, as a JAX tree: the
    reference's ``jax.random`` init compiles a kernel for each leaf shape,
    seconds a model on the CPU."""
    tp = init_params(abstract, torch.Generator().manual_seed(seed), "cpu",
                     torch.float32)
    return tree_map(lambda t: jnp.asarray(t.numpy()), tp)


@functools.cache
def _model(arch):
    """(jax cfg, port cfg, jax layout, jax params, port params), f32."""
    jcfg, tcfg = jconfig.reduced(jget(arch)), config.reduced(get(arch))
    jlay = single_device_layout("3d")
    jp = _draw(transformer.abstract_params(tcfg), 0)
    return jcfg, tcfg, jlay, jp, params_from_jax(jax.device_get(jp), "cpu")


def _run(eng, req_cls, prompts, max_new):
    reqs = [req_cls(uid=i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    stats = eng.run(reqs)
    assert all(r.done and not r.error for r in reqs), [r.error for r in reqs]
    return [r.out for r in reqs], stats


def _record_jax(eng):
    """Log every logits array the JAX engine samples from."""
    log, base = [], eng.sampler

    def recording(logits, key):
        jax.debug.callback(lambda x: log.append(np.array(x)), logits)
        return base(logits, key)
    eng.sampler = recording
    eng._build_paged()
    return log


def _record_port(eng):
    log, sample = [], eng._sample

    def recording(logits):
        log.append(logits.detach().float().numpy().copy())
        return sample(logits)
    eng._sample = recording
    return log


# ---------------------------------------------------------------------------
# mixtral: the window wraps
# ---------------------------------------------------------------------------
# prompts of 40-55 tokens and 24 new ones: positions reach 78 > window 64
LONG = [[2 + (7 * i + 3 * j) % 500 for j in range(40 + 5 * i)]
        for i in range(4)]


def test_mixtral_engine_past_the_window_matches_reference(tlayout):
    jcfg, tcfg, jlay, jp, tp = _model("mixtral-8x7b")
    assert tcfg.window == 64
    kw = dict(batch_size=2, max_len=128)
    jeng = JEngine(jcfg, jlay, jp, **kw)
    jlog = _record_jax(jeng)
    jout, _ = _run(jeng, JRequest, LONG, 24)

    eng = Engine(tcfg, tlayout, tp, **kw)
    assert eng.fused
    tlog = _record_port(eng)
    out, st = _run(eng, Request, LONG, 24)
    assert out == jout
    assert st["nonfinite_rows"] == 0
    assert len(tlog) == len(jlog)
    assert max(float(np.max(np.abs(t - j))) for t, j in zip(tlog, jlog)) \
        <= 1e-4
    gather, _ = _run(Engine(tcfg, tlayout, tp, fused_decode=False, **kw),
                     Request, LONG, 24)
    assert gather == jout


# ---------------------------------------------------------------------------
# Moonlight: every serving path the reference allows
# ---------------------------------------------------------------------------
SHARED = list(range(7, 7 + 32))             # two full blocks at block 16
PROMPTS = [SHARED + [100 + i, 101 + i] for i in range(3)] \
    + [SHARED[:20] + [55, 56]]               # a partial-block COW divergence


def test_moonlight_chunked_and_sequential_match_reference(tlayout):
    jcfg, tcfg, jlay, jp, tp = _model("moonshot-v1-16b-a3b")
    kw = dict(batch_size=2, max_len=64)
    modes = {"chunked": {}, "sequential": {"chunked_prefill": False}}
    for name, extra in modes.items():
        jout, _ = _run(JEngine(jcfg, jlay, jp, **extra, **kw), JRequest,
                       PROMPTS, 5)
        out, _ = _run(Engine(tcfg, tlayout, tp, **extra, **kw), Request,
                      PROMPTS, 5)
        assert out == jout, name


@pytest.mark.parametrize("pair", [
    ("mixtral-8x7b", "mixtral-8x7b"),
    ("moonshot-v1-16b-a3b", "moonshot-v1-16b-a3b"),
    ("moonshot-v1-16b-a3b", "mixtral-8x7b"),
    ("deepseek-v3-671b", "moonshot-v1-16b-a3b")])
def test_moe_draft_refusals_match_reference(pair, tlayout):
    target, draft = pair
    want = jspeculate.draft_unsupported_reason(jget(target), jget(draft))
    assert speculate.draft_unsupported_reason(get(target), get(draft)) == want
    if target == "mixtral-8x7b":
        assert "sliding-window ring" in want
        tcfg = config.reduced(get(target))
        with pytest.raises(ValueError, match="sliding-window ring"):
            Engine(tcfg, tlayout, {}, draft=speculate.DraftSpec(
                tcfg, tlayout, {}))
