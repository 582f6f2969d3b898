"""The port's serving engine on deepseek-v3-671b against the JAX engine,
on the CPU.

Reduced deepseek-v3 in f32 (MLA with q and k at 32 and v at 16, the
latent pool {"c_kv", "k_rope", "pos"}, the plan [dense, moe]), weights
drawn by the port's init and handed to JAX as arrays:

  * chunked prefill, then the fused paged decode (K4 over the latent pool,
    the current latent token folded in) and the gather-view decode (K4
    over the gathered view under the identity table): the JAX engine's
    greedy tokens, every step's logits within 1e-4 of its;
  * sequential prefill: the JAX engine's tokens;
  * the prefix-cache and draft refusals, worded as the reference's.
"""
import jax
import numpy as np
import pytest

from repro import config as jconfig
from repro.configs.registry import get as jget
from repro.core.topology import single_device_layout
from repro.serve import Engine as JEngine, Request as JRequest
from repro.serve import speculate as jspeculate
from repro_torch import config
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core.plan import ParallelPlan
from repro_torch.models import transformer
from repro_torch.serve import Engine, Request, speculate
from test_torch_moe_serve import _draw, _record_jax, _record_port, _run

ARCH = "deepseek-v3-671b"
# prompts of 20-37 tokens, 12 new: the views cross two blocks of 16
PROMPTS = [[2 + (7 * i + 3 * j) % 500 for j in range(20 + 5 * i)]
           for i in range(4)]


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jconfig.reduced(jget(ARCH)), config.reduced(get(ARCH))
    jp = _draw(transformer.abstract_params(tcfg), 0)
    return (jcfg, tcfg, single_device_layout("3d"), jp,
            params_from_jax(jax.device_get(jp), "cpu"),
            ParallelPlan().validate(mode="serve").build())


def test_engine_fused_and_gather_view_match_reference(model):
    jcfg, tcfg, jlay, jp, tp, tlay = model
    kw = dict(batch_size=2, max_len=64)
    jeng = JEngine(jcfg, jlay, jp, **kw)
    jlog = _record_jax(jeng)
    jout, _ = _run(jeng, JRequest, PROMPTS, 12)

    eng = Engine(tcfg, tlay, tp, **kw)
    assert eng.fused and set(eng.pool["moe"]) == {"c_kv", "k_rope", "pos"}
    tlog = _record_port(eng)
    out, st = _run(eng, Request, PROMPTS, 12)
    assert out == jout
    assert st["nonfinite_rows"] == 0
    assert len(tlog) == len(jlog)
    assert max(float(np.max(np.abs(t - j))) for t, j in zip(tlog, jlog)) \
        <= 1e-4
    gather, _ = _run(Engine(tcfg, tlay, tp, fused_decode=False, **kw),
                     Request, PROMPTS, 12)
    assert gather == jout


def test_engine_sequential_prefill_matches_reference(model):
    jcfg, tcfg, jlay, jp, tp, tlay = model
    kw = dict(batch_size=2, max_len=64, chunked_prefill=False)
    jout, _ = _run(JEngine(jcfg, jlay, jp, **kw), JRequest, PROMPTS[:2], 4)
    out, _ = _run(Engine(tcfg, tlay, tp, **kw), Request, PROMPTS[:2], 4)
    assert out == jout


def test_engine_prefix_cache_and_draft_refusals_match_reference(model):
    jcfg, tcfg, jlay, jp, tp, tlay = model
    with pytest.raises(ValueError, match="MLA latent caches") as want:
        JEngine(jcfg, jlay, jp, prefix_cache=True)
    with pytest.raises(ValueError) as got:
        Engine(tcfg, tlay, tp, prefix_cache=True)
    assert str(got.value) == str(want.value)
    reason = speculate.draft_unsupported_reason(tcfg, tcfg)
    assert reason == jspeculate.draft_unsupported_reason(jcfg, jcfg)
    assert "uses MLA" in reason
    with pytest.raises(ValueError, match="uses MLA"):
        Engine(tcfg, tlay, tp, draft=speculate.DraftSpec(tcfg, tlay, tp))
    with pytest.raises(NotImplementedError, match="MLA latent caches"):
        transformer.extend(tcfg, tlay, tp, {}, {})
