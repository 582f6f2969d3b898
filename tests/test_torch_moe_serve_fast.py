"""The port's other serving paths on the MoE family against the JAX
engine, on the CPU: reduced moonshot-v1-16b-a3b (a dense first layer, a
shared expert) in f32 with the prefix cache (a cold index, then a warm
one: the same hits, the same reused tokens) and with speculative decoding
(the target as its own draft, γ 3).  Each gives the JAX engine's greedy
tokens run the same way: a MoE layer's capacity depends on the whole
batch, so a prefix hit's shorter tail prefill and a verify's γ + 1 rows
route as the reference's do, not as the plain engine's.
"""
import functools

import jax
import jax.numpy as jnp
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

SHARED = list(range(7, 7 + 32))             # two full blocks at block 16
PROMPTS = [SHARED + [100 + i, 101 + i] for i in range(3)] \
    + [SHARED[:20] + [55, 56]]               # a partial-block COW divergence


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


def _run(eng, req_cls):
    reqs = [req_cls(uid=i, prompt=list(p), max_new=5)
            for i, p in enumerate(PROMPTS)]
    stats = eng.run(reqs)
    assert all(r.done and not r.error for r in reqs), [r.error for r in reqs]
    return [r.out for r in reqs], stats


def test_moonlight_prefix_cache_matches_reference():
    jcfg, tcfg, jlay, jp, tp = _model("moonshot-v1-16b-a3b")
    tlayout = ParallelPlan().validate(mode="serve").build()
    kw = dict(batch_size=2, max_len=64)
    jpfx = JEngine(jcfg, jlay, jp, prefix_cache=True, **kw)
    pfx = Engine(tcfg, tlayout, tp, prefix_cache=True, **kw)
    for _ in range(2):                        # a cold index, then a warm one
        jout, jst = _run(jpfx, JRequest)
        out, st = _run(pfx, Request)
        assert out == jout
        assert st["prefix_hits"] == jst["prefix_hits"] >= 2
        assert st["prefix_tokens_reused"] == jst["prefix_tokens_reused"]
    assert st["prefix_hits"] == len(PROMPTS)
    pfx.kv.allocator.check()


def test_moonlight_speculative_matches_reference():
    jcfg, tcfg, jlay, jp, tp = _model("moonshot-v1-16b-a3b")
    tlayout = ParallelPlan().validate(mode="serve").build()
    kw = dict(batch_size=2, max_len=64)
    jspec = JEngine(jcfg, jlay, jp, draft=jspeculate.DraftSpec(
        jcfg, jlay, jp, gamma=3), **kw)
    jout, _ = _run(jspec, JRequest)
    spec = Engine(tcfg, tlayout, tp,
                  draft=speculate.DraftSpec(tcfg, tlayout, tp, gamma=3), **kw)
    out, st = _run(spec, Request)
    assert out == jout
    assert st["spec_steps"] > 0 and st["accepted_mean"] >= 1.0
    assert st["nonfinite_rows"] == 0
