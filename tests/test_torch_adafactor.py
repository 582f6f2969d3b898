"""The port's Adafactor against the JAX package's, on the CPU.

One device: ``adafactor_update`` on one tree holding a 1-D leaf, a 2-D
leaf under 4096 values (its second moment whole), a factored 2-D leaf and
two stacked 3-D leaves, one on each side of the rule that updates a big
stacked leaf one layer slice at a time with an rms clip of its own
(``_BIG_LEAF_BYTES``, lowered in both modules with ``monkeypatch``);
three updates within 1e-5.  Then three Adafactor steps of reduced
tinyllama-1.1b within 1e-2 (``test_torch_train.three_adamw_steps``;
mixtral's and deepseek-v3's are in ``test_torch_adafactor_moe.py`` and
``test_torch_adafactor_mla.py``), and three steps of reduced tinyllama
on 8 gloo ranks at the cube (2, 2, 2) against JAX's on 8 host devices
(``test_torch_multirank_train.run_train``): each step's loss, gnorm and
lr, and every parameter shard, within 1e-2 (and 1e-5), and each rank's
stats within 1e-4 of the largest of JAX's at its coordinates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import config as jconfig
from repro.core.params import Param as JParam
from repro.core.params import init_params as jinit_params
from repro.core.topology import single_device_layout
from repro.optim import optimizers as joptim
from repro_torch import config
from repro_torch.core.params import Param
from repro_torch.core.plan import ParallelPlan
from repro_torch.models import transformer
from repro_torch.optim import optimizers as optim
from test_torch_multirank_islands import LAYOUTS, held, layout_of
from test_torch_multirank_train import (OPT, check_steps, flat, port_cfg,
                                        run_train)
from test_torch_train import build_model, three_adamw_steps

SHAPES = {"b": (64,), "small": (32, 64), "w": (64, 96),
          "stack_small": (2, 48, 64), "stack_big": (3, 64, 128)}
BIG = 2 ** 15          # bytes: stack_small (24 KiB) whole, stack_big sliced
KW = dict(name="adafactor", lr=1e-2, warmup=1, total_steps=3)


def _grads(rng):
    g = {k: (3 * rng.standard_normal(s)).astype(np.float32)
         for k, s in SHAPES.items()}
    # sparse first slice: its rms differs from the other slices'
    g["stack_big"][0] *= 10 * (rng.random(SHAPES["stack_big"][1:]) < 0.05)
    return g


def _updates(monkeypatch, big):
    monkeypatch.setattr(joptim, "_BIG_LEAF_BYTES", big)
    monkeypatch.setattr(optim, "_BIG_LEAF_BYTES", big)
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [_grads(rng) for _ in range(3)]
    jlay = single_device_layout()
    jtree = {k: JParam(s, P(*[None] * len(s)), dtype=jnp.float32)
             for k, s in SHAPES.items()}
    jcfg = jconfig.OptimConfig(**KW)
    jstate = jinit_params(joptim.opt_state_abstract(jtree, jlay, jcfg),
                          jax.random.key(1))
    jupd = jax.jit(joptim.make_optimizer(jcfg, jlay))
    lay = ParallelPlan().validate().build()
    tree = {k: Param(s) for k, s in SHAPES.items()}
    cfg = config.OptimConfig(**KW)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = optim.adamw_init(tp, lay, tree, cfg)
    upd = optim.make_optimizer(cfg, lay, tree)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    for g in grads:
        jp, jstate, jmet = jupd(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                jstate)
        tp, state, met = upd(tp, {k: torch.from_numpy(v.copy())
                                  for k, v in g.items()}, state)
        assert abs(met["gnorm"].item() - float(jmet["gnorm"])) <= 1e-5 * \
            float(jmet["gnorm"])
    return tp, state, jax.device_get(jp), jax.device_get(jstate)


def test_adafactor_update_matches_reference(monkeypatch):
    assert not optim._factored(SHAPES["small"])
    assert optim._factored(SHAPES["w"])
    tp, state, jp, jstate = _updates(monkeypatch, BIG)
    assert optim._scanned(SHAPES["stack_big"])
    assert not optim._scanned(SHAPES["stack_small"])
    assert state.step == 3 and state.m is None and jstate.m is None
    for k in SHAPES:
        err = float(np.abs(tp[k].numpy() - jp[k]).max())
        assert err <= 1e-5, (k, err)
        want, got = jstate.v[k], state.v[k]
        if isinstance(want, dict):
            assert sorted(got) == sorted(want) == ["col", "row"], k
            pairs = [(got[n], want[n]) for n in ("row", "col")]
        else:
            pairs = [(got, want)]
        for a, b in pairs:
            assert tuple(a.shape) == b.shape, k
            scale = float(np.abs(b).max())
            assert float(np.abs(a.numpy() - b).max()) <= 1e-5 * scale, k
    # the scan rule decides the result: the same updates with stack_big
    # updated whole (one rms clip) move it by far more than the limit
    whole, *_ = _updates(monkeypatch, 2 ** 40)
    assert float((whole["stack_big"] - tp["stack_big"]).abs().max()) > 1e-3
    assert torch.equal(whole["w"], tp["w"])


def test_three_adafactor_steps_match_reference():
    three_adamw_steps(build_model("mha"), 2, seq=16, optimizer="adafactor")


@pytest.fixture(scope="module")
def ranks_trained(tmp_path_factory):
    return run_train(tmp_path_factory.mktemp("adafactor"),
                     {"tinyllama-1.1b": {}}, mb=2,
                     layouts={"cube": LAYOUTS["cube"]},
                     opt=dict(OPT, name="adafactor"))


def test_three_adafactor_steps_on_8_ranks_match_jax(ranks_trained):
    """The steps and parameters within 1e-2, the parameters also within
    1e-5 (f32 on both sides: the rms clip's sums show there); each rank's
    stats (``row``, ``col``, or the whole second moment) within 1e-4 of
    the largest value of JAX's at the rank's coordinates."""
    layouts = {"cube": LAYOUTS["cube"]}
    check_steps(ranks_trained, "tinyllama-1.1b", {}, "cube", layouts=layouts)
    want, ranks = ranks_trained[("tinyllama-1.1b", "cube")]
    cfg = config.OptimConfig(**dict(OPT, name="adafactor"))
    for r, got in enumerate(ranks):
        lay = layout_of("cube", r, layouts)
        stats = optim.opt_state_abstract(transformer.abstract_params(
            port_cfg("tinyllama-1.1b", {}), lay), lay, cfg).v
        for k, p in flat(stats).items():
            ok, info = held(got["state/" + k], want["state/" + k], p.spec,
                            lay, what=f"rank {r} {k}")
            assert ok, info
        for k, p in flat(transformer.abstract_params(
                port_cfg("tinyllama-1.1b", {}), lay)).items():
            ok, info = held(got["param/" + k], want["param/" + k], p.spec,
                            lay, tol=1.0, what=f"rank {r} {k}")
            assert info[1] <= 1e-5, info
