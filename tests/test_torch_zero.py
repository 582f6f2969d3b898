"""ZeRO over the data axes and checkpoints across layouts: the port against
the JAX package, on the CPU.

The plan checks of ``tests/test_zero.py:20-40``, with the reference's
messages; ``zero_partition_spec`` equal to the reference's for every leaf
of reduced tinyllama-1.1b and gemma-2b at dp 2 x (2, 2, 1), at 1d(4) with
dp 2 and at pod 2 x dp 2 x (1, 1, 2).  Then one world of 8 gloo ranks
beside one JAX subprocess of 8 host devices
(``test_torch_multirank_islands.py``'s machinery), running
``test_zero.py``'s plans on reduced tinyllama in f32: the port's ``zero1``
and ``zero2_mb4`` against JAX's ``zero0``, ``zero1_pod`` against
``zero0_pod``, and Adafactor at ZeRO 2 (dp 2, 2 microbatches) against
JAX's Adafactor at stage 0; every step's loss and gnorm and every
parameter shard within 1e-2, and each AdamW rank's moment bytes within
[0.8, 1.1] x 1/(pod*dp) of stage 0's (at stage 2 the f32 accumulation
buffer's too), Adafactor's stats on the parameters' specs at every stage.

Checkpoints, in both directions between the packages: the port's ranks
save their ``zero1`` state (dp 2, ZeRO 1), which the JAX store restores
at dp 4 with its own ``opt_state_abstract``; the JAX package saves its
``zero0`` state placed at dp 2 / ZeRO 1, which the port's ranks restore
at dp 4 (and take one more step, within 1e-2 of JAX's) and the port
restores on one device; the port's Adafactor save at dp 2 / ZeRO 2,
restored at dp 4 by the JAX store and by the port's ranks.  Every
restored leaf is bit-equal.
"""
import json

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.config import reduced as jreduced
from repro.configs.registry import get as jget
from repro.core import topology as jtopology
from repro.core.plan import ParallelPlan as JPlan
from repro.models import transformer as jtransformer
from repro.optim.optimizers import zero_partition_spec as jzero_spec
from repro_torch import config
from repro_torch.checkpoint import store
from repro_torch.core.params import shard, sharded_bytes, tree_zip
from repro_torch.core.plan import ParallelPlan
from repro_torch.core.topology import make_layout
from repro_torch.models import transformer
from repro_torch.optim.optimizers import (opt_state_abstract,
                                          zero_partition_spec)
from test_torch_multirank_islands import WORLD, run_jax, run_ranks, wait_jax
from test_torch_multirank_train import flat, port_cfg, write_inputs

ARCH = "tinyllama-1.1b"
STEPS = 3
OPT = dict(lr=1e-3, warmup=2, total_steps=10)
ADA = dict(OPT, name="adafactor")
# tests/test_zero.py's plans (make_layout's arguments), and Adafactor at
# stage 2, whose gradient blocks are gathered back before its update
DP2 = dict(n_dp=2, n_model=4, cube=(1, 2, 2))
POD = dict(n_pod=2, n_dp=2, n_model=2, cube=(1, 1, 2))
DP4 = dict(n_dp=4, n_model=2, cube=(1, 1, 2))
PLANS = {"zero1": dict(DP2, zero_stage=1),
         "zero2_mb4": dict(DP2, zero_stage=2, microbatches=4),
         "zero1_pod": dict(POD, zero_stage=1),
         "ada_zero2_mb2": dict(DP2, zero_stage=2, microbatches=2)}
OPTS = {name: ADA if name.startswith("ada") else OPT for name in PLANS}
REF = {"zero1": "zero0", "zero2_mb4": "zero0", "zero1_pod": "zero0_pod",
       "ada_zero2_mb2": "ada_zero0"}
# the plan each checkpoint is saved from, and its directory
SAVES = {"zero1": "port_ckpt", "ada_zero2_mb2": "port_ada_ckpt"}


# ---------------------------------------------------------------------------
# The plan, as tests/test_zero.py:20-40
# ---------------------------------------------------------------------------
def test_zero_stage_auto_resolution():
    assert ParallelPlan(n_dp=1).resolved_zero_stage == 0
    assert ParallelPlan(n_dp=2).resolved_zero_stage == 1
    assert ParallelPlan(n_pod=2).resolved_zero_stage == 1
    assert ParallelPlan(n_dp=2, zero_stage=0).resolved_zero_stage == 0
    assert ParallelPlan(n_dp=2, zero_stage=2).resolved_zero_stage == 2
    assert ParallelPlan(n_dp=2, zero_stage=2).build(1).zero_stage == 2
    assert ParallelPlan(n_dp=2, n_model=4).build(0).effective_zero_stage() \
        == 1
    assert make_layout(n_model=8).effective_zero_stage() == 0


@pytest.mark.parametrize("kw,match", [
    (dict(n_dp=1, zero_stage=1), "data-parallel degree"),
    (dict(n_dp=1, n_model=8, zero_stage=2), "data-parallel degree"),
    (dict(n_dp=2, zero_stage=3), "not in"),
    (dict(n_dp=2, zero_stage=-1), "not in")])
def test_zero_stage_validation_rejects_bad_combos(kw, match):
    with pytest.raises(ValueError, match=match) as got:
        ParallelPlan(**kw).validate()
    with pytest.raises(ValueError) as want:
        JPlan(**kw).validate()
    assert str(got.value) == str(want.value)
    ParallelPlan(n_dp=2, zero_stage=2).validate()
    ParallelPlan(n_dp=1).validate()
    assert ParallelPlan(n_dp=2, zero_stage=1).describe()["zero_stage"] == 1


# ---------------------------------------------------------------------------
# zero_partition_spec against the reference's, every leaf
# ---------------------------------------------------------------------------
SPEC_LAYOUTS = {"dp2": dict(n_dp=2, n_model=4, cube=(2, 2, 1)),
                "1d4_dp2": dict(n_dp=2, n_model=4, strategy="1d"),
                "pod2_dp2": POD}


def _norm(spec, ndim):
    spec = [tuple(e) if isinstance(e, (tuple, list)) else e
            for e in (spec or ())]
    return tuple(spec + [None] * (ndim - len(spec)))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma-2b"])
@pytest.mark.parametrize("lname", sorted(SPEC_LAYOUTS))
def test_zero_partition_spec_matches_reference(arch, lname):
    kw = dict(SPEC_LAYOUTS[lname])
    lay = make_layout(**kw)
    cube = kw.pop("cube", None) or lay.cube
    strategy = kw.pop("strategy", "3d")
    jlay = jtopology.Layout(mesh=AbstractMesh(
        (kw.get("n_pod", 1), kw["n_dp"], 1, *cube), jtopology.AXES),
        strategy=strategy)
    jtree = jtransformer.abstract_params(jreduced(jget(arch)), jlay)
    tree = transformer.abstract_params(port_cfg(arch, {}), lay)
    n = sharded = 0
    for p, jp in tree_zip(tree, jtree):
        assert p.shape == jp.shape
        assert _norm(p.spec, len(p.shape)) == _norm(jp.spec, len(p.shape))
        got = _norm(zero_partition_spec(p, lay), len(p.shape))
        assert got == _norm(jzero_spec(jp, jlay), len(p.shape)), p
        n += 1
        sharded += got != _norm(p.spec, len(p.shape))
    assert n > 8 and sharded >= n - 2


# ---------------------------------------------------------------------------
# 8 ranks beside JAX on 8 host devices
# ---------------------------------------------------------------------------
JAX_SCRIPT = r"""
import os, time
import numpy as np
import jax, jax.numpy as jnp
from repro import config
from repro.checkpoint import store
from repro.config import reduced
from repro.configs.registry import get
from repro.core.params import init_params, shardings
from repro.core.topology import make_layout
from repro.models import transformer
from repro.optim.optimizers import opt_state_abstract
from repro.train.step import make_train_step

d = os.environ["MR_DIR"]
ARCH, STEPS, DP2, POD, DP4 = %(arch)r, %(steps)d, %(dp2)r, %(pod)r, %(dp4)r
OPT = config.OptimConfig(**%(opt)r)
ADA = config.OptimConfig(**%(ada)r)
cfg = reduced(get(ARCH))


def unflat(dd):
    out = {}
    for path, v in dd.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(v)
    return out


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(jax.device_get(tree))}


def load(s):
    return {k: jnp.asarray(v) for k, v in
            np.load(os.path.join(d, f"{ARCH}_batch{s}.npz")).items()}


def wait_for(name):
    t0 = time.time()
    while not os.path.exists(os.path.join(d, name)):
        assert time.time() - t0 < 500, name
        time.sleep(0.2)


def place(tree, lay):
    return jax.device_put(tree, shardings(tree_abs(lay), lay))


def tree_abs(lay):
    return transformer.abstract_params(cfg, lay)


def flat_state(params, state):
    out = {"param/" + k: v for k, v in flat(params).items()}
    if state.m is not None:
        out.update({"m/" + k: v for k, v in flat(state.m).items()})
    out.update({"v/" + k: v for k, v in flat(state.v).items()})
    return out


def dump(name, params, state):
    np.savez(os.path.join(d, name), step=np.asarray(state.step),
             **flat_state(params, state))


def restore(ckpt, opt):
    wait_for(ckpt + ".done")
    lay4 = make_layout(zero_stage=1, **DP4)
    ab4 = tree_abs(lay4)
    return store.restore(os.path.join(d, ckpt), STEPS, ab4, lay4,
                         opt_template=opt_state_abstract(ab4, lay4, opt))


p0 = unflat(dict(np.load(os.path.join(d, f"{ARCH}_params.npz"))))
res = {}
for name, kw, opt in (("zero0", DP2, OPT), ("zero0_pod", POD, OPT),
                      ("ada_zero0", DP2, ADA)):
    lay = make_layout(zero_stage=0, **kw)
    params = place(p0, lay)
    state = init_params(opt_state_abstract(tree_abs(lay), lay, opt),
                        jax.random.key(1))
    step = jax.jit(make_train_step(cfg, lay, opt))
    for s in range(STEPS):
        params, state, met = step(params, state, load(s))
        res[f"{name}/loss{s}"] = np.asarray(met["loss"])
        res[f"{name}/gnorm{s}"] = np.asarray(met["gnorm"])
    res.update({f"{name}/" + k: v for k, v in
                flat_state(params, state).items()})
    if name == "zero0":
        # the state placed at dp 2 / ZeRO 1 and saved there
        lay1 = make_layout(zero_stage=1, **kw)
        state1 = jax.device_put(state, shardings(
            opt_state_abstract(tree_abs(lay1), lay1, OPT), lay1))
        store.save(os.path.join(d, "jax_ckpt"), STEPS, params, state1,
                   layout=lay1)
        dump("jax_saved.npz", params, state)
        open(os.path.join(d, "jax_ckpt.done"), "w").close()
        _, _, met = step(params, state, load(STEPS))
        res["zero0/post"] = np.asarray(met["loss"])
np.savez(os.path.join(d, "jax.npz"), **res)

# the port's dp 2 checkpoints (AdamW at ZeRO 1, Adafactor at ZeRO 2),
# restored at dp 4
p4, o4, _ = restore("port_ckpt", OPT)
dump("jax_restored.npz", p4, o4)
p4, o4, _ = restore("port_ada_ckpt", ADA)
dump("jax_ada_restored.npz", p4, o4)
print("JAX-OK")
"""

RANK_SCRIPT = r"""
import dataclasses, os, time
import numpy as np
import torch
from repro_torch import config
from repro_torch.checkpoint import store
from repro_torch.config import reduced
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core import comm
from repro_torch.core.params import tree_leaves
from repro_torch.core.topology import make_layout
from repro_torch.data.pipeline import shard_batch, to_device
from repro_torch.launch import ranks
from repro_torch.models import transformer
from repro_torch.optim import adamw_init
from repro_torch.optim.optimizers import opt_state_abstract
from repro_torch.train.step import make_train_step

torch.set_num_threads(1)
me = ranks.rank_env()
ranks.init_world(me, "gloo", torch.device("cpu"))
d = os.environ["MR_DIR"]
ARCH, STEPS, PLANS, DP4 = %(arch)r, %(steps)d, %(plans)r, %(dp4)r
OPTS = {k: config.OptimConfig(**v) for k, v in %(opts)r.items()}
OPT, SAVES = OPTS["zero1"], %(saves)r
cfg = reduced(get(ARCH))


def unflat(dd):
    out = {}
    for path, v in dd.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().numpy().copy()}


def layout(kw):
    kw = dict(kw)
    if "cube" in kw:
        kw["cube"] = tuple(kw["cube"])
    return comm.init(make_layout(rank=me.rank, **kw), "gloo")


def batch(lay, s):
    b = dict(np.load(os.path.join(d, f"{ARCH}_batch{s}.npz")))
    return to_device(shard_batch(b, lay), "cpu")


def moment_bytes(state):
    return sum(t.nbytes for t in tree_leaves(state.m or {})
               + tree_leaves(state.v))


def dump(out, params, state):
    out.update({"param/" + k: v for k, v in flat(params).items()})
    if state.m is not None:
        out.update({"m/" + k: v for k, v in flat(state.m).items()})
    out.update({"v/" + k: v for k, v in flat(state.v).items()})
    out["step"] = np.asarray(state.step)


def restore(ckpt, opt):
    lay4 = layout(DP4)
    ab4 = transformer.abstract_params(cfg, lay4)
    p4, o4, _ = store.restore(os.path.join(d, ckpt), STEPS, ab4,
                              opt_state_abstract(ab4, lay4, opt),
                              device="cpu", dtype=torch.float32, layout=lay4)
    return lay4, p4, o4


p0 = unflat(dict(np.load(os.path.join(d, f"{ARCH}_params.npz"))))
for name, kw in PLANS.items():
    opt = OPTS[name]
    lay = layout(kw)
    params = params_from_jax(p0, "cpu", cfg=cfg, layout=lay)
    abstract = transformer.abstract_params(cfg, lay)
    state = adamw_init(params, lay, abstract, opt)
    lay0 = dataclasses.replace(lay, zero_stage=0)
    out = {"bytes": moment_bytes(state), "bytes0": moment_bytes(
        adamw_init(params, lay0, abstract, opt)),
        "param_values": sum(t.numel() for t in tree_leaves(params))}
    step = make_train_step(cfg, lay, opt)
    for s in range(STEPS):
        params, state, met = step(params, state, batch(lay, s))
        out[f"loss{s}"] = float(met["loss"])
        out[f"gnorm{s}"] = float(met["gnorm"])
    dump(out, params, state)
    if name in SAVES:
        store.save(os.path.join(d, SAVES[name]), STEPS, params, state,
                   layout=lay, abstract=abstract,
                   opt_abstract=opt_state_abstract(abstract, lay, opt))
        if me.rank == 0:
            open(os.path.join(d, SAVES[name] + ".done"), "w").close()
    np.savez(os.path.join(d, f"rank{me.rank}_{name}.npz"), **out)

# JAX's dp 2 / ZeRO 1 checkpoint, restored at dp 4; one more step there
t0 = time.time()
while not os.path.exists(os.path.join(d, "jax_ckpt.done")):
    assert time.time() - t0 < 500
    time.sleep(0.2)
lay4, p4, o4 = restore("jax_ckpt", OPT)
out = {}
dump(out, p4, o4)
_, _, met = make_train_step(cfg, lay4, OPT)(p4, o4, batch(lay4, STEPS))
out["post"] = float(met["loss"])
np.savez(os.path.join(d, f"rank{me.rank}_restored.npz"), **out)
# the ranks' own Adafactor checkpoint (dp 2, ZeRO 2), restored at dp 4
_, p4, o4 = restore("port_ada_ckpt", OPTS["ada_zero2_mb2"])
out = {}
dump(out, p4, o4)
np.savez(os.path.join(d, f"rank{me.rank}_ada_restored.npz"), **out)
print("RANK-OK")
"""


def _lay(kw, rank):
    return make_layout(rank=rank, **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero")
    write_inputs(tmp, {ARCH: {}})
    plans = {k: dict(v, cube=list(v["cube"])) for k, v in PLANS.items()}
    fill = {"arch": ARCH, "steps": STEPS, "opt": OPT, "ada": ADA,
            "opts": OPTS, "saves": SAVES, "plans": plans, "dp2": DP2,
            "pod": POD, "dp4": DP4}
    run = run_jax(JAX_SCRIPT % fill, tmp)
    try:
        run_ranks(RANK_SCRIPT % fill, tmp, timeout=600)
    finally:
        wait_jax(run, timeout=600)
    load = lambda n: dict(np.load(tmp / n))  # noqa: E731
    return {"dir": tmp, "jax": load("jax.npz"),
            "saved": load("jax_saved.npz"),
            "jax_restored": load("jax_restored.npz"),
            "jax_ada_restored": load("jax_ada_restored.npz"),
            "ranks": {n: [load(f"rank{r}_{n}.npz") for r in range(WORLD)]
                      for n in (*PLANS, "restored", "ada_restored")}}


def _specs(kw, rank, moments, opt=OPT):
    """{"param/k": spec, "m/k": spec, "v/k": spec} of rank ``rank``'s
    layout ``kw``; the optimizer ``opt``'s state on the stage's specs
    (Adafactor's ``v/k/row`` and ``v/k/col`` for a factored leaf)."""
    lay = _lay(kw, rank)
    cfg = port_cfg(ARCH, {})
    ab = transformer.abstract_params(cfg, lay)
    out = {"param/" + k: (p.spec, lay) for k, p in flat(ab).items()}
    if moments:
        st = opt_state_abstract(ab, lay, config.OptimConfig(**opt))
        for part, tree in (("m", st.m), ("v", st.v)):
            out.update({f"{part}/{k}": (p.spec, lay)
                        for k, p in flat(tree or {}).items()})
    return out


def _block(want, spec, lay):
    return shard(torch.from_numpy(np.asarray(want)), spec, lay).numpy()


@pytest.mark.parametrize("name", sorted(PLANS))
def test_zero_trajectory_matches_jax_zero0(world, name):
    """Every step's loss and gnorm, and every parameter shard after the
    steps, within 1e-2 of JAX's stage-0 run; each rank's moment blocks
    within 1e-3 of the largest value of JAX's moment at the rank's
    coordinates under the ZeRO spec."""
    want = world["jax"]
    ref = REF[name]
    for r, got in enumerate(world["ranks"][name]):
        for s in range(STEPS):
            for key in ("loss", "gnorm"):
                assert abs(float(got[f"{key}{s}"])
                           - float(want[f"{ref}/{key}{s}"])) <= 1e-2, (
                    name, r, key, s)
        for k, (spec, lay) in _specs(PLANS[name], r, True,
                                     OPTS[name]).items():
            glob = want[f"{ref}/{k}"]
            err = float(np.abs(got[k] - _block(glob, spec, lay)).max())
            if k.startswith("param/"):
                assert err <= 1e-2, (name, r, k, err)
            else:
                assert err <= 1e-3 * float(np.abs(glob).max()), (name, r, k)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_zero_moment_bytes_shrink_by_data_degree(world, name):
    """Each AdamW rank's moments 1/(pod*dp) of stage 0's, as
    ``sharded_bytes`` of their ZeRO specs counts them (at stage 2 the f32
    accumulation buffer, on the moments' specs, too); Adafactor's stats
    as many bytes as at stage 0, on the parameters' specs."""
    n_data = PLANS[name].get("n_pod", 1) * PLANS[name]["n_dp"]
    for r, got in enumerate(world["ranks"][name]):
        lay = _lay(PLANS[name], r)
        st = opt_state_abstract(transformer.abstract_params(
            port_cfg(ARCH, {}), lay), lay, config.OptimConfig(**OPTS[name]))
        assert int(got["bytes"]) == sharded_bytes(st.m or {}, lay) + \
            sharded_bytes(st.v, lay)
        ratio = float(got["bytes"]) / float(got["bytes0"])
        if st.m is None:
            assert ratio == 1.0, (name, ratio)
            continue
        assert 0.8 / n_data <= ratio <= 1.1 / n_data, (name, ratio)
        if lay.effective_zero_stage() == 2:
            ratio = sharded_bytes(st.m, lay) / (
                4 * float(got["param_values"]))
            assert 0.8 / n_data <= ratio <= 1.1 / n_data, ratio


def test_jax_restores_port_zero1_checkpoint_at_dp4(world):
    """The port's dp 2 / ZeRO 1 save, restored by the JAX store at dp 4:
    each rank's parameter and moment shards, bit-equal."""
    index = json.loads((world["dir"] / "port_ckpt" / f"step_{STEPS:08d}" /
                        "index.json").read_text())
    assert index["meta"]["zero_stage"] == 1
    assert index["meta"]["mesh"]["dp"] == 2
    glob = world["jax_restored"]
    assert int(glob["step"]) == STEPS
    for r, got in enumerate(world["ranks"]["zero1"]):
        assert int(got["step"]) == STEPS
        specs = _specs(PLANS["zero1"], r, True)
        assert sorted(specs) == sorted(k for k in glob if k != "step")
        for k, (spec, lay) in specs.items():
            assert np.array_equal(got[k], _block(glob[k], spec, lay)), (r, k)


def test_port_restores_jax_zero1_checkpoint_at_dp4(world):
    """JAX's dp 2 / ZeRO 1 save, restored by the port's ranks at dp 4:
    every shard bit-equal to JAX's value, and one more step's loss within
    1e-2 of JAX's."""
    glob = world["saved"]
    for r, got in enumerate(world["ranks"]["restored"]):
        assert int(got["step"]) == STEPS
        for k, (spec, lay) in _specs(DP4, r, True).items():
            assert np.array_equal(got[k], _block(glob[k], spec, lay)), (r, k)
        assert abs(float(got["post"]) - float(world["jax"]["zero0/post"])) \
            <= 1e-2


def test_port_restores_jax_zero1_checkpoint_on_one_device(world):
    cfg = port_cfg(ARCH, {})
    lay = ParallelPlan().validate().build()
    ab = transformer.abstract_params(cfg, lay)
    params, state, _ = store.restore(
        str(world["dir"] / "jax_ckpt"), STEPS, ab,
        opt_state_abstract(ab, lay, config.OptimConfig(**OPT)),
        device="cpu", dtype=torch.float32, layout=lay)
    assert state.step == STEPS
    glob = world["saved"]
    got = {"param/" + k: v for k, v in flat(params).items()}
    got.update({"m/" + k: v for k, v in flat(state.m).items()})
    got.update({"v/" + k: v for k, v in flat(state.v).items()})
    assert sorted(got) == sorted(k for k in glob if k != "step")
    for k, t in got.items():
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(),
                                                           glob[k]), k


def test_adafactor_checkpoint_moves_from_dp2_zero2_to_dp4(world):
    """The port's Adafactor save at dp 2 / ZeRO 2: each rank's final
    parameter and stat shards bit-equal to the global values the JAX store
    restores at dp 4 (the reference's keys, ``v/<path>/row`` and ``col``),
    and the port's ranks' own restore at dp 4 bit-equal to them too."""
    index = json.loads((world["dir"] / "port_ada_ckpt" /
                        f"step_{STEPS:08d}" / "index.json").read_text())
    assert index["meta"]["zero_stage"] == 2
    assert not any(k.startswith("opt/.m/") for k in index["leaves"])
    glob = world["jax_ada_restored"]
    assert int(glob["step"]) == STEPS
    assert any(k.endswith("/row") for k in glob)
    for plan, name in ((PLANS["ada_zero2_mb2"], "ada_zero2_mb2"),
                       (DP4, "ada_restored")):
        for r, got in enumerate(world["ranks"][name]):
            assert int(got["step"]) == STEPS
            specs = _specs(plan, r, True, ADA)
            assert sorted(specs) == sorted(k for k in glob if k != "step")
            for k, (spec, lay) in specs.items():
                assert np.array_equal(got[k], _block(glob[k], spec, lay)), (
                    name, r, k)
