"""The port's pipeline pieces against the JAX package's, on the CPU.

In process: ``stage_assignment``, ``pipeline_info`` and
``pipeline_unsupported_reason`` equal the reference's on the cases of
``tests/test_pipeline_families.py:28-117`` (messages included), and so do
the plan's pipeline checks; the stage slabs of ``abstract_params`` equal
the reference's leaf for leaf; ``repartition_stack`` equals the
reference's on the same numpy trees (pp1 -> pp2 -> pp1, 3 layers over pp
2, xlstm's union slots); ``pipeline_report`` equals the reference's.
``ParallelPlan.validate`` with a speculative ``draft`` gives the
reference's outcome and message (ROADMAP.md Queue 3, fault 7), and the
serve launcher refuses an illegal pairing before it builds any weights.

Then one world of 8 gloo ranks beside one JAX subprocess of 8 host
devices (``test_torch_multirank_islands.py``'s machinery), reduced
tinyllama-1.1b in f32:

  * non-divisible depth (``tests/test_pipeline_families.py:209-258``): 3
    layers at pp2_mb4, the second stage's padding slot skipped, against
    pp1_mb4 (dp 2 x (1, 2, 2)), three AdamW steps within 1e-2, the
    padding slot's gradient exactly 0;
  * a checkpoint re-cut between the packages: the port saves at pp 2
    after one step, and the JAX store restores it bit for bit and re-cuts
    it to pp 1 by its ``repartition_stack``, bit for bit the port's
    re-cut; a JAX checkpoint saved at pp 1 restores on the port's pp 2
    ranks (``store.restore(cfg=...)``, which re-cuts by the port's
    ``repartition_stack``), every shard bit for bit, and without ``cfg``
    fails on the shape.
"""
import dataclasses
import json
import os
import types
import warnings

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.config import reduced as jreduced
from repro.configs.registry import get as jget
from repro.core import pipeline as jpipeline
from repro.core import topology as jtopology
from repro.core.plan import ParallelPlan as JPlan
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch.core import pipeline
from repro_torch.core.params import shard, tree_zip
from repro_torch.core.plan import ParallelPlan
from repro_torch.core.topology import make_layout, stage_assignment
from repro_torch.launch import serve as serve_launch
from repro_torch.models import registry, transformer
from test_torch_multirank_islands import WORLD, run_jax, run_ranks, wait_jax
from test_torch_multirank_train import flat, port_cfg
from test_torch_pipeline import PRELUDE, write_inputs

ARCHS = ("tinyllama-1.1b", "mixtral-8x7b", "xlstm-350m", "zamba2-1.2b",
         "internvl2-2b", "whisper-medium", "deepseek-v3-671b")


def _raised(fn):
    """(exception type, message) of ``fn()``, or ("ok", result)."""
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = fn()
        return "ok", [str(x.message) for x in w], type(out).__name__
    except Exception as e:      # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)


# ---------------------------------------------------------------------------
# In process, against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,pp", [(8, 2), (6, 3), (4, 1), (5, 2), (7, 3),
                                  (3, 2), (1, 2)])
def test_stage_assignment_matches_reference(n, pp):
    assert _raised(lambda: stage_assignment(n, pp)) == _raised(
        lambda: jtopology.stage_assignment(n, pp))
    if n >= pp:
        assert make_layout(n_pp=pp, n_model=1).stage_bounds(n) == \
            stage_assignment(n, pp)


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_info_and_reason_match_reference(arch):
    for layers in (None, 1, 3):
        cfg = port_cfg(arch, {} if layers is None else {"n_layers": layers})
        jcfg = dataclasses.replace(jreduced(jget(arch)), n_layers=cfg.n_layers)
        for pp in (1, 2, 3):
            assert registry.pipeline_unsupported_reason(cfg, pp) == \
                jregistry.pipeline_unsupported_reason(jcfg, pp)
            got = _raised(lambda: registry.pipeline_info(
                registry.get_stack(cfg.family), cfg, pp))
            want = _raised(lambda: jregistry.pipeline_info(
                jregistry.get_stack(jcfg.family), jcfg, pp))
            assert got == want, (arch, layers, pp, got, want)
            if got[0] == "ok":
                a = registry.pipeline_info(registry.get_stack(cfg.family),
                                           cfg, pp)
                b = jregistry.pipeline_info(
                    jregistry.get_stack(jcfg.family), jcfg, pp)
                assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert registry.NOOP == jregistry.NOOP


PLAN_CASES = [
    (dict(n_model=4, cube=(1, 2, 2), n_stages=2, microbatches=4),
     dict(mode="decode")),
    (dict(n_stages=2, microbatches=4), dict(mode="prefill")),
    (dict(n_stages=2, microbatches=4), dict(n_layers=3)),
    (dict(n_stages=2, microbatches=1), dict(n_layers=2)),
    (dict(n_stages=4), dict(n_layers=2)),
    (dict(n_model=4, cube=(1, 2, 2), n_stages=2, microbatches=4),
     dict(n_layers=2, global_batch=8))]


@pytest.mark.parametrize("i", range(len(PLAN_CASES) + len(ARCHS)))
def test_plan_pipeline_checks_match_reference(i):
    """tests/test_pipeline_families.py:86-112: serving modes refused under
    pp, the mtp head refused, every family accepted, a non-divisible depth
    warned; the outcome, message and warnings equal the reference's."""
    if i < len(PLAN_CASES):
        kw, vkw = PLAN_CASES[i]
        got = _raised(lambda: ParallelPlan(**kw).validate(**vkw))
        want = _raised(lambda: JPlan(**kw).validate(**vkw))
    else:
        arch = ARCHS[i - len(PLAN_CASES)]
        cfg, jcfg = port_cfg(arch, {}), jreduced(jget(arch))
        got = _raised(lambda: ParallelPlan(n_stages=2, microbatches=4)
                      .validate(n_layers=cfg.n_layers, global_batch=8,
                                model=cfg))
        want = _raised(lambda: JPlan(n_stages=2, microbatches=4).validate(
            n_layers=jcfg.n_layers, global_batch=8, model=jcfg))
    assert got[:2] == want[:2], (got, want)


DRAFT_CASES = [("tinyllama-1.1b", "tinyllama-1.1b", "serve"),
               ("deepseek-v3-671b", "tinyllama-1.1b", "serve"),
               ("tinyllama-1.1b", "tinyllama-1.1b", "train"),
               (None, "tinyllama-1.1b", "serve"),
               ("zamba2-1.2b", "tinyllama-1.1b", "serve"),
               ("tinyllama-1.1b", "qwen3-4b", "serve")]


@pytest.mark.parametrize("target,draft,mode", DRAFT_CASES)
def test_plan_validates_draft_as_reference(target, draft, mode):
    """ROADMAP.md Queue 3 fault 7: a legal pairing returns the plan, an
    illegal one raises the reference's ValueError."""
    got = _raised(lambda: ParallelPlan().validate(
        n_layers=22, model=target and port_cfg(target, {}), mode=mode,
        draft=port_cfg(draft, {})))
    want = _raised(lambda: JPlan().validate(
        n_layers=22, model=target and jreduced(jget(target)), mode=mode,
        draft=jreduced(jget(draft))))
    assert got == want, (got, want)
    if target == "deepseek-v3-671b":
        assert "uses MLA latents" in got[1]


def test_serve_launcher_refuses_illegal_draft_before_weights(monkeypatch):
    def no_weights(*a, **k):
        raise AssertionError("weights built before the plan's check")
    monkeypatch.setattr("repro_torch.core.params.init_params", no_weights)
    with pytest.raises(ValueError, match="uses MLA latents"):
        serve_launch.main(["--arch", "deepseek-v3-671b", "--reduced",
                           "--device", "cpu", "--draft", "tinyllama-1.1b"])


@pytest.mark.parametrize("layers", [2, 3])
def test_stage_slabs_match_reference_abstract_params(layers):
    cfg = port_cfg("tinyllama-1.1b", {"n_layers": layers})
    jcfg = dataclasses.replace(jreduced(jget("tinyllama-1.1b")),
                               n_layers=layers)
    lay = make_layout(n_model=4, cube=(1, 2, 2), n_pp=2)
    jlay = jtopology.Layout(mesh=AbstractMesh((1, 1, 2, 1, 2, 2),
                                              jtopology.AXES))
    tree = transformer.abstract_params(cfg, lay)
    n = 0
    for p, jp in tree_zip(tree, jtransformer.abstract_params(jcfg, jlay)):
        assert p.shape == jp.shape, (p, jp)
        spec = [tuple(e) if isinstance(e, (tuple, list)) else e
                for e in (p.spec or ())]
        jspec = [tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in (jp.spec or ())]
        pad = len(p.shape)
        assert spec + [None] * (pad - len(spec)) == \
            jspec + [None] * (pad - len(jspec)), (p, jp)
        n += 1
    assert n > 8
    with pytest.raises(ValueError, match="training-only schedule"):
        transformer.forward(cfg, lay, {}, {}, mode="decode")


def test_stage_fn_skips_the_padding_slot():
    """3 layers over pp 2: stage 0 applies slots 0 and 1, stage 1 its
    slot 0 only; the padding slot is not computed."""
    cfg = port_cfg("tinyllama-1.1b", {"n_layers": 3})
    info = registry.pipeline_info(registry.get_stack(cfg.family), cfg, 2)
    slab = {"dense": {"w": torch.arange(2.0).reshape(1, 2, 1)}}
    for stage, want in ((0, [0.0, 1.0]), (1, [0.0])):
        seen = []
        fn = registry.make_stage_fn(info, stage, lambda k, x, p: (
            seen.append((k, float(p["w"]))), x + 1)[1])
        assert float(fn(torch.zeros(()), slab)) == len(want)
        assert seen == [("dense", w) for w in want], (stage, seen)


def _stack_tree(cfg, rng):
    """A random (count, 2, 3) leaf per stacked kind and sub-leaf."""
    plan = registry.layer_plan(cfg)
    return {k: {"a": rng.standard_normal((plan.count(k), 2, 3)).astype(
        np.float32), "b": {"c": rng.standard_normal(
            (plan.count(k), 4)).astype(np.float32)}}
        for k in dict.fromkeys(plan) if k != "attn"}


@pytest.mark.parametrize("arch,layers", [("tinyllama-1.1b", 2),
                                         ("tinyllama-1.1b", 3),
                                         ("tinyllama-1.1b", 5),
                                         ("xlstm-350m", None)])
def test_repartition_stack_matches_reference(arch, layers):
    import jax
    cfg = port_cfg(arch, {} if layers is None else {"n_layers": layers})
    jcfg = dataclasses.replace(jreduced(jget(arch)), n_layers=cfg.n_layers)
    tree = _stack_tree(cfg, np.random.default_rng(0))
    st = lambda n: types.SimpleNamespace(n_stages=n)    # noqa: E731
    for pps in ((1, 2, 1), (1, 3, 2, 1)):
        cur, jcur = tree, jax.tree.map(np.asarray, tree)
        for a, b in zip(pps, pps[1:]):
            if b > len(registry.layer_plan(cfg)):
                break
            cur = registry.repartition_stack(cfg, cur, a, b)
            jcur = jax.tree.map(np.asarray, jregistry.repartition_stack(
                jcfg, jcur, st(a), st(b)))
            for x, y in tree_zip(cur, jcur):
                assert x.shape == y.shape and np.array_equal(x, y), (a, b)
        if pps[-1] == 1 and len(cur):
            for x, y in tree_zip(cur, tree):
                assert np.array_equal(x, y)


@pytest.mark.parametrize("pp,m", [(1, 8), (2, 4), (4, 8), (3, 1)])
def test_pipeline_report_matches_reference(pp, m):
    assert pipeline.pipeline_report(pp, m) == jpipeline.pipeline_report(pp, m)


# ---------------------------------------------------------------------------
# 8 ranks beside JAX on 8 host devices
# ---------------------------------------------------------------------------
ARCH = "tinyllama-1.1b"
STEPS, JSTEP = 3, 5
OPT = dict(lr=1e-3, warmup=2, total_steps=10)
PLANS = {"pp1": dict(n_dp=2, n_model=4, cube=(1, 2, 2)),
         "pp1_mb4": dict(n_dp=2, n_model=4, cube=(1, 2, 2), microbatches=4),
         "pp2_mb4": dict(n_model=4, cube=(1, 2, 2), n_pp=2, microbatches=4)}

JAX_SCRIPT = PRELUDE + r"""
import jax, jax.numpy as jnp
from repro import config
from repro.checkpoint import store
from repro.config import reduced
from repro.configs.registry import get
from repro.core.params import shardings
from repro.core.topology import make_layout
from repro.models import registry, transformer
from repro.optim.optimizers import OptState, opt_state_abstract

cfg = reduced(get(ARCH))
OPT = config.OptimConfig(**OPT_KW)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(jax.device_get(tree))}


# a pp 1 checkpoint: the port's weights, moments from the test's seed
lay1 = make_layout(zero_stage=0, **lay_kw("pp1"))
ab1 = transformer.abstract_params(cfg, lay1)
p1 = unflat(dict(np.load(os.path.join(d, "params.npz"))), jnp.asarray)
mv = dict(np.load(os.path.join(d, "moments.npz")))
state = OptState(jnp.int32(%(jstep)d),
                 unflat({k[2:]: v for k, v in mv.items() if k[0] == "m"},
                        jnp.asarray),
                 unflat({k[2:]: v for k, v in mv.items() if k[0] == "v"},
                        jnp.asarray))
store.save(os.path.join(d, "jax_ckpt"), %(jstep)d,
           jax.device_put(p1, shardings(ab1, lay1)), state, layout=lay1)
open(os.path.join(d, "jax_ckpt.done"), "w").close()

# the port's pp 2 checkpoint, restored at pp 2, re-cut to pp 1
t0 = time.time()
while not os.path.exists(os.path.join(d, "port_ckpt.done")):
    assert time.time() - t0 < 200
    time.sleep(0.2)
lay2 = make_layout(zero_stage=0, **lay_kw("pp2_mb4"))
ab2 = transformer.abstract_params(cfg, lay2)
p, o, _ = store.restore(os.path.join(d, "port_ckpt"), 1, ab2, lay2,
                        opt_template=opt_state_abstract(ab2, lay2, OPT))
out = {"param/" + k: v for k, v in flat(p).items()}
out.update({"m/" + k: v for k, v in flat(o.m).items()})
out.update({"v/" + k: v for k, v in flat(o.v).items()})
for part, tree in (("param", p), ("m", o.m), ("v", o.v)):
    cut = registry.repartition_stack(cfg, tree["stack"], lay2, lay1)
    out.update({f"pp1/{part}/stack/" + k: v for k, v in flat(cut).items()})
np.savez(os.path.join(d, "jax.npz"), **out)
print("JAX-OK")
"""

RANK_SCRIPT = PRELUDE + r"""
import torch
from repro_torch import config
from repro_torch.checkpoint import store
from repro_torch.config import reduced
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core import comm
from repro_torch.core.params import tree_map
from repro_torch.core.topology import make_layout
from repro_torch.data.pipeline import shard_batch, to_device
from repro_torch.launch import ranks
from repro_torch.models import registry, transformer
from repro_torch.optim import adamw_init
from repro_torch.optim.optimizers import opt_state_abstract
from repro_torch.train.step import loss_and_grads, make_train_step

torch.set_num_threads(1)
me = ranks.rank_env()
ranks.init_world(me, "gloo", torch.device("cpu"))
OPT = config.OptimConfig(**OPT_KW)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().numpy().copy()}


def setup(name, cfg, p1):
    lay = comm.init(make_layout(rank=me.rank, **lay_kw(name)), "gloo")
    tree = dict(p1)
    if lay.size("pp") > 1:
        tree["stack"] = registry.repartition_stack(cfg, p1["stack"], 1, lay)
    return lay, params_from_jax(tree, "cpu", cfg=cfg, layout=lay)


def shard(lay, tag, s):
    b = dict(np.load(os.path.join(d, f"{tag}batch{s}.npz")))
    return to_device(shard_batch(b, lay), "cpu")


# non-divisible depth: 3 layers, pp2_mb4 against pp1_mb4
cfg3 = dataclasses.replace(reduced(get(ARCH)), n_layers=3)
p3 = unflat(dict(np.load(os.path.join(d, "nd/params.npz"))))
for name in ("pp1_mb4", "pp2_mb4"):
    lay, params = setup(name, cfg3, p3)
    out = {}
    if lay.size("pp") > 1:
        _, _, grads = loss_and_grads(cfg3, lay, params, shard(lay, "nd/", 0))
        it = iter(grads)
        out.update({"grad/" + k: v for k, v in flat(tree_map(
            lambda _: next(it), params)).items()})
    step = make_train_step(cfg3, lay, OPT)
    state = adamw_init(params, lay, transformer.abstract_params(cfg3, lay),
                       OPT)
    for s in range(STEPS):
        params, state, met = step(params, state, shard(lay, "nd/", s + 1))
        out[f"step{s}/loss"] = np.asarray(float(met["loss"]), np.float32)
    np.savez(os.path.join(d, f"rank{me.rank}_nd_{name}.npz"), **out)

# the pp 2 checkpoint after one step, for the JAX store
cfg = reduced(get(ARCH))
p1 = unflat(dict(np.load(os.path.join(d, "params.npz"))))
lay, params = setup("pp2_mb4", cfg, p1)
ab = transformer.abstract_params(cfg, lay)
oab = opt_state_abstract(ab, lay, OPT)
state = adamw_init(params, lay, ab, OPT)
params, state, _ = make_train_step(cfg, lay, OPT)(params, state,
                                                  shard(lay, "", 1))
store.save(os.path.join(d, "port_ckpt"), 1, params, state, layout=lay,
           abstract=ab, opt_abstract=oab)
if me.rank == 0:
    open(os.path.join(d, "port_ckpt.done"), "w").close()

# JAX's pp 1 checkpoint on the pp 2 ranks
t0 = time.time()
while not os.path.exists(os.path.join(d, "jax_ckpt.done")):
    assert time.time() - t0 < 200
    time.sleep(0.2)
out = {}
try:
    store.restore(os.path.join(d, "jax_ckpt"), %(jstep)d, ab, oab,
                  device="cpu", dtype=torch.float32, layout=lay)
except ValueError as e:
    out["no_cfg_error"] = np.asarray(str(e))
p, o, _ = store.restore(os.path.join(d, "jax_ckpt"), %(jstep)d, ab, oab,
                        device="cpu", dtype=torch.float32, layout=lay,
                        cfg=cfg)
out.update({"param/" + k: v for k, v in flat(p).items()})
out.update({"m/" + k: v for k, v in flat(o.m).items()})
out.update({"v/" + k: v for k, v in flat(o.v).items()})
out["step"] = np.asarray(o.step)
np.savez(os.path.join(d, f"rank{me.rank}_restored.npz"), **out)
print("RANK-OK")
"""


def fill(script):
    plans = {k: dict(v, cube=list(v["cube"])) for k, v in PLANS.items()}
    return script % {"arch": ARCH, "steps": STEPS, "plans": plans,
                     "change": {}, "opt": OPT, "jstep": JSTEP}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline_more")
    cfg = port_cfg(ARCH, {})
    write_inputs(tmp, cfg, steps=1)
    (tmp / "nd").mkdir()
    write_inputs(tmp / "nd", port_cfg(ARCH, {"n_layers": 3}))
    rng = np.random.default_rng(7)
    shapes = flat(dict(np.load(tmp / "params.npz")))
    np.savez(tmp / "moments.npz", **{
        f"{part}/{k}": (rng.standard_normal(v.shape) ** (1 + (part == "v"))
                        ).astype(np.float32)
        for part in "mv" for k, v in shapes.items()})
    run = run_jax(fill(JAX_SCRIPT), tmp)
    try:
        run_ranks(fill(RANK_SCRIPT), tmp, timeout=240)
    finally:
        wait_jax(run, timeout=240)
    load = lambda n: dict(np.load(tmp / n))  # noqa: E731
    return {"dir": tmp, "jax": load("jax.npz"),
            "moments": load("moments.npz"), "params": load("params.npz"),
            "nd": {n: [load(f"rank{r}_nd_{n}.npz") for r in range(WORLD)]
                   for n in ("pp1_mb4", "pp2_mb4")},
            "restored": [load(f"rank{r}_restored.npz")
                         for r in range(WORLD)]}


def test_non_divisible_depth_tracks_pp1_mb4(world):
    ref = world["nd"]["pp1_mb4"][0]
    for r, got in enumerate(world["nd"]["pp2_mb4"]):
        diffs = [abs(float(got[f"step{s}/loss"]) -
                     float(ref[f"step{s}/loss"])) for s in range(STEPS)]
        assert max(diffs) <= 1e-2, (r, diffs)


def test_padding_slot_gradient_is_exactly_zero(world):
    """3 layers over pp 2: stage 1's second slot is padding, skipped; its
    gradient is 0 on every leaf, every other slot's is not."""
    n = 0
    for r, got in enumerate(world["nd"]["pp2_mb4"]):
        stage = make_layout(rank=r, **PLANS["pp2_mb4"]).index("pp")
        for k, g in got.items():
            if not k.startswith("grad/stack/"):
                continue
            assert g.shape[:2] == (1, 2), (k, g.shape)
            if stage == 1:
                assert not np.any(g[0, 1]), (r, k)
                n += 1
            assert np.any(g[0, 0]), (r, k)
    assert n > 8


def _ckpt(d, step):
    """{key: global array} of a checkpoint's files, bf16 as its bits."""
    d = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    return {k: np.load(os.path.join(d, e["file"]))
            for k, e in index["leaves"].items()}, index


def test_jax_restores_port_pp2_checkpoint_and_recuts_it(world):
    files, index = _ckpt(world["dir"] / "port_ckpt", 1)
    assert index["meta"]["mesh"]["pp"] == 2
    cfg = port_cfg(ARCH, {})
    got = world["jax"]
    keys = {"param/": "params/", "m/": "opt/.m/", "v/": "opt/.v/"}
    n = 0
    for k, v in got.items():
        if k.startswith("pp1/"):
            continue
        part = k.split("/")[0] + "/"
        want = files[keys[part] + k[len(part):]]
        assert v.dtype == want.dtype and np.array_equal(v, want), k
        n += 1
    assert n == len(files) - 1          # every leaf but the step
    for part, pre in keys.items():
        tree = {}
        for k, v in files.items():
            if k.startswith(pre + "stack/"):
                node = tree
                *head, last = k[len(pre + "stack/"):].split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[last] = v
        cut = flat(registry.repartition_stack(cfg, tree, 2, 1))
        for k, v in cut.items():
            assert np.array_equal(got[f"pp1/{part}stack/{k}"], v), k
            assert v.shape[0] == cfg.n_layers


def test_port_restores_jax_pp1_checkpoint_on_pp2_ranks(world):
    cfg = port_cfg(ARCH, {})
    files, index = _ckpt(world["dir"] / "jax_ckpt", JSTEP)
    assert index["meta"]["mesh"]["pp"] == 1
    glob = {"param": world["params"],
            "m": {k[2:]: v for k, v in world["moments"].items()
                  if k[0] == "m"},
            "v": {k[2:]: v for k, v in world["moments"].items()
                  if k[0] == "v"}}
    n = 0
    for r, got in enumerate(world["restored"]):
        assert "global shape" in str(got["no_cfg_error"])
        assert int(got["step"]) == JSTEP
        lay = make_layout(rank=r, **PLANS["pp2_mb4"])
        specs = flat(transformer.abstract_params(cfg, lay))
        for part, tree in glob.items():
            stack = {k[len("stack/"):]: v for k, v in tree.items()
                     if k.startswith("stack/")}
            nested = {}
            for k, v in stack.items():
                node = nested
                *head, last = k.split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[last] = v
            cut = {"stack/" + k: v for k, v in flat(
                registry.repartition_stack(cfg, nested, 1, 2)).items()}
            for k, p in specs.items():
                want = shard(torch.from_numpy(np.ascontiguousarray(
                    cut.get(k, tree.get(k)))), p.spec, lay).numpy()
                assert np.array_equal(got[f"{part}/{k}"], want), (r, part, k)
                n += 1
    assert n == WORLD * 3 * len(flat(transformer.abstract_params(cfg)))
