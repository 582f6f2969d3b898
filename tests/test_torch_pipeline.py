"""The port's pipeline stages on 8 ranks against the JAX package's on 8
host devices: ``tests/test_pipeline.py``'s uniform battery (``:63-69``)
on reduced tinyllama-1.1b in f32, B 8 x S 32 with its uneven label
padding (the first two rows, microbatch 0, lose half their labels).

One JAX subprocess and one world of 8 gloo ranks run at once
(``test_torch_multirank_islands.py``'s machinery).  The weights are the
port's seeded pp = 1 init, handed to JAX as arrays; each package re-cuts
the layer stack into its (pp, slots, ...) stage slabs with its own
``repartition_stack``.  Held, at pp2_mb4 (pp 2 x cube (1, 2, 2), 4
microbatches): the loss, and every gradient leaf's shard on every rank
within 1e-4 of the leaf's largest value against JAX's at the rank's
coordinates (the stage slabs at the rank's stage, after the train step's
leaf sync, the leaves replicated over pp summed over it), and the
forward alone (``forward(mode="train")``) giving the same loss; three AdamW
steps, each step's loss and gnorm and every parameter shard within 1e-2
of JAX's; and the trajectories of pp1_mb4 (dp 2 x (1, 2, 2), 4
microbatches) and pp2_mb4 within 1e-2 of the port's pp1 (dp 2 x (1, 2,
2)), as ``tests/test_pipeline.py`` holds the reference's.  What pp
composes with, at pp 2 and 4 microbatches: dp 2 x (1, 1, 2) (ZeRO 1, the
default at dp > 1), the 1-D and the 2-D baselines on 4 ranks a stage, and
Adafactor on the cube; three steps at each within 1e-2 of JAX's at the
same plan (two JAX subprocesses share the compiles), and the AdamW ones'
trajectories within 1e-2 of the port's pp1.  Last, each stage boundary
moves exactly one microbatch's activation shard a microbatch: stage 0
sends them forward, stage 1 their gradients back.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.params import init_params
from repro_torch.core.topology import make_layout
from repro_torch.models import transformer
from test_torch_multirank_islands import (WORLD, held, run_jax, run_ranks,
                                          wait_jax)
from test_torch_multirank_train import flat, port_cfg

ARCH = "tinyllama-1.1b"
B, S, STEPS, M = 8, 32, 3, 4
OPT = dict(lr=1e-3, warmup=2, total_steps=10)
# tests/test_pipeline.py:63-69, make_layout's arguments (and the
# optimizer's name where it is not AdamW)
PLANS = {"pp1": dict(n_dp=2, n_model=4, cube=(1, 2, 2)),
         "pp1_mb4": dict(n_dp=2, n_model=4, cube=(1, 2, 2), microbatches=M),
         "pp2_mb4": dict(n_model=4, cube=(1, 2, 2), n_pp=2, microbatches=M),
         # what pp composes with: dp (ZeRO 1 by default), the 1-D and 2-D
         # baselines, Adafactor
         "pp2_dp2": dict(n_dp=2, n_model=2, cube=(1, 1, 2), n_pp=2,
                         microbatches=M),
         "pp2_1d": dict(n_model=4, strategy="1d", n_pp=2, microbatches=M),
         "pp2_2d": dict(n_model=4, strategy="2d", n_pp=2, microbatches=M),
         "pp2_adafactor": dict(n_model=4, cube=(1, 2, 2), n_pp=2,
                               microbatches=M, optimizer="adafactor")}
COMPOSED = ("pp2_dp2", "pp2_1d", "pp2_2d", "pp2_adafactor")


def write_inputs(tmp, cfg, steps=STEPS):
    """The port's seeded f32 pp = 1 weights and ``steps`` + 1 batches
    with the battery's uneven padding."""
    p = init_params(transformer.abstract_params(cfg),
                    torch.Generator().manual_seed(0), "cpu", torch.float32)
    np.savez(tmp / "params.npz", **{k: v.numpy() for k, v in flat(p).items()})
    for s in range(steps + 1):
        rng = np.random.default_rng(100 + s)
        labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        labels[:2, S // 2:] = -1
        np.savez(tmp / f"batch{s}.npz",
                 tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                 labels=labels)


PRELUDE = r"""
import dataclasses, os, time
import numpy as np
d = os.environ["MR_DIR"]
ARCH, STEPS, PLANS, CHANGE = %(arch)r, %(steps)d, %(plans)r, %(change)r
OPT_KW = %(opt)r


def unflat(dd, wrap=lambda v: v):
    out = {}
    for path, v in dd.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = wrap(v)
    return out


def lay_kw(name):
    kw = dict(PLANS[name])
    kw.pop("optimizer", None)
    if "cube" in kw:
        kw["cube"] = tuple(kw["cube"])
    return kw


def opt_kw(name):
    return dict(OPT_KW, name=PLANS[name].get("optimizer", "adamw"))
"""

JAX_HEAD = PRELUDE + r"""
import jax, jax.numpy as jnp
from repro import config
from repro.config import reduced
from repro.configs.registry import get
from repro.core.params import init_params, shardings
from repro.core.topology import make_layout
from repro.models import registry, transformer
from repro.optim.optimizers import opt_state_abstract
from repro.train.step import make_train_step

cfg = dataclasses.replace(reduced(get(ARCH)), **CHANGE)
OPT = config.OptimConfig(**OPT_KW)
COMPOSED, OUT = %(composed)r, %(out)r


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(jax.device_get(tree), np.float32)}


def load(name):
    return {k: jnp.asarray(v) for k, v in np.load(os.path.join(d, name)).items()}


p1 = unflat(dict(np.load(os.path.join(d, "params.npz"))), jnp.asarray)
lay1 = make_layout(zero_stage=0, **lay_kw("pp1"))
out = {}
"""

# pp2_mb4: the loss and gradients, then three steps
JAX_SCRIPT = JAX_HEAD + r"""
lay = make_layout(zero_stage=0, **lay_kw("pp2_mb4"))
p2 = dict(p1, stack=registry.repartition_stack(cfg, p1["stack"], lay1, lay))
ab = transformer.abstract_params(cfg, lay)
params = jax.device_put(p2, shardings(ab, lay))
(loss, _), grads = jax.jit(jax.value_and_grad(
    lambda p, b: transformer.forward(cfg, lay, p, b, mode="train"),
    has_aux=True))(params, load("batch0.npz"))
out["loss"] = np.asarray(loss, np.float32)
out.update({"grad/" + k: v for k, v in flat(grads).items()})
state = init_params(opt_state_abstract(ab, lay, OPT), jax.random.key(1))
step = jax.jit(make_train_step(cfg, lay, OPT))
for s in range(STEPS):
    params, state, met = step(params, state, load(f"batch{s + 1}.npz"))
    for key in ("loss", "gnorm"):
        out[f"step{s}/{key}"] = np.asarray(met[key], np.float32)
out.update({"param/" + k: v for k, v in flat(params).items()})
"""

# three steps at each plan of COMPOSED, its keys under the plan's name
JAX_COMPOSED = r"""
for name in COMPOSED:       # the plan's own ZeRO default, as the port's
    lay = make_layout(**lay_kw(name))
    opt = config.OptimConfig(**opt_kw(name))
    ab = transformer.abstract_params(cfg, lay)
    params = jax.device_put(dict(p1, stack=registry.repartition_stack(
        cfg, p1["stack"], lay1, lay)), shardings(ab, lay))
    state = init_params(opt_state_abstract(ab, lay, opt), jax.random.key(1))
    step = jax.jit(make_train_step(cfg, lay, opt))
    for s in range(STEPS):
        params, state, met = step(params, state, load(f"batch{s + 1}.npz"))
        for key in ("loss", "gnorm"):
            out[f"{name}/step{s}/{key}"] = np.asarray(met[key], np.float32)
    out.update({f"{name}/param/" + k: v for k, v in flat(params).items()})
np.savez(os.path.join(d, OUT + ".npz"), **out)
print("JAX-OK")
"""
# two JAX subprocesses beside the ranks, each compiling about half the
# train steps
JAX_JOBS = {"jax": (JAX_SCRIPT + JAX_COMPOSED, COMPOSED[:2]),
            "jax2": (JAX_HEAD + JAX_COMPOSED, COMPOSED[2:])}

RANK_SCRIPT = PRELUDE + r"""
import torch
from repro_torch import config
from repro_torch.config import reduced
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core import comm
from repro_torch.core.params import tree_leaves, tree_map
from repro_torch.core.topology import make_layout
from repro_torch.data.pipeline import shard_batch, to_device
from repro_torch.launch import ranks
from repro_torch.models import registry
from repro_torch.optim import adamw_init
from repro_torch.models import transformer
from repro_torch.train.step import loss_and_grads, make_train_step

torch.set_num_threads(1)
me = ranks.rank_env()
ranks.init_world(me, "gloo", torch.device("cpu"))
cfg = dataclasses.replace(reduced(get(ARCH)), **CHANGE)
p1 = unflat(dict(np.load(os.path.join(d, "params.npz"))))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().float().numpy()}


for name in PLANS:
    lay = comm.init(make_layout(rank=me.rank, **lay_kw(name)), "gloo")
    tree = dict(p1)
    if lay.size("pp") > 1:
        tree["stack"] = registry.repartition_stack(cfg, p1["stack"], 1, lay)
    params = params_from_jax(tree, "cpu", cfg=cfg, layout=lay)

    def shard(s):
        b = dict(np.load(os.path.join(d, f"batch{s}.npz")))
        return to_device(shard_batch(b, lay), "cpu")

    out = {}
    if name == "pp2_mb4":
        comm.reset_bytes()
        loss, _, grads = loss_and_grads(cfg, lay, params, shard(0))
        out["permute_bytes"] = comm.bytes_moved()["by_kind"][
            "collective-permute"]
        it = iter(grads)
        out["loss"] = loss.numpy()
        # the forward alone (no backward through the stages)
        out["fwd_loss"] = transformer.forward(cfg, lay, params, shard(0),
                                              mode="train")[0].numpy()
        out.update({"grad/" + k: v for k, v in flat(tree_map(
            lambda _: next(it), params)).items()})
    opt = config.OptimConfig(**opt_kw(name))
    step = make_train_step(cfg, lay, opt)
    state = adamw_init(params, lay, transformer.abstract_params(cfg, lay),
                       opt)
    for s in range(STEPS):
        params, state, met = step(params, state, shard(s + 1))
        for key in ("loss", "gnorm"):
            out[f"step{s}/{key}"] = np.asarray(float(met[key]), np.float32)
    out.update({"param/" + k: v for k, v in flat(params).items()})
    np.savez(os.path.join(d, f"rank{me.rank}_{name}.npz"), **out)
print("RANK-OK")
"""


def fill(script, plans=PLANS, change=None, composed=(), out=""):
    plans = {k: {a: list(b) if a == "cube" else b for a, b in v.items()}
             for k, v in plans.items()}
    return script % {"arch": ARCH, "steps": STEPS, "plans": plans,
                     "change": change or {}, "opt": OPT,
                     "composed": tuple(composed), "out": out}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    write_inputs(tmp, port_cfg(ARCH, {}))
    runs = [run_jax(fill(script, composed=composed, out=out), tmp, out)
            for out, (script, composed) in JAX_JOBS.items()]
    try:
        run_ranks(fill(RANK_SCRIPT), tmp, timeout=240)
    finally:
        for run in runs:
            wait_jax(run, timeout=240)
    return {"jax": {k: v for out in JAX_JOBS
                    for k, v in np.load(tmp / f"{out}.npz").items()},
            "ranks": {n: [dict(np.load(tmp / f"rank{r}_{n}.npz"))
                          for r in range(WORLD)] for n in PLANS}}


def _lay(name, rank):
    kw = dict(PLANS[name])
    kw.pop("optimizer", None)
    return make_layout(rank=rank, **kw)


def test_pp2_loss_and_grad_shards_match_jax(world):
    want, cfg, bad = world["jax"], port_cfg(ARCH, {}), []
    for r, got in enumerate(world["ranks"]["pp2_mb4"]):
        lay = _lay("pp2_mb4", r)
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-4, (
            r, float(got["loss"]), float(want["loss"]))
        assert abs(float(got["fwd_loss"]) - float(got["loss"])) <= 1e-6
        specs = flat(transformer.abstract_params(cfg, lay))
        assert {"grad/" + k for k in specs} == {
            k for k in want if k.startswith("grad/")}
        for k, p in specs.items():
            ok, info = held(got["grad/" + k], want["grad/" + k], p.spec, lay,
                            what=f"rank {r} {k}")
            if not ok:
                bad.append(info)
    assert not bad, bad


def test_pp2_three_adamw_steps_match_jax(world):
    want, cfg = world["jax"], port_cfg(ARCH, {})
    for r, got in enumerate(world["ranks"]["pp2_mb4"]):
        lay = _lay("pp2_mb4", r)
        for s in range(STEPS):
            for key in ("loss", "gnorm"):
                k = f"step{s}/{key}"
                assert abs(float(got[k]) - float(want[k])) <= 1e-2, (
                    r, k, float(got[k]), float(want[k]))
        for k, p in flat(transformer.abstract_params(cfg, lay)).items():
            _, info = held(got["param/" + k], want["param/" + k], p.spec,
                           lay, tol=1.0, what=f"rank {r} {k}")
            assert info[1] <= 1e-2, info


@pytest.mark.parametrize("name", COMPOSED)
def test_pp2_compositions_match_jax(world, name):
    """pp beside dp (ZeRO 1 by default), the 1-D and 2-D baselines, and
    Adafactor (whose stats factor each (pp, slots, ...) slab as the
    reference's do): three steps, each step's loss and gnorm and every
    parameter shard within 1e-2 of JAX's at the same plan."""
    want, cfg = world["jax"], port_cfg(ARCH, {})
    for r, got in enumerate(world["ranks"][name]):
        lay = _lay(name, r)
        assert lay.size("pp") == 2
        for s in range(STEPS):
            for key in ("loss", "gnorm"):
                k = f"step{s}/{key}"
                assert abs(float(got[k]) - float(want[f"{name}/{k}"])) \
                    <= 1e-2, (name, r, k, float(got[k]),
                              float(want[f"{name}/{k}"]))
        for k, p in flat(transformer.abstract_params(cfg, lay)).items():
            _, info = held(got["param/" + k], want[f"{name}/param/" + k],
                           p.spec, lay, tol=1.0, what=f"{name} rank {r} {k}")
            assert info[1] <= 1e-2, info


@pytest.mark.parametrize("name", ["pp1_mb4", "pp2_mb4", "pp2_dp2", "pp2_1d",
                                  "pp2_2d"])
def test_trajectory_matches_pp1(world, name):
    ref = world["ranks"]["pp1"][0]
    for r, got in enumerate(world["ranks"][name]):
        diffs = [abs(float(got[f"step{s}/loss"]) - float(ref[f"step{s}/loss"]))
                 for s in range(STEPS)]
        assert max(diffs) <= 1e-2, (name, r, diffs)


def test_boundary_moves_one_activation_shard_a_microbatch(world):
    """Stage 0 sends each microbatch's (B/m, S/y, d/z) f32 shard forward;
    the last stage sends its gradient back; nothing else crosses pp."""
    cfg = port_cfg(ARCH, {})
    lay = _lay("pp2_mb4", 0)
    shard_bytes = (B // M) * (S // lay.size("y")) * \
        (cfg.d_model // lay.size("z")) * 4
    for r, got in enumerate(world["ranks"]["pp2_mb4"]):
        assert float(got["permute_bytes"]) == M * shard_bytes, (
            r, float(got["permute_bytes"]), M * shard_bytes)
