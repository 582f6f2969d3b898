"""The port's dense training on 8 ranks against the JAX package's at the
same layout on 8 host devices, in f32: reduced tinyllama-1.1b and
gemma-2b (one kv head, replicated over the head axis: the island's
sliced-kv branch) on the cube (2, 2, 2) and on dp 2 x cube (2, 2, 1)
(``tests/test_multidev.py:66-67``).

One JAX subprocess and one world of 8 gloo ranks run at once
(``test_torch_multirank_islands.py``'s machinery).  The weights are the
port's seeded init, handed to JAX as arrays; each rank keeps its shards
(``convert.params_from_jax(layout=)``) and its shard of each batch
(``data.pipeline.shard_batch``).  Held: the loss, and every gradient
leaf's shard on every rank within 1e-4 of the leaf's largest value
against JAX's at the rank's coordinates; then three AdamW steps at two
microbatches (the train step, its leaf sync and the sharded global norm;
at dp 2 the moments on their ZeRO-1 shards, the default):
each step's loss and gnorm, and every parameter shard, within 1e-2
(each side also saves its optimizer's ``v`` tree under ``state/``).
``run_train``, ``check_grads`` and ``check_steps`` serve
``test_torch_multirank_more.py`` too.
"""
import numpy as np
import pytest
import torch

from repro_torch.config import reduced
from repro_torch.configs.registry import get
from repro_torch.core.params import init_params, tree_leaves
from repro_torch.models import transformer
from test_torch_multirank_islands import (LAYOUTS, WORLD, held, layout_of,
                                          run_jax, run_ranks, wait_jax)

# arch -> the reduced config's change
ARCHS = {"tinyllama-1.1b": {}, "gemma-2b": {}}
B, S, STEPS = 8, 32, 3
OPT = dict(lr=3e-3, warmup=2, total_steps=3)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def batch(vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -5:] = -1                              # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


def port_cfg(arch, change):
    """The reduced config of ``arch`` (a registry name, or one with an
    ``@tag`` that tells two configs of one arch apart) with ``change``;
    its "moe" entry, a dict, changes the MoE config's fields."""
    import dataclasses
    cfg = reduced(get(arch.split("@")[0]))
    change = dict(change)
    if "moe" in change:
        change["moe"] = dataclasses.replace(cfg.moe, **change["moe"])
    return dataclasses.replace(cfg, **change)


def write_inputs(tmp, archs):
    """The seeded f32 weights and the batches of each arch."""
    for arch, change in archs.items():
        cfg = port_cfg(arch, change)
        p = init_params(transformer.abstract_params(cfg),
                        torch.Generator().manual_seed(0), "cpu",
                        torch.float32)
        np.savez(tmp / f"{arch}_params.npz",
                 **{k: v.numpy() for k, v in flat(p).items()})
        for s in range(STEPS + 1):
            np.savez(tmp / f"{arch}_batch{s}.npz", **batch(cfg.vocab, s))


JAX_SCRIPT = r"""
import dataclasses, os
import numpy as np
import jax, jax.numpy as jnp
from repro import config
from repro.config import reduced
from repro.configs.registry import get
from repro.core.params import init_params, shardings
from repro.core.topology import make_layout
from repro.models import transformer
from repro.optim.optimizers import opt_state_abstract
from repro.train.step import make_train_step

d = os.environ["MR_DIR"]
ARCHS, LAYOUTS, RUNS, MB = %(archs)r, %(layouts)r, %(runs)r, %(mb)d
OPT = config.OptimConfig(**%(opt)r)


def unflat(dd):
    out = {}
    for path, v in dd.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(v)
    return out


def make_cfg(arch, change):
    cfg = reduced(get(arch.split("@")[0]))
    change = dict(change)
    if "moe" in change:
        change["moe"] = dataclasses.replace(cfg.moe, **change["moe"])
    return dataclasses.replace(cfg, **change)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(jax.device_get(tree), np.float32)}


def load(name):
    return {k: jnp.asarray(v) for k, v in np.load(os.path.join(d, name)).items()}


for arch, change in ARCHS.items():
    cfg = make_cfg(arch, change)
    p0 = unflat(dict(np.load(os.path.join(d, f"{arch}_params.npz"))))
    for lname, nsteps in RUNS[arch].items():
        kw = dict(LAYOUTS[lname])
        if "cube" in kw:
            kw["cube"] = tuple(kw["cube"])
        kw.setdefault("strategy", "3d")
        lay = make_layout(zero_stage=0, **kw)
        params = jax.device_put(p0, shardings(
            transformer.abstract_params(cfg, lay), lay))
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: transformer.forward(cfg, lay, p, b, mode="train"),
            has_aux=True))(params, load(f"{arch}_batch0.npz"))
        out = {"loss": np.asarray(loss, np.float32)}
        out.update({"grad/" + k: v for k, v in flat(grads).items()})
        lay_mb = make_layout(zero_stage=0, microbatches=MB, **kw)
        state = init_params(opt_state_abstract(
            transformer.abstract_params(cfg, lay_mb), lay_mb, OPT),
            jax.random.key(1))
        step = jax.jit(make_train_step(cfg, lay_mb, OPT))
        for s in range(nsteps):
            params, state, met = step(params, state,
                                      load(f"{arch}_batch{s + 1}.npz"))
            for key in ("loss", "gnorm", "lr"):
                out[f"step{s}/{key}"] = np.asarray(met[key], np.float32)
        out.update({"param/" + k: v for k, v in flat(params).items()})
        out.update({"state/" + k: v for k, v in flat(state.v).items()})
        np.savez(os.path.join(d, f"jax_{arch}_{lname}.npz"), **out)
print("JAX-OK")
"""

RANK_SCRIPT = r"""
import dataclasses, os
import numpy as np
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
from repro_torch.models import transformer
from repro_torch.optim import adamw_init
from repro_torch.train.step import leaf_sync_axes, make_train_step

torch.set_num_threads(1)
me = ranks.rank_env()
ranks.init_world(me, "gloo", torch.device("cpu"))
d = os.environ["MR_DIR"]
ARCHS, LAYOUTS, RUNS, MB = %(archs)r, %(layouts)r, %(runs)r, %(mb)d
OPT = config.OptimConfig(**%(opt)r)


def unflat(dd):
    out = {}
    for path, v in dd.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def make_cfg(arch, change):
    cfg = reduced(get(arch.split("@")[0]))
    change = dict(change)
    if "moe" in change:
        change["moe"] = dataclasses.replace(cfg.moe, **change["moe"])
    return dataclasses.replace(cfg, **change)


def after_layout(arch, lname, lay, cfg, params, state, out):
    pass


%(extra)s


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().float().numpy()}


for arch, change in ARCHS.items():
    cfg = make_cfg(arch, change)
    p0 = unflat(dict(np.load(os.path.join(d, f"{arch}_params.npz"))))
    for lname, nsteps in RUNS[arch].items():
        kw = LAYOUTS[lname]
        lay = comm.init(make_layout(rank=me.rank, **dict(
            {"strategy": "3d"}, **kw)), "gloo")
        params = params_from_jax(p0, "cpu", cfg=cfg, layout=lay)

        def shard(s):
            b = dict(np.load(os.path.join(d, f"{arch}_batch{s}.npz")))
            return to_device(shard_batch(b, lay), "cpu")

        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = transformer.forward(cfg, lay, live, shard(0), mode="train")
        grads = torch.autograd.grad(loss, tree_leaves(live))
        # the train step's sync of the leaves outside the islands
        abstract = tree_leaves(transformer.abstract_params(cfg, lay))
        grads = [comm.psum(lay, g, leaf_sync_axes(p, lay))
                 for g, p in zip(grads, abstract)]
        it = iter(grads)
        out = {"loss": loss.detach().numpy()}
        out.update({"grad/" + k: v for k, v in flat(tree_map(
            lambda _: next(it), params)).items()})
        lay_mb = dataclasses.replace(lay, microbatches=MB)
        step = make_train_step(cfg, lay_mb, OPT)
        state = adamw_init(params, lay_mb,
                           transformer.abstract_params(cfg, lay_mb), OPT)
        for s in range(nsteps):
            params, state, met = step(params, state, shard(s + 1))
            for key in ("loss", "gnorm", "lr"):
                out[f"step{s}/{key}"] = np.asarray(float(met[key]),
                                                   np.float32)
        out.update({"param/" + k: v for k, v in flat(params).items()})
        out.update({"state/" + k: v for k, v in flat(state.v).items()})
        after_layout(arch, lname, lay, cfg, params, state, out)
        np.savez(os.path.join(d, f"rank{me.rank}_{arch}_{lname}.npz"), **out)
print("RANK-OK")
"""


def fill(script, archs, mb, layouts, runs, opt=None, extra=""):
    layouts = {k: dict(v, cube=list(v["cube"])) if "cube" in v else v
               for k, v in layouts.items()}
    return script % {"archs": archs, "layouts": layouts, "runs": runs,
                     "mb": mb, "opt": opt or OPT, "extra": extra}


def run_train(tmp, archs, mb, layouts=LAYOUTS, steps=None, opt=None,
              runs=None, extra=""):
    """Run both sides, a JAX subprocess for each arch beside the ranks, at
    each of ``layouts``, with the optimizer steps (AdamW, or ``opt``'s
    OptimConfig fields) for the archs of ``steps`` (None: every arch);
    ``runs`` ({arch: {layout: steps}}) names the layouts and steps of each
    arch instead.  ``extra`` is code for the ranks that may redefine
    ``after_layout(arch, lname, lay, cfg, params, state, out)``, called
    after each layout's steps in the world of 8 ranks.  Returns
    {(arch, layout): (jax outputs, [rank outputs])}.  The port's ranks
    run at the layouts' default ZeRO stage, the JAX side at stage 0."""
    runs = runs or {a: {ln: STEPS if steps is None or a in steps else 0
                        for ln in layouts} for a in archs}
    write_inputs(tmp, archs)
    jobs = [run_jax(fill(JAX_SCRIPT, {a: archs[a]}, mb, layouts, runs, opt),
                    tmp, f"jax_{a}") for a in archs]
    try:
        run_ranks(fill(RANK_SCRIPT, archs, mb, layouts, runs, opt, extra),
                  tmp, timeout=600)
    finally:
        for job in jobs:
            wait_jax(job, timeout=600)
    return {(a, ln): (dict(np.load(tmp / f"jax_{a}_{ln}.npz")),
                      [dict(np.load(tmp / f"rank{r}_{a}_{ln}.npz"))
                       for r in range(WORLD)])
            for a in archs for ln in runs[a]}


def check_grads(res, arch, change, lname, layouts=LAYOUTS):
    want, ranks = res[(arch, lname)]
    cfg = port_cfg(arch, change)
    bad = []
    for r, got in enumerate(ranks):
        lay = layout_of(lname, r, layouts)
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-4, (
            r, float(got["loss"]), float(want["loss"]))
        specs = flat(transformer.abstract_params(cfg, lay))
        assert {"grad/" + k for k in specs} == {
            k for k in want if k.startswith("grad/")}
        for k, p in specs.items():
            ok, info = held(got["grad/" + k], want["grad/" + k], p.spec, lay,
                            what=f"rank {r} {k}")
            if not ok:
                bad.append(info)
    assert not bad, bad


def check_steps(res, arch, change, lname, layouts=LAYOUTS):
    want, ranks = res[(arch, lname)]
    cfg = port_cfg(arch, change)
    for r, got in enumerate(ranks):
        lay = layout_of(lname, r, layouts)
        for s in range(STEPS):
            for key in ("loss", "gnorm", "lr"):
                k = f"step{s}/{key}"
                assert abs(float(got[k]) - float(want[k])) <= 1e-2, (
                    r, k, float(got[k]), float(want[k]))
        for k, p in flat(transformer.abstract_params(cfg, lay)).items():
            ok, info = held(got["param/" + k], want["param/" + k], p.spec,
                            lay, tol=1.0, what=f"rank {r} {k}")
            # within 1e-2 absolute, as test_torch_train.three_adamw_steps
            assert info[1] <= 1e-2, info


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return run_train(tmp_path_factory.mktemp("train"), ARCHS, mb=2)


CASES = [(a, ln) for a in ARCHS for ln in LAYOUTS]


@pytest.mark.parametrize("arch,lname", CASES)
def test_loss_and_grad_shards_match_jax(trained, arch, lname):
    check_grads(trained, arch, ARCHS[arch], lname)


@pytest.mark.parametrize("arch,lname", CASES)
def test_three_adamw_steps_match_jax(trained, arch, lname):
    check_steps(trained, arch, ARCHS[arch], lname)
