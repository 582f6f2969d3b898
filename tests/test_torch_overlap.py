"""The async-TP overlap of the port's 3-D islands (``Layout.overlap``,
``core/ops3d.py``'s chunked forward, dx and dw) against the plain islands
and against the JAX package's chunked islands.

One world of 8 gloo ranks runs ``tests/test_paged_decode.py``'s overlap
battery (``:266-353``) on reduced paper-transformer (d_model 256, 2
layers, no remat) in f32, B 8 x S 128: at the cube (1, 2, 4), at (2, 2,
2), at dp 2 x (1, 2, 2) and at pp 2 x (1, 2, 2) with 2 microbatches, the
loss and every gradient shard (the train step's, its leaf sync included)
with ``overlap_chunks=4`` within 1e-4 of the plain islands'; and the
battery's ZeRO-1 trajectory, three AdamW steps in the config's bf16 at dp
2 x (1, 2, 2), within 5e-3.  In the same world one ``matmul3d`` island
in bf16 at (2, 2, 2), forward and backward, counts its collective bytes
by kind: the all-gathers the plain island's, the forward's and dx's
reduce-scatters k f32 partials each (k · 4 / 2 = 8 times the plain
bytes), dw's the plain bytes in k row blocks.

Beside the ranks one JAX subprocess on 8 host devices runs the same
model at (2, 2, 2) with overlap (the reference battery runs only cubes
with x = 1, where dx's (sx, f_loc) reshape is the identity): the port's
loss and every gradient shard within 1e-4 of JAX's.  The rest needs no
rank: ``_overlap_k`` against the reference's, the plan's two messages,
and the chunked island on one device against the plain one.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.config import reduced
from repro_torch.configs.registry import get
from repro_torch.core.params import init_params
from repro_torch.core.topology import make_layout
from repro_torch.models import transformer
from test_torch_multirank_islands import (WORLD, held, run_jax, run_ranks,
                                          wait_jax)
from test_torch_multirank_train import flat

ARCH = "paper-transformer"
B, S, CHUNKS, STEPS = 8, 128, 4, 3
# tests/test_paged_decode.py:287-291 and (2, 2, 2); make_layout's
# arguments
LAYOUTS = {"cube124": dict(n_model=8, cube=(1, 2, 4)),
           "cube222": dict(n_model=8, cube=(2, 2, 2)),
           "dp2": dict(n_dp=2, n_model=4, cube=(1, 2, 2)),
           "pp2": dict(n_model=4, cube=(1, 2, 2), n_pp=2, microbatches=2)}
# the battery's ZeRO-1 run (tests/test_paged_decode.py:305-323)
OPT = dict(lr=1e-3, warmup=1, total_steps=3)
ISLAND = dict(b=2, s=16, h=32, f=48)      # (B, S, H) @ (H, F), bf16


def cfg_f32():
    return dataclasses.replace(reduced(get(ARCH)), dtype="float32")


def write_inputs(tmp):
    """The port's seeded f32 weights and ``STEPS`` + 1 batches."""
    cfg = cfg_f32()
    p = init_params(transformer.abstract_params(cfg),
                    torch.Generator().manual_seed(0), "cpu", torch.float32)
    np.savez(tmp / "params.npz", **{k: v.numpy() for k, v in flat(p).items()})
    for s in range(STEPS + 1):
        rng = np.random.default_rng(200 + s)
        toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        np.savez(tmp / f"batch{s}.npz", tokens=toks[:, :-1],
                 labels=toks[:, 1:])


PRELUDE = r"""
import dataclasses, os
import numpy as np
d = os.environ["MR_DIR"]
ARCH, LAYOUTS, CHUNKS, STEPS = %(arch)r, %(layouts)r, %(chunks)d, %(steps)d
OPT, ISLAND = %(opt)r, %(island)r


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
    return dict(LAYOUTS[name], cube=tuple(LAYOUTS[name]["cube"]))
"""

JAX_SCRIPT = PRELUDE + r"""
import jax, jax.numpy as jnp
from repro.config import reduced
from repro.configs.registry import get
from repro.core.params import shardings
from repro.core.topology import make_layout
from repro.models import transformer

cfg = dataclasses.replace(reduced(get(ARCH)), dtype="float32")
lay = make_layout(overlap=True, overlap_chunks=CHUNKS, **lay_kw("cube222"))
p = unflat(dict(np.load(os.path.join(d, "params.npz"))), jnp.asarray)
params = jax.device_put(p, shardings(transformer.abstract_params(cfg, lay),
                                     lay))
b = {k: jnp.asarray(v)
     for k, v in np.load(os.path.join(d, "batch0.npz")).items()}
(loss, _), grads = jax.jit(jax.value_and_grad(
    lambda p, b: transformer.forward(cfg, lay, p, b, mode="train"),
    has_aux=True))(params, b)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(jax.device_get(tree), np.float32)}


np.savez(os.path.join(d, "jax.npz"), loss=np.asarray(loss, np.float32),
         **{"grad/" + k: v for k, v in flat(grads).items()})
print("JAX-OK")
"""

RANK_SCRIPT = PRELUDE + r"""
import torch
from repro_torch import config
from repro_torch.config import reduced
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core import comm, ops3d
from repro_torch.core.params import init_params, tree_map
from repro_torch.core.topology import make_layout
from repro_torch.data.pipeline import shard_batch, to_device
from repro_torch.launch import ranks
from repro_torch.models import registry, transformer
from repro_torch.optim import adamw_init
from repro_torch.train.step import loss_and_grads, make_train_step

torch.set_num_threads(1)
me = ranks.rank_env()
ranks.init_world(me, "gloo", torch.device("cpu"))
cfg = dataclasses.replace(reduced(get(ARCH)), dtype="float32")
p1 = unflat(dict(np.load(os.path.join(d, "params.npz"))))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().float().numpy()}


def layout(name, overlap, **more):
    return comm.init(make_layout(rank=me.rank, overlap=overlap,
                                 overlap_chunks=CHUNKS,
                                 **dict(lay_kw(name), **more)), "gloo")


def shard(lay, s):
    b = dict(np.load(os.path.join(d, f"batch{s}.npz")))
    return to_device(shard_batch(b, lay), "cpu")


out = {}
for name in LAYOUTS:
    for overlap in (False, True):
        lay = layout(name, overlap)
        tree = dict(p1)
        if lay.size("pp") > 1:
            tree["stack"] = registry.repartition_stack(cfg, p1["stack"], 1,
                                                       lay)
        params = params_from_jax(tree, "cpu", cfg=cfg, layout=lay)
        loss, _, grads = loss_and_grads(cfg, lay, params, shard(lay, 0))
        it = iter(grads)
        tag = f"{name}/{int(overlap)}/"
        out[tag + "loss"] = loss.detach().numpy()
        out.update({tag + "grad/" + k: v for k, v in flat(tree_map(
            lambda _: next(it), params)).items()})

# the battery's ZeRO-1 trajectory, in the config's bf16
bcfg = reduced(get(ARCH))
opt = config.OptimConfig(**OPT)
for overlap in (False, True):
    lay = layout("dp2", overlap, zero_stage=1)
    abstract = transformer.abstract_params(bcfg, lay)
    params = init_params(abstract, torch.Generator().manual_seed(0), "cpu",
                         torch.bfloat16, layout=lay)
    state = adamw_init(params, lay, abstract, opt)
    step = make_train_step(bcfg, lay, opt)
    for s in range(STEPS):
        params, state, met = step(params, state, shard(lay, s + 1))
        out[f"zero1/{int(overlap)}/step{s}"] = np.float32(float(met["loss"]))

# one island's bytes by kind at (2, 2, 2) in bf16, forward and backward
for overlap in (False, True):
    lay = layout("cube222", overlap)
    g = torch.Generator().manual_seed(7 + me.rank)
    i = ISLAND
    sz = lambda a: lay.size(a)
    x = torch.randn(i["b"] // sz("x"), i["s"] // sz("y"), i["h"] // sz("z"),
                    generator=g).bfloat16().requires_grad_()
    w = torch.randn(i["h"] // sz("z"), i["f"] // (sz("y") * sz("x")),
                    generator=g).bfloat16().requires_grad_()
    comm.reset_bytes()
    y = ops3d.matmul3d(lay, "y", "z", x, w)
    fwd = comm.bytes_moved()["by_kind"]
    dx, dw = torch.autograd.grad(y, (x, w), torch.ones_like(y))
    tag = f"island/{int(overlap)}/"
    out.update({tag + "fwd/" + k: np.float64(v) for k, v in fwd.items()})
    out.update({tag + "all/" + k: np.float64(v)
                for k, v in comm.bytes_moved()["by_kind"].items()})
    out[tag + "shapes"] = np.array([y.numel(), dx.numel(), dw.numel()])
np.savez(os.path.join(d, f"rank{me.rank}.npz"), **out)
print("RANK-OK")
"""


def fill(script):
    layouts = {k: dict(v, cube=list(v["cube"])) for k, v in LAYOUTS.items()}
    return script % {"arch": ARCH, "layouts": layouts, "chunks": CHUNKS,
                     "steps": STEPS, "opt": OPT, "island": ISLAND}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("overlap")
    write_inputs(tmp)
    run = run_jax(fill(JAX_SCRIPT), tmp)
    try:
        run_ranks(fill(RANK_SCRIPT), tmp, timeout=240)
    finally:
        wait_jax(run, timeout=240)
    return {"jax": dict(np.load(tmp / "jax.npz")),
            "ranks": [dict(np.load(tmp / f"rank{r}.npz"))
                      for r in range(WORLD)]}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_overlap_matches_plain_islands(world, name):
    """The loss and every gradient shard with 4 chunks within 1e-4 of the
    plain islands' on every rank (the reference battery's criterion)."""
    for r, got in enumerate(world["ranks"]):
        plain, over = f"{name}/0/", f"{name}/1/"
        assert abs(float(got[over + "loss"]) - float(got[plain + "loss"])) \
            <= 1e-4, (name, r)
        keys = [k[len(plain):] for k in got if k.startswith(plain + "grad/")]
        assert keys
        worst = max(float(np.abs(got[over + k] - got[plain + k]).max())
                    for k in keys)
        assert worst <= 1e-4, (name, r, worst)


def test_overlap_zero1_trajectory_matches_plain(world):
    """Three AdamW steps at dp 2 x (1, 2, 2) on ZeRO-1 shards in bf16: the
    overlapped losses within 5e-3 of the plain ones."""
    for r, got in enumerate(world["ranks"]):
        diffs = [abs(float(got[f"zero1/1/step{s}"])
                     - float(got[f"zero1/0/step{s}"])) for s in range(STEPS)]
        assert max(diffs) <= 5e-3, (r, diffs)


def test_overlap_222_matches_jax(world):
    """At (2, 2, 2) with overlap: the loss and every gradient shard within
    1e-4 of the JAX package's chunked islands (of the leaf's largest
    value)."""
    want, cfg, bad = world["jax"], cfg_f32(), []
    specs = flat(transformer.abstract_params(
        cfg, make_layout(**LAYOUTS["cube222"])))
    assert {"grad/" + k for k in specs} == {k for k in want if
                                            k.startswith("grad/")}
    for r, got in enumerate(world["ranks"]):
        lay = make_layout(rank=r, **LAYOUTS["cube222"])
        assert abs(float(got["cube222/1/loss"]) - float(want["loss"])) \
            <= 1e-4, (r, float(got["cube222/1/loss"]), float(want["loss"]))
        for k, p in specs.items():
            ok, info = held(got["cube222/1/grad/" + k], want["grad/" + k],
                            p.spec, lay, what=f"rank {r} {k}")
            if not ok:
                bad.append(info)
    assert not bad, bad


def test_overlap_island_bytes_by_kind(world):
    """One bf16 island at (2, 2, 2), k = 4: the all-gathers move what the
    plain island's move; the forward's and dx's reduce-scatters carry k
    f32 partials (k · 4 / 2 times the plain bf16 bytes), dw's the plain
    bytes in k row blocks."""
    k, n = CHUNKS, 2                        # every cube axis is 2
    for r, got in enumerate(world["ranks"]):
        ny, ndx, ndw = (int(v) for v in got["island/0/shapes"])
        for phase in ("fwd", "all"):
            assert float(got[f"island/1/{phase}/all-gather"]) == \
                float(got[f"island/0/{phase}/all-gather"]) > 0, (r, phase)
        plain = {"fwd": ny * 2 * (n - 1),
                 "all": (ny + ndx + ndw) * 2 * (n - 1)}
        over = {"fwd": k * ny * 4 * (n - 1),
                "all": (k * (ny + ndx) * 4 + ndw * 2) * (n - 1)}
        for phase in ("fwd", "all"):
            assert float(got[f"island/0/{phase}/reduce-scatter"]) == \
                plain[phase], (r, phase)
            assert float(got[f"island/1/{phase}/reduce-scatter"]) == \
                over[phase], (r, phase)
        # bf16 at k = 4: the forward's reduce-scatter bytes 8 times
        assert float(got["island/1/fwd/reduce-scatter"]) == \
            8 * float(got["island/0/fwd/reduce-scatter"])


# ---------------------------------------------------------------------------
# No rank
# ---------------------------------------------------------------------------
def test_overlap_k_matches_reference():
    from repro.core.ops3d import _overlap_k as ref_k
    from repro_torch.core.ops3d import _overlap_k
    for overlap in (False, True):
        for chunks in range(1, 9):
            lay = make_layout(overlap=overlap, overlap_chunks=chunks)
            ns = types.SimpleNamespace(overlap=overlap,
                                       overlap_chunks=chunks)
            for n in range(1, 65):
                assert _overlap_k(lay, n) == ref_k(ns, n), (overlap, chunks,
                                                            n)


@pytest.mark.parametrize("kw", [
    dict(overlap_chunks=0), dict(overlap=True, strategy="1d", n_model=4),
    dict(overlap=True, strategy="2d", n_model=4)])
def test_plan_overlap_messages_match_reference(kw):
    from repro.core.plan import ParallelPlan as JPlan
    from repro_torch.core.plan import ParallelPlan
    with pytest.raises(ValueError) as want:
        JPlan(**kw).validate()
    with pytest.raises(ValueError) as got:
        ParallelPlan(**kw).validate()
    assert str(got.value) == str(want.value)
    lay = ParallelPlan(n_model=8, overlap=True, overlap_chunks=3).build(5)
    assert (lay.overlap, lay.overlap_chunks, lay.rank) == (True, 3, 5)


@pytest.mark.parametrize("shard_f", [True, False])
def test_chunked_island_on_one_device_matches_plain(shard_f):
    """On one device every collective is the identity, so the chunked
    forward, dx and dw are the plain ones up to f32 summation order."""
    from repro_torch.core import ops3d
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 24, generator=g).requires_grad_()
    w = torch.randn(24, 40, generator=g).requires_grad_()
    dc = torch.randn(2, 16, 40, generator=g)
    outs = []
    for overlap in (False, True):
        lay = make_layout(overlap=overlap, overlap_chunks=4)
        assert ops3d._overlap_k(lay, 24) == (4 if overlap else 1)
        y = ops3d.matmul3d(lay, "y", "z", x, w, shard_f)
        outs.append((y, *torch.autograd.grad(y, (x, w), dc)))
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


def test_launcher_refuses_a_joined_world_that_differs(monkeypatch):
    """A rank whose world is already joined keeps it only when it is the
    world the flags ask for: another backend raises, naming both."""
    import torch.distributed as dist
    from repro_torch.launch import train as train_launch
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(ValueError, match="runs nccl with rank 0 of 2, not "
                       "--backend gloo with rank 0 of 2"):
        train_launch.main(["--arch", "tinyllama-1.1b", "--reduced",
                           "--device", "cpu", "--steps", "1", "--batch", "2",
                           "--seq", "16", "--model", "2", "--overlap"])
