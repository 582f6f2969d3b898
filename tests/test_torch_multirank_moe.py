"""The MoE family trained on 8 ranks against the JAX package at the same
layout on 8 host devices, in f32: expert parallelism, the experts split
over ``ep_axes`` and the tokens exchanged by all-to-all
(``models/moe.py``), with ``test_torch_multirank_train.py``'s machinery
(one world of 8 gloo ranks beside a JAX subprocess an arch).

Reduced mixtral-8x7b (4 experts, top 2, window 64) at the cube (2, 2, 2)
(ep ('x', 'y')) and at dp 2 x (2, 2, 1) at ZeRO 1 (ep ('dp', 'y'), 'x' a
batch axis summed by the leaf sync).  Held: the loss and every gradient
leaf's shard on every rank within 1e-4 of the leaf's largest value
against JAX's at the rank's coordinates, and three AdamW steps at two
microbatches within 1e-2.  In the same world: ``comm.all_to_all`` over
the axis tuples ('z', 'x') and ('y', 'x') of the cube, whose mixed-radix
order is not the global ranks' (the model's ep tuples all follow the
global order), against numpy's blocks, forward and backward, also with
the fault ``a2a_order`` planted (the group's own order taken for JAX's),
which must fail; and mixtral's state after its steps at the cube saved
by ``checkpoint.store`` across the ranks and restored on one rank, every
rank's shard bit for bit.  ``test_torch_multirank_moe_more.py`` holds
the other layouts and configs.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store
from repro_torch.config import OptimConfig
from repro_torch.core.params import shard
from repro_torch.core.topology import make_layout
from repro_torch.models import transformer
from repro_torch.optim.optimizers import opt_state_abstract
from test_torch_multirank_islands import WORLD, layout_of
from test_torch_multirank_train import (OPT, STEPS, check_grads,
                                        check_steps, flat, port_cfg,
                                        run_train)

LAYOUTS = {"cube": dict(n_pod=1, n_dp=1, n_model=8),
           "dp2": dict(n_pod=1, n_dp=2, n_model=4, cube=(2, 2, 1)),
           "1d": dict(n_pod=1, n_dp=2, n_model=4, strategy="1d"),
           "2d": dict(n_pod=1, n_dp=2, n_model=4, strategy="2d")}
MIX = "mixtral-8x7b"
ARCHS = {MIX: {}}
# arch -> {layout: AdamW steps}
RUNS = {MIX: {"cube": STEPS, "dp2": STEPS}}
GRAD_CASES = [(a, ln) for a, r in RUNS.items() for ln in r]
STEP_CASES = [(a, ln) for a, r in RUNS.items() for ln, n in r.items() if n]
# the all-to-all check: axis tuples of the cube, rows a block
A2A_AXES = (("z", "x"), ("y", "x"))
A2A_ROWS, A2A_COLS = 2, 3
CKPT = (MIX, "cube")

EXTRA = r"""
from repro_torch.checkpoint import store
from repro_torch.optim.optimizers import opt_state_abstract

A2A_AXES, A2A_ROWS, A2A_COLS = %(a2a)r
CKPT = %(ckpt)r


def a2a_check(lay, tag):
    # each rank's input, a function of its rank; the cotangent another
    res = {}
    for axes in A2A_AXES:
        n = lay.size(axes)
        rows = n * A2A_ROWS
        x = (1000.0 * me.rank + torch.arange(rows * A2A_COLS,
             dtype=torch.float32).view(rows, A2A_COLS)).requires_grad_()
        y = comm.all_to_all_ad(lay, x, axes, split_dim=0, concat_dim=1)
        g = -(1000.0 * me.rank + torch.arange(y.numel(),
              dtype=torch.float32).view(y.shape))
        (dx,) = torch.autograd.grad(y, x, g)
        name = "".join(axes)
        res[f"{tag}/{name}/y"] = y.detach().numpy()
        res[f"{tag}/{name}/dx"] = dx.numpy()
    return res


def after_layout(arch, lname, lay, cfg, params, state, out):
    if (arch, lname) != tuple(CKPT):
        return
    out.update(a2a_check(lay, "a2a"))
    real = comm.Groups.order
    comm.Groups.order = lambda self, axes: (self.group[frozenset(axes)],
                                            None)
    try:
        out.update(a2a_check(lay, "a2a_order"))
    finally:
        comm.Groups.order = real
    abstract = transformer.abstract_params(cfg, lay)
    store.save(os.path.join(d, "moe_ckpt"), %(steps)d, params, state,
               layout=lay, abstract=abstract,
               opt_abstract=opt_state_abstract(abstract, lay, OPT))
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    extra = EXTRA % {"a2a": (A2A_AXES, A2A_ROWS, A2A_COLS), "ckpt": CKPT,
                     "steps": STEPS}
    res = run_train(tmp, ARCHS, mb=2, layouts=LAYOUTS, runs=RUNS,
                    extra=extra)
    return res, tmp


@pytest.mark.parametrize("arch,lname", GRAD_CASES)
def test_loss_and_grad_shards_match_jax(trained, arch, lname):
    check_grads(trained[0], arch, ARCHS[arch], lname, LAYOUTS)


@pytest.mark.parametrize("arch,lname", STEP_CASES)
def test_three_adamw_steps_match_jax(trained, arch, lname):
    check_steps(trained[0], arch, ARCHS[arch], lname, LAYOUTS)


def _a2a_want(axes):
    """{rank: (y, dx)} of ``a2a_check`` from numpy: the group of a rank
    shares its coordinates off ``axes``; member j (mixed radix over
    ``axes``, first axis major) receives block j of every member's rows,
    side by side in the members' order; dx is the reverse exchange of the
    cotangent."""
    lays = [make_layout(n_model=8, rank=r) for r in range(WORLD)]
    n = lays[0].size(axes)
    rows, cols = n * A2A_ROWS, A2A_COLS

    def inp(r):
        return 1000.0 * r + np.arange(rows * cols, dtype=np.float32).reshape(
            rows, cols)

    def cot(r):
        return -(1000.0 * r + np.arange(rows * cols, dtype=np.float32)
                 ).reshape(A2A_ROWS, n * cols)

    want = {}
    for r, lay in enumerate(lays):
        others = [a for a in ("pod", "dp", "pp", "x", "y", "z")
                  if a not in axes]
        group = sorted((q for q in range(WORLD) if all(
            lays[q].coords[a] == lay.coords[a] for a in others)),
            key=lambda q: lays[q].index(axes))
        j = lay.index(axes)
        blk = slice(j * A2A_ROWS, (j + 1) * A2A_ROWS)
        y = np.concatenate([inp(q)[blk] for q in group], axis=1)
        dx = np.concatenate([cot(q)[:, j * cols:(j + 1) * cols]
                             for q in group], axis=0)
        want[r] = (y, dx)
    return want


@pytest.mark.parametrize("fault", ["none", "a2a_order"])
def test_all_to_all_over_axis_tuples(trained, fault):
    """Clean, every rank's exchange equals numpy's, forward and backward;
    with the group's own order in place of JAX's, some rank's does not."""
    tag = "a2a" if fault == "none" else "a2a_order"
    ranks = trained[0][CKPT][1]
    bad = []
    for axes in A2A_AXES:
        name = "".join(axes)
        for r, (y, dx) in _a2a_want(axes).items():
            for what, want in (("y", y), ("dx", dx)):
                got = ranks[r][f"{tag}/{name}/{what}"]
                if got.shape != want.shape or not np.array_equal(got, want):
                    bad.append((name, r, what))
    if fault == "none":
        assert not bad, bad
    else:
        assert bad, "the planted a2a_order fault passed"


def test_checkpoint_saved_across_ranks_restores_on_one(trained):
    """The cube's state after three steps, written from the 8 ranks'
    shards, restored on one rank: every rank's parameter shard and AdamW
    ``v`` shard bit for bit."""
    res, tmp = trained
    arch, lname = CKPT
    cfg = port_cfg(arch, ARCHS[arch])
    lay1 = make_layout()
    abstract = transformer.abstract_params(cfg, lay1)
    params, state, _ = store.restore(
        str(tmp / "moe_ckpt"), STEPS, abstract,
        opt_state_abstract(abstract, lay1, OptimConfig(**OPT)),
        device="cpu", dtype=torch.float32)
    got_p, got_v = flat(params), flat(state.v)
    for r, ranks_out in enumerate(res[CKPT][1]):
        lay = layout_of(lname, r, LAYOUTS)
        for k, p in flat(transformer.abstract_params(cfg, lay)).items():
            for prefix, tree in (("param/", got_p), ("state/", got_v)):
                want = shard(torch.as_tensor(tree[k]), p.spec, lay).numpy()
                assert np.array_equal(ranks_out[prefix + k], want), (
                    r, prefix + k)
