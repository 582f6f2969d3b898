"""The port's MoE family against the JAX package, on the CPU.

``moe_apply`` (the router, the capacity dispatch with its drops, the
expert FFN chunked over capacity, the combine, the load-balance and z
losses, the shared expert) within 1e-4 of the reference's in f32, output,
aux and the gradients of the input and of every weight, on batches that
overflow the capacity and on decode batches; the chosen experts equal
the reference's, with the smallest top-k margin printed.  Then the whole
model on reduced mixtral-8x7b (4 experts top-2, window 64) and reduced
moonshot-v1-16b-a3b (a dense first layer, a shared expert): the parameter
tree (the router kept in f32 through ``params_from_jax``'s cast), the
layer plan, the counts and the FLOPs formula; the train loss
(xent and aux apart) and every gradient leaf within 1e-4 with tokens
dropped.  The capacity factor is lowered to 0.5 where a case must drop.
Three AdamW steps and the checkpoints are in ``test_torch_moe_train.py``,
the engines in ``test_torch_moe_serve*.py``.  K1, K2 and K3 run their
plain versions here.  Inputs come from numpy with a seed; weights cross
by ``convert.params_from_jax``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import config as jconfig
from repro.configs.registry import get as jget
from repro.core.topology import Dirs as JDirs
from repro.core.topology import single_device_layout
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import config
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core.params import init_params, tree_leaves, tree_map
from repro_torch.core.plan import ParallelPlan
from repro_torch.core.topology import Dirs
from repro_torch.models import moe, registry, transformer

F32 = jnp.float32
ARCHS = ("mixtral-8x7b", "moonshot-v1-16b-a3b")


def _np(a):
    return np.asarray(jax.device_get(a), np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _cfgs(arch, cf=None):
    """(jax cfg, port cfg), reduced, capacity factor ``cf`` if given."""
    jc, tc = jconfig.reduced(jget(arch)), config.reduced(get(arch))
    if cf is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=cf))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=cf))
    return jc, tc


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _draw(abstract, seed):
    """Seeded f32 weights drawn by the port's init, as a JAX tree: the
    reference's ``jax.random`` init compiles a kernel for each leaf shape,
    seconds a model on the CPU."""
    tp = init_params(abstract, torch.Generator().manual_seed(seed), "cpu",
                     torch.float32)
    return tree_map(lambda t: jnp.asarray(t.numpy()), tp)


def _drops(fn):
    """Run ``fn`` with the drop counter on: (its result, routed, dropped)."""
    moe.DROPS = []
    try:
        out = fn()
        tot = torch.stack(moe.DROPS).sum(0) if moe.DROPS else \
            torch.zeros(2, dtype=torch.long)
    finally:
        moe.DROPS = None
    return out, int(tot[0]), int(tot[1])


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------
# case -> (arch, capacity factor, (B, S), decode, must drop).  T = 4096 at
# factor 0.5 gives mixtral a capacity of 1024: two FFN chunks of 512
MOE_CASES = {
    "mixtral_overflow": ("mixtral-8x7b", 0.5, (2, 2048), False, True),
    "moonlight_overflow": ("moonshot-v1-16b-a3b", 0.5, (2, 256), False, True),
    "mixtral_decode": ("mixtral-8x7b", None, (8, 1), True, False),
    "moonlight_decode": ("moonshot-v1-16b-a3b", None, (8, 1), True, False),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_and_grads_match_reference(case):
    arch, cf, (b, s), decode, must_drop = MOE_CASES[case]
    jc, tc = _cfgs(arch, cf)
    jlay = single_device_layout("3d")
    jdirs = JDirs("y", "z")
    jp = _draw(moe.moe_params(tc), 3)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, s, tc.d_model)).astype(np.float32)
    w = rng.standard_normal((b, s, tc.d_model)).astype(np.float32)

    def jf(x, p):
        y, aux = jmoe.moe_apply(jlay, jc, jdirs, x, p, decode=decode)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), (jdx, jdp) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jp)

    # the chosen experts equal the reference's
    T = b * s
    jt = jnp.asarray(x).reshape(T, -1)
    jprobs = jax.nn.softmax(jt @ jp["w_router"], axis=-1)
    _, jsel = lax.top_k(jprobs, tc.moe.top_k)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    _, probs, sel, _ = moe.route(_t(x).reshape(T, -1), tp["w_router"],
                                 tc.moe.top_k)
    srt = np.sort(probs.numpy(), axis=-1)[:, ::-1]
    margin = float(np.min(srt[:, tc.moe.top_k - 1] - srt[:, tc.moe.top_k]))
    print(f"{case}: smallest top-k margin {margin:.3e}")
    assert np.array_equal(sel.numpy(), np.asarray(jsel)), margin

    live = tree_map(lambda t: t.detach().requires_grad_(), tp)
    xt = _t(x).requires_grad_()
    lay = ParallelPlan().validate().build()
    (y, aux), routed, dropped = _drops(
        lambda: moe.moe_apply(lay, tc, Dirs("y", "z"), xt, live,
                              decode=decode))
    assert routed == T * tc.moe.top_k
    if must_drop:
        assert dropped > 0
    grads = torch.autograd.grad((y * _t(w)).sum() + aux,
                                [xt] + tree_leaves(live))
    assert _maxerr(y.detach(), _np(jy)) <= 1e-4
    assert abs(aux.item() - float(jaux)) <= 1e-4
    assert _maxerr(grads[0], _np(jdx)) <= 1e-4
    jg = jax.device_get(jdp)
    for (path, _), g in zip(_paths(live), grads[1:]):
        want = np.asarray(_at(jg, path), np.float32)
        scale = max(float(np.abs(want).max()), 1.0)
        assert _maxerr(g, want) <= 1e-4 * scale, (path, _maxerr(g, want))


def test_capacity_chunk_matches_reference():
    """The FFN's chunk over the capacity: 2048/1024/512 where it divides
    and is smaller (reference ``moe.py:171-176``)."""
    for cap, want in ((2560, 512), (4096, 2048), (3072, 1024), (1024, 512),
                      (512, 512), (30, 30), (3, 3)):
        assert moe._chunk(cap) == want, cap


# ---------------------------------------------------------------------------
# The family's copies
# ---------------------------------------------------------------------------
def test_param_tree_plan_counts_and_flops_match_reference():
    jlay = single_device_layout("3d")
    for arch in ARCHS:
        for red in (False, True):
            c, jc = get(arch), jget(arch)
            if red:
                c, jc = config.reduced(c), jconfig.reduced(jc)
            plan = jregistry.get_stack(jc.family).layer_plan(jc)
            assert registry.layer_plan(c) == plan, arch
            if not red:
                continue
            want = dict(_paths(jtransformer.abstract_params(jc, jlay)))
            got = dict(_paths(transformer.abstract_params(c)))
            assert sorted(got) == sorted(want), arch
            for path, p in got.items():
                assert tuple(p.shape) == tuple(want[path].shape), path
                f32 = want[path].dtype == jnp.float32
                assert (p.dtype == torch.float32) == f32, path
            n = sum(int(np.prod(p.shape)) for p in got.values())
            assert n == jtransformer.param_counts(jc)[0]
            # a cast to bf16 keeps the router in f32, as init does
            tp = params_from_jax(jax.device_get(_model(arch)[3]), "cpu",
                                 dtype=torch.bfloat16, cfg=c)
            assert tp["stack"]["moe"]["moe"]["w_router"].dtype == \
                torch.float32
            assert tp["stack"]["moe"]["moe"]["w1"].dtype == torch.bfloat16
        for s in (1, 2048, 8192):
            assert registry.train_flops_per_token(get(arch), s) == \
                jregistry.train_flops_per_token(jget(arch), s)
    # deepseek-v3 (MLA, the mtp head) is ported: its plan is the
    # reference's; its model is held in test_torch_deepseek.py
    ds, jds = get("deepseek-v3-671b"), jget("deepseek-v3-671b")
    assert registry.layer_plan(ds) == \
        jregistry.get_stack(jds.family).layer_plan(jds)


# ---------------------------------------------------------------------------
# The model: train loss, gradients, trajectory
# ---------------------------------------------------------------------------
@functools.cache
def _model(arch):
    """(jax cfg, port cfg, jax layout, jax f32 params, port params) at
    capacity factor 0.5, so that every step drops choices."""
    jcfg, tcfg = _cfgs(arch, 0.5)
    jlay = single_device_layout("3d")
    jp = _draw(transformer.abstract_params(tcfg), 0)
    return jcfg, tcfg, jlay, jp, params_from_jax(jax.device_get(jp), "cpu")


def _batch(vocab, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -5:] = -1                              # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_aux_and_grads_match_reference(arch):
    jcfg, tcfg, jlay, jp, tp = _model(arch)
    batch = _batch(tcfg.vocab)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.forward(jcfg, jlay, p, b, mode="train"),
        has_aux=True))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    lay = ParallelPlan().validate().build()
    live = tree_map(lambda t: t.detach().requires_grad_(), tp)
    (loss, met), _, dropped = _drops(lambda: transformer.forward(
        tcfg, lay, live, {k: torch.from_numpy(v).long()
                          for k, v in batch.items()}, mode="train"))
    assert dropped > 0
    grads = torch.autograd.grad(loss, tree_leaves(live))
    assert float(jmet["aux"]) > 0
    assert abs(met["xent"].item() - float(jmet["xent"])) <= 1e-4
    assert abs(met["aux"].item() - float(jmet["aux"])) <= 1e-4
    assert abs(loss.item() - float(jloss)) <= 1e-4
    jg = jax.device_get(jgrads)
    n = 0
    for (path, _), g in zip(_paths(live), grads):
        want = np.asarray(_at(jg, path), np.float32)
        assert g.shape == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        assert _maxerr(g, want) <= 1e-4 * scale, (path, _maxerr(g, want),
                                                  scale)
        n += 1
    assert n == len(jax.tree.leaves(jg))
