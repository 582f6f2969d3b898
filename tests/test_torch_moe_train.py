"""The port's MoE training against the JAX package, on the CPU: three
AdamW steps of reduced mixtral-8x7b within 1e-2 at two microbatches, so
the router losses ride through them as the reference weights them, every
step dropping tokens at capacity factor 0.5; then a MoE checkpoint round
trip between the packages in both directions (reduced
moonshot-v1-16b-a3b), the f32 router included.  Inputs come from numpy with a
seed; weights cross by ``convert.params_from_jax``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import config as jconfig
from repro.checkpoint import store as jstore
from repro.configs.registry import get as jget
from repro.core.topology import single_device_layout
from repro.models import transformer as jtransformer
from repro.optim.optimizers import opt_state_abstract
from repro_torch import config
from repro_torch.checkpoint import store
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core.params import init_params, tree_map
from repro_torch.core.plan import ParallelPlan
from repro_torch.models import transformer
from repro_torch.optim import OptState, adamw_init
from test_torch_train import three_adamw_steps

F32 = jnp.float32
OPT = dict(lr=3e-3, warmup=2, total_steps=6)


def _draw(abstract, seed):
    """Seeded f32 weights drawn by the port's init, as a JAX tree: the
    reference's ``jax.random`` init compiles a kernel for each leaf shape,
    seconds a model on the CPU."""
    tp = init_params(abstract, torch.Generator().manual_seed(seed), "cpu",
                     torch.float32)
    return tree_map(lambda t: jnp.asarray(t.numpy()), tp)


@functools.cache
def _model(arch):
    """(jax cfg, port cfg, jax layout, jax f32 params, port params),
    reduced, at capacity factor 0.5, so that every step drops choices."""
    jcfg, tcfg = jconfig.reduced(jget(arch)), config.reduced(get(arch))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.5))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.5))
    jlay = single_device_layout("3d")
    jp = _draw(transformer.abstract_params(tcfg), 0)
    return jcfg, tcfg, jlay, jp, params_from_jax(jax.device_get(jp), "cpu")


def _batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -5:] = -1                              # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


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


def test_three_adamw_steps_match_reference():
    """Mixtral at two microbatches; Moonlight's dense layer and shared
    expert are held by the loss and gradient test of test_torch_moe.py."""
    three_adamw_steps(_model("mixtral-8x7b"), 2, seq=16,
                      metrics=("loss", "xent", "aux", "gnorm"))


# ---------------------------------------------------------------------------
# Checkpoints between the packages
# ---------------------------------------------------------------------------
def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(jax.device_get(a))
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _same_bits(port_tree, jax_tree):
    jt = jax.device_get(jax_tree)

    def walk(t, want, path):
        if isinstance(t, dict):
            assert sorted(t) == sorted(want), path
            return sum(walk(t[k], want[k], path + (k,)) for k in t)
        assert tuple(t.shape) == tuple(want.shape), path
        assert np.array_equal(_bits(t), _bits(want)), path
        return 1
    assert walk(port_tree, jt, ()) == len(jax.tree.leaves(jt))


def test_moe_checkpoint_round_trips_between_packages(tmp_path):
    """A port save of Moonlight's bf16 parameters (the router in f32) and
    an AdamW state, restored by the JAX store bit for bit; the JAX tree
    saved again by the JAX store, restored by the port bit for bit."""
    jcfg = jconfig.reduced(jget("moonshot-v1-16b-a3b"))
    tcfg = config.reduced(get("moonshot-v1-16b-a3b"))
    jlay = single_device_layout("3d")
    gen = torch.Generator().manual_seed(3)
    params = init_params(transformer.abstract_params(tcfg), gen, "cpu",
                         torch.bfloat16)
    router = params["stack"]["moe"]["moe"]["w_router"]
    assert router.dtype == torch.float32
    opt = OptState(7, tree_map(lambda t: torch.randn(t.shape, generator=gen),
                               params),
                   tree_map(lambda t: torch.rand(t.shape, generator=gen),
                            params))
    lay = ParallelPlan().validate().build()
    store.save(str(tmp_path / "port"), 7, params, opt, layout=lay)
    jtmpl = jtransformer.abstract_params(jcfg, jlay)
    jp, jopt, _ = jstore.restore(
        str(tmp_path / "port"), 7, jtmpl, jlay,
        opt_state_abstract(jtmpl, jlay, jconfig.OptimConfig(**OPT)))
    assert int(jopt.step) == 7
    _same_bits(params, jp)
    _same_bits(opt.m, jopt.m)
    _same_bits(opt.v, jopt.v)
    assert jp["stack"]["moe"]["moe"]["w_router"].dtype == jnp.float32

    jstore.save(str(tmp_path / "jax"), 9, jp, jopt, layout=jlay)
    tmpl = init_params(transformer.abstract_params(tcfg),
                       torch.Generator().manual_seed(5), "cpu",
                       torch.bfloat16)
    tp, tstate, _ = store.restore(
        str(tmp_path / "jax"), 9, tmpl,
        adamw_init(tmpl, lay, transformer.abstract_params(tcfg)))
    assert tstate.step == 7
    _same_bits(tp, jp)
    _same_bits(tstate.m, jopt.m)
    assert tp["stack"]["moe"]["moe"]["w_router"].dtype == torch.float32
