"""The port's deepseek-v3-671b training against the JAX package, on the
CPU.

Reduced deepseek-v3 (d_model 256, 4 heads with q and k at 32 and v at 16,
the plan [dense, moe], 4 experts top-2 with a shared one, the mtp head) in
f32, weights drawn by the port's init and handed to JAX as arrays:

  * the copies: the layer plan and the FLOPs formula;
  * the train loss, its parts (xent, the router losses, the mtp loss) and
    every gradient leaf within 1e-4, at capacity factor 0.5 so that the
    step drops choices;
  * three AdamW steps at two microbatches within 1e-2;
  * the MLA and mtp leaves through the checkpoint store, both ways, bit
    for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import config as jconfig
from repro.checkpoint import store as jstore
from repro.configs.registry import get as jget
from repro.core.topology import single_device_layout
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.optim.optimizers import opt_state_abstract
from repro_torch import config
from repro_torch.checkpoint import store
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core.params import init_params, tree_leaves, tree_map
from repro_torch.core.plan import ParallelPlan
from repro_torch.models import moe, registry, transformer
from repro_torch.optim import OptState, adamw_init
from test_torch_moe_train import _at, _batch, _draw, _paths, _same_bits
from test_torch_train import three_adamw_steps

ARCH = "deepseek-v3-671b"
OPT = dict(lr=3e-3, warmup=2, total_steps=3)
_MODEL = {}


def _model():
    """(jax cfg, port cfg, jax layout, jax f32 params, port params),
    reduced, at capacity factor 0.5."""
    if not _MODEL:
        jcfg, tcfg = jconfig.reduced(jget(ARCH)), config.reduced(get(ARCH))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=0.5))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=0.5))
        jp = _draw(transformer.abstract_params(tcfg), 0)
        _MODEL["m"] = (jcfg, tcfg, single_device_layout("3d"), jp,
                       params_from_jax(jax.device_get(jp), "cpu"))
    return _MODEL["m"]


def test_deepseek_copies_match_reference():
    cfg, jcfg = get(ARCH), jget(ARCH)
    assert registry.layer_plan(cfg) == ("dense",) * 3 + ("moe",) * 58
    assert jregistry._plan_moe(jcfg) == registry.layer_plan(cfg)
    for s in (1, 2048, 8192):
        assert registry.train_flops_per_token(cfg, s) == \
            jregistry.train_flops_per_token(jcfg, s)
    # the port's tree has the reference's names and shapes, mtp included
    jcfg_r, tcfg_r = jconfig.reduced(jcfg), config.reduced(cfg)
    want = dict(_paths(jtransformer.abstract_params(
        jcfg_r, single_device_layout("3d"))))
    got = dict(_paths(transformer.abstract_params(tcfg_r)))
    assert sorted(got) == sorted(want)
    for path, p in got.items():
        assert tuple(p.shape) == tuple(want[path].shape), path
    assert jtransformer.param_counts(jcfg_r)[0] == sum(
        int(np.prod(p.shape)) for p in got.values())


def test_train_loss_mtp_and_grads_match_reference():
    jcfg, tcfg, jlay, jp, tp = _model()
    batch = _batch(tcfg.vocab, 2, 32, 0)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.forward(jcfg, jlay, p, b, mode="train"),
        has_aux=True))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    lay = ParallelPlan().validate().build()
    live = tree_map(lambda t: t.detach().requires_grad_(), tp)
    moe.DROPS = []
    try:
        loss, met = transformer.forward(
            tcfg, lay, live, {k: torch.from_numpy(v).long()
                              for k, v in batch.items()}, mode="train")
        dropped = int(torch.stack(moe.DROPS).sum(0)[1])
    finally:
        moe.DROPS = None
    assert dropped > 0
    grads = torch.autograd.grad(loss, tree_leaves(live))
    assert sorted(met) == sorted(jmet) == ["aux", "mtp", "xent"]
    for key in ("xent", "aux", "mtp"):
        assert abs(met[key].item() - float(jmet[key])) <= 1e-4, key
    assert abs(loss.item() - float(jloss)) <= 1e-4
    jg = jax.device_get(jgrads)
    n = 0
    for (path, _), g in zip(_paths(live), grads):
        want = np.asarray(_at(jg, path), np.float32)
        assert g.shape == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.max(np.abs(g.numpy() - want)))
        assert err <= 1e-4 * scale, (path, err, scale)
        n += 1
    assert n == len(jax.tree.leaves(jg))


def test_three_adamw_steps_match_reference():
    """Two microbatches, the mtp loss and the router losses riding through
    the accumulated gradient as the reference weights them."""
    three_adamw_steps(_model(), 2, seq=16,
                      metrics=("loss", "xent", "aux", "mtp", "gnorm"))


def test_mla_and_mtp_leaves_round_trip_between_packages(tmp_path):
    """A port save of reduced deepseek-v3's bf16 parameters (the MLA
    blocks, the mtp head, the f32 routers) and an AdamW state, restored by
    the JAX store bit for bit; the JAX tree saved again by the JAX store,
    restored by the port bit for bit."""
    jcfg, tcfg = jconfig.reduced(jget(ARCH)), config.reduced(get(ARCH))
    jlay = single_device_layout("3d")
    gen = torch.Generator().manual_seed(3)
    params = init_params(transformer.abstract_params(tcfg), gen, "cpu",
                         torch.bfloat16)
    assert "w_ukv" in params["mtp"]["block"]["mla"]
    opt = OptState(5, tree_map(lambda t: torch.randn(t.shape, generator=gen),
                               params),
                   tree_map(lambda t: torch.rand(t.shape, generator=gen),
                            params))
    lay = ParallelPlan().validate().build()
    store.save(str(tmp_path / "port"), 5, params, opt, layout=lay)
    jtmpl = jtransformer.abstract_params(jcfg, jlay)
    jparams, jopt, _ = jstore.restore(
        str(tmp_path / "port"), 5, jtmpl, jlay,
        opt_state_abstract(jtmpl, jlay, jconfig.OptimConfig(**OPT)))
    assert int(jopt.step) == 5
    _same_bits(params, jparams)
    _same_bits(opt.m, jopt.m)
    _same_bits(opt.v, jopt.v)

    jstore.save(str(tmp_path / "jax"), 6, jparams, jopt, layout=jlay)
    tmpl = init_params(transformer.abstract_params(tcfg),
                       torch.Generator().manual_seed(4), "cpu",
                       torch.bfloat16)
    back, tstate, _ = store.restore(
        str(tmp_path / "jax"), 6, tmpl,
        adamw_init(tmpl, lay, transformer.abstract_params(tcfg)))
    assert tstate.step == 5
    _same_bits(back, jparams)
    _same_bits(tstate.v, jopt.v)
