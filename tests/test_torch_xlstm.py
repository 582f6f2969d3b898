"""The port's xLSTM path against the JAX package, on the CPU.

The recurrences (``mlstm_scan_seq``, the chunk-parallel ``mlstm_scan``
with a chunk that does not divide T and with a carried state,
``mlstm_step``, ``slstm_scan``, ``slstm_step``) and both blocks, outputs
and gradients within 1e-4 in f32; the parameter tree, the layer plan and
the FLOPs formula; the whole model on reduced xlstm-350m ([mlstm, slstm],
d_model 256): the train loss and every gradient leaf within 1e-4, three
AdamW steps within 1e-2, token-by-token decode from a fresh cache against
the full forward, and the port's engine against the JAX engine (3
requests in 2 slots: the same greedy tokens, every step's logits within
1e-4).  Last, the reference's slot wipe pinned: its engine zeroes the
sLSTM normaliser n, which the cache init and the training scan start at
1, so a served request's first logits differ from the forward's.  K1 and
K3 run their plain versions here.  Inputs come from numpy with a seed;
weights cross by ``convert.params_from_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.configs.registry import get as jget
from repro.core.params import init_params as jinit_params
from repro.core.plan import ParallelPlan as JPlan
from repro.core.topology import single_device_layout
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm
from repro.optim.optimizers import opt_state_abstract
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import config
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core.params import init_params, tree_leaves, tree_map
from repro_torch.core.plan import ParallelPlan
from repro_torch.core.topology import Dirs
from repro_torch.kernels import matmul as k1
from repro_torch.kernels import rmsnorm as k3
from repro_torch.models import blocks, registry, transformer, xlstm
from repro_torch.optim import adamw_init
from repro_torch.serve import Engine, Request, kvcache
from repro_torch.train.step import make_train_step

F32 = jnp.float32
DIRS = Dirs("y", "z")


def _np(a):
    return np.asarray(jax.device_get(a), np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _scaled_err(got, want):
    """max |got - want| / (1 + max |want|), in f32."""
    w = np.asarray(want, np.float32)
    return _maxerr(got, w) / (1 + float(np.max(np.abs(w))))


@pytest.fixture(scope="module")
def tlayout():
    return ParallelPlan().validate(mode="serve").build()


@pytest.fixture(scope="module")
def model():
    """(jax cfg, port cfg, jax layout, jax f32 params, port params) of
    reduced xlstm-350m: the plan [mlstm, slstm], d_model 256, 4 heads."""
    jcfg = jconfig.reduced(jget("xlstm-350m"))
    tcfg = config.reduced(get("xlstm-350m"))
    jlay = single_device_layout("3d")
    jp = jinit_params(jtransformer.abstract_params(jcfg, jlay),
                      jax.random.key(4), dtype=F32)
    return jcfg, tcfg, jlay, jp, params_from_jax(jax.device_get(jp), "cpu")


# ---------------------------------------------------------------------------
# The recurrences
# ---------------------------------------------------------------------------
def _mlstm_inputs(b, T, nh, dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, T, nh, dh)).astype(np.float32)
               for _ in range(3))
    ig = rng.standard_normal((b, T, nh)).astype(np.float32)
    fg = np.asarray(jax.nn.log_sigmoid(
        rng.standard_normal((b, T, nh)) + 2.0), np.float32)
    w = rng.standard_normal((b, T, nh, dh)).astype(np.float32)
    return [q, k, v, ig, fg], w


def _mlstm_state(b, nh, dh, seed):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.standard_normal((b, nh, dh, dh))).astype(np.float32),
            (0.3 * rng.standard_normal((b, nh, dh))).astype(np.float32),
            rng.standard_normal((b, nh)).astype(np.float32)]


def _both(jfn, tfn, args, w, n_grad):
    """(output, grads of sum(out * w) w.r.t. the first n_grad args) of the
    reference under jax.grad and of the port under autograd."""
    def jloss(*a):
        y = jfn(*a)
        return jnp.sum(y * w), y
    (_, jy), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(n_grad)), has_aux=True))(
            *map(jnp.asarray, args))
    ts = [_t(a).requires_grad_(i < n_grad) for i, a in enumerate(args)]
    y = tfn(*ts)
    grads = torch.autograd.grad((y * _t(w)).sum(), ts[:n_grad])
    return (y.detach(), grads), (_np(jy), [_np(g) for g in jg])


def _check(got, want, tol=1e-4):
    (y, grads), (jy, jg) = got, want
    assert y.shape == jy.shape
    assert _scaled_err(y, jy) <= tol, _scaled_err(y, jy)
    for i, (g, j) in enumerate(zip(grads, jg)):
        assert g.shape == j.shape, i
        assert _scaled_err(g, j) <= tol, (i, _scaled_err(g, j))


# (case, b, T, nh, dh, chunk, carried state): T = 50 under chunk 16 falls
# to Q = 10, five chunks
MLSTM_CASES = [("seq", 2, 24, 2, 16, None, False),
               ("seq_state", 2, 24, 2, 16, None, True),
               ("chunked", 2, 50, 2, 16, 16, False),
               ("chunked_state", 2, 50, 2, 16, 16, True),
               ("one_chunk", 1, 40, 4, 8, 256, False)]


@pytest.mark.parametrize("case", MLSTM_CASES, ids=[c[0] for c in MLSTM_CASES])
def test_mlstm_recurrences_and_grads_match_reference(case):
    """``mlstm_scan_seq`` (chunk None) and ``mlstm_scan``, outputs and the
    gradients w.r.t. q, k, v, the gates and a carried state."""
    name, b, T, nh, dh, chunk, carried = case
    args, w = _mlstm_inputs(b, T, nh, dh, seed=T + nh)
    n_grad = 5
    if carried:
        args = args + _mlstm_state(b, nh, dh, seed=dh)
        n_grad = 7                        # C and n too; m is not smooth

    def wrap(mod, seq):
        def fn(q, k, v, ig, fg, *st):
            state = tuple(st) if st else None
            if seq:
                return mod.mlstm_scan_seq(q, k, v, ig, fg, state)[0]
            return mod.mlstm_scan(q, k, v, ig, fg, state, chunk=chunk)[0]
        return fn
    seq = chunk is None
    _check(*_both(wrap(jxlstm, seq), wrap(xlstm, seq), args, w, n_grad))
    if not seq:
        assert xlstm.chunk_len(T, chunk) == (10 if chunk == 16 else T)


def test_mlstm_scan_final_state_matches_reference():
    args, _ = _mlstm_inputs(2, 50, 2, 16, seed=3)
    state = _mlstm_state(2, 2, 16, seed=4)
    _, jst = jxlstm.mlstm_scan(*map(jnp.asarray, args),
                               state=tuple(map(jnp.asarray, state)),
                               chunk=16)
    _, tst = xlstm.mlstm_scan(*map(_t, args), state=tuple(map(_t, state)),
                              chunk=16)
    for got, want in zip(tst, jst):
        assert _scaled_err(got, _np(want)) <= 1e-5


def test_mlstm_step_matches_reference():
    b, nh, dh = 3, 2, 16
    args, w = _mlstm_inputs(b, 1, nh, dh, seed=8)
    args = [a[:, 0] for a in args]
    state = _mlstm_state(b, nh, dh, seed=9)
    jh, jst = jxlstm.mlstm_step(tuple(map(jnp.asarray, state)),
                                *map(jnp.asarray, args))
    th, tst = xlstm.mlstm_step(tuple(map(_t, state)), *map(_t, args))
    assert _scaled_err(th, _np(jh)) <= 1e-5
    for got, want in zip(tst, jst):
        assert _scaled_err(got, _np(want)) <= 1e-5

    def fn(mod):
        return lambda C, n, q, k, v, ig, fg, m: mod.mlstm_step(
            (C, n, m), q, k, v, ig, fg)[0]
    _check(*_both(fn(jxlstm), fn(xlstm), state[:2] + args + state[2:],
                  w[:, 0], 7))


def _slstm_inputs(b, T, nh, dh, seed):
    rng = np.random.default_rng(seed)
    gates = [rng.standard_normal((b, T, nh, dh)).astype(np.float32)
             for _ in range(4)]
    R = (0.3 * rng.standard_normal((4, nh, dh, dh)) / np.sqrt(dh)) \
        .astype(np.float32)
    w = rng.standard_normal((b, T, nh, dh)).astype(np.float32)
    return gates + [R], w


@pytest.mark.parametrize("carried", [False, True])
def test_slstm_scan_and_grads_match_reference(carried):
    b, T, nh, dh = 2, 40, 2, 16
    args, w = _slstm_inputs(b, T, nh, dh, seed=11)
    rng = np.random.default_rng(12)
    state = [(0.5 * rng.standard_normal((b, nh, dh))).astype(np.float32),
             (1 + rng.random((b, nh, dh))).astype(np.float32),
             (0.5 * rng.standard_normal((b, nh, dh))).astype(np.float32),
             (0.5 * rng.standard_normal((b, nh, dh))).astype(np.float32)]

    def fn(mod):
        def f(z, i, f_, o, R, *st):
            return mod.slstm_scan(z, i, f_, o, R,
                                  tuple(st) if st else None)[0]
        return f
    full = args + (state if carried else [])
    _check(*_both(fn(jxlstm), fn(xlstm), full, w, len(full) - carried))
    _, jst = jxlstm.slstm_scan(*map(jnp.asarray, args[:4]),
                               jnp.asarray(args[4]))
    _, tst = xlstm.slstm_scan(*map(_t, args))
    for got, want in zip(tst, jst):
        assert _scaled_err(got, _np(want)) <= 1e-5


def test_slstm_step_matches_reference():
    b, nh, dh = 3, 2, 16
    args, w = _slstm_inputs(b, 1, nh, dh, seed=13)
    gates, R = [a[:, 0] for a in args[:4]], args[4]
    rng = np.random.default_rng(14)
    state = [(0.5 * rng.standard_normal((b, nh, dh))).astype(np.float32),
             (1 + rng.random((b, nh, dh))).astype(np.float32),
             (0.5 * rng.standard_normal((b, nh, dh))).astype(np.float32),
             (0.5 * rng.standard_normal((b, nh, dh))).astype(np.float32)]
    jh, jst = jxlstm.slstm_step(tuple(map(jnp.asarray, state)),
                                *map(jnp.asarray, gates), jnp.asarray(R))
    th, tst = xlstm.slstm_step(tuple(map(_t, state)), *map(_t, gates), _t(R))
    assert _scaled_err(th, _np(jh)) <= 1e-5
    for got, want in zip(tst, jst):
        assert _scaled_err(got, _np(want)) <= 1e-5

    def fn(mod):
        return lambda c, n, h, z, i, f, o, R_, m: mod.slstm_step(
            (c, n, h, m), z, i, f, o, R_)[0]
    _check(*_both(fn(jxlstm), fn(xlstm), state[:3] + gates + [R, state[3]],
                  w[:, 0], 8))


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_and_grads_match_reference(kind):
    """One block over 300 steps (the mLSTM's chunk falls to Q = 150), its
    norm gains moved off their init: output and the gradients of x and of
    every parameter."""
    jcfg = jconfig.reduced(jget("xlstm-350m"))
    tcfg = config.reduced(get("xlstm-350m"))
    jlay = single_device_layout("3d")
    dirs = jtransformer.entry_dirs()
    jparams_fn = getattr(jxlstm, f"{kind}_params")
    p = jax.device_get(jinit_params(jparams_fn(jlay, jcfg, dirs),
                                    jax.random.key(5), dtype=F32))
    rng = np.random.default_rng(6)
    for k in ("ln", "out_ln"):
        if k in p:
            p[k] = (np.asarray(p[k]) + 0.3 * rng.standard_normal(
                p[k].shape)).astype(np.float32)
    T = 300 if kind == "mlstm" else 64
    x = rng.standard_normal((2, T, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    japply = getattr(jxlstm, f"{kind}_apply")

    def jloss(xx, pp):
        y, _ = japply(jlay, jcfg, dirs, xx, pp, None)
        return jnp.sum(y * w), y
    (_, jy), (jdx, jdp) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), p)
    lay = ParallelPlan().validate().build()
    tp = {k: v.requires_grad_() for k, v in params_from_jax(p, "cpu").items()}
    tx = _t(x).requires_grad_()
    before = (k1.launches, k3.launches)
    y, cache = getattr(xlstm, f"{kind}_apply")(lay, tcfg, DIRS, tx, tp)
    assert cache is None and (k1.launches, k3.launches) == before
    names = sorted(tp)
    grads = torch.autograd.grad((y * _t(w)).sum(), [tx] + [tp[k]
                                                          for k in names])
    assert _scaled_err(y.detach(), _np(jy)) <= 1e-5
    assert _scaled_err(grads[0], _np(jdx)) <= 1e-4
    jdp = jax.device_get(jdp)
    for k, g in zip(names, grads[1:]):
        assert _scaled_err(g, _np(jdp[k])) <= 1e-4, (k, _scaled_err(
            g, _np(jdp[k])))


# ---------------------------------------------------------------------------
# The parameter tree, the layer plan, the FLOPs formula
# ---------------------------------------------------------------------------
def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("red", [False, True])
def test_param_tree_matches_reference(red):
    """Names, shapes, dtypes and init rules of abstract_params for
    xlstm-350m, full size (abstract only) and reduced; R's fan-in runs
    over its last axis at scale 0.3."""
    jc, tc = jget("xlstm-350m"), get("xlstm-350m")
    if red:
        jc, tc = jconfig.reduced(jc), config.reduced(tc)
    jtree = jtransformer.abstract_params(jc, single_device_layout())
    jflat = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda p: hasattr(p, "spec"))[0]
    want = {tuple(k.key for k in path): (
        tuple(p.shape), jnp.dtype(p.dtype).name, p.init, p.fan_axis, p.scale)
        for path, p in jflat}
    model_dtype = getattr(torch, tc.dtype)
    got = {path: (p.shape, str(p.dtype or model_dtype)[6:], p.init,
                  p.fan_axis, p.scale)
           for path, p in _flat(transformer.abstract_params(tc))}
    assert got == want
    if not red:
        assert got[("stack", "mlstm", "w_if")][0] == (21, 1024, 8)
        assert got[("stack", "slstm", "R")][0] == (3, 4, 4, 256, 256)


def test_layer_plan_matches_reference():
    plan = registry.layer_plan(get("xlstm-350m"))
    assert len(plan) == 24 and plan.count("mlstm") == 21 \
        and plan.count("slstm") == 3
    assert plan == jregistry.get_stack(config.Family.SSM).layer_plan(
        jget("xlstm-350m"))
    assert registry.layer_plan(config.reduced(get("xlstm-350m"))) == \
        ("mlstm", "slstm")
    for every, n in ((8, 24), (2, 5), (3, 3), (0, 4), (4, 9)):
        jc = dataclasses.replace(jget("xlstm-350m"), n_layers=n, ssm=(
            dataclasses.replace(jget("xlstm-350m").ssm, slstm_every=every)))
        c = dataclasses.replace(get("xlstm-350m"), n_layers=n, ssm=(
            dataclasses.replace(get("xlstm-350m").ssm, slstm_every=every)))
        assert registry.layer_plan(c) == jregistry._plan_xlstm(jc)


def test_counts_and_flops_match_reference():
    """The real tree holds 0.342B parameters; the reference's SSM FLOPs
    formula counts n_active_params, 0.204B, and the port copies it."""
    c, jc = get("xlstm-350m"), jget("xlstm-350m")
    n_tree = sum(np.prod(p.shape)
                 for p in tree_leaves(transformer.abstract_params(c)))
    assert n_tree == jtransformer.param_counts(jc)[0]
    assert round(n_tree / 1e9, 3) == 0.342
    assert round(c.n_active_params() / 1e9, 3) == 0.204
    for cfg, jcfg in ((c, jc), (config.reduced(c), jconfig.reduced(jc))):
        for s in (1, 2048, 8192):
            assert registry.train_flops_per_token(cfg, s) == \
                jregistry.train_flops_per_token(jcfg, s)


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------
def _batch(vocab, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -5:] = -1                              # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_train_loss_and_grads_match_reference(model):
    """288 tokens a row: the mLSTM runs two chunks of 144."""
    jcfg, tcfg, jlay, jp, tp = model
    batch = _batch(tcfg.vocab, s=288)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.forward(jcfg, jlay, p, b, mode="train"),
        has_aux=True))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    lay = ParallelPlan().validate().build()
    live = tree_map(lambda t: t.detach().requires_grad_(), tp)
    loss, met = transformer.forward(
        tcfg, lay, live, {k: torch.from_numpy(v).long()
                          for k, v in batch.items()}, mode="train")
    grads = torch.autograd.grad(loss, tree_leaves(live))
    assert abs(loss.item() - float(jloss)) <= 1e-4
    assert abs(met["xent"].item() - float(jmet["xent"])) <= 1e-4
    jg = jax.device_get(jgrads)
    paths = [path for path, _ in _flat(live)]
    for path, g in zip(paths, grads):
        want = np.asarray(_at(jg, path), np.float32)
        assert g.shape == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        assert _maxerr(g, want) <= 1e-4 * scale, (path, _maxerr(g, want),
                                                  scale)
    assert len(paths) == len(jax.tree.leaves(jg)) == 15


def test_three_adamw_steps_match_reference(model):
    jcfg, tcfg, jlay, jp, tp = model
    opt = dict(lr=3e-3, warmup=2, total_steps=3)
    jlay1 = JPlan().build()
    jstate = jinit_params(opt_state_abstract(
        jtransformer.abstract_params(jcfg, jlay1), jlay1,
        jconfig.OptimConfig(**opt)), jax.random.key(1))
    jstep = jax.jit(jmake_train_step(jcfg, jlay1, jconfig.OptimConfig(**opt)))
    lay = ParallelPlan().validate(global_batch=4).build()
    step = make_train_step(tcfg, lay, config.OptimConfig(**opt))
    tparams = tree_map(lambda t: t.clone(), tp)
    tstate = adamw_init(tparams, lay, transformer.abstract_params(tcfg, lay))
    jparams = jp
    for s in range(3):
        batch = _batch(tcfg.vocab, b=4, s=16, seed=10 + s)
        jparams, jstate, jmet = jstep(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tparams, tstate, met = step(
            tparams, tstate, {k: torch.from_numpy(v).long()
                              for k, v in batch.items()})
        assert abs(met["loss"].item() - float(jmet["loss"])) <= 1e-2
        assert abs(met["gnorm"].item() - float(jmet["gnorm"])) <= 1e-2
    jg = jax.device_get(jparams)
    for path, t in _flat(tparams):
        assert _maxerr(t, np.asarray(_at(jg, path), np.float32)) <= 1e-2, path


def _decode_all(tcfg, tlayout, tp, toks, cache):
    steps = []
    for t in range(toks.shape[1]):
        logits, cache = transformer.forward(
            tcfg, tlayout, tp, {"token": toks[:, t:t + 1],
                                "pos": torch.full((toks.shape[0],), t,
                                                  dtype=torch.int32)},
            mode="decode", cache=cache)
        steps.append(logits)
    return torch.stack(steps, dim=1), cache


def _full_logits(tcfg, tlayout, tp, toks):
    dirs = transformer.entry_dirs()
    x = transformer.embed(tlayout, tcfg, dirs, tp, toks)
    pos = torch.arange(toks.shape[1]).expand(*toks.shape)
    x, _, _ = transformer.run_stack(tlayout, tcfg, dirs, x, tp, pos,
                                    mode="train")
    x = blocks.apply_norm(tcfg, x, tp["ln_f"])
    return x @ tp["head"]


def _fresh_cache(tcfg, tlayout, b, length=64):
    tree = kvcache.cache_with_dtype(
        transformer.abstract_cache(tcfg, tlayout, b, length), torch.float32)
    return init_params(tree, None, "cpu")


def test_decode_from_fresh_cache_matches_full_forward(model, tlayout):
    """40 tokens decoded one a step from ``abstract_cache``'s initial
    state (sLSTM n = 1) against the whole-sequence forward, whose chunk
    scan and sLSTM scan start from the same state: within 1e-4 at every
    position."""
    _, tcfg, _, _, tp = model
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(2, tcfg.vocab, (2, 40)))
    cache = _fresh_cache(tcfg, tlayout, 2)
    assert (cache["slstm"]["n"] == 1).all() and (cache["mlstm"]["C"] == 0) \
        .all()
    dec, cache = _decode_all(tcfg, tlayout, tp, toks, cache)
    assert _maxerr(dec, _full_logits(tcfg, tlayout, tp, toks)) <= 1e-4


def test_stack_cache_matches_reference(model):
    jcfg, tcfg, jlay, _, _ = model
    want = jtransformer.abstract_cache(jcfg, jlay, 3, 80)
    got = transformer.abstract_cache(tcfg, None, 3, 80)
    assert sorted(got) == sorted(want) == ["mlstm", "slstm"]
    for kind in want:
        assert sorted(got[kind]) == sorted(want[kind])
        for leaf, p in want[kind].items():
            assert got[kind][leaf].shape == tuple(p.shape), (kind, leaf)
            assert got[kind][leaf].init == p.init, (kind, leaf)
            assert got[kind][leaf].dtype == torch.float32


def test_engine_matches_reference(model, tlayout):
    """3 requests in 2 slots (a slot is wiped and reused), sequential
    prefill: the JAX engine's greedy tokens, decode logits within 1e-4 at
    every step."""
    from repro.serve import Engine as JEngine
    from repro.serve import Request as JRequest
    jcfg, tcfg, jlay, jp, tp = model
    jeng = JEngine(jcfg, jlay, jp, batch_size=2, max_len=64)
    teng = Engine(tcfg, tlayout, tp, batch_size=2, max_len=64)
    assert not teng.paged and not teng.chunked
    jlog, tlog = [], []
    fwd = jax.jit(lambda p, c, t, s: jtransformer.forward(
        jcfg, jlay, p, {"token": t, "pos": s}, mode="decode", cache=c))

    def jdecode(params, cache, tok, pos, key):
        logits, cache = fwd(params, cache, tok, pos)
        jlog.append(_np(logits))
        return jnp.argmax(logits, axis=-1), cache
    jeng._decode = jdecode
    sample = teng._sample

    def tsample(logits):
        tlog.append(logits.detach().float().numpy().copy())
        return sample(logits)
    teng._sample = tsample
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, 512, n).tolist() for n in (9, 20, 5)]
    news = (6, 16, 8)
    jreqs = [JRequest(uid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, news))]
    treqs = [Request(uid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, news))]
    jeng.run(jreqs)
    stats = teng.run(treqs)
    assert all(r.done and len(r.out) == m for r, m in zip(treqs, news))
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert stats["nonfinite_rows"] == 0 and stats["prefill_steps"] == 0
    assert len(tlog) == len(jlog) == stats["decode_steps"]
    assert max(_maxerr(t, j) for t, j in zip(tlog, jlog)) <= 1e-4


def test_reference_wipe_zeroes_slstm_normaliser(model, tlayout):
    """The reference's ``reset_rows`` (``serve/engine.py:230-236``) wipes
    every float leaf of a placed slot to 0, on the first admission too, so
    the sLSTM's n starts a served request at 0, not at the 1 of its cache
    init (``models/xlstm.py:370-372``) and its training scan.  Through
    that wiped cache the first decode logits of [mlstm, slstm] differ from
    the full forward's; with n set back to 1 they agree within 1e-4.  The
    port's engine copies the wipe (its tokens equal the JAX engine's)."""
    from repro.serve import Engine as JEngine
    jcfg, tcfg, jlay, jp, tp = model
    jeng = JEngine(jcfg, jlay, jp, batch_size=2, max_len=64)
    jeng.cache = jeng._reset(jeng.cache, jnp.asarray([True, True]))
    assert float(jnp.max(jnp.abs(jeng.cache["slstm"]["n"]))) == 0.0
    teng = Engine(tcfg, tlayout, tp, batch_size=2, max_len=64)
    teng._reset_rows(torch.tensor([True, True]))
    assert (teng.cache["slstm"]["n"] == 0).all()
    rng = np.random.default_rng(12)
    toks = torch.from_numpy(rng.integers(2, tcfg.vocab, (2, 4)))
    full = _full_logits(tcfg, tlayout, tp, toks)
    ones = tree_map(lambda t: t.clone(), teng.cache)
    ones["slstm"]["n"].fill_(1.0)
    wiped, _ = _decode_all(tcfg, tlayout, tp, toks, teng.cache)
    assert _maxerr(wiped[:, 0], full[:, 0]) > 1e-2
    ones, _ = _decode_all(tcfg, tlayout, tp, toks, ones)
    assert _maxerr(ones, full) <= 1e-4


def test_xlstm_refuses_prefill_and_extend(model, tlayout):
    _, tcfg, _, _, tp = model
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="recurrent state"):
        transformer.prefill(tcfg, tlayout, tp,
                            {"tokens": toks,
                             "length": torch.tensor([8], dtype=torch.int32)})
    with pytest.raises(ValueError, match="recurrent state"):
        transformer.extend(tcfg, tlayout, tp, {}, {})
