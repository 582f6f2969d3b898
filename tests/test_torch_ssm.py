"""The port's Mamba2 path against the JAX package, on the CPU.

K5 (the SSD scan) runs its plain versions here: the forward is held
against the reference's Pallas kernel in interpret mode, the whole
``ssd_chunked`` (the prologue, K5 with its explicit backward, the D skip)
and an autograd twin of it, written here, against the reference's
``ssd_chunked`` and ``jax.grad`` of it, with several heads per group and a
chunk that does not divide 64, and in the overflow case.  Then the Mamba2
block, the hybrid parameter tree and layer plan against the reference.
The whole zamba2 train step is held in ``tests/test_torch_train.py``.
Inputs come from numpy with a seed; weights cross by
``convert.params_from_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import config as jconfig
from repro.configs.registry import ARCH_IDS, get as jget
from repro.core.params import init_params as jinit_params
from repro.core.topology import single_device_layout
from repro.kernels import ops
from repro.models import mamba2 as jmamba2
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch import config
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core.params import init_params, tree_leaves
from repro_torch.core.plan import ParallelPlan
from repro_torch.core.topology import Dirs
from repro_torch.kernels import ssd_scan as k5
from repro_torch.models import mamba2, registry, transformer
from test_torch_cuda import ssd_inputs

F32 = jnp.float32
TF32 = torch.float32


def _np(a):
    return np.asarray(jax.device_get(a), np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _scaled_err(got, want):
    """max |got - want| / (1 + max |want|), in f32."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.max(np.abs(g - w)) / (1 + np.max(np.abs(w))))


# ---------------------------------------------------------------------------
# K5 SSD scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 256, 64, 16, 64), (2, 512, 32, 64, 128),
                                   (1, 128, 16, 8, 32)])
@pytest.mark.parametrize("bc_dtype", ["float32", "bfloat16"])
def test_k5_plain_matches_pallas(shape, bc_dtype):
    """The shapes of tests/test_kernels.py, one head per batch row: the
    Pallas kernel's flattened (BH, T, ...) is the port's (b, T, 1, ...)."""
    bh, T, dh, N, chunk = shape
    xbar, la, B, C = ssd_inputs(bh, T, 1, dh, 1, N, seed=2)
    jd, td = getattr(jnp, bc_dtype), getattr(torch, bc_dtype)
    want = ops.pallas_ssd(jnp.asarray(xbar[:, :, 0]), jnp.asarray(la[..., 0]),
                          jnp.asarray(B[:, :, 0], jd),
                          jnp.asarray(C[:, :, 0], jd), chunk=chunk,
                          interpret=True)
    before = k5.launches
    got, states = k5.ssd_scan_fwd(_t(xbar), _t(la), _t(B, td), _t(C, td),
                                  chunk)
    assert k5.launches == before                      # CPU: no kernel
    assert tuple(states.shape) == (bh, 1, T // chunk, N, dh)
    assert _scaled_err(got[:, :, 0], _np(want)) <= 1e-5


# (b, T, nh, dh, G, N, chunk): rep = nh / G heads per group; a T that the
# chunk does not divide (Q falls to the largest divisor, 50 and 40 here)
SSD_CASES = [(2, 128, 8, 16, 2, 16, 64), (1, 150, 4, 16, 2, 8, 64),
             (2, 160, 6, 8, 3, 4, 64)]


def ssd_chunked_plain(x, dt, A_log, B, C, D, chunk: int):
    """An autograd twin of ``mamba2.ssd_chunked``, independent of K5's
    explicit backward: the reference's chunk loop op for op in PyTorch,
    the exponent masked before ``exp`` (reference ``mamba2.py:70-73``)."""
    b, T, nh, dh = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = nh // G
    q = k5.chunk_len(T, chunk)
    a = -torch.exp(A_log.to(TF32))
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    h = torch.zeros(b, nh, dh, N, dtype=TF32, device=x.device)
    ys = []
    for s in range(0, T, q):
        dtf = F.softplus(dt[:, s:s + q].to(TF32))
        laq = dtf * a
        xq = x[:, s:s + q].to(TF32) * dtf[..., None]
        Bh = B[:, s:s + q].to(TF32).repeat_interleave(rep, dim=2)
        Ch = C[:, s:s + q].to(TF32).repeat_interleave(rep, dim=2)
        cum = torch.cumsum(laq, dim=1)                    # (b, Q, nh)
        tot = cum[:, -1]
        cb = torch.einsum("bihn,bjhn->bhij", Ch, Bh)
        cumT = cum.transpose(1, 2)
        ldec = torch.where(causal, cumT[..., :, None] - cumT[..., None, :],
                           -1e30)
        scores = torch.where(causal, cb, 0.0) * torch.exp(ldec)
        y = torch.einsum("bhij,bjhd->bihd", scores, xq)
        y = y + torch.einsum("bihn,bhdn->bihd",
                             Ch * torch.exp(cum)[..., None], h)
        w = torch.exp(tot[:, None] - cum)
        h = h * torch.exp(tot)[..., None, None] + torch.einsum(
            "bjh,bjhd,bjhn->bhdn", w, xq, Bh)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return y + x.to(TF32) * D.to(TF32)[None, None, :, None]


SSD_FNS = {"ssd_chunked": mamba2.ssd_chunked,
           "ssd_chunked_plain": ssd_chunked_plain}


def _ssd_args(b, T, nh, dh, G, N, *, seed=0, dt_shift=0.0, a_shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, T, nh, dh)).astype(np.float32)
    dt = (rng.standard_normal((b, T, nh)) + dt_shift).astype(np.float32)
    A_log = (rng.standard_normal(nh) * 0.5 + a_shift).astype(np.float32)
    B = (rng.standard_normal((b, T, G, N)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, T, G, N)) * 0.5).astype(np.float32)
    D = rng.standard_normal(nh).astype(np.float32)
    w = rng.standard_normal((b, T, nh, dh)).astype(np.float32)
    return (x, dt, A_log, B, C, D), w


def _ssd_both(fn, args, w, chunk):
    """(y, grads) of sum(fn(...) * w) in the port and of the reference's
    ssd_chunked under jax.grad, w.r.t. x, dt, A_log, B, C and D."""
    def jloss(*a):
        y, _ = jmamba2.ssd_chunked(*a, chunk=chunk)
        return jnp.sum(y * w), y
    (_, jy), jg = jax.value_and_grad(jloss, argnums=tuple(range(6)),
                                     has_aux=True)(*map(jnp.asarray, args))
    ts = [_t(a).requires_grad_() for a in args]
    y = fn(*ts, chunk)
    grads = torch.autograd.grad((y * _t(w)).sum(), ts)
    return (y.detach(), grads), (_np(jy), [_np(g) for g in jg])


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("fn", ["ssd_chunked", "ssd_chunked_plain"])
def test_ssd_chunked_and_grads_match_reference(case, fn):
    """ssd_chunked runs K5 (its plain forward and its explicit plain
    backward on the CPU); ssd_chunked_plain is differentiated by autograd.
    Both against jax.grad of the reference's ssd_chunked, f32."""
    *dims, chunk = case
    args, w = _ssd_args(*dims, seed=sum(dims))
    before = (k5.launches, k5.launches_bwd)
    (y, grads), (jy, jg) = _ssd_both(SSD_FNS[fn], args, w, chunk)
    assert (k5.launches, k5.launches_bwd) == before   # CPU: no kernel
    assert _scaled_err(y, jy) <= 1e-5
    for name, g, want in zip(("x", "dt", "A_log", "B", "C", "D"), grads, jg):
        assert g.shape == want.shape, name
        assert _scaled_err(g, want) <= 1e-4, (name, _scaled_err(g, want))


def test_ssd_overflow_case_has_finite_gradients():
    """dt and A_log large: per-step log-decays near -400, so an exponent
    taken above the diagonal would be exp(+25000) = inf, and inf * 0 = NaN
    in the backward.  The port masks it before exp, as the reference
    does."""
    b, T, nh, dh, G, N, chunk = 1, 128, 4, 16, 2, 8, 64
    args, w = _ssd_args(b, T, nh, dh, G, N, seed=9, dt_shift=20.0,
                        a_shift=3.0)
    for fn in ("ssd_chunked", "ssd_chunked_plain"):
        (y, grads), (jy, jg) = _ssd_both(SSD_FNS[fn], args, w, chunk)
        assert torch.isfinite(y).all()
        for g, want in zip(grads, jg):
            assert torch.isfinite(g).all() and np.isfinite(want).all()
            assert _scaled_err(g, want) <= 1e-4
    xbar, la, B, C = ssd_inputs(b, T, nh, dh, G, N, la_scale=400.0)
    y, states = k5.ssd_scan_plain(_t(xbar), _t(la), _t(B), _t(C), chunk)
    grads = k5.ssd_scan_bwd_plain(torch.ones_like(y), _t(xbar), _t(la),
                                  _t(B), _t(C), states, chunk)
    assert all(torch.isfinite(g).all() for g in (y, *grads))


def test_k5_refuses_other_devices():
    """K5 runs its plain version for CPU tensors, and for meta tensors
    (the dry run's shapes); a mix of devices raises."""
    xbar, la, B, C = (_t(a) for a in ssd_inputs(1, 8, 2, 4, 1, 4))
    y = k5.ssd_scan(xbar.to("meta"), la.to("meta"), B.to("meta"),
                    C.to("meta"))
    assert y.device.type == "meta" and y.shape == xbar.shape
    with pytest.raises(ValueError):
        k5.ssd_scan(xbar, la, B, C.to("meta"))


# ---------------------------------------------------------------------------
# The Mamba2 block
# ---------------------------------------------------------------------------
def _random_block(jcfg, seed):
    """One Mamba2 layer's f32 params with dt_bias, A_log, D and the conv
    biases drawn (the init leaves them zero or one)."""
    jlay = single_device_layout("3d")
    tree = jmamba2.mamba_params(jlay, jcfg, jtransformer.entry_dirs())
    p = jax.device_get(jinit_params(tree, jax.random.key(seed), dtype=F32))
    rng = np.random.default_rng(seed)
    for k in ("dt_bias", "A_log", "D", "conv_x_b", "conv_bc_b", "ln",
              "gate_ln"):
        p[k] = (np.asarray(p[k]) + rng.standard_normal(p[k].shape) * 0.3) \
            .astype(np.float32)
    return jlay, p


def test_mamba_block_and_grads_match_reference():
    """reduced zamba2 (d 256, 8 heads of 64, 2 groups, d_state 16, chunk
    64) over 160 steps: Q = 40, so the state crosses three chunk ends."""
    jcfg = jconfig.reduced(jget("zamba2-1.2b"))
    tcfg = config.reduced(get("zamba2-1.2b"))
    jlay, p = _random_block(jcfg, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 160, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    dirs = jtransformer.entry_dirs()

    def jloss(xx, pp):
        y, _ = jmamba2.mamba_apply(jlay, jcfg, dirs, xx, pp, None)
        return jnp.sum(y * w), y
    (_, jy), (jdx, jdp) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), p)
    lay = ParallelPlan().validate().build()
    tp = {k: v.requires_grad_() for k, v in params_from_jax(p, "cpu").items()}
    tx = _t(x).requires_grad_()
    y = mamba2.mamba_apply(lay, tcfg, Dirs("y", "z"), tx, tp)
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
# The hybrid parameter tree and layer plan
# ---------------------------------------------------------------------------
def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("red", [False, True])
def test_hybrid_param_tree_matches_reference(red):
    """Names, shapes and dtypes of transformer.abstract_params for
    zamba2-1.2b, full width and reduced: dt_bias, A_log and D stay f32."""
    jc, tc = jget("zamba2-1.2b"), get("zamba2-1.2b")
    if red:
        jc, tc = jconfig.reduced(jc), config.reduced(tc)
    jtree = jtransformer.abstract_params(jc, single_device_layout())
    jflat = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda p: hasattr(p, "spec"))[0]
    want = {tuple(k.key for k in path): (tuple(p.shape),
                                         jnp.dtype(p.dtype).name, p.init)
            for path, p in jflat}
    model_dtype = getattr(torch, tc.dtype)
    got = {path: (p.shape, str(p.dtype or model_dtype)[6:], p.init)
           for path, p in _flat(transformer.abstract_params(tc))}
    assert got == want
    f32 = {path[-1] for path, v in got.items() if v[1] == "float32"}
    assert f32 == {"dt_bias", "A_log", "D"}


def test_init_and_convert_keep_f32_leaves():
    cfg = config.reduced(get("zamba2-1.2b"))
    p = init_params(transformer.abstract_params(cfg),
                    torch.Generator().manual_seed(0), "cpu")
    m = p["stack"]["mamba"]
    assert m["A_log"].dtype == m["D"].dtype == m["dt_bias"].dtype \
        == torch.float32
    assert (m["A_log"] == 0).all() and (m["D"] == 1).all()
    assert m["w_x"].dtype == m["ln"].dtype == torch.bfloat16
    # conv taps: fan-in over the K = 4 axis
    assert abs(m["conv_x"].float().std().item() * 2 - 1) < 0.05
    jtree = jtransformer.abstract_params(jconfig.reduced(jget("zamba2-1.2b")),
                                         single_device_layout())
    jp = jax.device_get(jinit_params(jtree, jax.random.key(0), dtype=F32))
    tp = params_from_jax(jp, "cpu", dtype=torch.bfloat16, cfg=cfg)
    for path, t in _flat(tp):
        want = torch.float32 if path[-1] in ("dt_bias", "A_log", "D") \
            else torch.bfloat16
        assert t.dtype == want, path
    with pytest.raises(ValueError):
        params_from_jax(jp, "cpu", dtype=torch.bfloat16)


def test_layer_plan_and_segments_match_reference():
    for arch in ARCH_IDS:
        for red in (False, True):
            c, jc = get(arch), jget(arch)
            if red:
                c, jc = config.reduced(c), jconfig.reduced(jc)
            plan = jregistry.get_stack(jc.family).layer_plan(jc)
            assert registry.layer_plan(c) == plan, arch
            assert registry.segments(plan) == jregistry._segments(plan)
    for every, n in ((6, 38), (2, 5), (3, 3), (0, 4)):
        jc = dataclasses.replace(jget("zamba2-1.2b"), n_layers=n, ssm=(
            dataclasses.replace(jget("zamba2-1.2b").ssm, attn_every=every)))
        c = dataclasses.replace(get("zamba2-1.2b"), n_layers=n, ssm=(
            dataclasses.replace(get("zamba2-1.2b").ssm, attn_every=every)))
        assert registry.layer_plan(c) == jregistry._plan_hybrid(jc)


def test_hybrid_counts_and_flops_match_reference():
    """The real tree holds 1.18B parameters; the reference's FLOPs formula
    counts 2.68B (n_params, dense accounting), and the port copies it, as
    it copies the SSM family's formula for xlstm-350m."""
    c, jc = get("zamba2-1.2b"), jget("zamba2-1.2b")
    n_tree = sum(np.prod(p.shape)
                 for p in tree_leaves(transformer.abstract_params(c)))
    assert n_tree == jtransformer.param_counts(jc)[0]
    assert round(n_tree / 1e9, 2) == 1.18
    assert round(c.n_params() / 1e9, 2) == 2.68
    for s in (1, 2048, 8192):
        assert registry.train_flops_per_token(c, s) == \
            jregistry.train_flops_per_token(jc, s)
    for s in (1, 2048, 8192):
        assert registry.train_flops_per_token(get("xlstm-350m"), s) == \
            jregistry.train_flops_per_token(jget("xlstm-350m"), s)
