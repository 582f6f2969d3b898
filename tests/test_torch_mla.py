"""MLA's pieces in the port against the JAX package, on the CPU.

  * K2 at MLA's training pair, q and k at 192 and v at 128: out, dq, dk and
    dv against the reference model's ``flash_attention_jnp`` and its
    ``jax.grad``, within 1e-4 in f32;
  * K4's plain version on MLA's latent decode, q f32 over bf16 pools (one
    kv head of 576, v 512 wide, a group of 8 heads), against the
    reference's ``paged_flash_decode`` (its residuals too);
  * ``matmul3d_noswap``, ``matmul3d_repc`` and ``matmul3d_repc_decode``,
    forward and gradients, against the reference's ``custom_vjp`` islands,
    within 1e-4;
  * ``mla_apply`` of reduced deepseek-v3 (q and k at 32, v at 16) in
    training (output and every gradient), in the contiguous decode (a
    cache from ``mla_cache_init``, positions starting at 0) and in the
    paged decode over a latent pool, within 1e-4.

Inputs come from numpy with a seed and cross as arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.configs.registry import get as jget
from repro.core import ops3d as jops3d
from repro.core.topology import Dirs as JDirs
from repro.core.topology import single_device_layout
from repro.kernels import paged_decode as jk4
from repro.models import blocks as jblocks
from repro.models import mla as jmla
from repro_torch import config
from repro_torch.configs.registry import get
from repro_torch.core import ops3d
from repro_torch.core.params import init_params, tree_map
from repro_torch.core.plan import ParallelPlan
from repro_torch.core.topology import Dirs
from repro_torch.kernels import flash_attention as k2
from repro_torch.kernels import paged_decode as k4
from repro_torch.models import blocks, mla

F32 = jnp.float32
TOL = 1e-4


def _maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _close(got, want, tol=TOL):
    """Within ``tol`` of 1 + the reference's largest magnitude."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    err = _maxerr(got, want)
    assert err <= tol * (1.0 + float(np.abs(want).max())), err


@pytest.fixture(scope="module")
def lay():
    return (single_device_layout("3d"), ParallelPlan().validate().build())


# ---------------------------------------------------------------------------
# K2 at dk 192 / dv 128 (fails on the plain backward before the repair)
# ---------------------------------------------------------------------------
def test_k2_dv_unlike_dk_matches_jnp_and_its_grad():
    b, s, h, dk, dv = 1, 8, 2, 192, 128
    rng = np.random.default_rng(0)
    q, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    w = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    qp = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    kp = np.arange(s, dtype=np.int32)

    def jf(q, k, v):
        out, _ = jblocks.flash_attention_jnp(q, k, v, jnp.asarray(qp),
                                             jnp.asarray(kp), causal=True)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, _ = k2.flash_attention(tq, tk, tv, torch.from_numpy(qp),
                                torch.from_numpy(kp), causal=True)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.shape == (b, s, h, dv)
    _close(out, jout)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        _close(got, want)


# ---------------------------------------------------------------------------
# K4's plain version on the latent shape
# ---------------------------------------------------------------------------
def test_k4_latent_decode_plain_matches_reference():
    B, g, R, dr, block, nb = 3, 8, 512, 64, 16, 4
    rng = np.random.default_rng(1)
    phys = (B * nb + 2) * block
    q = rng.standard_normal((B, g, R + dr)).astype(np.float32)
    kpool = rng.standard_normal((phys, 1, R + dr)).astype(np.float32)
    kpool_bf = torch.from_numpy(kpool).to(torch.bfloat16)
    vpool_bf = kpool_bf[:, :, :R].contiguous()
    pos = np.full(phys, -1, np.int32)
    tables = np.zeros((B, nb), np.int32)
    cur = np.array([20, 37, 63], np.int32)
    for i in range(B):
        tables[i] = 2 + i * nb + np.arange(nb)
        n = int(cur[i])
        rows = (tables[i][:, None] * block + np.arange(block)).reshape(-1)
        pos[rows[:n]] = np.arange(n)
    kw = dict(block=block, scale=1.0 / np.sqrt(192.0))
    jk = jnp.asarray(kpool_bf.float().numpy()).astype(jnp.bfloat16)
    jv = jk[:, :, :R]
    args = (torch.from_numpy(q), kpool_bf, vpool_bf, torch.from_numpy(pos),
            torch.from_numpy(tables), torch.from_numpy(cur))
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(pos), jnp.asarray(tables),
             jnp.asarray(cur))
    out = k4.paged_flash_decode(*args, **kw)
    assert out.dtype == torch.float32
    _close(out, jk4.paged_flash_decode(*jargs, impl="jnp", **kw))
    res = k4.paged_flash_decode(*args, return_residuals=True, **kw)
    jres = jk4.paged_flash_decode(*jargs, impl="jnp", return_residuals=True,
                                  **kw)
    for got, want in zip(res, jres):
        _close(got, want)


# ---------------------------------------------------------------------------
# The low-rank 3-D linears
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["noswap", "repc", "repc_decode"])
def test_lowrank_linears_and_grads_match_reference(op, lay):
    jlay, tlay = lay
    s = 1 if op == "repc_decode" else 12
    b, h, f = 2, 48, 40
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    w = (rng.standard_normal((h, f)) / np.sqrt(h)).astype(np.float32)
    c = rng.standard_normal((b, s, f)).astype(np.float32)
    jfn = {"noswap": jops3d.matmul3d_noswap, "repc": jops3d.matmul3d_repc,
           "repc_decode": jops3d.matmul3d_repc_decode}[op]
    tfn = {"noswap": ops3d.matmul3d_noswap, "repc": ops3d.matmul3d_repc,
           "repc_decode": ops3d.matmul3d_repc_decode}[op]

    def jf(x, w):
        y = jfn(jlay, "y", "z", x, w)
        return jnp.sum(y * c), y

    (_, jy), (jdx, jdw) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    y = tfn(tlay, "y", "z", tx, tw)
    (y * torch.from_numpy(c)).sum().backward()
    _close(y, jy)
    _close(tx.grad, jdx)
    _close(tw.grad, jdw)


# ---------------------------------------------------------------------------
# mla_apply
# ---------------------------------------------------------------------------
def _mla_setup(seed=3):
    """(jax cfg, port cfg, jax params, port params) of one reduced MLA."""
    jcfg = jconfig.reduced(jget("deepseek-v3-671b"))
    tcfg = config.reduced(get("deepseek-v3-671b"))
    tp = init_params(mla.mla_params(tcfg),
                     torch.Generator().manual_seed(seed), "cpu",
                     torch.float32)
    return jcfg, tcfg, tree_map(lambda t: jnp.asarray(t.numpy()), tp), tp


def test_mla_apply_train_and_grads_match_reference(lay):
    jlay, tlay = lay
    jcfg, tcfg, jp, tp = _mla_setup()
    assert tcfg.mla.qk_nope_dim + tcfg.mla.qk_rope_dim != tcfg.mla.v_head_dim
    b, s = 2, 24
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()

    def jf(x, p):
        y, kv = jmla.mla_apply(jlay, jcfg, JDirs("y", "z"), x, p,
                               jnp.asarray(pos), collect_kv=True)
        return jnp.sum(y * w), (y, kv)

    (_, (jy, jkv)), (jdx, jdp) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jp)
    live = tree_map(lambda t: t.detach().requires_grad_(), tp)
    tx = torch.from_numpy(x).requires_grad_()
    y, kv = mla.mla_apply(tlay, tcfg, Dirs("y", "z"), tx, live,
                          torch.from_numpy(pos), collect_kv=True)
    (y * torch.from_numpy(w)).sum().backward()
    _close(y, jy)
    for got, want in zip(kv, jkv):
        _close(got, want)
    _close(tx.grad, jdx)
    for name in tp:
        _close(live[name].grad, jdp[name])


def _latents(rng, b, n, tcfg):
    m = tcfg.mla
    return (rng.standard_normal((b, n, m.kv_lora_rank)).astype(np.float32),
            rng.standard_normal((b, n, m.qk_rope_dim)).astype(np.float32))


def test_mla_contiguous_decode_matches_reference(lay):
    """A cache from ``mla_cache_init`` (positions 0 in unwritten slots),
    the first slots written, two decode steps per row at positions below
    and past the written ones."""
    jlay, tlay = lay
    jcfg, tcfg, jp, tp = _mla_setup()
    b, L = 3, 32
    rng = np.random.default_rng(5)
    cc, ckr = _latents(rng, b, L, tcfg)
    fill = np.array([5, 17, 31])
    cpos = np.zeros((b, L), np.int32)
    for i, n in enumerate(fill):
        cpos[i, :n] = np.arange(n)
    cc[cpos == 0] = 0.0
    ckr[cpos == 0] = 0.0
    jcache = {"c_kv": jnp.asarray(cc), "k_rope": jnp.asarray(ckr),
              "pos": jnp.asarray(cpos)}
    tcache = {"c_kv": torch.from_numpy(cc.copy()),
              "k_rope": torch.from_numpy(ckr.copy()),
              "pos": torch.from_numpy(cpos.copy())}
    assert set(tcache) == set(mla.mla_cache_init(tcfg, b, L))
    for step in range(2):
        x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
        pos = (fill + step).astype(np.int32)
        jy, jcache = jmla.mla_apply(jlay, jcfg, JDirs("y", "z"),
                                    jnp.asarray(x), jp,
                                    jnp.asarray(pos)[:, None], decode=True,
                                    cache=jcache)
        y, tcache = mla.mla_apply(tlay, tcfg, Dirs("y", "z"),
                                  torch.from_numpy(x), tp,
                                  torch.from_numpy(pos)[:, None],
                                  decode=True, cache=tcache)
        _close(y, jy)
        for name in tcache:
            _close(tcache[name].float(), np.asarray(jcache[name],
                                                    np.float32))


def test_mla_paged_decode_matches_reference(lay):
    jlay, tlay = lay
    jcfg, tcfg, jp, tp = _mla_setup()
    b, block, nb = 3, 8, 3
    phys = (b * nb + 2) * block
    rng = np.random.default_rng(6)
    cc, ckr = _latents(rng, 1, phys, tcfg)
    ppos = np.full(phys, -1, np.int32)
    tables = np.zeros((b, nb), np.int32)
    cur = np.array([3, 11, 23], np.int32)
    for i in range(b):
        tables[i] = 2 + i * nb + np.arange(nb)
        rows = (tables[i][:, None] * block + np.arange(block)).reshape(-1)
        ppos[rows[:int(cur[i])]] = np.arange(int(cur[i]))
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    active = np.ones(b, bool)
    jpage = jblocks.PageInfo(tables=jnp.asarray(tables),
                             active=jnp.asarray(active), block=block)
    jcache = {"c_kv": jnp.asarray(cc[0]), "k_rope": jnp.asarray(ckr[0]),
              "pos": jnp.asarray(ppos)}
    jy, jnew = jmla.mla_apply(jlay, jcfg, JDirs("y", "z"), jnp.asarray(x),
                              jp, jnp.asarray(cur)[:, None], decode=True,
                              cache=jcache, page=jpage)
    page = blocks.PageInfo(tables=torch.from_numpy(tables),
                           active=torch.from_numpy(active), block=block)
    tcache = {"c_kv": torch.from_numpy(cc[0]),
              "k_rope": torch.from_numpy(ckr[0]),
              "pos": torch.from_numpy(ppos)}
    y, new = mla.mla_apply(tlay, tcfg, Dirs("y", "z"), torch.from_numpy(x),
                           tp, torch.from_numpy(cur)[:, None], decode=True,
                           cache=tcache, page=page)
    _close(y, jy)
    assert set(new) == set(jnew)
    for name in new:
        _close(new[name].float(), np.asarray(jnew[name], np.float32))
