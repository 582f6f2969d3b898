"""The port's kernels against the JAX package.

On the CPU each kernel module's plain version runs and is held against the
reference's Pallas kernel in interpret mode and its jnp oracle: K1 (matmul
+ bias + activation) at 1e-4 in f32, K4 (paged flash-decode, residuals
included) at 1e-5.  The routing of K1 and K2 between their kernels is
checked here too (K2's plain version is held against the JAX package in
``test_torch_train.py``).  ``test_torch_cuda.py`` holds each CUDA kernel
against its plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.kernels.matmul import matmul as pallas_matmul_bias
from repro.kernels.paged_decode import paged_flash_decode as jax_paged_decode
from repro_torch.kernels import flash_attention as k2
from repro_torch.kernels import matmul as k1
from repro_torch.kernels import paged_decode as k4
from test_torch_cuda import _mm_inputs, _paged_case


# ---------------------------------------------------------------------------
# K1 matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("x_shape,n", [((64, 32), 48), ((2, 8, 64), 40)])
@pytest.mark.parametrize("act", k1.ACTS)
@pytest.mark.parametrize("bias", [False, True])
def test_k1_plain_matches_pallas(x_shape, n, act, bias):
    x, w, b = _mm_inputs(x_shape, n, bias)
    got = k1.matmul(torch.from_numpy(x), torch.from_numpy(w),
                    None if b is None else torch.from_numpy(b), act=act)
    assert tuple(got.shape) == (*x_shape[:-1], n)
    got = got.numpy().reshape(-1, n)
    x2 = x.reshape(-1, x_shape[-1])
    if b is None:
        pallas = ops.pallas_matmul(jnp.asarray(x), jnp.asarray(w), act=act,
                                   interpret=True)
    else:
        pallas = pallas_matmul_bias(jnp.asarray(x2), jnp.asarray(w),
                                    jnp.asarray(b), act=act, interpret=True)
    oracle = ref.matmul_ref(jnp.asarray(x2), jnp.asarray(w),
                            None if b is None else jnp.asarray(b), act=act)
    for want in (pallas, oracle):
        err = float(np.max(np.abs(got - np.asarray(want).reshape(-1, n))))
        assert err <= 1e-4, err


def test_kernels_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors, or for meta
    tensors (the dry run's shapes, ``_build.on_cuda``); a mix of devices,
    or any other device, raises instead of falling back."""
    import types

    from repro_torch.kernels import _build
    x, w = torch.zeros(4, 8), torch.zeros(8, 4)
    with pytest.raises(ValueError):
        k1.matmul(x, w.to("meta"))
    q = torch.zeros(1, 2, 4, device="meta")
    pool = torch.zeros(4, 1, 4, device="meta")
    pos = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        k4.paged_flash_decode(torch.zeros(q.shape), pool, pool, pos,
                              pos[None, :1], pos[:1], block=2)
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="xpu"):
        _build.on_cuda("K1 matmul", other, other)
    assert not _build.on_cuda("K1 matmul", x.to("meta"), w.to("meta"))


# (M, K, N) of every GEMM on the port's main paths: tinyllama-1.1b's decode
# step (M = 8), prefill (M = 4096; its head at M = 8) and training step
# (M = 8192; head chunks of 4096), and zamba2-1.2b's training step
_TINY_KN = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)]
_ZAMBA_KN = [(2048, 4096), (2048, 256), (2048, 64), (4096, 2048),
             (2048, 2048), (2048, 8192), (8192, 2048)]
_MAIN_PATH_GEMMS = sorted(
    {(m, k, n) for m in (8, 4096, 8192) for k, n in _TINY_KN}
    | {(8, 2048, 32000), (4096, 2048, 32000)}
    | {(8192, k, n) for k, n in _ZAMBA_KN})


@pytest.mark.parametrize("m,k,n", _MAIN_PATH_GEMMS)
def test_k1_routes_main_path_gemms_to_tensor_cores_or_decode(m, k, n):
    x = torch.empty(m, k, dtype=torch.bfloat16)
    w = torch.empty(k, n, dtype=torch.bfloat16)
    got = k1.route_for(x, w)
    assert got == ("decode" if m <= k1.DECODE_MAX_M else "tc")
    assert got == ("decode" if m == 8 else "tc")
    assert k1.route_for(x.float(), w.float()) == "simt"
    assert k1.tile_n(m, n) in (64, 128, 256)


@pytest.mark.parametrize("m,k,n", [(8, 2048, 130), (4096, 97, 256),
                                   (8, 96 + 1, 64), (70, 96, 130)])
def test_k1_routes_shapes_tma_cannot_describe_to_simt(m, k, n):
    x = torch.empty(m, k, dtype=torch.bfloat16)
    w = torch.empty(k, n, dtype=torch.bfloat16)
    assert k1.route_for(x, w) == "simt"
    assert k1.route(m, n, k, torch.bfloat16, True) == "simt"


@pytest.mark.parametrize("m", [8, 4096])
def test_k1_routes_unaligned_views_to_simt(m):
    """A contiguous view may start off 16 bytes: TMA and the decode
    kernel's 16-byte loads cannot take it."""
    k, n = 256, 256
    xs = torch.empty(m * k + 8, dtype=torch.bfloat16)
    ws = torch.empty(k * n + 8, dtype=torch.bfloat16)
    x, w = xs[:m * k].view(m, k), ws[:k * n].view(k, n)
    assert x.data_ptr() % 16 == 0 and k1.route_for(x, w) != "simt"
    x_off = xs[1:1 + m * k].view(m, k)
    w_off = ws[3:3 + k * n].view(k, n)
    assert x_off.is_contiguous() and w_off.is_contiguous()
    assert k1.route_for(x_off, w) == "simt"
    assert k1.route_for(x, w_off) == "simt"
    assert k1.route(m, n, k, torch.bfloat16, False) == "simt"


def test_k1_route_f32_and_other_dtypes_take_simt():
    for m, k, n in _MAIN_PATH_GEMMS:
        assert k1.route(m, n, k, torch.float32, True) == "simt"


@pytest.mark.parametrize("n,k", sorted({(n, k) for _, k, n in
                                        _MAIN_PATH_GEMMS}
                                       | {(8, 8), (256, 5632), (64, 96)}))
def test_k1_decode_plan_covers_k_once_on_tile_boundaries(n, k):
    kt, length, splits = k1.decode_plan(n, k)
    assert kt in k1.DECODE_TILES
    assert length > 0 and length % kt == 0
    # the ranges [s*len, min((s+1)*len, K)) tile [0, K) exactly once,
    # none empty, each a whole number of kt-row stages but the last
    assert splits == -(-k // length)
    assert (splits - 1) * length < k <= splits * length
    covered = np.zeros(k, np.int64)
    for s_ in range(splits):
        covered[s_ * length:min((s_ + 1) * length, k)] += 1
    assert (covered == 1).all()
    ctas = -(-n // k1.DECODE_COLS) * splits
    if n == 256:
        assert ctas >= 2 * k1.NUM_SMS
    if -(-k // k1.DECODE_TILES[-1]) * -(-n // k1.DECODE_COLS) \
            >= k1.DECODE_MIN_CTAS:
        assert ctas >= k1.DECODE_MIN_CTAS


@pytest.mark.parametrize("m,rows", [(1, 8), (8, 8), (9, 16), (32, 32),
                                    (33, 64), (64, 64), (200, 64)])
def test_k1_decode_rows(m, rows):
    assert k1.decode_rows(m) == rows


def test_k1_tile_n_fills_the_card():
    assert k1.tile_n(8192, 64) == 64
    assert k1.tile_n(8192, 256) == 128       # 64 tiles of 128 x 256: too few
    assert k1.tile_n(8192, 2048) == 256
    assert k1.tile_n(4096, 32000) == 256
    assert k1.tile_n(128, 2048) == 128


def test_k1_force_names_a_route():
    x, w = torch.zeros(4, 8), torch.zeros(8, 8)
    # CPU tensors run the plain version whatever route is named
    assert torch.equal(k1.matmul(x, w, force="tc"), k1.matmul_plain(x, w))


# ---------------------------------------------------------------------------
# K2 flash attention: routes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", k2.TC_HEAD_DIMS)
def test_k2_routes_aligned_bf16_at_d64_d128_to_tensor_cores(d):
    q = torch.empty(2, 128, 8, d, dtype=torch.bfloat16)
    kv = torch.empty(2, 128, 2, d, dtype=torch.bfloat16)
    assert k2.route(torch.bfloat16, d, True) == "tc"
    assert k2.route_for(q, kv, kv) == "tc"


@pytest.mark.parametrize("dtype,d,aligned", [
    (torch.float32, 64, True), (torch.float32, 128, True),
    (torch.float32, 16, True), (torch.bfloat16, 16, True),
    (torch.bfloat16, 32, True), (torch.bfloat16, 64, False),
    (torch.bfloat16, 128, False)])
def test_k2_routes_f32_small_heads_and_unaligned_to_simt(dtype, d, aligned):
    assert k2.route(dtype, d, aligned) == "simt"


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_k2_routes_unaligned_views_to_simt(which):
    """A contiguous view may start off 16 bytes: TMA cannot take it."""
    shapes = {"q": (1, 64, 4, 64), "k": (1, 64, 2, 64), "v": (1, 64, 2, 64)}
    ts = {n: torch.empty(s, dtype=torch.bfloat16) for n, s in shapes.items()}
    buf = torch.empty(ts[which].numel() + 8, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    ts[which] = buf[8:].view(shapes[which])
    assert k2.route_for(ts["q"], ts["k"], ts["v"]) == "tc"
    ts[which] = buf[1:1 + ts[which].numel()].view(shapes[which])
    assert ts[which].is_contiguous()
    assert k2.route_for(ts["q"], ts["k"], ts["v"]) == "simt"


def _k2_cpu_case(dtype=torch.float32):
    rng = np.random.default_rng(5)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype) for s in ((1, 40, 4, 64), (1, 40, 2, 64),
                                         (1, 40, 2, 64), (1, 40, 4, 64)))
    pos = torch.arange(40, dtype=torch.int32)
    return q, k, v, dout, pos[None].contiguous(), pos


@pytest.mark.parametrize("force", k2.ROUTES)
def test_k2_force_names_a_route(force):
    """CPU tensors run the plain versions whatever route is named, and
    never touch the launch counters."""
    q, k, v, dout, q_pos, k_pos = _k2_cpu_case(torch.bfloat16)
    before = (k2.launches, k2.launches_bwd, dict(k2.launches_by_route),
              dict(k2.launches_bwd_by_route))
    out, lse = k2.flash_attention_fwd(q, k, v, q_pos, k_pos, force=force)
    want = k2.flash_attention_fwd_plain(q, k, v, q_pos, k_pos)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    grads = k2.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos,
                                   force=force)
    want = k2.flash_attention_bwd_plain(q, k, v, out, dout, lse, q_pos,
                                        k_pos)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    qg = q.clone().requires_grad_()
    k2.flash_attention(qg, k, v, q_pos, k_pos)[0].float().sum().backward()
    assert torch.isfinite(qg.grad.float()).all()
    assert (k2.launches, k2.launches_bwd, k2.launches_by_route,
            k2.launches_bwd_by_route) == before


def test_k2_force_rejects_an_unknown_route():
    q, k, v, dout, q_pos, k_pos = _k2_cpu_case()
    out, lse = k2.flash_attention_fwd_plain(q, k, v, q_pos, k_pos)
    with pytest.raises(ValueError):
        k2.flash_attention_fwd(q, k, v, q_pos, k_pos, force="sdpa")
    with pytest.raises(ValueError):
        k2.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos,
                               force="cudnn")
    with pytest.raises(ValueError):
        k2.flash_attention_fwd(q, k, v, q_pos, k_pos, force="TC")


# ---------------------------------------------------------------------------
# K4 paged decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [
    # (B, nq, nkv, dk, dv, block, nb, n_blocks)
    (3, 8, 2, 32, 32, 8, 5, 16),
    (2, 4, 1, 16, 48, 4, 7, 16),      # MQA, dv != dk
    (2, 8, 8, 16, 16, 16, 3, 8),      # MHA
])
@pytest.mark.parametrize("window", [0, 10])
@pytest.mark.parametrize("residuals", [False, True])
def test_k4_plain_matches_pallas(shape, window, residuals):
    B, nq, nkv, dk, dv, block, nb, n_blocks = shape
    case = _paged_case(B=B, nq=nq, nkv=nkv, dk=dk, dv=dv, block=block,
                       nb=nb, n_blocks=n_blocks)
    want = jax_paged_decode(*map(jnp.asarray, case), block=block,
                            window=window, impl="pallas", interpret=True,
                            return_residuals=residuals)
    got = k4.paged_flash_decode(*map(torch.from_numpy, case), block=block,
                                window=window, return_residuals=residuals)
    if not residuals:
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        err = float(np.max(np.abs(g.numpy() - np.asarray(w))))
        assert err <= 1e-5, err


@pytest.mark.parametrize("shape", [
    # (B, nq, nkv, dk, dv, block, nb, n_blocks)
    (3, 8, 2, 32, 32, 8, 5, 16),
    (2, 4, 1, 16, 48, 4, 7, 16),      # MQA, dv != dk
])
@pytest.mark.parametrize("splits", [1, 3, "nb"])
@pytest.mark.parametrize("window", [0, 10])
@pytest.mark.parametrize("residuals", [False, True])
def test_k4_split_algebra_matches_pallas(shape, splits, window, residuals):
    """The split route's algebra (the plain K4's residuals over runs of
    table columns, then the combine pass) against the Pallas kernel in
    interpret mode.  At 3 and nb splits the last splits hold no valid
    column (every slot's context ends before them)."""
    B, nq, nkv, dk, dv, block, nb, n_blocks = shape
    case = _paged_case(B=B, nq=nq, nkv=nkv, dk=dk, dv=dv, block=block,
                       nb=nb, n_blocks=n_blocks)
    n = nb if splits == "nb" else splits
    assert k4.split_cols(nb, n)[0] == n
    want = jax_paged_decode(*map(jnp.asarray, case), block=block,
                            window=window, impl="pallas", interpret=True,
                            return_residuals=residuals)
    got = k4.paged_flash_decode_split_plain(
        *map(torch.from_numpy, case), block=block, splits=n, window=window,
        return_residuals=residuals)
    if not residuals:
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        err = float(np.max(np.abs(g.numpy() - np.asarray(w))))
        assert err <= 1e-4, err


@pytest.mark.parametrize("n_kv", [4, 2, 1])
@pytest.mark.parametrize("window", [0, 10])
def test_k4_step_plain_matches_reference_fold(n_kv, window):
    """The fused-fold entry's plain version (residual K4, then the current
    token folded in) against the reference's ``attention_decode_paged``
    (``src/repro/models/blocks.py``: K4's residuals, then the fold) on the
    same inputs, at tinyllama's reduced widths with 4/n_kv heads."""
    import dataclasses

    from repro.config import reduced as jreduced
    from repro.configs.registry import get as jget
    from repro.core.topology import Dirs, single_device_layout
    from repro.models import blocks as jblocks
    cfg = dataclasses.replace(jreduced(jget("tinyllama-1.1b")), n_kv=n_kv)
    nq, d, block, nb = cfg.n_heads, cfg.head_dim, 8, 5
    case = _paged_case(B=3, nq=nq, nkv=n_kv, dk=d, dv=d, block=block, nb=nb,
                       n_blocks=16)
    q, k_pool, v_pool, pos_pool, tables, cur = case
    rng = np.random.default_rng(1)
    k_new, v_new = (rng.standard_normal((3, n_kv, d)).astype(np.float32)
                    for _ in range(2))
    lay = single_device_layout("3d")
    page = jblocks.PageInfo(jnp.asarray(tables), jnp.ones((3,), bool), block)
    cache = {"k": jnp.asarray(k_pool), "v": jnp.asarray(v_pool),
             "pos": jnp.asarray(pos_pool)}
    want, _ = jblocks.attention_decode_paged(
        lay, cfg, Dirs("y", "z"), jnp.asarray(q)[:, None],
        jnp.asarray(k_new)[:, None], jnp.asarray(v_new)[:, None], cache,
        jnp.asarray(cur), page, window=window)
    t = [torch.from_numpy(a) for a in (q, k_new, v_new, k_pool, v_pool,
                                       pos_pool, tables, cur)]
    got = k4.paged_flash_decode_step_plain(*t, block=block, window=window)
    assert k4.paged_flash_decode_step(*t, block=block, window=window).equal(
        got)
    err = float(np.max(np.abs(got.numpy() - np.asarray(want)[:, 0])))
    assert err <= 1e-4, err


def test_k4_routes_and_split_plan():
    """``route`` sends bf16 at dk = dv in (64, 128) with a group of 1-8 and
    a block of 8-32 (a multiple of 8), on 16 bytes, to the split kernel and
    everything else to simt; ``split_plan`` fills one wave of the CTAs the
    card holds from host sizes alone and covers every column; the ring
    that sets how many CTAs an SM holds grows with d and the block."""
    bf, f32 = torch.bfloat16, torch.float32
    assert k4.route(bf, 64, 64, 8, 16, True) == "split"        # tinyllama
    assert k4.route(bf, 128, 128, 1, 8, True) == "split"
    assert k4.route(bf, 128, 128, 4, 32, True) == "split"
    for args in [(f32, 64, 64, 8, 16, True), (bf, 32, 48, 4, 8, True),
                 (bf, 64, 64, 8, 16, False), (bf, 64, 64, 16, 16, True),
                 (bf, 64, 64, 3, 16, True), (bf, 64, 64, 8, 12, True),
                 (bf, 64, 64, 8, 64, True), (bf, 256, 256, 8, 16, True)]:
        assert k4.route(*args) == "simt", args
    assert k4.split_ring(16, 64) == (4, 64 * 1024)     # 3 CTAs an SM
    assert k4.split_ring(16, 128) == (3, 96 * 1024)    # 2
    assert k4.split_ring(32, 64) == (3, 96 * 1024)
    assert k4.split_ring(32, 128) == (2, 128 * 1024)   # 1
    assert k4.split_plan(8, 4, 32, 3 * 132) == (8, 4)      # serve: 256 CTAs
    assert k4.split_plan(64, 4, 128, 3 * 132) == (1, 128)  # long: 256 CTAs
    assert k4.split_plan(4, 4, 128, 3 * 132) == (16, 8)    # 256 CTAs
    assert k4.split_plan(4, 4, 128, 132) == (8, 16)        # 128 CTAs
    for B, nkv, nb, per_sm in [(8, 4, 32, 3), (1, 1, 7, 3), (3, 4, 200, 2),
                               (64, 8, 1, 2), (2, 2, 0, 1), (512, 8, 64, 1),
                               (16, 4, 64, 1)]:
        n, cols = k4.split_plan(B, nkv, nb, per_sm * 132)
        assert n >= 1 and n * cols >= nb and (n - 1) * cols < max(nb, 1)
        assert cols % k4.WARPS == 0
        assert n == 1 or n * B * nkv <= per_sm * 132
    with pytest.raises(ValueError):
        k4.paged_flash_decode(*(torch.zeros(1) for _ in range(6)), block=1,
                              force="tc")
