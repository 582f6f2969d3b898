"""The port's CUDA kernels against their plain versions, on the card:
K1 matmul, K2 flash attention and K3 RMSNorm (forward and backward), K4
paged decode, K5 SSD scan (forward and backward).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports only torch, numpy and ``repro_torch``, so it runs
where jax is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

``_mm_inputs`` and ``_paged_case`` also feed ``test_torch_kernels.py``,
which holds the plain versions against the JAX package on the CPU.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as k2
from repro_torch.kernels import matmul as k1
from repro_torch.kernels import paged_decode as k4
from repro_torch.kernels import rmsnorm as k3
from repro_torch.kernels import ssd_scan as k5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mm_inputs(x_shape, n, bias, seed=0):
    rng = np.random.default_rng(seed)
    k = x_shape[-1]
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal((k, n)) / math.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    return x, w, b


def _paged_case(*, B, nq, nkv, dk, dv, block, nb, n_blocks, seed=0):
    """Pool + tables with per-slot distinct physical blocks, the null block
    0 on unused columns, unwritten (-1) tails and a recycled block 1 whose
    stale positions lie past every slot's cur (the cases of
    tests/test_paged_decode.py, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    phys = n_blocks * block
    q = rng.standard_normal((B, nq, dk)).astype(np.float32)
    k_pool = rng.standard_normal((phys, nkv, dk)).astype(np.float32)
    v_pool = rng.standard_normal((phys, nkv, dv)).astype(np.float32)
    pos_pool = np.full((phys,), -1, np.int32)
    tables = np.zeros((B, nb), np.int32)
    cur = np.zeros((B,), np.int32)
    nxt = 2
    for b in range(B):
        L = (b * 7 + 5) % (nb * block) + 1
        cur[b] = L - 1
        for j in range((L + block - 1) // block):
            tables[b, j] = nxt
            for e in range(block):
                if j * block + e < L:
                    pos_pool[nxt * block + e] = j * block + e
            nxt += 1
    assert nxt <= n_blocks
    pos_pool[block:2 * block] = int(cur.max()) + 100
    return q, k_pool, v_pool, pos_pool, tables, cur


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 2048, 256), (70, 96, 130)])
def test_k1_kernel_matches_plain_on_card(cuda, dtype, m, k, n):
    x, w, b = _mm_inputs((m, k), n, True)
    xt, wt, bt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w, b))
    for act in k1.ACTS:
        for bias in (None, bt):
            before = k1.launches
            got = k1.matmul(xt, wt, bias, act=act)
            assert k1.launches == before + 1
            want = k1.matmul_plain(xt, wt, bias, act=act)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            # bf16: one rounding of the output may land on either side
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            assert err <= tol, (act, bias is not None, err)


def _bf16_case(cuda, m, k, n, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=gen, device=cuda)
         / math.sqrt(k)).to(torch.bfloat16)
    b = torch.randn(n, generator=gen, device=cuda).to(torch.bfloat16)
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2048, 5632])
@pytest.mark.parametrize("n", [64, 256, 32000])
@pytest.mark.parametrize("m", [8, 70, 4095, 8192])
def test_k1_routes_match_plain_on_card(cuda, m, k, n):
    """Each bf16 route against the plain version, every activation, with
    and without bias: the route the shape takes, and at M <= 128 the other
    bf16 route too (the decode route re-reads the weight for every 8 rows,
    so it is not run at thousands of rows)."""
    x, w, b = _bf16_case(cuda, m, k, n, seed=m + n + k)
    path = k1.route_for(x, w)
    assert path == ("decode" if m <= k1.DECODE_MAX_M else "tc")
    routes = ["tc", "decode"] if m <= 128 else [path]
    for route in routes:
        for act in k1.ACTS:
            for bias in (None, b):
                got = k1.matmul(x, w, bias, act=act, force=route)
                want = k1.matmul_plain(x, w, bias, act=act)
                torch.cuda.synchronize()
                # bf16: one rounding of the output may land on either side
                err = ((got.float() - want.float()).abs()
                       / (1 + want.float().abs())).max().item()
                assert err <= 1e-2, (route, act, bias is not None, err)


@pytest.mark.cuda
@pytest.mark.parametrize("route,m", [("tc", 4095), ("tc", 70),
                                     ("decode", 8), ("decode", 70),
                                     ("simt", 70)])
def test_k1_routes_repeat_bit_for_bit_and_count(cuda, route, m):
    x, w, b = _bf16_case(cuda, m, 2048, 256, seed=7)
    before = dict(k1.launches_by_route)
    total = k1.launches
    first = k1.matmul(x, w, b, act="silu", force=route)
    again = k1.matmul(x, w, b, act="silu", force=route)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert k1.launches == total + 2
    for r in k1.ROUTES:
        assert k1.launches_by_route[r] == before[r] + (2 if r == route
                                                       else 0)


@pytest.mark.cuda
def test_k1_routes_refuse_what_they_cannot_take(cuda):
    x, w, _ = _bf16_case(cuda, 8, 96, 130, seed=3)
    assert k1.route_for(x, w) == "simt"
    before = k1.launches
    for route in ("tc", "decode"):
        with pytest.raises(ValueError):
            k1.matmul(x, w, force=route)          # N = 130
        with pytest.raises(ValueError):
            k1.matmul(x.float(), w[:, :128].float().contiguous(),
                      force=route)                # f32
    with pytest.raises(ValueError):
        k1.matmul(x, w, force="cublas")
    assert k1.launches == before
    # an unaligned contiguous view takes simt, and matches the plain version
    buf = torch.randn(8 * 96 + 1, device=cuda).to(torch.bfloat16)
    xv = buf[1:].view(8, 96)
    wv = torch.randn(96, 64, device=cuda).to(torch.bfloat16)
    assert k1.route_for(xv, wv) == "simt"
    got = k1.matmul(xv, wv)
    assert (got.float() - k1.matmul_plain(xv, wv).float()).abs().max() \
        <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 10])
@pytest.mark.parametrize("residuals", [False, True])
def test_k4_kernel_matches_plain_on_card(cuda, window, residuals):
    case = _paged_case(B=3, nq=8, nkv=2, dk=32, dv=48, block=8, nb=5,
                       n_blocks=16)
    args = [torch.from_numpy(a).to(cuda) for a in case]
    before = k4.launches
    got = k4.paged_flash_decode(*args, block=8, window=window,
                                return_residuals=residuals)
    assert k4.launches == before + 1
    want = k4.paged_flash_decode_plain(*args, block=8, window=window,
                                       return_residuals=residuals)
    torch.cuda.synchronize()
    if not residuals:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    """On a CUDA tensor a wrapper launches its kernel or raises; it never
    falls back to the plain version."""
    x = torch.zeros(4, 8, device=cuda)
    w = torch.zeros(8, 4, device=cuda)
    before = k1.launches
    with pytest.raises(TypeError):
        k1.matmul(x.half(), w.half())
    with pytest.raises(ValueError):
        k1.matmul(x, w.t())                       # not contiguous
    with pytest.raises(ValueError):
        k1.matmul(x, w.cpu())                     # two devices
    assert k1.launches == before
    case = _paged_case(B=3, nq=8, nkv=2, dk=32, dv=48, block=8, nb=5,
                       n_blocks=16)
    args = [torch.from_numpy(a).to(cuda) for a in case]
    args[4] = args[4].long()                      # tables must be int32
    with pytest.raises(TypeError):
        k4.paged_flash_decode(*args, block=8)


# f32 kernels against their f32 plain versions differ by summation order
# only; bf16 outputs may round to either neighbour, and the bf16 P of the
# attention backward is rounded at other points than the plain version's.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / (1 + want.float().abs().max())).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zc", [False, True])
@pytest.mark.parametrize("shape", [(3, 37, 2048), (1000, 64), (5, 300)])
def test_k3_kernel_matches_plain_on_card(cuda, dtype, zc, shape):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal(shape[-1]) * 0.1 + 1)
                         .astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x, g, dy = (t.to(cuda, dtype) for t in (x, g, dy))
    before = (k3.launches, k3.launches_bwd)
    y, rstd = k3.rmsnorm_fwd(x, g, zero_centered=zc)
    dx, dg = k3.rmsnorm_bwd(dy, x, g, rstd, zero_centered=zc)
    assert (k3.launches, k3.launches_bwd) == (before[0] + 1, before[1] + 1)
    y2, rstd2 = k3.rmsnorm_plain(x, g, zero_centered=zc)
    dx2, dg2 = k3.rmsnorm_bwd_plain(dy, x, g, rstd2, zero_centered=zc)
    torch.cuda.synchronize()
    assert _rel(rstd, rstd2) <= 1e-5
    for got, want in ((y, y2), (dx, dx2), (dg, dg2)):
        assert got.dtype == want.dtype
        assert _rel(got, want) <= TOL[dtype]
    # the same inputs give the same bits: no atomics
    assert torch.equal(k3.rmsnorm_bwd(dy, x, g, rstd, zero_centered=zc)[1],
                       dg)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (b, sq, sk, nq, nkv, d, causal, window, q offset)
    (2, 100, 100, 8, 2, 64, True, 0, 0),
    (1, 64, 200, 4, 4, 32, True, 0, 136),
    (2, 70, 70, 4, 1, 16, True, 24, 0),
    (1, 50, 90, 6, 3, 128, False, 0, 0)])
def test_k2_kernel_matches_plain_on_card(cuda, dtype, case):
    b, sq, sk, nq, nkv, d, causal, window, off = case
    rng = np.random.default_rng(8)

    def rand(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)) \
            .to(cuda, dtype)
    q, k, v, dout = rand(b, sq, nq, d), rand(b, sk, nkv, d), \
        rand(b, sk, nkv, d), rand(b, sq, nq, d)
    q_pos = (off + torch.arange(sq, dtype=torch.int32, device=cuda)) \
        .expand(b, sq).contiguous()
    k_pos = torch.arange(sk, dtype=torch.int32, device=cuda)
    kw = dict(causal=causal, window=window)
    before = (k2.launches, k2.launches_bwd)
    out, lse = k2.flash_attention_fwd(q, k, v, q_pos, k_pos, **kw)
    grads = k2.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos,
                                   **kw)
    assert (k2.launches, k2.launches_bwd) == (before[0] + 1, before[1] + 1)
    out2, lse2 = k2.flash_attention_fwd_plain(q, k, v, q_pos, k_pos, **kw)
    grads2 = k2.flash_attention_bwd_plain(q, k, v, out, dout, lse, q_pos,
                                          k_pos, **kw)
    torch.cuda.synchronize()
    assert _rel(lse, lse2) <= 1e-5
    assert _rel(out, out2) <= TOL[dtype]
    for got, want in zip(grads, grads2):
        assert got.dtype == dtype and _rel(got, want) <= TOL[dtype]
    again = k2.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos,
                                   **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, grads))


@pytest.mark.cuda
def test_k2_k3_autograd_launch_the_kernels(cuda):
    q = torch.randn(1, 64, 4, 64, device=cuda, requires_grad=True)
    pos = torch.arange(64, dtype=torch.int32, device=cuda)
    g = torch.ones(64, device=cuda, requires_grad=True)
    before = (k2.launches, k2.launches_bwd, k3.launches, k3.launches_bwd)
    out, _ = k2.flash_attention(q, q, q, pos[None].contiguous(), pos)
    k3.rmsnorm(out, g).sum().backward()
    assert (k2.launches, k2.launches_bwd, k3.launches, k3.launches_bwd) == \
        tuple(n + 1 for n in before)
    assert torch.isfinite(q.grad).all() and torch.isfinite(g.grad).all()


@pytest.mark.cuda
def test_k2_k3_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(4, 64, device=cuda)
    g = torch.ones(64, device=cuda)
    before = (k3.launches, k2.launches)
    with pytest.raises(TypeError):
        k3.rmsnorm(x.half(), g.half())
    with pytest.raises(TypeError):
        k3.rmsnorm(x, g.bfloat16())                  # mixed dtypes
    with pytest.raises(ValueError):
        k3.rmsnorm(x, torch.ones(32, device=cuda))   # gamma shape
    with pytest.raises(ValueError):
        k3.rmsnorm(x, g.cpu())                       # two devices
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    kv = torch.zeros(1, 8, 2, 64, device=cuda)
    pos = torch.arange(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        k2.flash_attention(q.half(), kv.half(), kv.half(), pos[None], pos)
    with pytest.raises(TypeError):                   # positions must be int32
        k2.flash_attention(q, kv, kv, pos[None].long(), pos.long())
    with pytest.raises(ValueError):                  # head dim 48
        k2.flash_attention(q[..., :48].contiguous(), kv[..., :48].contiguous(),
                           kv[..., :48].contiguous(), pos[None], pos)
    with pytest.raises(ValueError):                  # 4 q heads on 3 kv heads
        k2.flash_attention(q, torch.zeros(1, 8, 3, 64, device=cuda),
                           torch.zeros(1, 8, 3, 64, device=cuda), pos[None],
                           pos)
    with pytest.raises(ValueError):
        k2.flash_attention(q, kv, kv.cpu(), pos[None], pos)
    assert (k3.launches, k2.launches) == before


def ssd_inputs(b, T, nh, P, G, N, *, seed=0, la_scale=0.1):
    """numpy (xbar, la, B, C) of the SSD scan: la <= 0 as the model makes
    it (softplus(dt) * -exp(A_log)); ``tests/test_torch_ssm.py`` feeds the
    same cases to the JAX package."""
    rng = np.random.default_rng(seed)
    xbar = (rng.standard_normal((b, T, nh, P)) * 0.5).astype(np.float32)
    la = (-np.abs(rng.standard_normal((b, T, nh))) * la_scale) \
        .astype(np.float32)
    B = (rng.standard_normal((b, T, G, N)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, T, G, N)) * 0.3).astype(np.float32)
    return xbar, la, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (b, T, nh, P, G, N, chunk, la scale)
    (2, 512, 8, 64, 2, 64, 256, 0.1),       # rep 4, two whole chunks
    (1, 300, 4, 64, 1, 16, 256, 0.1),       # ragged: Q = 150, not 64k
    (2, 200, 6, 32, 3, 48, 64, 0.1),        # Q = 50, P and N below 64
    (1, 256, 4, 64, 2, 64, 256, 200.0)])    # la << 0: exp(gap) overflows
def test_k5_kernel_matches_plain_on_card(cuda, dtype, case):
    b, T, nh, P, G, N, chunk, scale = case
    xbar, la, B, C = (torch.from_numpy(a).to(cuda) for a in
                      ssd_inputs(b, T, nh, P, G, N, la_scale=scale))
    B, C = B.to(dtype), C.to(dtype)
    dy = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, T, nh, P)).astype(np.float32)).to(cuda)
    before = (k5.launches, k5.launches_bwd)
    y, states = k5.ssd_scan_fwd(xbar, la, B, C, chunk)
    grads = k5.ssd_scan_bwd(dy, xbar, la, B, C, states, chunk)
    assert (k5.launches, k5.launches_bwd) == (before[0] + 1, before[1] + 1)
    y2, states2 = k5.ssd_scan_plain(xbar, la, B, C, chunk)
    grads2 = k5.ssd_scan_bwd_plain(dy, xbar, la, B, C, states2, chunk)
    torch.cuda.synchronize()
    # f32 sums in another order; dB, dC in bf16 round once.  With la near
    # -160 a step, cum reaches -4e4 within a chunk, where one f32 ulp is
    # 4e-3: a decay exp(cum_i - cum_j) between neighbours is the difference
    # of two such sums, and the kernel's and torch.cumsum's orders may
    # differ by an ulp or two, so those decays differ by up to ~1%
    tol = 1e-4 if scale < 1 else 1e-2
    assert _rel(y, y2) <= tol and _rel(states, states2) <= tol
    for got, want in zip(grads, grads2):
        assert got.dtype == want.dtype and torch.isfinite(got).all()
        assert _rel(got, want) <= (tol if got.dtype == torch.float32
                                   else 1e-2)
    again = k5.ssd_scan_bwd(dy, xbar, la, B, C, states, chunk)
    assert all(torch.equal(a, g) for a, g in zip(again, grads))


@pytest.mark.cuda
def test_k5_autograd_launches_the_kernels(cuda):
    xbar, la, B, C = (torch.from_numpy(a).to(cuda).requires_grad_() for a in
                      ssd_inputs(1, 128, 4, 64, 2, 64))
    before = (k5.launches, k5.launches_bwd)
    k5.ssd_scan(xbar, la, B, C, 64).square().sum().backward()
    assert (k5.launches, k5.launches_bwd) == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad).all() for t in (xbar, la, B, C))


@pytest.mark.cuda
def test_k5_refuses_what_it_does_not_take(cuda):
    xbar, la, B, C = (torch.from_numpy(a).to(cuda) for a in
                      ssd_inputs(1, 64, 4, 64, 2, 64))
    before = k5.launches
    with pytest.raises(TypeError):
        k5.ssd_scan(xbar.bfloat16(), la, B, C)      # xbar must be f32
    with pytest.raises(TypeError):
        k5.ssd_scan(xbar, la, B, C.bfloat16())      # mixed B and C
    with pytest.raises(ValueError):                 # 4 heads on 3 groups
        k5.ssd_scan(xbar, la, torch.zeros(1, 64, 3, 64, device=cuda),
                    torch.zeros(1, 64, 3, 64, device=cuda))
    with pytest.raises(ValueError):                 # N above 64
        k5.ssd_scan(xbar, la, torch.zeros(1, 64, 2, 80, device=cuda),
                    torch.zeros(1, 64, 2, 80, device=cuda))
    with pytest.raises(ValueError):                 # not contiguous
        k5.ssd_scan(xbar.transpose(1, 2).contiguous().transpose(1, 2), la,
                    B, C)
    with pytest.raises(ValueError):                 # two devices
        k5.ssd_scan(xbar, la.cpu(), B, C)
    assert k5.launches == before
