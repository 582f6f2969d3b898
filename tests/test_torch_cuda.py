"""The port's CUDA kernels against their plain versions, on the card:
K1 matmul (each route, xlstm's GEMMs with w_if's N = 8 among them, the
MoE family's and deepseek-v3's), K2 flash attention (each route, the MoE
family's d 128 training layers and MLA's dk 192 / dv 128 among them) and
K3 RMSNorm (forward and backward, xlstm's and deepseek-v3's widths among
them), K4 paged decode (each
route, mixtral's and Moonlight's serve steps, MLA's latent decode and
whisper's static cross k/v among them), K5 SSD scan (forward and
backward); K2 at whisper's non-causal shapes (448 and 1504 rows over
1504 frames) and at a (2,2,2) rank's rows (q offset by half the keys),
and K3's two phases for a row that a rank of the 3-D cube holds only
part of, too.

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


# xlstm-350m's projections (K, N): w_q/w_k/w_v/w_z, w_if (2 x 4 heads),
# w_gates, the sLSTM's w_out, the mLSTM's w_out, the head
XLSTM_GEMMS = [(1024, 2048), (1024, 8), (1024, 4096), (1024, 1024),
               (2048, 1024), (1024, 50304)]


# the MoE family's K1 GEMMs (K, N): mixtral's attention and head, and
# Moonlight's attention, dense layer (11264), shared experts (2816) and
# head (163840); the experts' own products are torch.matmul
MOE_GEMMS = [(4096, 4096), (4096, 1024), (4096, 32000), (2048, 2048),
             (2048, 11264), (11264, 2048), (2048, 2816), (2816, 2048),
             (2048, 163840)]


# deepseek-v3's K1 GEMMs (K, N): MLA's w_dq, w_uq, w_dkv (N 576, not a
# whole number of tc tiles), w_ukv and w_o, the dense MLP (18432), the
# shared expert (2048), the mtp head's proj and the head (129280)
DEEPSEEK_GEMMS = [(7168, 1536), (1536, 24576), (7168, 576), (512, 32768),
                  (16384, 7168), (7168, 18432), (18432, 7168), (7168, 2048),
                  (2048, 7168), (14336, 7168), (7168, 129280)]


# whisper-medium's and internvl2-2b's K1 GEMMs (M, K, N) at the rows their
# paths give them: whisper's decode step (M 8: the d x d projections, the
# MLP of 4096, the head of 51872), its training step's encoder linears and
# cross k/v over 4 x 1504 frame rows and its decoder linears and head over
# 4 x 448 text rows; internvl2's decode step (M 8: wq/wo, wk/wv of 8 x
# 128, the MLP of 8192, the head of 92560) and its training step (4 x 2048
# rows, the head in chunks of 4096)
MODALITY_GEMMS = [
    (8, 1024, 1024), (8, 1024, 4096), (8, 4096, 1024), (8, 1024, 51872),
    (6016, 1024, 1024), (6016, 1024, 4096), (6016, 4096, 1024),
    (1792, 1024, 1024), (1792, 1024, 4096), (1792, 4096, 1024),
    (1792, 1024, 51872),
    (8, 2048, 2048), (8, 2048, 1024), (8, 2048, 8192), (8, 8192, 2048),
    (8, 2048, 92560), (8192, 2048, 2048), (8192, 2048, 1024),
    (8192, 2048, 8192), (8192, 8192, 2048), (4096, 2048, 92560)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MODALITY_GEMMS)
def test_k1_modality_shapes_match_plain_on_card(cuda, m, k, n):
    """whisper's and internvl2's GEMMs at their decode and training rows,
    as xlstm's: the decode route at M 8, tc at the training rows."""
    _check_k1_shape(cuda, m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", XLSTM_GEMMS)
@pytest.mark.parametrize("m", [8, 8192])
def test_k1_xlstm_shapes_match_plain_on_card(cuda, m, k, n):
    """xlstm's GEMMs at a decode step's M (8) and a training step's (8192):
    the route ``route`` picks and, at M = 8, the other bf16 route, every
    activation, with and without bias; w_if's N = 8 (narrower than one
    64-column tile or TMA box) also on the simt route in f32."""
    _check_k1_shape(cuda, m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", MOE_GEMMS)
@pytest.mark.parametrize("m", [8, 8192])
def test_k1_moe_shapes_match_plain_on_card(cuda, m, k, n):
    """The MoE family's GEMMs at a decode step's M and a training step's,
    as xlstm's."""
    _check_k1_shape(cuda, m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", DEEPSEEK_GEMMS)
@pytest.mark.parametrize("m", [8, 2048, 4096])
def test_k1_deepseek_shapes_match_plain_on_card(cuda, m, k, n):
    """deepseek-v3's GEMMs at its decode step's M (8), its training step's
    (2048) and its prefill's (4096), as xlstm's."""
    _check_k1_shape(cuda, m, k, n)


def _check_k1_shape(cuda, m, k, n):
    x, w, b = _bf16_case(cuda, m, k, n, seed=m + n + k)
    path = k1.route_for(x, w)
    assert path == ("decode" if m <= k1.DECODE_MAX_M else "tc")
    cases = [(route, x, w, b) for route in
             (["tc", "decode"] if m <= 128 else [path])]
    if n < 64:
        cases.append(("simt", x.float(), w.float(), b.float()))
    for route, xx, ww, bb in cases:
        for act in k1.ACTS:
            for bias in (None, bb):
                got = k1.matmul(xx, ww, bias, act=act, force=route)
                want = k1.matmul_plain(xx, ww, bias, act=act)
                torch.cuda.synchronize()
                err = ((got.float() - want.float()).abs()
                       / (1 + want.float().abs())).max().item()
                tol = 1e-2 if xx.dtype == torch.bfloat16 else 1e-4
                assert err <= tol, (route, act, bias is not None, err)


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


def _paged_lens_case(lens, *, nq, nkv, d, block, nb, seed=0):
    """A pool holding one slot per context length (blocks at shuffled
    ids, the null block 0 on unused columns, slot 0's first unused column
    on a recycled block 1 whose stale positions lie past every cur; a
    length of 0 leaves a slot with no valid entry), and the step's own
    k_new, v_new (B, nkv, d)."""
    rng = np.random.default_rng(seed)
    used = sum(-(-n // block) for n in lens)
    n_blocks = used + 2
    ids = list(rng.permutation(used) + 2)
    pos_pool = np.full((n_blocks * block,), -1, np.int32)
    tables = np.zeros((len(lens), nb), np.int32)
    for b, n in enumerate(lens):
        for j in range(-(-n // block)):
            blk = ids.pop()
            tables[b, j] = blk
            e = np.arange(block)
            pos_pool[blk * block:(blk + 1) * block] = np.where(
                j * block + e < n, j * block + e, -1)
    pos_pool[block:2 * block] = max(lens) + 100
    tables[0, -(-lens[0] // block)] = 1
    cur = np.asarray([n - 1 for n in lens], np.int32)
    B, phys = len(lens), n_blocks * block
    q, k_pool, v_pool, k_new, v_new = (
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((B, nq, d), (phys, nkv, d), (phys, nkv, d),
                      (B, nkv, d), (B, nkv, d)))
    return (q, k_pool, v_pool, pos_pool, tables, cur), (k_new, v_new)


# K4 in bf16, ||got - want|| / ||want|| against the plain version: the
# limits of chip_smoke.py phase 3 (m over the rows with a valid entry)
K4_NORM_TOL = {"out": 5e-4, "acc": 1e-5, "m": 5e-7, "l": 1e-6}


def _k4_on_card(cuda, case, new):
    args = [torch.from_numpy(a).to(cuda) for a in case]
    for i in range(3):
        args[i] = args[i].bfloat16()
    return args, [torch.from_numpy(a).to(cuda).bfloat16() for a in new]


def _k4_check(got, want):
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    names = ("acc", "m", "l") if len(want) == 3 else ("out",)
    for name, g, w in zip(names, got, want):
        if name == "m":
            live = w > -1e29
            assert torch.equal(g[~live], w[~live])
            g, w = g[live], w[live]
        err = _norm_err(g, w)
        assert err <= K4_NORM_TOL[name], (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("block,d,nq,nkv,lens,nb", [
    # the serve shape: 3 CTAs an SM, 8 splits of 4 columns
    (16, 64, 32, 4, [275, 276, 277, 278, 279, 275, 276, 277], 32),
    (8, 64, 32, 4, [0, 5, 40, 300, 100, 64, 17, 1], 48),  # block 8, empty
    (16, 128, 16, 2, [700, 33, 1200, 511], 96),           # d 128: 2 an SM
    (32, 64, 8, 8, [900, 31, 1500], 64),                  # block 32, MHA
    (32, 128, 8, 4, [2000, 1], 80),                       # 1 an SM, group 2
    (16, 64, 16, 4, [3000], 200),                         # one slot: 50 splits
    # mixtral's serve step (32/8 heads of 128) and Moonlight's (16/16)
    (16, 128, 32, 8, [275, 276, 277, 278, 279, 275, 276, 277], 32),
    (16, 128, 16, 16, [16, 17, 20, 24], 4),
    # the served self attention of whisper (16/16 of 64) and internvl2
    # (16/8 of 128): 8 slots 43-78 tokens in, a cache of 512
    (16, 64, 16, 16, [43 + 5 * i for i in range(8)], 32),
    (16, 128, 16, 8, [43 + 5 * i for i in range(8)], 32),
])
@pytest.mark.parametrize("kind", ["out", "residuals", "step"])
def test_k4_split_route_matches_plain_on_card(cuda, block, d, nq, nkv, lens,
                                               nb, kind):
    """The split route (both passes) against the plain version in bf16:
    the normalised output, the residuals (acc, m, l), and the step entry
    with the current token folded in by the combine pass, at head dims 64
    and 128, blocks 8-32, groups 1-8 and 8 to 50 splits (each shape's own
    plan); a second run gives the same bits."""
    case, new = _paged_lens_case(lens, nq=nq, nkv=nkv, d=d, block=block,
                                 nb=nb)
    args, new = _k4_on_card(cuda, case, new)
    assert k4.route_for(*args[:4], block) == "split"
    kw = dict(block=block)
    if kind == "step":
        def run():
            return k4.paged_flash_decode_step(args[0], *new, *args[1:],
                                              force="split", **kw)
        want = k4.paged_flash_decode_step_plain(args[0], *new, *args[1:],
                                                block=block)
    else:
        res = kind == "residuals"

        def run():
            return k4.paged_flash_decode(*args, force="split",
                                         return_residuals=res, **kw)
        want = k4.paged_flash_decode_plain(*args, block=block,
                                           return_residuals=res)
    got, again = run(), run()
    torch.cuda.synchronize()
    _k4_check(got, want)
    if isinstance(got, torch.Tensor):
        got, again = (got,), (again,)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.cuda
def test_k4_split_over_static_cross_kv_on_card(cuda):
    """Whisper's cross decode: K4's split route over a static 1,504-frame
    k/v laid out as a pool under the identity table, every frame valid,
    no token folded in (``models/blocks.py:cross_decode``), against the
    plain version and the reference's unmasked f32 softmax; one split
    launch with its combine pass, twice bit for bit."""
    from repro_torch.models.blocks import contiguous_block, cross_decode
    rng = np.random.default_rng(15)
    B, F, nh, d = 8, 1504, 16, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda).bfloat16()
               for s in ((B, 1, nh, d), (B, F, nh, d), (B, F, nh, d)))
    blk = contiguous_block(F)
    assert blk == 16
    args = (q[:, 0], k.reshape(B * F, nh, d), v.reshape(B * F, nh, d),
            torch.arange(F, dtype=torch.int32, device=cuda).repeat(B),
            torch.arange(B * F // blk, dtype=torch.int32,
                         device=cuda).view(B, -1),
            torch.full((B,), F - 1, dtype=torch.int32, device=cuda))
    assert k4.route_for(*args[:4], blk) == "split"
    before = (k4.launches_by_route["split"], k4.launches_combine)
    got, again = cross_decode(None, None, None, q, k, v), \
        cross_decode(None, None, None, q, k, v)
    torch.cuda.synchronize()
    assert (k4.launches_by_route["split"] - before[0],
            k4.launches_combine - before[1]) == (2, 2)
    assert torch.equal(got, again)
    want = k4.paged_flash_decode_plain(*args, block=blk)
    _k4_check(got[:, 0], want)
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float() * d ** -0.5,
                     k.float())
    p = torch.exp(s - s.amax(-1, keepdim=True))
    ref = torch.einsum("bhk,bkhd->bhd", p, v.float()) / p.sum(-1)[..., None]
    assert _norm_err(got[:, 0], ref.bfloat16()) <= K4_NORM_TOL["out"]


@pytest.mark.cuda
def test_k4_routes_count_and_refuse(cuda):
    """Each call adds one to ``launches`` and to its route's count, the
    split route's combine pass one to ``launches_combine``; ``force``
    names a route that must take the inputs, and an unknown name raises."""
    case, new = _paged_lens_case([40, 20, 0], nq=32, nkv=4, d=64, block=16,
                                 nb=4)
    args, new = _k4_on_card(cuda, case, new)
    before = (k4.launches, dict(k4.launches_by_route), k4.launches_combine)
    k4.paged_flash_decode_step(args[0], *new, *args[1:], block=16)
    k4.paged_flash_decode(*args, block=16, force="simt")
    k4.paged_flash_decode_step(args[0], *new, *args[1:], block=16,
                               force="simt")
    assert k4.route_for(args[0], args[1], args[2], args[3], 16) == "split"
    assert k4.launches == before[0] + 3
    assert k4.launches_by_route["split"] == before[1]["split"] + 1
    assert k4.launches_by_route["simt"] == before[1]["simt"] + 2
    assert k4.launches_combine == before[2] + 1
    f32 = [a.float() if a.is_floating_point() else a for a in args]
    with pytest.raises(ValueError):               # f32 takes simt only
        k4.paged_flash_decode(*f32, block=16, force="split")
    wide = _paged_case(B=3, nq=8, nkv=2, dk=32, dv=48, block=8, nb=5,
                       n_blocks=16)
    wide = [torch.from_numpy(a).to(cuda) for a in wide]
    wide[:3] = [t.bfloat16() for t in wide[:3]]
    with pytest.raises(ValueError):               # dv != dk
        k4.paged_flash_decode(*wide, block=8, force="split")
    with pytest.raises(ValueError):
        k4.paged_flash_decode(*args, block=16, force="tc")
    assert k4.launches == before[0] + 3


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
# K2's tc route in bf16: ||got - want|| / ||want||, chip_smoke.py's limits
# (a few times what the route reads, far below a dropped key tile)
K2_NORM_TOL = {"out": 5e-3, "dq": 1e-2, "dk": 1e-2, "dv": 1.5e-3}


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / (1 + want.float().abs().max())).item()


def _norm_err(got, want):
    g, w = got.double(), want.double()
    return ((g - w).norm() / w.norm().clamp_min(1e-300)).item()


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


# K3: ||got - want|| / ||want|| against the plain version, per dtype
# (chip_smoke.py's limits, a few times the readings)
K3_NORM_TOL = {torch.float32: {"y": 3e-7, "dx": 3e-7, "dg": 1.5e-6},
               torch.bfloat16: {"y": 6e-5, "dx": 1e-4, "dg": 3e-4}}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zc", [False, True])
@pytest.mark.parametrize("h,n", [(2048, 2), (2048, 4), (2560, 2),
                                 (2560, 4), (300, 3)])
def test_k3_two_phases_match_plain_and_one_phase_on_card(cuda, dtype, zc, h,
                                                         n):
    """K3's two phases on rows of ``h`` cut in ``n`` pieces, as a rank of
    the 3-D cube holds them (tinyllama's and gemma-2b's 2048, qwen3-4b's
    2560), the pieces' partial sums added on the card as the all-reduce
    adds them: y, dx and dg against the plain phases and against the
    one-phase K3 on the whole rows, within ``K3_NORM_TOL``; each piece
    launches each of the four kernels once."""
    rng = np.random.default_rng(11)
    m = 1000
    x, dy = (torch.from_numpy(rng.standard_normal((m, h)).astype(np.float32))
             .to(cuda, dtype) for _ in range(2))
    g = torch.from_numpy((rng.standard_normal(h) * 0.1 + 1)
                         .astype(np.float32)).to(cuda, dtype)
    xs, gs, dys = ([t.contiguous() for t in a.chunk(n, -1)]
                   for a in (x, g, dy))
    counters = ("launches_moments", "launches_apply", "launches_bwd_dot",
                "launches_bwd_apply")
    before = [getattr(k3, c) for c in counters]
    ss = sum(k3.rmsnorm_moments(p) for p in xs)
    fw = [k3.rmsnorm_apply(p, gp, ss, h, zero_centered=zc)
          for p, gp in zip(xs, gs)]
    dot = sum(k3.rmsnorm_bwd_dot(d, p, gp, zc)
              for d, p, gp in zip(dys, xs, gs))
    bw = [k3.rmsnorm_bwd_apply(d, p, gp, r, dot, h, zc)
          for d, p, gp, (_, r) in zip(dys, xs, gs, fw)]
    assert [getattr(k3, c) - b for c, b in zip(counters, before)] == [n] * 4
    ss2 = sum(k3.rmsnorm_moments_plain(p) for p in xs)
    fw2 = [k3.rmsnorm_apply_plain(p, gp, ss2, h, zero_centered=zc)
           for p, gp in zip(xs, gs)]
    dot2 = sum(k3.rmsnorm_bwd_dot_plain(d, p, gp, zc)
               for d, p, gp in zip(dys, xs, gs))
    bw2 = [k3.rmsnorm_bwd_apply_plain(d, p, gp, r, dot2, h, zc)
           for d, p, gp, (_, r) in zip(dys, xs, gs, fw2)]
    y1, rstd1 = k3.rmsnorm_fwd(x, g, zero_centered=zc)
    dx1, dg1 = k3.rmsnorm_bwd(dy, x, g, rstd1, zero_centered=zc)
    torch.cuda.synchronize()

    def cat(parts, i):
        return torch.cat([p[i] for p in parts], -1)
    got = {"y": cat(fw, 0), "dx": cat(bw, 0), "dg": cat(bw, 1)}
    plain = {"y": cat(fw2, 0), "dx": cat(bw2, 0), "dg": cat(bw2, 1)}
    whole = {"y": y1, "dx": dx1, "dg": dg1}
    assert _rel(fw[0][1], rstd1) <= 1e-5
    for name in got:
        assert got[name].dtype == dtype
        assert _norm_err(got[name], plain[name]) <= K3_NORM_TOL[dtype][name]
        assert _norm_err(got[name], whole[name]) <= K3_NORM_TOL[dtype][name]


@pytest.mark.cuda
def test_k3_two_phases_never_fall_back(cuda):
    """A CUDA tensor through the two-phase path launches the kernel or
    raises: mixed devices and a wrong sum raise."""
    x = torch.randn(4, 64, device=cuda)
    g = torch.ones(64, device=cuda)
    with pytest.raises(ValueError):
        k3.rmsnorm_apply(x, g, torch.zeros(4), 128)
    with pytest.raises(ValueError):
        k3.rmsnorm_apply(x, g, torch.zeros(5, device=cuda), 128)
    with pytest.raises(ValueError):
        k3.rmsnorm_apply(x, g, torch.zeros(4, device=cuda), 32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [128, 2048, 3072, 4096, 1000])
@pytest.mark.parametrize("offset", [0, 1])
def test_k3_widths_match_plain_on_card(cuda, dtype, h, offset):
    """The paths' widths (16-byte accesses from registers), a narrow and
    an odd width (a block per row), and views that start off 16 bytes
    (offset 1: the same kernel with scalar accesses): within the scaled
    limit and ``K3_NORM_TOL``, dg repeating bit for bit, over a row count
    that no block's row count divides."""
    m = 333
    rng = np.random.default_rng(h + offset)
    buf = torch.from_numpy(rng.standard_normal(m * h + offset)
                           .astype(np.float32)).to(cuda, dtype)
    x = buf[offset:].view(m, h)
    g = torch.from_numpy((rng.standard_normal(h) * 0.1 + 1)
                         .astype(np.float32)).to(cuda, dtype)
    dy = torch.from_numpy(rng.standard_normal((m, h)).astype(np.float32)) \
        .to(cuda, dtype)
    for zc in (False, True):
        y, rstd = k3.rmsnorm_fwd(x, g, zero_centered=zc)
        dx, dg = k3.rmsnorm_bwd(dy, x, g, rstd, zero_centered=zc)
        y2, rstd2 = k3.rmsnorm_plain(x, g, zero_centered=zc)
        dx2, dg2 = k3.rmsnorm_bwd_plain(dy, x, g, rstd2, zero_centered=zc)
        torch.cuda.synchronize()
        assert _rel(rstd, rstd2) <= 1e-5
        for name, got, want in (("y", y, y2), ("dx", dx, dx2),
                                ("dg", dg, dg2)):
            assert _rel(got, want) <= TOL[dtype], name
            assert _norm_err(got, want) <= K3_NORM_TOL[dtype][name], name
        assert torch.equal(k3.rmsnorm_bwd(dy, x, g, rstd,
                                          zero_centered=zc)[1], dg)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [1024, 2048])
@pytest.mark.parametrize("m", [8, 8192])
def test_k3_xlstm_widths_match_plain_on_card(cuda, h, m):
    """xlstm's norms in bf16: ``ln`` and ``ln_f`` at 1024 (a block per
    row), the mLSTM's ``out_ln`` at 2048 (a row in registers), at a
    decode step's 8 rows and a training step's 8192, forward and
    backward, within the scaled limit and ``K3_NORM_TOL``."""
    _check_k3_bf16(cuda, m, h)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [512, 1536, 7168])
@pytest.mark.parametrize("m", [8, 2048])
def test_k3_deepseek_widths_match_plain_on_card(cuda, h, m):
    """deepseek-v3's norms in bf16: ``kv_ln`` (512), ``q_ln`` (1536) and
    every norm over d_model (7168), at a decode step's 8 rows and a
    training step's 2048, as xlstm's."""
    _check_k3_bf16(cuda, m, h)


def _check_k3_bf16(cuda, m, h):
    gen = torch.Generator(device=cuda).manual_seed(h + m)
    x, dy = (torch.randn(m, h, generator=gen, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    g = (torch.randn(h, generator=gen, device=cuda) * 0.1 + 1) \
        .to(torch.bfloat16)
    before = (k3.launches, k3.launches_bwd)
    y, rstd = k3.rmsnorm_fwd(x, g)
    dx, dg = k3.rmsnorm_bwd(dy, x, g, rstd)
    assert (k3.launches, k3.launches_bwd) == (before[0] + 1, before[1] + 1)
    y2, rstd2 = k3.rmsnorm_plain(x, g)
    dx2, dg2 = k3.rmsnorm_bwd_plain(dy, x, g, rstd2)
    torch.cuda.synchronize()
    assert _rel(rstd, rstd2) <= 1e-5
    for name, got, want in (("y", y, y2), ("dx", dx, dx2), ("dg", dg, dg2)):
        assert _rel(got, want) <= TOL[torch.bfloat16], name
        assert _norm_err(got, want) <= K3_NORM_TOL[torch.bfloat16][name], \
            name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (b, sq, sk, nq, nkv, d, causal, window, q offset)
    (2, 100, 100, 8, 2, 64, True, 0, 0),
    (1, 64, 200, 4, 4, 32, True, 0, 136),
    (2, 70, 70, 4, 1, 16, True, 24, 0),
    (1, 50, 90, 6, 3, 128, False, 0, 0),
    # whisper's cross attention, non-causal over a ragged last key tile
    # (1504 = 23.5 x 64): f32 on simt, bf16 on tc
    (1, 448, 1504, 16, 16, 64, False, 0, 0)])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (b, sq, sk, nq, nkv, d, causal, window, q offset): the paper's head
    # dim 48 and gemma's 256 (MQA), ragged tiles, GQA, a window, an offset
    (2, 100, 100, 8, 8, 48, True, 0, 0),
    (1, 70, 130, 6, 2, 48, True, 0, 60),
    (2, 90, 90, 4, 1, 48, True, 24, 0),
    (1, 130, 130, 4, 1, 256, True, 0, 0),
    (2, 50, 90, 8, 1, 256, False, 0, 0),
    (1, 100, 100, 8, 2, 256, True, 40, 0)])
def test_k2_simt_takes_head_dims_48_and_256_on_card(cuda, dtype, case):
    """The simt route at the head dims the tc route does not take, forward
    and backward against the plain version (bf16 also to ``K2_NORM_TOL``),
    the backward repeating bit for bit."""
    b, sq, sk, nq, nkv, d, causal, window, off = case
    q, k, v, dout, q_pos, k_pos = (
        t.to(dtype) if t.is_floating_point() else t
        for t in _k2_case(cuda, b, sq, sk, nq, nkv, d, off, seed=d))
    kw = dict(causal=causal, window=window)
    assert k2.route_for(q, k, v, dout) == "simt"
    before = (dict(k2.launches_by_route), dict(k2.launches_bwd_by_route))
    out, lse = k2.flash_attention_fwd(q, k, v, q_pos, k_pos, **kw)
    grads = k2.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos,
                                   **kw)
    assert k2.launches_by_route == dict(before[0],
                                        simt=before[0]["simt"] + 1)
    assert k2.launches_bwd_by_route == dict(before[1],
                                            simt=before[1]["simt"] + 1)
    out2, lse2 = k2.flash_attention_fwd_plain(q, k, v, q_pos, k_pos, **kw)
    grads2 = k2.flash_attention_bwd_plain(q, k, v, out, dout, lse, q_pos,
                                          k_pos, **kw)
    torch.cuda.synchronize()
    assert _rel(lse, lse2) <= 1e-5
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                               (out2, *grads2)):
        assert got.dtype == dtype and _rel(got, want) <= TOL[dtype], name
        if dtype == torch.bfloat16:
            assert _norm_err(got, want) <= K2_NORM_TOL[name], name
    again = k2.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos,
                                   **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, grads))


def _k2_case(cuda, b, sq, sk, nq, nkv, d, off, seed=9):
    rng = np.random.default_rng(seed)

    def rand(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)) \
            .to(cuda, torch.bfloat16)
    q, k, v, dout = rand(b, sq, nq, d), rand(b, sk, nkv, d), \
        rand(b, sk, nkv, d), rand(b, sq, nq, d)
    q_pos = (off + torch.arange(sq, dtype=torch.int32, device=cuda)) \
        .expand(b, sq).contiguous()
    k_pos = torch.arange(sk, dtype=torch.int32, device=cuda)
    return q, k, v, dout, q_pos, k_pos


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (b, sq, sk, nq, nkv, d, causal, window, q offset): ragged and whole
    # tiles, GQA groups 1, 2, 4 and 8, windows, a q offset, non-causal
    (2, 100, 100, 8, 2, 64, True, 0, 0),
    (1, 64, 200, 4, 4, 64, True, 0, 136),
    (2, 70, 70, 8, 1, 64, True, 24, 0),
    (1, 300, 300, 4, 4, 64, False, 0, 0),
    (2, 256, 256, 16, 2, 64, True, 0, 0),
    (1, 50, 90, 6, 3, 128, False, 0, 0),
    (2, 100, 100, 8, 2, 128, True, 0, 0),
    (1, 200, 200, 8, 1, 128, True, 50, 0),
    # the MoE family's training layers: mixtral (32/8, window 4096) and
    # Moonlight (16/16), 4 x 2048 at d 128
    (4, 2048, 2048, 32, 8, 128, True, 4096, 0),
    (4, 2048, 2048, 16, 16, 128, True, 0, 0),
    # internvl2's training layer (16/8, 4 x 2048 at d 128)
    (4, 2048, 2048, 16, 8, 128, True, 0, 0),
    # whisper (16/16 heads of 64, non-causal): the cross attention, 448
    # text rows over 1504 frames, and the encoder over 1504 frames; the
    # last key tile is half full and the dk/dv pass runs over Sk > Sq
    (4, 448, 1504, 16, 16, 64, False, 0, 0),
    (2, 1504, 1504, 16, 16, 64, False, 0, 0),
    # a (2,2,2) rank of tinyllama's 4 x 2048 step: 1024 q rows of 16
    # heads at offsets 0 and 1024 over the 2048 gathered keys of its 2 kv
    # heads, causal
    (2, 1024, 2048, 16, 2, 64, True, 0, 0),
    (2, 1024, 2048, 16, 2, 64, True, 0, 1024)])
def test_k2_tc_route_matches_plain_on_card(cuda, case):
    """The tc route (wgmma + TMA) against the plain version in bf16, with
    the limits of the simt route's bf16 test and ``K2_NORM_TOL``, and its
    backward repeating bit for bit."""
    b, sq, sk, nq, nkv, d, causal, window, off = case
    q, k, v, dout, q_pos, k_pos = _k2_case(cuda, b, sq, sk, nq, nkv, d, off)
    kw = dict(causal=causal, window=window)
    assert k2.route_for(q, k, v, dout) == "tc"
    before = (dict(k2.launches_by_route), dict(k2.launches_bwd_by_route))
    out, lse = k2.flash_attention_fwd(q, k, v, q_pos, k_pos, **kw)
    grads = k2.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos,
                                   **kw)
    assert k2.launches_by_route == dict(before[0],
                                        tc=before[0]["tc"] + 1)
    assert k2.launches_bwd_by_route == dict(before[1],
                                            tc=before[1]["tc"] + 1)
    out2, lse2 = k2.flash_attention_fwd_plain(q, k, v, q_pos, k_pos, **kw)
    grads2 = k2.flash_attention_bwd_plain(q, k, v, out, dout, lse, q_pos,
                                          k_pos, **kw)
    torch.cuda.synchronize()
    assert _rel(lse, lse2) <= 1e-5
    assert _rel(out, out2) <= TOL[torch.bfloat16]
    for got, want in zip(grads, grads2):
        assert got.dtype == torch.bfloat16
        assert _rel(got, want) <= TOL[torch.bfloat16]
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                               (out2, *grads2)):
        assert _norm_err(got, want) <= K2_NORM_TOL[name], name
    again = k2.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos,
                                   **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["tc", "simt"])
def test_k2_routes_repeat_bit_for_bit_and_count(cuda, route):
    q, k, v, dout, q_pos, k_pos = _k2_case(cuda, 2, 130, 130, 8, 2, 64, 0)
    before = (k2.launches, k2.launches_bwd, dict(k2.launches_by_route),
              dict(k2.launches_bwd_by_route))
    runs = []
    for _ in range(2):
        out, lse = k2.flash_attention_fwd(q, k, v, q_pos, k_pos, force=route)
        runs.append((out, lse, *k2.flash_attention_bwd(
            q, k, v, out, dout, lse, q_pos, k_pos, force=route)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert (k2.launches, k2.launches_bwd) == (before[0] + 2, before[1] + 2)
    for r in k2.ROUTES:
        assert k2.launches_by_route[r] == before[2][r] + 2 * (r == route)
        assert k2.launches_bwd_by_route[r] == before[3][r] + 2 * (r == route)


@pytest.mark.cuda
def test_k2_tc_route_refuses_what_it_cannot_take(cuda):
    q, k, v, dout, q_pos, k_pos = _k2_case(cuda, 1, 64, 64, 4, 2, 64, 0)
    before = (k2.launches, k2.launches_bwd)
    with pytest.raises(ValueError):                  # f32
        k2.flash_attention_fwd(q.float(), k.float(), v.float(), q_pos, k_pos,
                               force="tc")
    with pytest.raises(ValueError):                  # d 32
        k2.flash_attention_fwd(*(t[..., :32].contiguous() for t in (q, k, v)),
                               q_pos, k_pos, force="tc")
    buf = torch.zeros(q.numel() + 1, device=cuda, dtype=torch.bfloat16)
    q_off = buf[1:].view(q.shape)                    # off 16 bytes
    q_off.copy_(q)
    assert q_off.is_contiguous() and k2.route_for(q_off, k, v) == "simt"
    with pytest.raises(ValueError):
        k2.flash_attention_fwd(q_off, k, v, q_pos, k_pos, force="tc")
    out, lse = k2.flash_attention_fwd(q, k, v, q_pos, k_pos)
    with pytest.raises(ValueError):
        k2.flash_attention_bwd(q, k, v, out, q_off, lse, q_pos, k_pos,
                               force="tc")
    with pytest.raises(ValueError):
        k2.flash_attention_fwd(q, k, v, q_pos, k_pos, force="cudnn")
    assert (k2.launches, k2.launches_bwd) == (before[0] + 1, before[1])
    # the unaligned view takes simt and matches the plain version
    got, _ = k2.flash_attention_fwd(q_off, k, v, q_pos, k_pos)
    want, _ = k2.flash_attention_fwd_plain(q_off, k, v, q_pos, k_pos)
    assert _rel(got, want) <= TOL[torch.bfloat16]


@pytest.mark.cuda
def test_k2_autograd_takes_the_tc_route(cuda):
    q, k, v, _, q_pos, k_pos = _k2_case(cuda, 1, 96, 96, 8, 2, 64, 0)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (dict(k2.launches_by_route), dict(k2.launches_bwd_by_route))
    out, _ = k2.flash_attention(q, k, v, q_pos, k_pos)
    out.float().square().sum().backward()
    assert k2.launches_by_route == dict(before[0], tc=before[0]["tc"] + 1)
    assert k2.launches_bwd_by_route == dict(before[1],
                                            tc=before[1]["tc"] + 1)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


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
    with pytest.raises(ValueError):                  # head dim 40
        k2.flash_attention(q[..., :40].contiguous(), kv[..., :40].contiguous(),
                           kv[..., :40].contiguous(), pos[None], pos)
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


# K5: ||got - want|| / ||want|| against the plain version (chip_smoke.py's
# limits, a few times the readings; bf16 B/C rounds dB and dC once, and
# with la near -200 a step the decays differ by up to ~1%)
_K5_F32 = dict.fromkeys(("y", "states", "dxbar", "dla", "dB", "dC"), 5e-6)
K5_NORM_TOL = {
    str(torch.float32): _K5_F32,
    str(torch.bfloat16): dict(_K5_F32, dB=2.5e-4, dC=2.5e-4),
    "la << 0" + str(torch.float32): dict(y=1e-4, states=3e-4, dxbar=1e-4,
                                         dla=3e-3, dB=1e-4, dC=1e-4),
    "la << 0" + str(torch.bfloat16): dict(y=1e-4, states=3e-4, dxbar=1e-4,
                                          dla=3e-3, dB=3e-4, dC=3e-4)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (b, T, nh, P, G, N, chunk, la scale)
    (2, 512, 8, 64, 2, 64, 256, 0.1),       # rep 4, two whole chunks
    (1, 300, 4, 64, 1, 16, 256, 0.1),       # ragged: Q = 150, not 64k
    (2, 200, 6, 32, 3, 48, 64, 0.1),        # Q = 50, P and N below 64
    (1, 256, 4, 64, 2, 64, 256, 200.0),     # la << 0: exp(gap) overflows
    (1, 2000, 8, 64, 2, 64, 256, 0.1)])     # Q = 250: a 58-step sub-chunk
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
    ntol = K5_NORM_TOL[("la << 0" if scale >= 1 else "") + str(dtype)]
    for name, got, want in zip(("y", "states", "dxbar", "dla", "dB", "dC"),
                               (y, states, *grads), (y2, states2, *grads2)):
        assert _norm_err(got, want) <= ntol[name], name
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


# ---------------------------------------------------------------------------
# MLA's shapes: K2 at dk 192 / dv 128, K4 on the latent decode
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (b, sq, sk, nh, causal, window, q offset): ragged tiles, a window, an
    # offset, non-causal; every head its own k and v, as MLA's
    (1, 100, 100, 4, True, 0, 0),
    (2, 70, 130, 3, True, 0, 60),
    (1, 90, 90, 2, True, 24, 0),
    (2, 50, 90, 2, False, 0, 0)])
def test_k2_simt_takes_mla_head_dims_on_card(cuda, dtype, case):
    """q and k at 192, v at 128 through the simt route, forward and
    backward against the plain version (bf16 also to ``K2_NORM_TOL``);
    the tc route refuses the pair."""
    b, sq, sk, nh, causal, window, off = case
    rng = np.random.default_rng(sq)

    def rand(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)) \
            .to(cuda, dtype)
    q, k, v, dout = (rand(b, sq, nh, 192), rand(b, sk, nh, 192),
                     rand(b, sk, nh, 128), rand(b, sq, nh, 128))
    q_pos = (off + torch.arange(sq, dtype=torch.int32, device=cuda)) \
        .expand(b, sq).contiguous()
    k_pos = torch.arange(sk, dtype=torch.int32, device=cuda)
    kw = dict(causal=causal, window=window)
    assert k2.route_for(q, k, v, dout) == "simt"
    with pytest.raises(ValueError, match="tc route"):
        k2.flash_attention_fwd(q, k, v, q_pos, k_pos, force="tc", **kw)
    before = (dict(k2.launches_by_route), dict(k2.launches_bwd_by_route))
    out, lse = k2.flash_attention_fwd(q, k, v, q_pos, k_pos, **kw)
    grads = k2.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos,
                                   **kw)
    assert k2.launches_by_route == dict(before[0],
                                        simt=before[0]["simt"] + 1)
    assert k2.launches_bwd_by_route == dict(before[1],
                                            simt=before[1]["simt"] + 1)
    out2, lse2 = k2.flash_attention_fwd_plain(q, k, v, q_pos, k_pos, **kw)
    grads2 = k2.flash_attention_bwd_plain(q, k, v, out, dout, lse, q_pos,
                                          k_pos, **kw)
    torch.cuda.synchronize()
    assert out.shape == (b, sq, nh, 128)
    assert _rel(lse, lse2) <= 1e-5
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                               (out2, *grads2)):
        assert got.shape == want.shape and got.dtype == dtype, name
        assert _rel(got, want) <= TOL[dtype], name
        if dtype == torch.bfloat16:
            assert _norm_err(got, want) <= K2_NORM_TOL[name], name


# chip_smoke.py's K4 limits for the f32 arithmetic of the simt route
K4_NORM_TOL_F32 = {"out": 1.5e-6, "acc": 3e-6, "m": 5e-7, "l": 6e-7}


@pytest.mark.cuda
@pytest.mark.parametrize("group", [128, 20])
def test_k4_latent_decode_on_card(cuda, group):
    """MLA's latent decode: q f32 (dk 576) over bf16 pools (one kv head,
    k 576 and v 512 wide), a group of all the heads (128, and 20 for a
    ragged row tile), through the simt route against the plain version,
    the residuals too, then the fold of the current token; q is not cast
    to bf16 (the kernel reads it as f32)."""
    lens = [275, 276, 277, 278, 279, 1, 17, 0]
    case, new = _paged_lens_case(lens, nq=group, nkv=1, d=576, block=16,
                                 nb=19, seed=group)
    args = [torch.from_numpy(a).to(cuda) for a in case]
    args[2] = args[1][:, :, :512].contiguous()
    for i in (1, 2):
        args[i] = args[i].bfloat16()
    k_new = torch.from_numpy(new[0]).to(cuda)
    v_new = k_new[:, :, :512].contiguous()
    assert args[0].dtype == torch.float32
    assert k4.route_for(args[0], args[1], args[2], args[3], 16) == "simt"
    before = dict(k4.launches_by_route)
    acc, m, l = k4.paged_flash_decode(*args, block=16,
                                      return_residuals=True)
    out = k4.paged_flash_decode(*args, block=16)
    assert k4.launches_by_route == dict(before, simt=before["simt"] + 2)
    want = k4.paged_flash_decode_plain(*args, block=16,
                                       return_residuals=True)
    want_out = k4.paged_flash_decode_plain(*args, block=16)
    torch.cuda.synchronize()
    assert acc.dtype == out.dtype == torch.float32
    for name, g, w in zip(("acc", "m", "l", "out"), (acc, m, l, out),
                          (*want, want_out)):
        if name == "m":
            live = w > -1e29
            assert torch.equal(g[~live], w[~live])
            g, w = g[live], w[live]
        assert _norm_err(g, w) <= K4_NORM_TOL_F32[name], name
    folded = k4.fold_current_token(args[0], k_new, v_new, acc, m, l)
    folded_want = k4.fold_current_token(args[0], k_new, v_new, *want)
    assert _norm_err(folded, folded_want) <= K4_NORM_TOL_F32["out"]
    with pytest.raises(TypeError):          # bf16 q over f32 pools
        k4.paged_flash_decode(args[0].bfloat16(), args[1].float(),
                              args[2].float(), *args[3:], block=16)
