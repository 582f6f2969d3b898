"""The port's CUDA kernels against their plain versions, on the card.

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

from repro_torch.kernels import matmul as k1
from repro_torch.kernels import paged_decode as k4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
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
