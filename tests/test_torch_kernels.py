"""The port's kernels against the JAX package.

On the CPU each kernel module's plain version runs and is held against the
reference's Pallas kernel in interpret mode and its jnp oracle: K1 (matmul
+ bias + activation) at 1e-4 in f32, K4 (paged flash-decode, residuals
included) at 1e-5.  ``test_torch_cuda.py`` holds each CUDA kernel against
its plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.kernels.matmul import matmul as pallas_matmul_bias
from repro.kernels.paged_decode import paged_flash_decode as jax_paged_decode
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
    """A wrapper runs its plain version only for CPU tensors; any other
    device, or a mix of devices, raises instead of falling back."""
    x, w = torch.zeros(4, 8), torch.zeros(8, 4)
    with pytest.raises(ValueError):
        k1.matmul(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError):
        k1.matmul(x, w.to("meta"))
    q = torch.zeros(1, 2, 4, device="meta")
    pool = torch.zeros(4, 1, 4, device="meta")
    pos = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        k4.paged_flash_decode(q, pool, pool, pos, pos[None, :1], pos[:1],
                              block=2)


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
