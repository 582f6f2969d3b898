"""Three AdamW steps of the port's training slice against the JAX package,
on the CPU, at microbatch 1 and 2 within 1e-2: reduced tinyllama-1.1b, with
multi-head attention and with grouped-query attention under remat.  The
variants and the body (``three_adamw_steps``) are ``test_torch_train.py``'s;
the cases live in files of their own so that the test run spreads them
over its workers.
"""
import pytest

from test_torch_train import build_model, one_thread, three_adamw_steps  # noqa: F401


@pytest.fixture(scope="module", params=['gqa_remat', 'mha'])
def model(request):
    """(jax cfg, port cfg, jax layout, jax f32 params, port params)."""
    return build_model(request.param)


@pytest.mark.parametrize("mb", [1, 2])
def test_three_adamw_steps_match_reference(model, mb):
    three_adamw_steps(model, mb)
