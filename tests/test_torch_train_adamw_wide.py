"""Three AdamW steps of the port's training slice against the JAX package,
on the CPU, at microbatch 1 and 2 within 1e-2: the paper's model at head
dim 48 and gemma-2b at head dim 256.  The variants and the body
(``three_adamw_steps``) are ``test_torch_train.py``'s; the cases live in
files of their own so that the test run spreads them over its workers.
"""
import pytest

from test_torch_train import build_model, one_thread, three_adamw_steps  # noqa: F401


@pytest.fixture(scope="module", params=['gemma_d256', 'paper_d48'])
def model(request):
    """(jax cfg, port cfg, jax layout, jax f32 params, port params)."""
    return build_model(request.param)


@pytest.mark.parametrize("mb", [1, 2])
def test_three_adamw_steps_match_reference(model, mb):
    three_adamw_steps(model, mb)
