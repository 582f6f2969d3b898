"""More of the dense family on 8 ranks against the JAX package, as
``test_torch_multirank_train.py`` holds tinyllama-1.1b and gemma-2b:
reduced paper-transformer at the paper's head dim 48 (LayerNorm, its
moments summed over the split hidden dim in PyTorch) and reduced
qwen3-4b (qk-norm on the unsplit head dim) at both layouts, in f32: the
loss and every gradient leaf's shard within 1e-4, three AdamW steps
within 1e-2.  (The train launcher's 8-rank runs are in
``test_torch_multirank_islands.py``, which has the time for them.)
"""
import pytest

from test_torch_multirank_islands import LAYOUTS
from test_torch_multirank_train import check_grads, check_steps, run_train

ARCHS = {"paper-transformer": {"d_head": 48}, "qwen3-4b": {}}
CASES = [(a, ln) for a in ARCHS for ln in LAYOUTS]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return run_train(tmp_path_factory.mktemp("more"), ARCHS, mb=1)


@pytest.mark.parametrize("arch,lname", CASES)
def test_loss_and_grad_shards_match_jax(trained, arch, lname):
    check_grads(trained, arch, ARCHS[arch], lname)


@pytest.mark.parametrize("arch,lname", CASES)
def test_three_adamw_steps_match_jax(trained, arch, lname):
    check_steps(trained, arch, ARCHS[arch], lname)
