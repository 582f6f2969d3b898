"""More of the MoE family on 8 ranks against the JAX package, as
``test_torch_multirank_moe.py`` holds mixtral at the cube and dp 2, in
f32, the loss and every gradient leaf's shard within 1e-4:

  * reduced mixtral-8x7b at 1d(4) = dp 2 x (1, 1, 4) (ep ('dp',), the
    router whole, the FFN dim over 'z', the block's output replicated
    over 'z') and 2d(q2) = dp 2 x (1, 2, 2) (ep ('dp', 'y'); its dense
    islands copy the reference's 2-D backward, ROADMAP.md Queue 3 fault
    6);
  * reduced moonshot-v1-16b-a3b (a dense first layer, one shared expert)
    at the cube (2, 2, 2);
  * mixtral with 3 experts at dp 2 x (2, 2, 1): no axis divides 3, so ep
    is () and the FFN dim is stored over 'dp' (``sdp``), gathered for the
    FFN, its gradient reduce-scattered back.
"""
import pytest

from test_torch_multirank_moe import LAYOUTS
from test_torch_multirank_train import check_grads, run_train

MIX, MOON, MIX3 = "mixtral-8x7b", "moonshot-v1-16b-a3b", "mixtral-8x7b@e3"
ARCHS = {MIX: {}, MOON: {}, MIX3: {"moe": {"n_experts": 3}}}
RUNS = {MIX: {"1d": 0, "2d": 0}, MOON: {"cube": 0}, MIX3: {"dp2": 0}}
CASES = [(a, ln) for a, r in RUNS.items() for ln in r]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return run_train(tmp_path_factory.mktemp("moe_more"), ARCHS, mb=1,
                     layouts=LAYOUTS, runs=RUNS)


@pytest.mark.parametrize("arch,lname", CASES)
def test_loss_and_grad_shards_match_jax(trained, arch, lname):
    check_grads(trained, arch, ARCHS[arch], lname, LAYOUTS)
