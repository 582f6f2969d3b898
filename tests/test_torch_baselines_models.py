"""The dense family's training at the paper's 1-D and 2-D baselines on 8
ranks against the JAX package's at the same layouts on 8 host devices, in
f32: ``1d(4)`` = dp 2 x cube (1, 1, 4) and ``2d(q2)`` = dp 2 x cube
(1, 2, 2) (``tests/test_multidev.py:68-69``).

Reduced tinyllama-1.1b, gemma-2b (one kv head, replicated over the head
axis 'z': the island's sliced-kv branch, wk and wv through
``linear1d_rep`` and ``matmul2d_rep``) and paper-transformer at the
paper's head dim 48 (LayerNorm, over the split hidden dim at 2d).  Held,
with ``test_torch_multirank_train.py``'s machinery: the loss and every
gradient leaf's shard on every rank within 1e-4 of the leaf's largest
value against JAX's (at 2d both carry ROADMAP.md Queue 3 fault 6, the
reference's 2-D backward); then three AdamW steps at two microbatches
within 1e-2, for tinyllama-1.1b at both layouts.
"""
import pytest

from test_torch_multirank_train import check_grads, check_steps, run_train

BASELINES = {"1d": dict(n_pod=1, n_dp=2, n_model=4, strategy="1d"),
             "2d": dict(n_pod=1, n_dp=2, n_model=4, strategy="2d")}
ARCHS = {"tinyllama-1.1b": {}, "gemma-2b": {},
         "paper-transformer": {"d_head": 48}}
STEPPED = ("tinyllama-1.1b",)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return run_train(tmp_path_factory.mktemp("baselines"), ARCHS, mb=2,
                     layouts=BASELINES, steps=STEPPED)


@pytest.mark.parametrize("arch,lname",
                         [(a, ln) for a in ARCHS for ln in BASELINES])
def test_loss_and_grad_shards_match_jax(trained, arch, lname):
    check_grads(trained, arch, ARCHS[arch], lname, BASELINES)


@pytest.mark.parametrize("arch,lname",
                         [(a, ln) for a in STEPPED for ln in BASELINES])
def test_three_adamw_steps_match_jax(trained, arch, lname):
    check_steps(trained, arch, ARCHS[arch], lname, BASELINES)
