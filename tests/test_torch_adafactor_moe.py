"""Three Adafactor steps of reduced mixtral-8x7b (the routed experts, at
capacity factor 0.5) against the JAX package's on the CPU: each step's
metrics and every parameter within 1e-2
(``test_torch_train.three_adamw_steps``).  tinyllama's and the update
itself are in ``test_torch_adafactor.py``, deepseek-v3's in
``test_torch_adafactor_mla.py``.
"""
from test_torch_moe_train import _model
from test_torch_train import three_adamw_steps


def test_three_adafactor_steps_match_reference():
    three_adamw_steps(_model("mixtral-8x7b"), 2, seq=16,
                      metrics=("loss", "xent", "aux", "gnorm"),
                      optimizer="adafactor")
