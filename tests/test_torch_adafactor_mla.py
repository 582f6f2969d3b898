"""Three Adafactor steps of reduced deepseek-v3 (MLA, the mtp head, the
routed experts) against the JAX package's on the CPU: each step's metrics
and every parameter within 1e-2 (``test_torch_train.three_adamw_steps``).
"""
from test_torch_deepseek import _model
from test_torch_train import three_adamw_steps


def test_three_adafactor_steps_match_reference():
    three_adamw_steps(_model(), 2, seq=16,
                      metrics=("loss", "xent", "aux", "mtp", "gnorm"),
                      optimizer="adafactor")
