"""xlstm-350m [ssm] — mLSTM + sLSTM blocks (7:1) [arXiv:2405.04517].
d_ff=0: xLSTM blocks carry their own up/down projections (factor 2)."""
from ..config import Family, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch="xlstm-350m", family=Family.SSM,
    n_layers=24, d_model=1024, n_heads=4, n_kv=4, d_head=256,
    d_ff=0, vocab=50304,
    act="gelu", rope_base=0.0,
    ssm=SSMConfig(slstm_every=8),
    source="arXiv:2405.04517 (xLSTM), xLSTM[7:1] interleave",
)
