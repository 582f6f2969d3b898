"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1) [arXiv:2403.08295]."""
from ..config import Family, ModelConfig

CONFIG = ModelConfig(
    arch="gemma-2b", family=Family.DENSE,
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, d_head=256,
    d_ff=16384, vocab=256000,
    act="gelu", norm="rmsnorm", zero_centered_norm=True, emb_scale_sqrt_d=True,
    rope_base=10000.0,
    source="arXiv:2403.08295 (Gemma)",
)
