"""zamba2-1.2b [hybrid] — Mamba2 backbone + one shared attention block
applied periodically [arXiv:2411.15242]."""
from ..config import Family, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch="zamba2-1.2b", family=Family.HYBRID,
    n_layers=38, d_model=2048, n_heads=32, n_kv=32, d_head=64,
    d_ff=8192, vocab=32000,
    act="gelu", rope_base=10000.0, window=4096,  # shared-attn window for long ctx
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, n_groups=2, chunk=256,
                  attn_every=6),
    source="arXiv:2411.15242 (Zamba2); shared block every 6 mamba layers",
)
