"""The paper's own evaluation model: consecutive Transformer layers,
seq 512, hidden per Table 1/2 (the benchmark harness sweeps hidden/batch)."""
from ..config import Family, ModelConfig

CONFIG = ModelConfig(
    arch="paper-transformer", family=Family.DENSE,
    n_layers=4, d_model=3072, n_heads=64, n_kv=64, d_head=48,
    d_ff=12288, vocab=32000,
    act="gelu_mlp", norm="layernorm", rope_base=10000.0,
    source="this paper, Tables 1-2 (hidden 2048..8192, seq 512)",
)
