"""tinyllama-1.1b [dense] — llama2 architecture, small [arXiv:2401.02385]."""
from ..config import Family, ModelConfig

CONFIG = ModelConfig(
    arch="tinyllama-1.1b", family=Family.DENSE,
    n_layers=22, d_model=2048, n_heads=32, n_kv=4, d_head=64,
    d_ff=5632, vocab=32000,
    act="silu", rope_base=10000.0,
    source="arXiv:2401.02385 (TinyLlama)",
)
