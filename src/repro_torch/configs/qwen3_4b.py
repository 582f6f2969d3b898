"""qwen3-4b [dense] — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B]."""
from ..config import Family, ModelConfig

CONFIG = ModelConfig(
    arch="qwen3-4b", family=Family.DENSE,
    n_layers=36, d_model=2560, n_heads=32, n_kv=8, d_head=128,
    d_ff=9728, vocab=151936,
    act="silu", qk_norm=True, rope_base=1000000.0,
    source="hf:Qwen/Qwen3-8B (Qwen3 family card)",
)
