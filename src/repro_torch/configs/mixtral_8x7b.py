"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from ..config import Family, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="mixtral-8x7b", family=Family.MOE,
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_head=128,
    d_ff=14336, vocab=32000,
    act="silu", rope_base=1000000.0, window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, expert_ff=14336),
    source="arXiv:2401.04088 (Mixtral)",
)
