"""moonshot-v1-16b-a3b [dense->moe] — Moonlight-16B-A3B: 64 experts top-6,
2 shared experts, first layer dense [hf:moonshotai/Moonlight-16B-A3B]."""
from ..config import Family, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="moonshot-v1-16b-a3b", family=Family.MOE,
    n_layers=48, d_model=2048, n_heads=16, n_kv=16, d_head=128,
    d_ff=1408, vocab=163840,
    act="silu", rope_base=50000.0,
    moe=MoEConfig(n_experts=64, top_k=6, expert_ff=1408, n_shared=2,
                  first_k_dense=1, dense_ff=11264),
    source="hf:moonshotai/Moonlight-16B-A3B",
)
