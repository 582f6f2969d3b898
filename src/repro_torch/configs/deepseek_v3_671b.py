"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437]."""
from ..config import Family, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="deepseek-v3-671b", family=Family.MOE,
    n_layers=61, d_model=7168, n_heads=128, n_kv=128, d_head=128,
    d_ff=2048, vocab=129280,
    act="silu", rope_base=10000.0, mtp=True,
    moe=MoEConfig(n_experts=256, top_k=8, expert_ff=2048, n_shared=1,
                  first_k_dense=3, dense_ff=18432,
                  capacity_factor=1.25),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    source="arXiv:2412.19437 (DeepSeek-V3)",
)
