"""internvl2-2b [vlm] — InternViT (stub frontend) + InternLM2 backbone
[arXiv:2404.16821].  The ViT + projector is a STUB: input_specs provides
precomputed patch embeddings (B, 1024, d_model)."""
from ..config import Family, ModelConfig

CONFIG = ModelConfig(
    arch="internvl2-2b", family=Family.VLM,
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, d_head=128,
    d_ff=8192, vocab=92553 + 7,   # padded to a shardable multiple (92560)
    act="silu", rope_base=1000000.0,
    n_vision_tokens=1024,
    source="arXiv:2404.16821 (InternVL2); vocab padded 92553->92560 for TP divisibility",
)
