"""whisper-medium [audio] — enc-dec, conv frontend STUB [arXiv:2212.04356].
input_specs provides precomputed frame embeddings (B, 1500, d_model);
decoder positions use RoPE instead of learned embeddings (DESIGN.md §6)."""
from ..config import EncoderConfig, Family, ModelConfig

CONFIG = ModelConfig(
    arch="whisper-medium", family=Family.AUDIO,
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, d_head=64,
    d_ff=4096, vocab=51865 + 7,   # padded to 51872 for TP divisibility
    act="gelu_mlp", norm="layernorm", rope_base=10000.0,
    encoder=EncoderConfig(n_layers=24, n_frames=1504, d_model=1024),  # 1500 padded to /16 for pod*cube seq splits
    source="arXiv:2212.04356 (Whisper); vocab padded 51865->51872, frames 1500->1504",
)
