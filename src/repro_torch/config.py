"""Model, shape and optimizer configuration, copied from
``repro/config.py``.

``ModelConfig`` covers all six architecture families (dense, moe, ssm,
hybrid, vlm, audio); each ``repro_torch/configs/<arch>.py`` instantiates
one.  The port keeps its own copy so that it imports nothing of the JAX
package; ``tests/test_torch_serve.py`` holds every config equal to the
reference's, ``tests/test_torch_train.py`` the parameter counts,
``ShapeConfig`` and ``OptimConfig``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    VLM = "vlm"
    AUDIO = "audio"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    expert_ff: int = 0              # per-expert FFN width
    n_shared: int = 0               # shared (always-on) experts
    first_k_dense: int = 0          # leading dense layers (DeepSeek style)
    dense_ff: int = 0               # FFN width of those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    n_groups: int = 1
    chunk: int = 256
    # hybrid (zamba2): one shared attention block applied every `attn_every`
    attn_every: int = 0
    # xlstm: 1 sLSTM block per `slstm_every` mLSTM blocks (0 = pure mLSTM)
    slstm_every: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (audio) or ViT stub (vlm)."""
    n_layers: int = 24
    n_frames: int = 1500            # audio frames / vision patches after frontend
    d_model: int = 1024             # encoder width (= decoder width here)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    act: str = "silu"               # silu (SwiGLU) | gelu (GeGLU) | gelu_mlp (plain)
    qk_norm: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    rope_base: float = 10000.0
    tie_embeddings: bool = False
    window: int = 0                 # sliding-window attention size (0 = full)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    encoder: Optional[EncoderConfig] = None
    n_vision_tokens: int = 0        # vlm: patch tokens prepended to the text
    mtp: bool = False               # DeepSeek multi-token-prediction head
    zero_centered_norm: bool = False  # gemma-style (1 + gamma)
    emb_scale_sqrt_d: bool = False    # gemma scales embeddings by sqrt(d)
    remat: bool = True
    dtype: str = "bfloat16"
    source: str = ""                # citation

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def n_params(self) -> int:
        """Total parameter count (dense accounting; embeddings included)."""
        d, nh, nkv, dh = self.d_model, self.n_heads, self.n_kv, self.head_dim
        attn = d * nh * dh + 2 * d * nkv * dh + nh * dh * d
        if self.mla is not None:
            m = self.mla
            attn = (d * m.q_lora_rank + m.q_lora_rank * nh * (m.qk_nope_dim + m.qk_rope_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * nh * (m.qk_nope_dim + m.v_head_dim)
                    + nh * m.v_head_dim * d)
        n_mats = 3 if self.act in ("silu", "gelu") else 2
        per_layer = attn + n_mats * d * self.d_ff
        total = 0
        for i in range(self.n_layers):
            if self.moe and i >= self.moe.first_k_dense:
                ff = (self.moe.n_experts + self.moe.n_shared) * n_mats * d * self.moe.expert_ff
                ff += d * self.moe.n_experts  # router
                total += attn + ff
            elif self.moe and self.moe.first_k_dense:
                total += attn + n_mats * d * self.moe.dense_ff
            else:
                total += per_layer
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed-in experts)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        n_mats = 3 if self.act in ("silu", "gelu") else 2
        total = self.n_params()
        inactive = (self.moe.n_experts - self.moe.top_k)
        n_moe_layers = self.n_layers - self.moe.first_k_dense
        total -= n_moe_layers * inactive * n_mats * d * self.moe.expert_ff
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


# the assigned input shapes (reference config.py:151-156)
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def reduced(cfg: ModelConfig, n_layers: int = 2, d_model: int = 256,
            n_experts: int = 4, vocab: int = 512) -> ModelConfig:
    """Smoke-test variant of the same family: <=2 layers, d_model<=512, <=4 experts."""
    d = min(cfg.d_model, d_model)
    nh = max(2, min(cfg.n_heads, 4))
    nkv = max(1, min(cfg.n_kv, nh))
    dh = max(16, d // nh)
    changes = dict(
        n_layers=n_layers, d_model=d, n_heads=nh, n_kv=nkv, d_head=dh,
        d_ff=max(64, min(cfg.d_ff, 4 * d)) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, vocab), remat=False,
    )
    if cfg.moe:
        ne = min(cfg.moe.n_experts, n_experts)
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=ne, top_k=min(cfg.moe.top_k, 2),
            n_shared=min(cfg.moe.n_shared, 1),
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            expert_ff=min(cfg.moe.expert_ff, 2 * d) or 2 * d,
            dense_ff=min(cfg.moe.dense_ff, 4 * d) if cfg.moe.dense_ff else 0)
    if cfg.ssm:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=min(cfg.ssm.d_state, 16), chunk=64,
            attn_every=2 if cfg.ssm.attn_every else 0,
            slstm_every=2 if cfg.ssm.slstm_every else 0)
    if cfg.mla:
        changes["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                   qk_nope_dim=16, qk_rope_dim=16, v_head_dim=16)
    if cfg.encoder:
        changes["encoder"] = EncoderConfig(n_layers=2, n_frames=32, d_model=d)
    if cfg.n_vision_tokens:
        changes["n_vision_tokens"] = 8
    if cfg.window:
        changes["window"] = 64
    return dataclasses.replace(cfg, **changes)
