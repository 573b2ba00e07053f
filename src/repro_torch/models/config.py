"""Model configuration for all assigned architecture families.

One dataclass covers the six families (dense / moe / ssm / hybrid / vlm /
audio): family-specific fields are simply unused elsewhere.  Configs are
plain data — no jax imports here — so importing a config never touches
device state (required by the dry-run contract).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio

    # trunk
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # attention flavour
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # tokens; None = full attention
    rope_theta: float = 10_000.0
    attn_logit_softcap: Optional[float] = None

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0  # per-expert hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0

    # SSM / RWKV6
    rwkv_head_size: int = 64

    # hybrid (RecurrentGemma): block pattern repeated over depth,
    # e.g. ("rglru", "rglru", "attn")
    block_pattern: Optional[Tuple[str, ...]] = None
    lru_width: Optional[int] = None
    conv_width: int = 4

    # enc-dec (audio)
    num_encoder_layers: int = 0
    encoder_frames: int = 1024  # stubbed audio frontend output length

    # vlm
    num_image_tokens: int = 0

    # activations / norms
    mlp_activation: str = "swiglu"  # swiglu | geglu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # numerics
    dtype: str = "bfloat16"

    # --- derived ---
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM / hybrid / sliding-window archs."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    @property
    def num_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def smoke(self) -> "ModelConfig":
        """Reduced variant of the same family for CPU smoke tests."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.num_heads, 4)
        head_dim = d_model // n_heads
        n_kv = max(1, min(self.num_kv_heads, n_heads))
        pattern = self.block_pattern
        num_layers = 2 if pattern is None else len(pattern)
        return dataclasses.replace(
            self,
            num_layers=num_layers,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.is_moe else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2) if self.is_moe else 0,
            moe_d_ff=min(self.moe_d_ff, 256) if self.is_moe else 0,
            rwkv_head_size=min(self.rwkv_head_size, 32),
            lru_width=min(self.lru_width, 256) if self.lru_width else None,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            encoder_frames=min(self.encoder_frames, 64),
            num_image_tokens=min(self.num_image_tokens, 16),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
        )
