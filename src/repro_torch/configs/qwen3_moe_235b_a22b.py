"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family]: 128 experts top-8,
GQA kv=4, qk_norm, 94 layers."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_activation="swiglu",
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=1536,
    capacity_factor=1.25,
)
