"""Qwen3-4B [hf:Qwen/Qwen3-8B family]: dense, GQA kv=8, qk_norm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_activation="swiglu",
)
