"""Qwen3-8B [hf:Qwen/Qwen3-8B]: dense, GQA kv=8, qk_norm. The paper's model."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_activation="swiglu",
)
