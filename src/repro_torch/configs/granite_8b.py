"""Granite-8B code [arXiv:2405.04324]: llama-arch dense, GQA kv=8."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    qk_norm=False,
    rope_theta=10_000_000.0,
    mlp_activation="swiglu",
)
