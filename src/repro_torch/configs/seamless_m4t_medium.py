"""SeamlessM4T-medium backbone [arXiv:2308.11596]: enc-dec, 12+12 layers.

The mel/conv audio frontend is a stub: the encoder consumes precomputed
frame embeddings (B, encoder_frames, d_model) from `input_specs`."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium",
    family="audio",
    num_layers=12,            # decoder layers
    num_encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    qk_norm=False,
    rope_theta=10_000.0,
    mlp_activation="swiglu",
    encoder_frames=1024,
)
