"""PaliGemma-3B [arXiv:2407.07726]: SigLIP (stubbed) + gemma decoder, MQA kv=1.

The ViT/SigLIP frontend is a stub: `input_specs` provides 256 precomputed,
projected patch embeddings (B, 256, d_model)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    qk_norm=False,
    rope_theta=10_000.0,
    mlp_activation="geglu",
    num_image_tokens=256,
)
