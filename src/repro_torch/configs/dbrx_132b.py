"""DBRX-132B [hf:databricks/dbrx-base]: fine-grained MoE, 16 experts top-4,
GQA kv=8, 40 layers."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    qk_norm=False,
    rope_theta=500_000.0,
    mlp_activation="swiglu",
    num_experts=16,
    num_experts_per_tok=4,
    moe_d_ff=10752,
    capacity_factor=1.25,
)
