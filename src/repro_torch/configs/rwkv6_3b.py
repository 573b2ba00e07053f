"""RWKV6-3B "Finch" [arXiv:2404.05892]: attention-free SSM, data-dependent
decay, head size 64. Runs long_500k (O(1) decode state)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,     # = d_model / rwkv_head_size (attention unused)
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_size=64,
    mlp_activation="swiglu",
)
