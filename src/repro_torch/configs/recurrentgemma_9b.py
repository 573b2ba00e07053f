"""RecurrentGemma-9B [arXiv:2402.19427]: RG-LRU + local attention, pattern
(recurrent, recurrent, local-attn), MQA kv=1, window 2048. Runs long_500k."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    qk_norm=False,
    sliding_window=2048,
    rope_theta=10_000.0,
    mlp_activation="geglu",
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=4096,
    conv_width=4,
)
