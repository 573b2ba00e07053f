"""H2O-Danube-3-4B [arXiv:2401.16818]: llama+mistral mix with sliding-window
attention (window 4096) — the dense arch that runs long_500k."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    qk_norm=False,
    sliding_window=4096,
    rope_theta=10_000.0,
    mlp_activation="swiglu",
)
