"""Architecture registry: `--arch <id>` resolves here (the port's copy of
the JAX package's ``configs``, with its input shapes as meta tensors)."""
from __future__ import annotations

from repro_torch.configs import shapes  # noqa: F401
from repro_torch.configs.shapes import SHAPES, InputShape, input_specs, shape_applicable  # noqa: F401
from repro_torch.models.config import ModelConfig

from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3_0_6b
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3_1_7b
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3_4b
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3_8b
from repro_torch.configs.granite_8b import CONFIG as _granite_8b
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3_moe
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx

REGISTRY: dict[str, ModelConfig] = {
    c.arch_id: c
    for c in (
        _qwen3_4b, _qwen3_8b, _granite_8b, _danube, _paligemma,
        _seamless, _qwen3_moe, _rgemma, _rwkv6, _dbrx,
        # beyond the assigned pool: the paper's Table-1 ablation sizes
        _qwen3_0_6b, _qwen3_1_7b,
    )
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def list_archs() -> list[str]:
    return sorted(REGISTRY)
