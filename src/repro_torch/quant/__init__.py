"""Quantized rollouts: int8/fp8 weights quantized at every weight sync
(``core.py``).  The int8 KV pool lives in ``models/paged.py``."""
from repro_torch.quant.core import (
    KV_MODES,
    MODES,
    QuantLeaf,
    dequantize_array,
    dequantize_params,
    is_quantized_tree,
    quantize_array,
    quantize_params,
)

__all__ = [
    "KV_MODES",
    "MODES",
    "QuantLeaf",
    "dequantize_array",
    "dequantize_params",
    "is_quantized_tree",
    "quantize_array",
    "quantize_params",
]
