"""The model FLOPs of the window over the window at the bf16 peak
(989 TFLOP/s), in % (``bench.lib.flops``: 2 N a token forward, 6 N forward
and backward, causal attention's products; non-padding tokens only,
prefill tokens the cache served left out)."""
from bench.lib.flops import BF16_FLOPS


def read(record):
    if record.flops is None or record.window_s <= 0:
        return None
    return 100.0 * record.flops / (record.window_s * BF16_FLOPS)
