"""Device resolution shared by the port's entry points.

Model init, ``get_api``, and ``PagedDecodeEngine`` run on the CUDA card
unless the caller asks for the CPU by name.  Without a card and without an
explicit ``device="cpu"`` they raise: there is no silent CPU path.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device to run on; a CUDA device always carries its index, so
    that tensors' devices compare equal to it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` string (``"bfloat16"``, ``"float32"``) -> torch."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
