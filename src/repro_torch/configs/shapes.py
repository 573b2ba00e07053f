"""Assigned input shapes and abstract stand-ins for the dry-run.

The port of the JAX package's ``configs/shapes.py``: ``input_specs``
never allocates, and where the reference hands out ``jax.ShapeDtypeStruct``s
it hands out tensors on the ``meta`` device of the same shape and dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.device import torch_dtype
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def _sds(shape, dtype):
    if isinstance(dtype, str):
        dtype = torch_dtype(dtype)
    return torch.empty(shape, dtype=dtype, device="meta")


def model_inputs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    """Forward-pass inputs (tokens + modality-stub embeddings)."""
    out: Dict[str, Any] = {}
    if cfg.family == "vlm":
        text = seq - cfg.num_image_tokens
        assert text > 0
        out["tokens"] = _sds((batch, text), torch.int32)
        out["patches"] = _sds((batch, cfg.num_image_tokens, cfg.d_model), cfg.dtype)
    elif cfg.family == "audio":
        out["tokens"] = _sds((batch, seq), torch.int32)
        out["frames"] = _sds((batch, cfg.encoder_frames, cfg.d_model), cfg.dtype)
    else:
        out["tokens"] = _sds((batch, seq), torch.int32)
    return out


def train_inputs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    """RL train_step inputs: rollout tokens + per-token RL fields."""
    out = model_inputs(cfg, batch, seq)
    tok_seq = out["tokens"].shape[1]
    f32 = torch.float32
    out.update(
        mask=_sds((batch, tok_seq), f32),           # response-token mask
        advantages=_sds((batch, tok_seq), f32),
        old_logprobs=_sds((batch, tok_seq), f32),   # behaviour policy (rollout engine)
        prox_logprobs=_sds((batch, tok_seq), f32),  # proximal policy (decoupled PPO)
        ref_logprobs=_sds((batch, tok_seq), f32),   # reference policy (KL term)
        is_positive=_sds((batch,), f32),            # TOPR T+/T- split
    )
    return out


def decode_inputs(cfg: ModelConfig, batch: int) -> Dict[str, Any]:
    return {
        "token": _sds((batch,), torch.int32),
        "pos": _sds((batch,), torch.int32),
    }


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """All host-provided step inputs for (arch, shape) — meta tensors only.

    The decode cache itself is built on the meta device by the launcher
    (it is carried state, not a host input).
    """
    if shape.kind == "train":
        return train_inputs(cfg, shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        return model_inputs(cfg, shape.global_batch, shape.seq_len)
    if shape.kind == "decode":
        return decode_inputs(cfg, shape.global_batch)
    raise ValueError(shape.kind)


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (see DESIGN.md skip notes)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: long_500k decode skipped (DESIGN.md §long_500k)"
    return True, ""
