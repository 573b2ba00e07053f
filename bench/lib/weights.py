"""Seeded random weights of a dense Qwen3, made by the benchmark.

One ``torch.Generator`` on the device, seeded with ``--seed``, draws every
leaf in a fixed order, one call per leaf for all layers at once, in the
dtype the model is served in (bf16 matrices; fp32 norm scales, as the port
keeps them).  Matrices are normal with standard deviation 1/sqrt(fan-in),
the embedding with the configuration's ``initializer_range`` (so that a
tied head, which unembeds with it, gives logits of about unit spread and
does not just repeat the last token), norm scales 1 + 0.1 N(0, 1) so that
no norm is the identity.  The same seed on the same kind of card gives the same
bits, so the reference draws them again after the window instead of
holding a copy through it.

``stacked`` is the benchmark's own layout, by name, the layers on a
leading axis; ``port_tree`` views it as the port's parameter tree.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench.lib.flops import shapes


def leaf_specs(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, scale): kind "matrix" (bf16, N(0, scale^2)) or
    "norm" (fp32, 1 + scale N(0, 1)).  A tied head has no leaf of its own:
    it unembeds with ``embed``."""
    n, d, h, kv, hd, f, v = shapes(cfg)
    return [
        ("embed", (v, d), "matrix", cfg["initializer_range"]),
        ("wq", (n, d, h * hd), "matrix", d ** -0.5),
        ("wk", (n, d, kv * hd), "matrix", d ** -0.5),
        ("wv", (n, d, kv * hd), "matrix", d ** -0.5),
        ("wo", (n, h * hd, d), "matrix", (h * hd) ** -0.5),
        ("wi_gate", (n, d, f), "matrix", d ** -0.5),
        ("wi_up", (n, d, f), "matrix", d ** -0.5),
        ("w_down", (n, f, d), "matrix", f ** -0.5),
        ("ln1", (n, d), "norm", 0.1),
        ("ln2", (n, d), "norm", 0.1),
        ("q_norm", (n, hd), "norm", 0.1),
        ("k_norm", (n, hd), "norm", 0.1),
        ("final_norm", (d,), "norm", 0.1),
    ] + ([] if cfg["tie_word_embeddings"] else [("lm_head", (d, v), "matrix", d ** -0.5)])


def stacked(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf by name, drawn from ``seed`` on ``device``; matrices in the
    configuration's ``torch_dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, cfg["torch_dtype"])
    out = {}
    for name, shape, kind, scale in leaf_specs(cfg):
        if kind == "norm":
            t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
            out[name] = t.mul_(scale).add_(1.0)
        else:
            out[name] = torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(scale)
    return out


def port_tree(w: Dict[str, torch.Tensor]) -> dict:
    """The port's parameter tree (``repro_torch.models.transformer.init_lm``'s
    layout) over views of ``w``."""
    blocks = []
    for i in range(w["wq"].shape[0]):
        blocks.append({
            "ln1": {"scale": w["ln1"][i]},
            "ln2": {"scale": w["ln2"][i]},
            "attn": {"wq": w["wq"][i], "wk": w["wk"][i], "wv": w["wv"][i], "wo": w["wo"][i],
                     "q_norm": w["q_norm"][i], "k_norm": w["k_norm"][i]},
            "mlp": {"wi_gate": w["wi_gate"][i], "wi_up": w["wi_up"][i], "wo": w["w_down"][i]},
        })
    tree = {"embed": w["embed"], "final_norm": {"scale": w["final_norm"]}, "blocks": blocks}
    if "lm_head" in w:
        tree["lm_head"] = w["lm_head"]
    return tree


def check_like(tree, like, path: str = "params") -> None:
    """Raise unless ``tree`` has ``like``'s keys, shapes and dtypes (``like``
    may live on the meta device)."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"{path}: keys {sorted(tree) if isinstance(tree, dict) else tree!r}"
                             f" != {sorted(like)}")
        for k in like:
            check_like(tree[k], like[k], f"{path}.{k}")
    elif isinstance(like, (list, tuple)):
        if len(tree) != len(like):
            raise ValueError(f"{path}: {len(tree)} entries != {len(like)}")
        for i, (a, b) in enumerate(zip(tree, like)):
            check_like(a, b, f"{path}[{i}]")
    elif tuple(tree.shape) != tuple(like.shape) or tree.dtype != like.dtype:
        raise ValueError(f"{path}: {tuple(tree.shape)} {tree.dtype} != "
                         f"{tuple(like.shape)} {like.dtype}")
