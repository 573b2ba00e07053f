"""Plain Qwen3 (dense) in fp32: the reference that ``correct`` holds the port
to.  It follows the published architecture (Qwen/Qwen3-1.7B and -4B
``config.json`` with HF transformers' ``modeling_qwen3``): pre-norm
RMSNorm blocks, q/k RMSNorm over the head dimension before a half-split
RoPE (theta from the configuration), grouped-query causal attention
(query head h reads KV head h // (heads / kv_heads)), SwiGLU MLP, final
RMSNorm and the unembedding: the embedding's transpose where
``tie_word_embeddings`` is set, as in both published configurations.  One sequence at a time, layer by layer,
in fp32 with TF32 off (the caller sets ``torch.backends``' flags);
``precision="fp8"`` instead computes every product in float8 e4m3: weight
matrices rounded with one scale per output column, activations with one
per token (the control of the train step: the nearest precision below
its bf16), gradients passed straight through.

Weights come as a dict of stacked tensors by name (``bench/lib/weights``'s
layout), in any dtype; each layer's are read in fp32.  Nothing here imports
the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

MATRICES = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up", "w_down", "lm_head")
FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (its absolute maximum at 448), gradients passed straight through."""
    scale = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class Qwen3:
    def __init__(self, cfg: dict, weights: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg, self.w, self.precision = cfg, weights, precision
        self.eps = cfg["rms_norm_eps"]
        self.h, self.kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.hd = cfg["head_dim"]
        half = self.hd // 2
        self.inv_freq = 1.0 / (cfg["rope_theta"] ** (
            torch.arange(half, dtype=torch.float64) * 2.0 / self.hd)).float()

    def get(self, name: str, i=None) -> torch.Tensor:
        if name == "lm_head" and self.cfg["tie_word_embeddings"]:
            t = self.w["embed"].T
        else:
            t = self.w[name] if i is None else self.w[name][i]
        t = t.float()
        if self.precision == "fp8" and name in MATRICES:
            t = _fp8(t, 0)
        return t

    def mm(self, x, name: str, i=None):
        """``x`` times a weight matrix, both in the model's precision."""
        if self.precision == "fp8":
            x = _fp8(x, -1)
        return x @ self.get(name, i)

    def norm(self, x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * scale

    def rope(self, x, positions):
        angles = positions.float()[:, None] * self.inv_freq.to(x.device)    # (S, half)
        cos, sin = angles.cos()[:, None, :], angles.sin()[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def layer(self, x, i: int):
        s = x.shape[0]
        pos = torch.arange(s, device=x.device)
        h = self.norm(x, self.get("ln1", i))
        q = self.mm(h, "wq", i).view(s, self.h, self.hd)
        k = self.mm(h, "wk", i).view(s, self.kv, self.hd)
        v = self.mm(h, "wv", i).view(s, self.kv, self.hd)
        q = self.rope(self.norm(q, self.get("q_norm", i)), pos)
        k = self.rope(self.norm(k, self.get("k_norm", i)), pos)
        g = self.h // self.kv
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        scores = torch.einsum("qhd,khd->hqk", q, k) * self.hd ** -0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("hqk,khd->qhd", probs, v).reshape(s, self.h * self.hd)
        x = x + self.mm(o, "wo", i)
        h = self.norm(x, self.get("ln2", i))
        return x + self.mm(F.silu(self.mm(h, "wi_gate", i)) * self.mm(h, "wi_up", i), "w_down", i)

    def features(self, tokens: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """Final-norm hidden states (S, d) of one sequence of token ids."""
        x = self.w["embed"][tokens].float()
        for i in range(self.cfg["num_hidden_layers"]):
            if remat and torch.is_grad_enabled():
                x = checkpoint(self.layer, x, i, use_reentrant=False)
            else:
                x = self.layer(x, i)
        return self.norm(x, self.get("final_norm"))

    def response_logprobs(self, prompt: torch.Tensor, response: torch.Tensor,
                          remat: bool = False) -> torch.Tensor:
        """log p(response[t] | prompt, response[:t]) for every t, fp32."""
        seq = torch.cat([prompt, response])
        x = self.features(seq, remat=remat)[len(prompt) - 1:len(seq) - 1]
        logits = self.mm(x, "lm_head")
        return torch.log_softmax(logits, dim=-1).gather(1, response[:, None].long())[:, 0]
