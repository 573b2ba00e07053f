"""Pass@k evaluation (the paper evaluates Pass@1 on math benchmarks) — the
port of the JAX package's ``eval/passk.py``.

Drives the slot ``DecodeEngine`` directly — the same serving path the
rollout uses — with k sampled candidates per prompt (temperature 1) plus a
greedy Pass@1 mode, and the unbiased Chen et al. (2021) Pass@k estimator.
``device`` and ``attn_impl`` go to the engine, which serves every ported
family (dense, MoE, RWKV-6, hybrid).  Unlike the JAX result, an
``EvalResult`` also carries the engine's decode steps (``decode_steps``),
against which a caller can hold the kernels' launch counts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.types import Sample, next_uid
from repro_torch.data.dataset import ArithmeticTask, EOS
from repro_torch.models.api import ModelAPI
from repro_torch.rewards.verifier import ArithmeticVerifier
from repro_torch.rollout.engine import DecodeEngine


def pass_at_k_estimator(n: int, c: int, k: int) -> float:
    """Unbiased Pass@k: 1 - C(n-c, k)/C(n, k)."""
    if n - c < k:
        return 1.0
    return float(1.0 - np.prod(1.0 - k / np.arange(n - c + 1, n + 1)))


@dataclasses.dataclass
class EvalResult:
    num_prompts: int
    n_per_prompt: int
    pass_at_1: float
    pass_at_k: dict
    decode_steps: int = 0


def evaluate_passk(api: ModelAPI, params, *, task: Optional[ArithmeticTask] = None,
                   reward_fn: Optional[Callable] = None, num_prompts: int = 32,
                   n_per_prompt: int = 8, ks=(1, 4), max_new_tokens: int = 6,
                   num_slots: int = 16, max_total_len: int = 32,
                   temperature: float = 1.0, seed: int = 0, device=None,
                   attn_impl: str = "kernel") -> EvalResult:
    task = task or ArithmeticTask(max_operand=4, ops=("+",), seed=seed + 1)
    reward_fn = reward_fn or ArithmeticVerifier(task, format_credit=0.0)

    engine = DecodeEngine(api, params, num_slots=num_slots,
                          max_total_len=max_total_len, eos_id=EOS,
                          temperature=temperature, seed=seed, device=device,
                          attn_impl=attn_impl)
    prompts = [task.sample_problem().prompt_tokens() for _ in range(num_prompts)]
    # queue (prompt_idx, candidate_idx) tasks through the engine
    pending = [(pi, ci) for pi in range(num_prompts) for ci in range(n_per_prompt)]
    rid_map = {}
    correct = np.zeros((num_prompts, n_per_prompt), bool)
    done = 0
    while done < len(rid_map) or pending:
        while pending and engine.num_free_slots > 0:
            pi, ci = pending.pop()
            rid = next_uid()
            rid_map[rid] = (pi, ci)
            engine.add_request(rid, prompts[pi], max_new_tokens)
        for rid, toks, lps in engine.step():
            pi, ci = rid_map[rid]
            s = Sample(sample_id=rid, prompt_id=pi, replica_idx=ci,
                       prompt_tokens=prompts[pi], response_tokens=toks,
                       logprobs=lps)
            correct[pi, ci] = reward_fn(s) >= 1.0
            done += 1
        if not engine.slots and not pending:
            break

    c = correct.sum(axis=1)
    p1 = float(np.mean([pass_at_k_estimator(n_per_prompt, int(ci), 1) for ci in c]))
    pk = {k: float(np.mean([pass_at_k_estimator(n_per_prompt, int(ci), k)
                            for ci in c]))
          for k in ks if k <= n_per_prompt}
    return EvalResult(num_prompts, n_per_prompt, p1, pk, engine.total_decode_steps)
