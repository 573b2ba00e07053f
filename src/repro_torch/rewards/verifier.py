"""RLVR reward workers: verifiable exact-match rewards.

Rewards are computed per-sample the moment its generation completes (queue
scheduling overlaps reward computation with ongoing decoding); the worker
is stateless and thread-safe.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.types import Sample
from repro_torch.data.dataset import ArithmeticTask, decode_number


class ArithmeticVerifier:
    """Exact-match verifier: reward 1.0 iff the generated number equals the
    ground-truth answer parsed from the prompt itself.

    ``format_credit`` gives partial reward for a well-formed numeric answer
    (standard RLVR shaping — densifies the sparse exact-match signal so a
    small random-init policy can bootstrap)."""

    def __init__(self, task: Optional[ArithmeticTask] = None, *,
                 format_credit: float = 0.1):
        self.task = task or ArithmeticTask()
        self.format_credit = format_credit

    def __call__(self, sample: Sample) -> float:
        prob = self.task.problem_from_prompt(sample.prompt_tokens)
        if prob is None:
            return 0.0
        pred = decode_number(sample.response_tokens)
        if pred is None:
            return 0.0
        return 1.0 if pred == prob.answer else self.format_credit


class LengthPenaltyWrapper:
    """Optional shaping: subtract a small per-token cost (keeps responses
    short — useful to demonstrate reward composition)."""

    def __init__(self, inner, *, per_token: float = 0.0):
        self.inner = inner
        self.per_token = per_token

    def __call__(self, sample: Sample) -> float:
        r = self.inner(sample)
        return r - self.per_token * float(np.asarray(sample.response_tokens).size)
