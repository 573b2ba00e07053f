"""The one general traffic generator: it reads a traffic mix's data file
(``bench/traffic/<mix>.json``) and draws what the cell sends from
``--seed``.

A length is given as ``[lo, hi]`` (uniform over the integers) or as
``{"log_uniform": [lo, hi]}``.  Every seed gets the same set of sizes in
another order: a mix names a ``pool`` of P draws, the sizes are the P
evenly spaced quantiles of the distribution, and each pass over the pool
takes them in a new order drawn from the seed.  So the work of a window
does not change with the seed, only its order and the token ids do.
"""
from __future__ import annotations

import json
import math
import os
from typing import Iterator, List, Tuple

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST_ID = 3        # token ids 0, 1, 2 are pad, bos and eos in the port's data


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def quantiles(spec, n: int) -> np.ndarray:
    """The ``n`` evenly spaced quantiles (midpoints) of a length spec, as
    integers."""
    u = (np.arange(n) + 0.5) / n
    if isinstance(spec, dict):
        lo, hi = spec["log_uniform"]
        x = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    else:
        lo, hi = spec
        x = lo + u * (hi + 1 - lo) - 0.5
    return np.clip(np.rint(x), spec_lo(spec), spec_hi(spec)).astype(np.int64)


def spec_lo(spec) -> int:
    return int((spec["log_uniform"] if isinstance(spec, dict) else spec)[0])


def spec_hi(spec) -> int:
    return int((spec["log_uniform"] if isinstance(spec, dict) else spec)[1])


def shuffled(spec, n: int, rng: np.random.Generator) -> Iterator[int]:
    """The spec's ``n`` quantiles, pass after pass, each pass in a new order."""
    values = quantiles(spec, n)
    while True:
        for i in rng.permutation(n):
            yield int(values[i])


def tokens(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return rng.integers(FIRST_ID, vocab, size=n, dtype=np.int64).astype(np.int32)


def parity_reward(response_tokens) -> float:
    """``chip_smoke._pipeline_reward``: 1 when more than half the response's
    tokens are even (random weights never solve a real task, and a reward
    that never varies leaves GRPO nothing to learn)."""
    r = np.asarray(response_tokens)
    return float(np.mean(r % 2 == 0) > 0.5) if r.size else 0.0


class SeededPrompts:
    """A task object for ``build_rlvr_pipeline(task=)``: ``prompt_stream``
    yields (prompt id, tokens), each prompt ``group_size`` times in a row."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab = mix, vocab
        self.rng = np.random.default_rng(seed)

    def prompt_stream(self, *, group_size: int = 1) -> Iterator[Tuple[int, np.ndarray]]:
        lengths = shuffled(self.mix["prompt_len"], self.mix["pool"], self.rng)
        pid = 0
        while True:
            toks = tokens(self.rng, next(lengths), self.vocab)
            for _ in range(group_size):
                yield pid, toks
            pid += 1


def train_batches(mix: dict, vocab: int, seed: int) -> Iterator[List[dict]]:
    """Batches of ``prompts`` x ``group`` samples, every batch with the same
    set of prompt and response lengths in a new order: prompt and response
    tokens, rollout logprobs of a plausible size (around -ln V, as random
    weights give), the parity reward, the group."""
    rng = np.random.default_rng(seed)
    p, g = mix["prompts"], mix["group"]
    prompt_q = quantiles(mix["prompt_len"], p)
    response_q = quantiles(mix["response_len"], p * g)
    mean_lp = -math.log(vocab)
    while True:
        batch = []
        resp = response_q[rng.permutation(p * g)]
        for j, plen in enumerate(prompt_q[rng.permutation(p)]):
            prompt = tokens(rng, int(plen), vocab)
            for k in range(g):
                r = tokens(rng, int(resp[j * g + k]), vocab)
                lp = (mean_lp + 0.5 * rng.standard_normal(r.size)).astype(np.float32)
                batch.append({"group": j, "prompt": prompt, "response": r,
                              "logprobs": np.minimum(lp, 0.0), "reward": parity_reward(r)})
        yield batch
