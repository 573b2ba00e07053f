"""Prompt datasets (the JAX package's ``data/dataset.py``, kept as the
port's own copy: it needs numpy only).

``ArithmeticTask`` is the synthetic DAPO-stand-in: verifiable math prompts
("a op b =") with exact-match rewards, sized so a ~100M model learns it in a
few hundred RL steps on CPU.  Token map (small closed vocab):

    0 pad | 1 bos | 2 eos | 3..12 digits 0-9 | 13 '+' | 14 '*' | 15 '=' | 16 '-'
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, List, Optional, Tuple

import numpy as np

PAD, BOS, EOS = 0, 1, 2
DIGIT0 = 3
PLUS, TIMES, EQUALS, MINUS = 13, 14, 15, 16
VOCAB = 32


def encode_number(n: int) -> List[int]:
    return [DIGIT0 + int(c) for c in str(int(n))]


def decode_number(tokens) -> Optional[int]:
    digits = []
    for t in np.asarray(tokens).ravel():
        t = int(t)
        if t == EOS:
            break
        if not (DIGIT0 <= t <= DIGIT0 + 9):
            return None
        digits.append(str(t - DIGIT0))
    if not digits:
        return None
    return int("".join(digits))


@dataclasses.dataclass(frozen=True)
class ArithmeticProblem:
    a: int
    b: int
    op: str

    @property
    def answer(self) -> int:
        return {"+": self.a + self.b, "*": self.a * self.b,
                "-": self.a - self.b}[self.op]

    def prompt_tokens(self) -> np.ndarray:
        op_tok = {"+": PLUS, "*": TIMES, "-": MINUS}[self.op]
        toks = [BOS] + encode_number(self.a) + [op_tok] + encode_number(self.b) + [EQUALS]
        return np.asarray(toks, np.int32)

    def answer_tokens(self) -> np.ndarray:
        return np.asarray(encode_number(self.answer) + [EOS], np.int32)


class ArithmeticTask:
    """Infinite stream of verifiable arithmetic prompts."""

    def __init__(self, *, max_operand: int = 20, ops: Tuple[str, ...] = ("+",),
                 seed: int = 0):
        self.max_operand = max_operand
        self.ops = ops
        self.rng = np.random.default_rng(seed)

    def sample_problem(self) -> ArithmeticProblem:
        a = int(self.rng.integers(0, self.max_operand + 1))
        b = int(self.rng.integers(0, self.max_operand + 1))
        op = str(self.rng.choice(list(self.ops)))
        if op == "-" and b > a:
            a, b = b, a
        return ArithmeticProblem(a, b, op)

    def problem_from_prompt(self, prompt_tokens) -> Optional[ArithmeticProblem]:
        toks = [int(t) for t in np.asarray(prompt_tokens).ravel() if t != PAD]
        if not toks or toks[0] != BOS or toks[-1] != EQUALS:
            return None
        body = toks[1:-1]
        for op_tok, op in ((PLUS, "+"), (TIMES, "*"), (MINUS, "-")):
            if op_tok in body:
                i = body.index(op_tok)
                a = decode_number(body[:i] + [EOS])
                b = decode_number(body[i + 1:] + [EOS])
                if a is None or b is None:
                    return None
                return ArithmeticProblem(a, b, op)
        return None

    def prompt_stream(self, *, group_size: int = 1) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (prompt_id, tokens); each prompt repeated group_size times
        consecutively (prompt replication for GRPO groups)."""
        for pid in itertools.count():
            prob = self.sample_problem()
            toks = prob.prompt_tokens()
            for _ in range(group_size):
                yield pid, toks


def pad_and_stack(seqs: List[np.ndarray], length: int, pad_value: int = PAD,
                  align: str = "right") -> np.ndarray:
    """Stack variable-length sequences to (N, length)."""
    out = np.full((len(seqs), length), pad_value, np.int32)
    for i, s in enumerate(seqs):
        s = np.asarray(s, np.int32)[:length]
        if align == "right":
            out[i, length - len(s):] = s
        else:
            out[i, :len(s)] = s
    return out
