"""BaseEnv: the environment interface consumed by EnvManager (§4.2).

Token-level API: observations and actions are int32 token arrays — the
EnvManager never sees text, matching the LLM-centric rollout loop.
"""
from __future__ import annotations

import abc
from typing import Tuple

import numpy as np


class BaseEnv(abc.ABC):
    @abc.abstractmethod
    def reset(self) -> np.ndarray:
        """Start an episode; returns initial observation tokens."""

    @abc.abstractmethod
    def step(self, action_tokens: np.ndarray) -> Tuple[np.ndarray, float, bool, dict]:
        """Apply an action; returns (obs_tokens, reward, done, info)."""

    def close(self) -> None:  # pragma: no cover - optional
        pass
