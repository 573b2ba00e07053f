"""Simulated agentic environments.

* ``LatencyEnv`` — latency-modeled env (Gaussian per-step latency, optional
  fail-slow multiplier and fail-stop hangs) for §5.2 experiments.  The task
  itself is a trivial token-echo so rewards are verifiable.
* ``GridTargetEnv`` — an ALFWorld-flavoured stateful task: the agent must
  emit the token sequence navigating to a target cell; rewards are sparse
  (success only), episodes span multiple turns.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from repro_torch.envs.base import BaseEnv

# token ids for grid actions
TOK_UP, TOK_DOWN, TOK_LEFT, TOK_RIGHT = 1, 2, 3, 4
_ACTION_DELTA = {TOK_UP: (0, -1), TOK_DOWN: (0, 1), TOK_LEFT: (-1, 0), TOK_RIGHT: (1, 0)}


class LatencyEnv(BaseEnv):
    """Env whose step() sleeps a sampled latency (real seconds, scaled)."""

    def __init__(self, env_id: int, *, mu: float = 0.05, sigma: float = 0.02,
                 max_steps: int = 4, p_fail_slow: float = 0.0,
                 fail_slow_factor: float = 5.0, p_fail_stop: float = 0.0,
                 time_scale: float = 1.0, seed: Optional[int] = None):
        self.env_id = env_id
        self.rng = np.random.default_rng(env_id if seed is None else seed)
        self.mu, self.sigma = mu, sigma
        self.max_steps = max_steps
        self.p_fail_slow = p_fail_slow
        self.fail_slow_factor = fail_slow_factor
        self.p_fail_stop = p_fail_stop
        self.time_scale = time_scale
        self._t = 0
        self._hung = False

    def reset(self) -> np.ndarray:
        self._t = 0
        self._hung = bool(self.p_fail_stop and self.rng.random() < self.p_fail_stop)
        return np.asarray([10 + self.env_id % 50], np.int32)

    def _latency(self) -> float:
        lat = max(0.0, self.rng.normal(self.mu, self.sigma))
        if self.p_fail_slow and self.rng.random() < self.p_fail_slow:
            lat *= self.fail_slow_factor
        return lat * self.time_scale

    def step(self, action_tokens) -> Tuple[np.ndarray, float, bool, dict]:
        if self._hung:
            # fail-stop: hang far longer than any reasonable step budget
            time.sleep(3600 * self.time_scale)
        time.sleep(self._latency())
        self._t += 1
        done = self._t >= self.max_steps
        reward = 1.0 if done and len(action_tokens) > 0 else 0.0
        return np.asarray([10 + self._t], np.int32), reward, done, {}


class GridTargetEnv(BaseEnv):
    """Navigate a 5x5 grid to the target; observation encodes (pos, target)."""

    SIZE = 5

    def __init__(self, env_id: int, *, max_steps: int = 8,
                 latency: float = 0.0, seed: Optional[int] = None):
        self.rng = np.random.default_rng(env_id if seed is None else seed)
        self.max_steps = max_steps
        self.latency = latency
        self.pos = (0, 0)
        self.target = (0, 0)
        self._t = 0

    def _obs(self) -> np.ndarray:
        return np.asarray([
            100 + self.pos[0], 110 + self.pos[1],
            120 + self.target[0], 130 + self.target[1],
        ], np.int32)

    def reset(self) -> np.ndarray:
        self.pos = tuple(self.rng.integers(0, self.SIZE, 2).tolist())
        while True:
            self.target = tuple(self.rng.integers(0, self.SIZE, 2).tolist())
            if self.target != self.pos:
                break
        self._t = 0
        return self._obs()

    def step(self, action_tokens) -> Tuple[np.ndarray, float, bool, dict]:
        if self.latency:
            time.sleep(self.latency)
        self._t += 1
        for tok in np.asarray(action_tokens).ravel():
            d = _ACTION_DELTA.get(int(tok))
            if d is None:
                continue
            self.pos = (int(np.clip(self.pos[0] + d[0], 0, self.SIZE - 1)),
                        int(np.clip(self.pos[1] + d[1], 0, self.SIZE - 1)))
        success = self.pos == self.target
        done = success or self._t >= self.max_steps
        return self._obs(), (1.0 if success else 0.0), done, {"success": success}
