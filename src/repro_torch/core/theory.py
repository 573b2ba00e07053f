"""Propositions 1 & 2 (§3.1): closed-form efficiency bounds.

All times are in abstract seconds; K counts generation *workers* (decode
slots), matching the paper's queue-scheduling model where a finished worker
immediately receives the next task.
"""
from __future__ import annotations

import dataclasses


# ---------------------------------------------------------------------------
# Proposition 1: generation time under queue scheduling
# ---------------------------------------------------------------------------

def prop1_completion_bound(q: int, k: int, mu_gen: float, l_gen: float) -> float:
    """T_completion <= Q/K * mu + L (eq. 4)."""
    return q / k * mu_gen + l_gen


def prop1_per_sample_bound(q: int, k: int, mu_gen: float, l_gen: float) -> float:
    """Average per-sample completion time bound (eq. 5)."""
    return mu_gen / k + l_gen / q


def prop1_sync_per_sample(n: int, k: int, mu_gen: float, l_gen: float) -> float:
    """Sync: Q = N (eq. 6)."""
    return prop1_per_sample_bound(n, k, mu_gen, l_gen)


def prop1_async_per_sample(n: int, k: int, mu_gen: float, l_gen: float,
                           alpha: float) -> float:
    """Async: Q = (alpha+1) N (eq. 7)."""
    return prop1_per_sample_bound(int((alpha + 1) * n), k, mu_gen, l_gen)


def prop1_max_speedup(mu_gen: float, l_gen: float) -> float:
    """K = N, alpha -> inf: (L + mu) / mu."""
    return (l_gen + mu_gen) / mu_gen


# ---------------------------------------------------------------------------
# Proposition 2: end-to-end with resource partitioning
# ---------------------------------------------------------------------------

def prop2_sync_bound(n: int, k: int, mu_gen: float, l_gen: float,
                     mu_train: float, e: float) -> float:
    """T_sync <= N/K (mu_gen + E mu_train) + L_gen (eq. 8)."""
    return n / k * (mu_gen + e * mu_train) + l_gen


def prop2_async_bound(n: int, k: int, mu_gen: float, l_gen: float,
                      mu_train: float, e: float, alpha: float,
                      beta: float) -> float:
    """T_async <= max(gen-side, train-side) (eq. 9)."""
    gen = n / ((1 - beta) * k) * mu_gen + l_gen / ((alpha + 1) * (1 - beta))
    train = e * n / (beta * k) * mu_train
    return max(gen, train)


def prop2_optimal_beta(n: int, k: int, mu_gen: float, l_gen: float,
                       mu_train: float, e: float, alpha: float) -> float:
    """beta* balancing both pipelines (eq. 10)."""
    num = e * n * mu_train
    den = n * mu_gen + k * l_gen / (alpha + 1) + e * n * mu_train
    return num / den


def prop2_async_bound_at_optimum(n: int, k: int, mu_gen: float, l_gen: float,
                                 mu_train: float, e: float, alpha: float) -> float:
    """T_async <= N/K (mu_gen + E mu_train) + L/(alpha+1) (eq. 11)."""
    return n / k * (mu_gen + e * mu_train) + l_gen / (alpha + 1)


def prop2_max_speedup(n: int, k: int, mu_gen: float, l_gen: float,
                      mu_train: float, e: float) -> float:
    """alpha -> inf: 1 + K L / (N (mu_gen + E mu_train))."""
    return 1.0 + k * l_gen / (n * (mu_gen + e * mu_train))


@dataclasses.dataclass(frozen=True)
class Workload:
    """Convenience bundle for the benchmarks."""
    n: int              # rollout batch size (samples per training step)
    k: int              # generation workers
    mu_gen: float
    l_gen: float
    mu_train: float
    e: float = 1.0      # sample reuse (ppo_epochs)

    def sync_bound(self) -> float:
        return prop2_sync_bound(self.n, self.k, self.mu_gen, self.l_gen,
                                self.mu_train, self.e)

    def async_bound(self, alpha: float, beta: float | None = None) -> float:
        if beta is None:
            beta = prop2_optimal_beta(self.n, self.k, self.mu_gen, self.l_gen,
                                      self.mu_train, self.e, alpha)
        return prop2_async_bound(self.n, self.k, self.mu_gen, self.l_gen,
                                 self.mu_train, self.e, alpha, beta)
