"""Seeded schedule perturbation: randomized yields at lock boundaries.

Installed into the runtime sanitizer (:mod:`repro_torch.analysis.sanitizer`) with
``install_perturber``, a :class:`SchedulePerturber` sleeps for a small random
interval immediately before a fraction of tracked lock acquisitions.  That
widens the windows between "release lock" and "re-acquire lock" — exactly
where every hand-found race in the async fleet lived — so running the ordinary test
suite under a perturber turns it into a race fuzzer.

Determinism: each thread gets its own ``random.Random`` seeded from
``(seed, thread_registration_order)``, so a given seed produces the same
per-thread decision *sequence* across runs.  (True interleavings still depend
on the OS scheduler; the seed makes the injected noise reproducible, not the
whole execution.)

Typical use::

    sanitizer.enable()
    sanitizer.install_perturber(SchedulePerturber(seed=7, p_yield=0.5))
    try:
        ...build components, run workload...
        sanitizer.assert_no_inversions()
    finally:
        sanitizer.install_perturber(None)
        sanitizer.enable(False)
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

__all__ = ["SchedulePerturber"]


class SchedulePerturber:
    def __init__(
        self,
        seed: int = 0,
        p_yield: float = 0.1,
        max_sleep_s: float = 0.002,
        only_locks: Optional[set] = None,
    ) -> None:
        """
        Args:
          seed: base seed; combined with per-thread registration order.
          p_yield: probability of injecting a yield at each lock acquisition.
          max_sleep_s: injected sleeps are uniform in (0, max_sleep_s].
          only_locks: if given, only acquisitions of lock names in this set
            (exact match) are perturbed — lets a test target one component.
        """
        self.seed = seed
        self.p_yield = p_yield
        self.max_sleep_s = max_sleep_s
        self.only_locks = only_locks
        self._mu = threading.Lock()
        self._next_thread_idx = 0
        self._tls = threading.local()
        self.injected = 0  # total yields injected (approximate, unlocked add)

    def _rng(self) -> random.Random:
        rng = getattr(self._tls, "rng", None)
        if rng is None:
            with self._mu:
                idx = self._next_thread_idx
                self._next_thread_idx += 1
            rng = random.Random(self.seed * 1_000_003 + idx)
            self._tls.rng = rng
        return rng

    def maybe_yield(self, lock_name: str) -> None:
        if self.only_locks is not None and lock_name not in self.only_locks:
            return
        rng = self._rng()
        r = rng.random()
        if r < self.p_yield:
            self.injected += 1
            # Half the injections are pure scheduler yields, half real sleeps:
            # yields shuffle thread order cheaply, sleeps open wide windows.
            if r < self.p_yield * 0.5:
                time.sleep(0)
            else:
                time.sleep(rng.uniform(0.0, self.max_sleep_s) + 1e-5)
