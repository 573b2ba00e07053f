"""SampleBuffer: the producer–consumer heart of rollout–train decoupling.

Implements the paper's §4.3 *asynchronous ratio* alpha as a per-sample
freshness constraint: a sample whose generation was initiated at policy
version ``v`` is admissible only while ``current_version - v <= alpha``.
Because generation initiation is gated on buffer occupancy
(``<= (1 + alpha) * batch_size`` unconsumed-or-in-flight samples), no sample
is ever wasted — the buffer never needs to drop a violating sample in steady
state; the ``reclaim`` hook exists for ABORTed partial generations, which
are recycled for recomputation rather than discarded.

alpha = 0 degenerates to fully synchronous training (the consumer blocks
until the freshest batch is complete and producers cannot run ahead).
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.analysis.sanitizer import new_condition, new_lock
from repro_torch.core.types import Sample


class StaleSampleError(RuntimeError):
    pass


class SampleBuffer:
    def __init__(self, batch_size: int, alpha: float = 0.0, *,
                 strict: bool = True):
        self.batch_size = batch_size
        self.alpha = alpha
        self.strict = strict
        self._lock = new_lock("SampleBuffer._lock")
        self._not_empty = new_condition(self._lock, name="SampleBuffer._not_empty")
        self._can_produce = new_condition(self._lock, name="SampleBuffer._can_produce")
        self._samples: List[Sample] = []  # guarded-by: _lock
        self._inflight = 0                # guarded-by: _lock
        self._initiated = 0               # guarded-by: _lock
        self._version = 0                 # guarded-by: _lock
        self._closed = False              # guarded-by: _lock
        self.total_produced = 0           # guarded-by: _lock
        self.total_consumed = 0           # guarded-by: _lock
        self.total_reclaimed = 0          # guarded-by: _lock
        self.total_evicted = 0            # guarded-by: _lock

    # ------------------------------------------------------------------ info
    @property
    def capacity(self) -> int:
        return int((1 + self.alpha) * self.batch_size)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def occupancy(self) -> int:
        """Completed-unconsumed + in-flight samples (the (1+alpha)B bound)."""
        with self._lock:
            return len(self._samples) + self._inflight

    # ------------------------------------------------------------ producers
    def _admissible(self) -> bool:  # holds: _lock
        """Freshness gate.  With FIFO-by-initiation consumption, the i-th
        initiated sample (0-based) is consumed while the policy is at version
        floor(i / B); admitting it requires floor(i/B) - v_now <= alpha, i.e.
        initiated < (v_now + alpha + 1) * B.  This also implies occupancy
        <= (1 + alpha) * B (the paper's buffer bound) since consumption
        removes B per version advance."""
        return self._initiated < (self._version + self.alpha + 1) * self.batch_size

    def try_begin_generation(self) -> Optional[int]:
        """Claim a generation slot; returns the initiating policy version or
        None if the freshness capacity is exhausted."""
        with self._lock:
            if self._closed or not self._admissible():
                return None
            self._inflight += 1
            self._initiated += 1
            return self._version

    def begin_generation(self, timeout: Optional[float] = None) -> Optional[int]:
        """Blocking variant of try_begin_generation."""
        with self._can_produce:
            while not self._closed and not self._admissible():
                if not self._can_produce.wait(timeout=timeout):
                    return None
            if self._closed:
                return None
            self._inflight += 1
            self._initiated += 1
            return self._version

    def put(self, sample: Sample) -> None:
        with self._lock:
            if self.strict and self._version - sample.version_started > self.alpha:
                raise StaleSampleError(
                    f"sample initiated at v{sample.version_started} is older than "
                    f"alpha={self.alpha} behind v{self._version}")
            sample.version_finished = self._version
            self._samples.append(sample)
            self._inflight = max(0, self._inflight - 1)
            self.total_produced += 1
            self._not_empty.notify_all()

    def reclaim(self, n: int = 1) -> None:
        """Release in-flight slots for abandoned generations (failed envs,
        shutdown).  Returns both the slot and the consumption reservation."""
        with self._lock:
            self._inflight = max(0, self._inflight - n)
            self._initiated = max(0, self._initiated - n)
            self.total_reclaimed += n
            self._can_produce.notify_all()

    # ------------------------------------------------------------ consumers
    def get_batch(self, n: Optional[int] = None, *, block: bool = True,
                  timeout: Optional[float] = None) -> List[Sample]:
        """Blocking get of n samples (FIFO = oldest-first, preserving
        freshness headroom for the rest)."""
        n = n if n is not None else self.batch_size
        with self._not_empty:
            if block:
                ok = self._not_empty.wait_for(
                    lambda: len(self._samples) >= n or self._closed, timeout=timeout)
                if not ok:
                    raise TimeoutError(f"get_batch({n}) timed out")
            if len(self._samples) < n:
                raise RuntimeError("buffer closed with insufficient samples")
            # consume oldest-initiated first: completion order can invert under
            # long-tail generation, and freshness headroom must go to the
            # oldest samples or they would stale out while waiting.
            self._samples.sort(key=lambda s: s.version_started)
            batch, self._samples = self._samples[:n], self._samples[n:]
            self.total_consumed += len(batch)
            # capture the version INSIDE the critical section: a concurrent
            # advance_version between releasing the lock and the strict
            # re-check below must not fail a batch that was admissible at
            # the moment it was consumed.
            version_at_consume = self._version
            self._can_produce.notify_all()
        if self.strict:
            for s in batch:
                if version_at_consume - s.version_started > self.alpha:
                    raise StaleSampleError(
                        f"consumed sample from v{s.version_started} "
                        f"at v{version_at_consume}")
        return batch

    def advance_version(self) -> int:
        """Called by the AsyncController after each train step / model_update.

        Enforces the per-sample freshness invariant on COMPLETED samples:
        a long-tail sample can complete at gap alpha, miss its batch (because
        faster, newer samples filled it), and would violate after this
        advance.  In-flight stragglers are ABORTed by the controller; the
        completed ones are evicted here and their reservations recycled so a
        fresh generation starts immediately (tracked as total_evicted —
        empirically a small fraction, see EXPERIMENTS.md)."""
        with self._lock:
            self._version += 1
            keep, evicted = [], 0
            for s in self._samples:
                if self._version - s.version_started > self.alpha:
                    evicted += 1
                else:
                    keep.append(s)
            if evicted:
                self._samples = keep
                self._initiated = max(0, self._initiated - evicted)
                self.total_evicted += evicted
            self._can_produce.notify_all()
            return self._version

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._can_produce.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def max_staleness(self) -> int:
        with self._lock:
            if not self._samples:
                return 0
            return max(self._version - s.version_started for s in self._samples)
