"""Fault injection for the rollout fleet: crashed replicas as data.

At fleet scale, replica death is a *scheduling event*, not an error
(Laminar's failure-isolated rollout workers; AsyncFlow's stall-tolerant
decoupled stages).  This module provides the machinery the elastic
``ProxyRouter`` is tested and benchmarked against:

* ``FaultyProxy`` — a transparent wrapper speaking the exact ``LLMProxy``
  protocol that can be ``kill()``-ed at any moment.  A killed replica
  behaves like a crashed process: its loop stops mid-flight, every
  callback it would have fired is suppressed (results die with the
  process — delivering them post-mortem would hide real failure modes),
  command submissions raise ``ReplicaDeadError``, and a snapshot of the
  decode progress lost in flight is kept for the router's ``lost_tokens``
  accounting.
* ``FaultInjector`` — seeded chaos: a background thread that fires random
  faults at live replicas while a workload runs (the CI ``faults`` tier),
  bounded by ``max_kills``/``min_alive`` so sweeps terminate.  Beyond
  crashes (``"kill"``) it covers the hang family the SLO watchdog exists
  for: ``"stall"`` freezes a replica's engine loop (detected by the
  router's steps-frozen probe, not by ``healthy()``) and ``"slow"``
  degrades decode throughput (exercises deadline/stall enforcement).

The router detects death through ``healthy()`` (heartbeat/health-probe
hook) or by catching ``ReplicaDeadError`` at dispatch, then fails every
in-flight handle on the dead replica over through the client's existing
abort→resume migration path — see ``ProxyRouter.mark_dead``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.analysis.sanitizer import new_lock


class ReplicaDeadError(RuntimeError):
    """Raised when a command is submitted to a crashed replica."""


class _ChaosEngine:
    """Engine shim injecting hang-family faults into the decode loop.

    Installed between a ``FaultyProxy`` and the real engine so the proxy's
    own event loop experiences the fault exactly where a real hung/slow
    engine would manifest: inside ``step()``.  A *stalled* engine spins
    (keeping the loop thread alive but making zero progress — the
    ``steps_executed`` counter freezes, which is what the router's stall
    probe watches); a *slowed* engine sleeps before each step.  A dead
    replica's engine executes nothing.
    """

    def __init__(self, inner, owner: "FaultyProxy"):
        self._inner = inner
        self._owner = owner

    def step(self):
        fp = self._owner
        if fp._dead.is_set():
            return []
        slow = fp._slow_s
        if slow > 0:
            time.sleep(slow)
        while (fp._stalled.is_set() and not fp._dead.is_set()
               and not fp.inner._stop.is_set()):
            # concheck: disable=busy-wait — the spin IS the injected fault:
            # a hung engine makes zero progress while its thread stays alive.
            time.sleep(0.002)
        if fp._dead.is_set() or fp.inner._stop.is_set():
            # the spin ended because the replica was killed/stopped, not
            # unstalled: a late step here would deliver post-mortem results
            # racing the router's failover into double resolution.
            return []
        return self._inner.step()

    def __getattr__(self, item):
        return getattr(self._inner, item)


class FaultyProxy:
    """Crash-injectable wrapper around an ``LLMProxy``.

    Every protocol method delegates to the wrapped proxy until ``kill()``;
    afterwards command submissions raise ``ReplicaDeadError``, the inner
    loop is stopped, and callbacks of in-flight requests never fire — the
    router's failover (not the dead replica) must resolve their handles.
    Metric reads keep returning the inner proxy's last (frozen) values so
    observability never throws mid-probe.

    ``kill_after_steps`` arms a self-destruct: the replica dies the first
    time its step counter crosses the threshold (checked on the caller of
    ``step_once`` — lockstep drivers — and by a watchdog when the
    threaded loop is used).
    """

    def __init__(self, inner, *, kill_after_steps: Optional[int] = None):
        self.inner = inner
        self.kill_after_steps = kill_after_steps
        self._dead = threading.Event()
        self._guard_lock = new_lock("FaultyProxy._guard_lock")
        self._decoded_at_death: Dict[int, int] = {}  # guarded-by: _guard_lock
        self._watchdog: Optional[threading.Thread] = None
        self.kills = 0  # guarded-by: _guard_lock — 0 or 1; survives the crash
        # hang-family faults, injected at the engine-step boundary
        self._slow_s = 0.0
        self._stalled = threading.Event()
        self.stalls = 0
        self.slowdowns = 0
        inner.engine = _ChaosEngine(inner.engine, self)

    # ------------------------------------------------------------ lifecycle
    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def engine(self):
        return self.inner.engine

    def healthy(self) -> bool:
        """Health-probe hook: False once killed (or the inner loop died)."""
        return not self._dead.is_set() and self.inner.healthy()

    def kill(self) -> None:
        """Simulate a replica crash NOW: snapshot the decode progress that
        dies with the process, stop the loop, suppress all callbacks."""
        with self._guard_lock:
            if self._dead.is_set():
                return
            # what a real crash loses: tokens decoded for requests that
            # were active on this replica and not yet delivered.
            counts: Dict[int, int] = {}
            peek = getattr(self.inner.engine, "peek_tokens", None)
            for rid in list(self.inner._active):
                try:
                    counts[rid] = len(peek(rid)) if peek is not None else 0
                except Exception:
                    counts[rid] = 0
            self._decoded_at_death = counts
            self._dead.set()
            self.kills = 1
        self.inner.stop()
        self._join_watchdog()

    def decoded_counts(self) -> Dict[int, int]:
        """Per-request decode progress lost at death (empty while alive) —
        the router sums this into its ``lost_tokens`` counter."""
        with self._guard_lock:
            return dict(self._decoded_at_death)

    # ----------------------------------------------------- hang-family faults
    def slow_decode(self, seconds: float) -> None:
        """Degrade decode: every engine step sleeps ``seconds`` first.
        Pass 0 to restore full speed."""
        if seconds > 0:
            self.slowdowns += 1
        self._slow_s = float(seconds)

    def stall(self) -> None:
        """Freeze the engine loop: steps spin without progress.  The replica
        still answers ``healthy()`` — only the router's steps-frozen probe
        (``SLOConfig.replica_stall_s``) can tell it is gone."""
        self.stalls += 1
        self._stalled.set()

    def unstall(self) -> None:
        self._stalled.clear()

    def _join_watchdog(self) -> None:
        w = self._watchdog
        if (w is not None and w.is_alive()
                and w is not threading.current_thread()):
            w.join(timeout=5.0)

    def start(self) -> "FaultyProxy":
        if self._dead.is_set():
            raise ReplicaDeadError(f"{self.name} is dead")
        self.inner.start()
        if self.kill_after_steps is not None and self._watchdog is None:
            self._watchdog = threading.Thread(
                target=self._watch, name=f"{self.name}:watchdog", daemon=True)
            self._watchdog.start()
        return self

    def _watch(self) -> None:
        # also exits when the inner loop is stopped normally — otherwise a
        # never-triggered self-destruct leaks its thread past shutdown
        while not self._dead.is_set() and not self.inner._stop.is_set():
            if self.inner.steps_executed >= self.kill_after_steps:
                self.kill()
                return
            # concheck: disable=busy-wait — chaos-harness watchdog polling a
            # plain step counter; there is no event source to park on.
            time.sleep(0.001)

    def stop(self) -> None:
        # stopping a dead replica is a no-op (the crash already stopped it)
        if not self._dead.is_set():
            self.inner.stop()
        self._join_watchdog()

    def step_once(self) -> bool:
        """Lockstep driving: a dead replica executes nothing.  The armed
        self-destruct fires here for thread-less (deterministic) fleets."""
        if self._dead.is_set():
            return False
        if (self.kill_after_steps is not None
                and self.inner.steps_executed >= self.kill_after_steps):
            self.kill()
            return False
        return self.inner.step_once()

    # ------------------------------------------------------------- commands
    def _check(self) -> None:
        if self._dead.is_set():
            raise ReplicaDeadError(f"replica {self.name} is dead")

    def _guard(self, callback: Callable) -> Callable:
        """Callbacks of a crashed replica must NEVER fire: the results died
        with the process, and a post-mortem delivery would race the
        router's synthesized failover abort into a double resolution."""
        def cb(res):
            if not self._dead.is_set():
                callback(res)
        return cb

    def generate(self, task, version, callback, **kw):
        self._check()
        return self.inner.generate(task, version, self._guard(callback), **kw)

    def generate_group(self, tasks, version, callback):
        self._check()
        return self.inner.generate_group(tasks, version, self._guard(callback))

    def generate_resumed(self, task, version, callback, resume_from, **kw):
        self._check()
        return self.inner.generate_resumed(task, version,
                                           self._guard(callback),
                                           resume_from=resume_from, **kw)

    def abort(self, request_id, retain=False):
        self._check()
        self.inner.abort(request_id, retain=retain)

    def abort_stale(self, min_version, retain=False):
        self._check()
        self.inner.abort_stale(min_version, retain=retain)

    def release_retained(self, request_id):
        self._check()
        self.inner.release_retained(request_id)

    def export_retained(self, request_id):
        self._check()
        return self.inner.export_retained(request_id)

    def generate_transferred(self, task, version, callback, record,
                             resume_from, **kw):
        self._check()
        return self.inner.generate_transferred(
            task, version, self._guard(callback), record=record,
            resume_from=resume_from, **kw)

    def export_prefix(self, tokens, deliver):
        self._check()
        self.inner.export_prefix(tokens, deliver)

    def import_prefix(self, record):
        self._check()
        self.inner.import_prefix(record)

    def suspend(self):
        self._check()
        self.inner.suspend()

    def resume(self):
        self._check()
        self.inner.resume()

    def update_weights(self, params):
        self._check()
        self.inner.update_weights(params)

    def update_weights_async(self, params):
        self._check()
        return self.inner.update_weights_async(params)

    # ------------------------------------------------------------- metrics
    # (delegated reads — frozen post-mortem, never raising)
    def __getattr__(self, item):
        return getattr(self.inner, item)


def wrap_fleet(proxies: List, **kw) -> List[FaultyProxy]:
    """Wrap every replica of a fleet for fault injection."""
    return [p if isinstance(p, FaultyProxy) else FaultyProxy(p, **kw)
            for p in proxies]


class FaultInjector(threading.Thread):
    """Seeded chaos monkey: fire random faults at live replicas while work
    runs.

    ``seed`` makes the victim/delay/mode SEQUENCE reproducible; the
    interleaving with the workload is still real concurrency — chaos tests
    assert outcome invariants (every handle resolves exactly once,
    survivors audit clean), never timing.  ``min_alive`` keeps the fleet
    routable; ``max_kills`` bounds the sweep (it counts every fault fired,
    not just crashes).

    ``modes`` selects the fault repertoire per firing:

    * ``"kill"``  — crash the replica (callbacks suppressed; the router's
      health probe / ``on_kill`` hook drives failover),
    * ``"stall"`` — freeze its engine loop; the replica stays "healthy",
      so only the router's steps-frozen probe rescues its work,
    * ``"slow"``  — degrade decode by a random per-step sleep; the SLO
      watchdog's deadline/stall enforcement is what keeps latency bounded.

    ``min_alive`` applies to the incapacitating modes (kill/stall);
    slowdowns can hit anyone.
    """

    def __init__(self, victims: List[FaultyProxy], *, seed: int = 0,
                 min_delay: float = 0.01, max_delay: float = 0.05,
                 max_kills: int = 1, min_alive: int = 1,
                 modes: tuple = ("kill",),
                 on_kill: Optional[Callable[[int], None]] = None):
        super().__init__(name="fault_injector", daemon=True)
        self.victims = list(victims)
        self.rng = np.random.default_rng(seed)
        self.min_delay = min_delay
        self.max_delay = max_delay
        self.max_kills = max_kills
        self.min_alive = min_alive
        self.modes = tuple(modes)
        self.on_kill = on_kill           # e.g. router.probe_health
        self.killed: List[int] = []
        self.stalled: List[int] = []
        self.slowed: List[int] = []
        # NB: not named _stop — threading.Thread owns that attribute
        self._halt = threading.Event()

    def stop(self) -> None:
        """Halt the sweep and wait for the thread to exit (no leak)."""
        self._halt.set()
        if self.is_alive() and self is not threading.current_thread():
            self.join(timeout=5.0)

    def _fired(self) -> int:
        return len(self.killed) + len(self.stalled) + len(self.slowed)

    def run(self) -> None:
        while not self._halt.is_set() and self._fired() < self.max_kills:
            delay = float(self.rng.uniform(self.min_delay, self.max_delay))
            if self._halt.wait(delay):
                return
            mode = str(self.rng.choice(self.modes))
            # an incapacitated (stalled) replica is not a useful victim either
            alive = [i for i, v in enumerate(self.victims)
                     if v.healthy() and not v._stalled.is_set()]
            if mode in ("kill", "stall") and len(alive) <= self.min_alive:
                continue
            if not alive:
                continue
            idx = int(self.rng.choice(alive))
            victim = self.victims[idx]
            if mode == "kill":
                victim.kill()
                self.killed.append(idx)
                if self.on_kill is not None:
                    self.on_kill(idx)
            elif mode == "stall":
                victim.stall()
                self.stalled.append(idx)
            else:                        # "slow"
                victim.slow_decode(float(self.rng.uniform(0.005, 0.02)))
                self.slowed.append(idx)
