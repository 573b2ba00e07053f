"""Runtime concurrency sanitizer: instrumented locks + dynamic lock-order graph.

Layer 2 of the concurrency toolkit (layer 1 is the static pass in
``static_check.py``).  Core modules create their locks through the factories
here::

    from repro_torch.analysis.sanitizer import new_lock, new_rlock, new_condition

    self._lock = new_rlock("ProxyRouter._lock")

When the sanitizer is inactive (the default) the factories return plain
``threading`` primitives — zero overhead, byte-identical behaviour.  When
active (``REPRO_SANITIZE=1`` in the environment, or an
explicit :func:`enable` call *before* the objects under test are constructed)
they return tracked wrappers that record, per acquisition:

- the **dynamic lock-order graph**, keyed on the lock *name* (its lock class,
  e.g. ``"ProxyRouter._lock"``), not the instance — so an inversion between
  any two replicas' locks of the same class is still one edge;
- **order inversions**: acquiring ``b`` while holding ``a`` when the graph
  already contains a path ``b -> … -> a`` (the lockdep algorithm).  Nesting
  two *different instances* of the same lock class is reported as an
  inversion too (self-deadlock risk) — reentrant re-acquisition of the same
  instance is fine and ignored;
- **long hold times** (report-only): any hold exceeding
  ``REPRO_SANITIZE_HOLD_S`` seconds (default 0.2).

A :class:`~repro_torch.analysis.schedules.SchedulePerturber` can be installed with
:func:`install_perturber`; it injects seeded randomized yields immediately
before every tracked acquisition, widening race windows so the ordinary test
suite doubles as a race fuzzer.

Thread-safety: the registry's own bookkeeping is guarded by an internal plain
``threading.Lock`` (never tracked, so it cannot recurse into itself); held
stacks are thread-local.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "enable",
    "enabled",
    "new_lock",
    "new_rlock",
    "new_condition",
    "install_perturber",
    "reset",
    "report",
    "assert_no_inversions",
    "graph_json",
    "TrackedLock",
    "TrackedRLock",
]

_active = os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


def enable(flag: bool = True) -> None:
    """Turn tracking on/off for locks created *after* this call."""
    global _active
    _active = flag


def enabled() -> bool:
    return _active


class _HeldEntry:
    __slots__ = ("lock", "t_acquired", "count")

    def __init__(self, lock: "TrackedLock", t_acquired: float) -> None:
        self.lock = lock
        self.t_acquired = t_acquired
        self.count = 1


class _Registry:
    """Process-global dynamic lock-order graph + violation log."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tls = threading.local()
        self.perturber: Optional[object] = None
        self.hold_threshold_s = float(os.environ.get("REPRO_SANITIZE_HOLD_S", "0.2"))
        self.reset()

    # -- per-thread held stack -------------------------------------------
    def _stack(self) -> List[_HeldEntry]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    # -- graph bookkeeping -----------------------------------------------
    def reset(self) -> None:
        with self._mu:
            # (held_name, acquired_name) -> observation count
            self.edges: Dict[Tuple[str, str], int] = {}
            self.inversions: List[dict] = []
            self.long_holds: List[dict] = []
            self.max_hold_s: Dict[str, float] = {}
            self.acquisitions = 0

    def _reachable(self, src: str, dst: str) -> bool:
        # DFS over the edge set; caller holds self._mu.
        seen = {src}
        frontier = [src]
        while frontier:
            node = frontier.pop()
            if node == dst:
                return True
            for a, b in self.edges:
                if a == node and b not in seen:
                    seen.add(b)
                    frontier.append(b)
        return dst in seen

    # -- hooks called by tracked locks -----------------------------------
    def before_acquire(self, lock: "TrackedLock") -> None:
        p = self.perturber
        if p is not None:
            p.maybe_yield(lock.name)  # type: ignore[attr-defined]

    def on_acquired(self, lock: "TrackedLock") -> None:
        st = self._stack()
        for entry in st:
            if entry.lock is lock:  # reentrant re-acquire of the same instance
                entry.count += 1
                return
        now = time.monotonic()
        held_names = [e.lock.name for e in st]
        with self._mu:
            self.acquisitions += 1
            for held in held_names:
                edge = (held, lock.name)
                if edge not in self.edges:
                    if held == lock.name or self._reachable(lock.name, held):
                        self.inversions.append(
                            {
                                "held": held,
                                "acquiring": lock.name,
                                "thread": threading.current_thread().name,
                                "held_stack": list(held_names),
                            }
                        )
                    self.edges[edge] = 0
                self.edges[edge] += 1
        st.append(_HeldEntry(lock, now))

    def on_release(self, lock: "TrackedLock") -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i].lock is lock:
                st[i].count -= 1
                if st[i].count == 0:
                    held = time.monotonic() - st[i].t_acquired
                    del st[i]
                    with self._mu:
                        if held > self.max_hold_s.get(lock.name, 0.0):
                            self.max_hold_s[lock.name] = held
                        if held > self.hold_threshold_s:
                            self.long_holds.append(
                                {
                                    "lock": lock.name,
                                    "held_s": round(held, 4),
                                    "thread": threading.current_thread().name,
                                }
                            )
                return
        # Release of a lock we never saw acquired (e.g. tracking enabled
        # mid-flight); ignore rather than corrupt the stack.

    # -- reporting --------------------------------------------------------
    def snapshot(self) -> dict:
        with self._mu:
            return {
                "edges": {f"{a} -> {b}": n for (a, b), n in sorted(self.edges.items())},
                "inversions": list(self.inversions),
                "long_holds": list(self.long_holds),
                "max_hold_s": dict(self.max_hold_s),
                "acquisitions": self.acquisitions,
            }


REGISTRY = _Registry()


class TrackedLock:
    """A named, non-reentrant mutex that reports to the global registry.

    Implements enough of the ``threading.Lock`` protocol to back a
    ``threading.Condition`` (which falls back to plain acquire/release when
    ``_release_save`` is absent — all of which route through our hooks, so a
    condition ``wait()`` correctly pops the lock from the held stack).
    """

    def __init__(self, name: str) -> None:
        self.name = name
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        REGISTRY.before_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            REGISTRY.on_acquired(self)
        return ok

    def release(self) -> None:
        REGISTRY.on_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<TrackedLock {self.name} locked={self.locked()}>"


class TrackedRLock:
    """A named reentrant mutex; implements the full Condition owner protocol."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._inner = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        REGISTRY.before_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            REGISTRY.on_acquired(self)
        return ok

    def release(self) -> None:
        REGISTRY.on_release(self)
        self._inner.release()

    # Condition protocol: release the full recursion count around a wait.
    def _release_save(self):
        st = REGISTRY._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i].lock is self:
                count = st[i].count
                st[i].count = 1  # force on_release to fully pop the entry
                REGISTRY.on_release(self)
                state = self._inner._release_save()  # type: ignore[attr-defined]
                return (state, count)
        state = self._inner._release_save()  # type: ignore[attr-defined]
        return (state, 1)

    def _acquire_restore(self, saved) -> None:
        state, count = saved
        REGISTRY.before_acquire(self)
        self._inner._acquire_restore(state)  # type: ignore[attr-defined]
        REGISTRY.on_acquired(self)
        st = REGISTRY._stack()
        for entry in st:
            if entry.lock is self:
                entry.count = count
                break

    def _is_owned(self) -> bool:
        return self._inner._is_owned()  # type: ignore[attr-defined]

    def __enter__(self) -> "TrackedRLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<TrackedRLock {self.name}>"


# ---------------------------------------------------------------------------
# factories — what core modules call
# ---------------------------------------------------------------------------


def new_lock(name: str = "anonymous.Lock") -> threading.Lock:
    """A mutex: plain ``threading.Lock`` normally, tracked when sanitizing."""
    if not _active:
        return threading.Lock()
    return TrackedLock(name)  # type: ignore[return-value]


def new_rlock(name: str = "anonymous.RLock") -> threading.RLock:
    if not _active:
        return threading.RLock()
    return TrackedRLock(name)  # type: ignore[return-value]


def new_condition(lock=None, name: str = "anonymous.Condition"):
    """A condition variable, optionally sharing ``lock`` (tracked or plain).

    ``threading.Condition`` drives whatever lock it is given through the
    standard owner protocol, so handing it a tracked lock keeps the held
    stack correct across ``wait()``.
    """
    if lock is None and _active:
        lock = TrackedRLock(name + ".lock")
    return threading.Condition(lock)


def install_perturber(perturber) -> None:
    """Install (or clear, with ``None``) the schedule perturber."""
    REGISTRY.perturber = perturber


def reset() -> None:
    """Clear the recorded graph and violation log (e.g. between tests)."""
    REGISTRY.reset()


def report() -> dict:
    """Snapshot of edges, inversions, long holds and per-lock max hold."""
    return REGISTRY.snapshot()


def assert_no_inversions(context: str = "") -> None:
    rep = REGISTRY.snapshot()
    if rep["inversions"]:
        raise AssertionError(
            f"lock-order inversions detected{' in ' + context if context else ''}: "
            f"{rep['inversions']}"
        )


def graph_json() -> dict:
    """The dynamic lock-order graph in the same shape concheck emits."""
    rep = REGISTRY.snapshot()
    nodes = sorted(
        {a for (a, _b) in (e.split(" -> ") for e in rep["edges"])}
        | {b for (_a, b) in (e.split(" -> ") for e in rep["edges"])}
    )
    return {
        "source": "runtime",
        "nodes": nodes,
        "edges": [
            {"from": e.split(" -> ")[0], "to": e.split(" -> ")[1], "count": n}
            for e, n in rep["edges"].items()
        ],
        "inversions": rep["inversions"],
    }
