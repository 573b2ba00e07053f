"""The port's concurrency toolkit (``repro_torch.analysis``): a twin of
each of ``test_analysis.py``'s tests, run on the port's sanitizer, checker,
``SampleBuffer`` and fleet — each static rule flags its known-bad fixture
(and passes the corrected twin), the runtime sanitizer detects seeded
inversions, the schedule perturber reproduces the historical SampleBuffer
version race against a deliberately buggy copy — plus the port's checker
command line.

Run the port's tests under the sanitizer with ``REPRO_SANITIZE=1`` in the
environment: every port lock is then tracked, and ``port_sanitizer`` below
fails a test that records a new lock-order inversion.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.analysis import sanitizer
from repro_torch.analysis.schedules import SchedulePerturber
from repro_torch.analysis.sanitizer import REGISTRY, TrackedLock, TrackedRLock
from repro_torch.analysis.static_check import check_paths, check_source
from repro_torch.core.sample_buffer import SampleBuffer, StaleSampleError
from repro_torch.core.types import GenerationResult, RolloutTask, Sample, next_uid

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def port_sanitizer():
    """Under ``REPRO_SANITIZE=1``: a test must leave the port's dynamic
    lock-order graph free of NEW inversions (the graph accumulates across
    the session, so two tests' orders that conflict are caught too)."""
    if not sanitizer.enabled():
        yield
        return
    before = len(sanitizer.report()["inversions"])
    yield
    new = sanitizer.report()["inversions"][before:]
    assert not new, f"lock-order inversions: {new}"


def _rules(src):
    res = check_source(textwrap.dedent(src), "fixture.py")
    return [v.rule for v in res.violations]


# ---------------------------------------------------------------------------
# static rules: one failing fixture + one clean twin per rule
# ---------------------------------------------------------------------------

def test_guarded_by_flags_unlocked_access():
    bad = """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._count = 0  # guarded-by: _lock

        def bump(self):
            self._count += 1
    """
    assert "guarded-by" in _rules(bad)


def test_guarded_by_accepts_locked_access_and_holds_marker():
    good = """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._count = 0  # guarded-by: _lock

        def bump(self):
            with self._lock:
                self._count += 1

        def _bump_locked(self):  # holds: _lock
            self._count += 1
    """
    assert _rules(good) == []


def test_guarded_by_waiver_suppresses():
    waived = """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._count = 0  # guarded-by: _lock

        def peek(self):
            # racy-read tolerated: monitoring only
            # concheck: disable=guarded-by
            return self._count
    """
    assert _rules(waived) == []


def test_lock_order_cycle_detected():
    bad = """
    import threading

    class A:
        def __init__(self):
            self._x = threading.Lock()

    class B:
        def __init__(self):
            self._y = threading.Lock()

    # lock-order: A._x -> B._y
    # lock-order: B._y -> A._x
    """
    assert "lock-order" in _rules(bad)


def test_lock_order_nested_with_builds_edges():
    src = """
    import threading

    class C:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def both(self):
            with self._a:
                with self._b:
                    pass
    """
    res = check_source(textwrap.dedent(src), "fixture.py")
    assert res.violations == []
    edges = {(e["from"], e["to"]) for e in res.graph["edges"]}
    assert ("C._a", "C._b") in edges


def test_blocking_call_under_lock_flagged():
    bad = """
    import threading
    import time

    class C:
        def __init__(self):
            self._lock = threading.Lock()

        def slow(self):
            with self._lock:
                time.sleep(1.0)
    """
    assert "blocking-under-lock" in _rules(bad)


def test_cond_wait_without_predicate_loop_flagged():
    bad = """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._cond = threading.Condition(self._lock)

        def wait_once(self):
            with self._cond:
                self._cond.wait()
    """
    assert "cond-wait-loop" in _rules(bad)
    good = bad.replace(
        "self._cond.wait()",
        "while not self.ready():\n                    self._cond.wait()")
    assert "cond-wait-loop" not in _rules(good)


def test_thread_started_without_join_flagged():
    bad = """
    import threading

    class C:
        def start(self):
            self._worker = threading.Thread(target=self._run)
            self._worker.start()
    """
    assert "thread-join" in _rules(bad)
    good = bad + """
        def stop(self):
            self._worker.join(timeout=5)
    """
    assert "thread-join" not in _rules(good)


def test_busy_wait_poll_loop_flagged():
    bad = """
    import time

    class C:
        def wait_done(self):
            while not self.done:
                time.sleep(0.001)
    """
    assert "busy-wait" in _rules(bad)


def test_busy_wait_timed_event_repoll_flagged():
    bad = """
    class C:
        def wait_done(self):
            while not self._stop.is_set():
                self._event.wait(timeout=0.01)
    """
    assert "busy-wait" in _rules(bad)


# ---------------------------------------------------------------------------
# the repo gate: the shipped tree must be clean
# ---------------------------------------------------------------------------

def test_repo_tree_passes_concheck():
    """The port's tree passes its checker, and its static lock graph has
    the locks and edges of the JAX package's."""
    res = check_paths([str(ROOT / "src" / "repro_torch")])
    assert res.violations == [], \
        [f"{v.path}:{v.line} {v.rule}: {v.msg}" for v in res.violations]
    ref = check_paths([str(ROOT / "src" / "repro")])
    assert res.graph["nodes"] == ref.graph["nodes"]
    assert ([(e["from"], e["to"]) for e in res.graph["edges"]]
            == [(e["from"], e["to"]) for e in ref.graph["edges"]])


def _concheck(*args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis.concheck", *args],
                          env=env, cwd=cwd, capture_output=True, text=True, timeout=120)


def test_concheck_cli_exit_codes(tmp_path):
    """0 on the port's tree (its default path) with the graph written; 1
    on a violation, which it prints; 2 on a bad flag (argparse)."""
    graph = tmp_path / "graph.json"
    ok = _concheck("--graph-out", str(graph), "--verbose")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "concheck: OK" in ok.stdout and "lock-order edges:" in ok.stdout
    g = json.loads(graph.read_text())
    assert g["source"] == "static" and len(g["nodes"]) == 5 and len(g["edges"]) == 5
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import time

        class C:
            def wait_done(self):
                while not self.done:
                    time.sleep(0.001)
    """))
    fail = _concheck(str(bad))
    assert fail.returncode == 1 and "busy-wait" in fail.stdout
    assert "1 violation(s)" in fail.stdout
    assert _concheck("--no-such-flag").returncode == 2


# ---------------------------------------------------------------------------
# runtime sanitizer
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_registry():
    """Isolate deliberate violations from the session-wide inversion check
    (and from other tests): snapshot-reset around the test body."""
    REGISTRY.reset()
    saved_threshold = REGISTRY.hold_threshold_s
    yield REGISTRY
    REGISTRY.hold_threshold_s = saved_threshold
    sanitizer.install_perturber(None)
    REGISTRY.reset()


def test_sanitizer_records_edges_and_detects_inversion(clean_registry):
    a = TrackedLock("T.a")
    b = TrackedLock("T.b")
    with a:
        with b:
            pass
    assert sanitizer.report()["inversions"] == []

    def reversed_order():
        with b:
            with a:
                pass
    t = threading.Thread(target=reversed_order)
    t.start()
    t.join()
    inv = sanitizer.report()["inversions"]
    assert inv and inv[0]["held"] == "T.b" and inv[0]["acquiring"] == "T.a"
    with pytest.raises(AssertionError):
        sanitizer.assert_no_inversions("self-test")


def test_sanitizer_same_class_different_instance_is_inversion(clean_registry):
    a1 = TrackedLock("Replica._lock")
    a2 = TrackedLock("Replica._lock")
    with a1:
        with a2:
            pass
    assert sanitizer.report()["inversions"], \
        "nesting two instances of one lock class is a self-deadlock risk"


def test_sanitizer_reentrant_rlock_is_not_inversion(clean_registry):
    r = TrackedRLock("T.r")
    with r:
        with r:
            pass
    assert sanitizer.report()["inversions"] == []


def test_sanitizer_condition_wait_pops_held_stack(clean_registry):
    r = TrackedRLock("T.cond_lock")
    cond = threading.Condition(r)
    other = TrackedLock("T.other")

    def waiter():
        with cond:
            cond.wait(timeout=5)
            # post-wait nesting must record cond_lock -> other, and the
            # wait itself must have released the tracked entry (otherwise
            # the notifier's acquisition below would report an inversion).
            with other:
                pass

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        cond.notify_all()
    t.join()
    rep = sanitizer.report()
    assert rep["inversions"] == []
    assert "T.cond_lock -> T.other" in rep["edges"]


def test_sanitizer_long_hold_reported(clean_registry):
    clean_registry.hold_threshold_s = 0.01
    lock = TrackedLock("T.slowpoke")
    with lock:
        time.sleep(0.05)
    holds = sanitizer.report()["long_holds"]
    assert holds and holds[0]["lock"] == "T.slowpoke"
    assert sanitizer.report()["inversions"] == []  # report-only


def test_graph_json_shape(clean_registry):
    a = TrackedLock("G.a")
    b = TrackedLock("G.b")
    with a:
        with b:
            pass
    g = sanitizer.graph_json()
    assert g["source"] == "runtime"
    assert {"from": "G.a", "to": "G.b", "count": 1} in g["edges"]
    assert set(g["nodes"]) == {"G.a", "G.b"}


# ---------------------------------------------------------------------------
# schedule perturbation: reproduce the historical buffer version race
# ---------------------------------------------------------------------------

class _VersionedQueue:
    """Minimal twin of the SampleBuffer consume path.  ``buggy=True``
    re-creates the staleness race this repo fixed in its early history: the
    strict re-check reads ``self._version`` AFTER the consume critical
    section instead of capturing it inside, so a concurrent
    ``advance_version`` fails a batch that was admissible at the moment it
    was consumed.  ``buggy=False`` captures inside — the shipped fix."""

    def __init__(self, *, buggy):
        self.buggy = buggy
        self._lock = TrackedLock("BuggyQueue._lock")
        self._version = 0

    def advance_version(self):
        with self._lock:
            self._version += 1

    def consume_one(self):
        """Produce-and-consume one sample at the current version.  Both
        happen in ONE critical section, so the sample is admissible at
        consume time BY CONSTRUCTION — any staleness failure is spurious."""
        with self._lock:
            version_started = self._version
            version_at_consume = self._version
        if self.buggy:
            # BUG: second acquisition re-reads the version post-consume
            with self._lock:
                version_at_consume = self._version
        if version_at_consume - version_started > 0:   # alpha = 0
            raise StaleSampleError(
                f"v{version_started} checked at v{version_at_consume}")


def _race_sweep(*, buggy, seed, iters=100):
    """One adversarial schedule: a trainer thread advancing the version at
    full tilt against a consumer; returns True if a spurious staleness
    failure was observed."""
    sanitizer.install_perturber(SchedulePerturber(
        seed=seed, p_yield=1.0, max_sleep_s=0.003,
        only_locks={"BuggyQueue._lock"}))
    q = _VersionedQueue(buggy=buggy)
    stop = threading.Event()

    def trainer():
        while not stop.is_set():
            q.advance_version()
            time.sleep(0.0002)

    t = threading.Thread(target=trainer)
    t.start()
    raced = False
    try:
        for _ in range(iters):
            try:
                q.consume_one()
            except StaleSampleError:
                raced = True
                break
    finally:
        stop.set()
        t.join()
        sanitizer.install_perturber(None)
    return raced


def test_perturber_reproduces_version_race_on_buggy_queue(clean_registry):
    """Under seeded schedule perturbation the buggy twin's post-release
    version read races with advance_version and fails spuriously."""
    assert any(_race_sweep(buggy=True, seed=s) for s in (1234, 99, 7)), \
        ("perturbed schedule never hit the version race — widen the sweep "
         "before trusting the fuzzer")


def test_fixed_queue_immune_to_version_race(clean_registry):
    """The shipped fix (capture version_at_consume INSIDE the critical
    section): the same adversarial schedules can never fail spuriously."""
    for s in (1234, 99, 7):
        assert not _race_sweep(buggy=False, seed=s)


def _sample(sid, version):
    z = np.zeros((1,), np.int32)
    return Sample(sample_id=sid, prompt_id=0, replica_idx=0,
                  prompt_tokens=z, response_tokens=z,
                  logprobs=np.zeros((1,), np.float32),
                  version_started=version)


def test_sample_buffer_under_perturbation(clean_registry):
    """Race-fuzz the real SampleBuffer's producer/consumer condition
    machinery: two producer threads vs a consuming main thread, every lock
    acquisition perturbed.  Every sample is either consumed exactly once or
    evicted as stale by advance_version — none lost, none duplicated — with
    zero lock-order inversions."""
    was = sanitizer.enabled()
    sanitizer.enable(True)         # buffer's factory locks become tracked
    try:
        buf = SampleBuffer(batch_size=2, alpha=1.0, strict=False)
    finally:
        sanitizer.enable(was)
    sanitizer.install_perturber(SchedulePerturber(
        seed=42, p_yield=0.5, max_sleep_s=0.001))
    per_producer = 10
    total = 2 * per_producer

    def producer(base):
        for k in range(per_producer):
            v = buf.begin_generation(timeout=10)
            assert v is not None
            buf.put(_sample(base + k, v))

    threads = [threading.Thread(target=producer, args=(b,))
               for b in (0, 1000)]
    for t in threads:
        t.start()
    got = []
    deadline = time.monotonic() + 30
    try:
        # advance_version evicts completed samples that staled past alpha, so
        # the exit condition is consumed + evicted == total, not consumed ==
        # total; single-sample gets avoid stranding an odd remainder.
        while len(got) + buf.total_evicted < total:
            assert time.monotonic() < deadline, "sweep made no progress"
            try:
                got.extend(buf.get_batch(1, timeout=0.5))
            except TimeoutError:
                continue
            if len(got) % 2 == 0:
                buf.advance_version()
    finally:
        for t in threads:
            t.join()
    ids = [s.sample_id for s in got]
    assert len(ids) + buf.total_evicted == total
    assert len(set(ids)) == len(ids)    # nothing lost, nothing duplicated
    sanitizer.assert_no_inversions("SampleBuffer perturbation sweep")


@pytest.mark.slow
def test_sanitized_router_sweep_no_inversions(clean_registry):
    """Race-fuzz the fleet path end to end: tracked locks + perturbation on
    every core lock class, concurrent submit / weight-sync / kill traffic.
    Any lock-order inversion anywhere in buffer, client, router or proxy
    fails the sweep."""
    from repro_torch.core.llm_proxy import LLMProxy
    from repro_torch.core.rollout_client import RolloutClient
    from repro_torch.core.router import ProxyRouter

    was = sanitizer.enabled()
    sanitizer.enable(True)
    try:
        proxies = [LLMProxy(FakeEngine(slots=4, step_sleep=0.0005),
                            name=f"r{i}") for i in range(2)]
        router = ProxyRouter(proxies)
    finally:
        sanitizer.enable(was)
    sanitizer.install_perturber(SchedulePerturber(
        seed=7, p_yield=0.3, max_sleep_s=0.001))
    router.start()
    client = RolloutClient(router)
    try:
        handles = [client.submit(_task(4)) for _ in range(16)]
        sync = router.update_weights_async({"w": 1})
        router.mark_dead(1)
        assert sync.wait(timeout=10)
        for h in handles:
            res = h.result(timeout=30)
            assert res is not None
    finally:
        router.stop()
    sanitizer.assert_no_inversions("router sweep")
    rep = sanitizer.report()
    assert rep["acquisitions"] > 0


class FakeEngine:
    """``test_router.py``'s deterministic engine over the port's types:
    each request emits 0,1,2,... one per step; abort-with-retain + resume."""

    supports_retain = True

    def __init__(self, slots=2, max_total_len=10_000, step_sleep=0.001):
        self.slots = slots
        self.max_total_len = max_total_len
        self.step_sleep = step_sleep
        self.active = {}
        self.retained = {}
        self.update_count = 0

    @property
    def num_free_slots(self):
        return self.slots - len(self.active)

    def add_request(self, rid, prompt, max_new):
        assert self.num_free_slots > 0
        self.active[rid] = {"left": int(max_new), "toks": []}

    def abort(self, rid, retain=False):
        st = self.active.pop(rid)
        if retain:
            self.retained[rid] = st
        return GenerationResult(
            request_id=rid, task=None,
            tokens=np.asarray(st["toks"], np.int32),
            logprobs=np.zeros(len(st["toks"]), np.float32),
            version_started=-1, aborted=True, partial=True,
            resumable=retain)

    def can_resume(self, rid, max_new):
        return rid in self.retained and self.num_free_slots > 0

    def resume_request(self, old_rid, new_rid, max_new):
        del self.retained[old_rid]
        self.active[new_rid] = {"left": int(max_new), "toks": []}

    def release_retained(self, rid):
        self.retained.pop(rid, None)

    def peek_tokens(self, rid, start=0):
        st = self.active.get(rid)
        return [] if st is None else list(st["toks"][start:])

    def step(self):
        if self.step_sleep:
            time.sleep(self.step_sleep)
        done = []
        for rid, st in list(self.active.items()):
            st["toks"].append(len(st["toks"]))
            st["left"] -= 1
            if st["left"] <= 0:
                done.append((rid, np.asarray(st["toks"], np.int32),
                             np.zeros(len(st["toks"]), np.float32)))
                del self.active[rid]
        return done

    def update_weights(self, params):
        self.update_count += 1


def _task(n=3, prompt=(1, 2), gid=-1, meta=None):
    return RolloutTask(task_id=next_uid(), prompt_id=0, replica_idx=0,
                       prompt_tokens=np.asarray(prompt, np.int32),
                       max_new_tokens=n, group_id=gid, meta=dict(meta or {}))
