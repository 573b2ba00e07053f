"""ProxyRouter: queue scheduling across an elastic fleet of rollout replicas.

The paper's headline rollout mechanism is *queue scheduling*: instead of
statically partitioning a batch across inference workers (and waiting for
the slowest partition — the long-tail straggler problem), every prompt is
dispatched individually to the least-loaded worker the moment it is
submitted.  This module scales the single proxy/engine rollout path to N
replicas behind one object that speaks the exact ``LLMProxy`` protocol, so
``RolloutClient``, ``RolloutProducer``, ``EnvManagerPool`` and the
``AsyncController`` consume a fleet without changes:

* **Queue scheduling** — ``generate`` routes each request to the replica
  with the least outstanding decode work (``LLMProxy.load()``, in tokens),
  subject to static admission feedback (``can_accept``: a request that can
  never fit a replica's page pool is not queued there).
* **Co-location** — the G candidates of a GRPO group land on ONE replica
  (COW prefix sharing is per-replica), and every turn of an agentic
  ``Session`` follows its predecessors (the radix prefix cache holding the
  conversation history is per-replica too).  Placement pins are LRU-capped.
* **Cross-replica abort→resume migration** — ``prefer_resume`` tells the
  RolloutClient whether an aborted-with-retain request should re-attach in
  place (the cheap default) or migrate.  ``generate_migrated`` moves the
  parked KV pages themselves: the home replica exports them to a host-side
  record (``export_retained``), the target imports them and resumes with
  ZERO re-prefill (``generate_transferred``), and only when the transfer
  can't run (dead home, page pressure on the target, quant mismatch) does
  it degrade to the client-built concatenated re-prefill.  Migration
  triggers when the home replica is draining (``drain()``), overloaded
  past ``migrate_factor``/``migrate_margin``, or DEAD (its parked pages
  died with it — a crash is the one case that still re-prefills).
* **Cache-aware routing** (``cache_aware=True``) — a router-owned
  ``FleetRadixIndex`` mirrors every replica's radix prefix cache
  (maintained push-style from insert/evict/clear events), making placement
  two-tier: a request routes to the replica holding its longest cached
  prefix when that replica's load is within ``cache_affinity_slack``
  tokens of the fleet minimum, otherwise it routes least-loaded and the
  prefix pages are PULLED across (``export_prefix``/``import_prefix``)
  before admission.  ``fleet_audit`` cross-checks the index against every
  live replica's local tree.
* **Replica lifecycle & crash failover** — every replica carries a state
  (``healthy``/``draining``/``dead``/``retired``).  Death is detected by
  the ``healthy()`` heartbeat probe (``probe_health`` — poll it, or run
  ``start_health_monitor``) or by catching ``ReplicaDeadError`` at
  dispatch.  ``mark_dead`` then fails EVERY in-flight handle on the dead
  replica over through the client's existing abort→resume continuation: a
  synthesized non-resumable abort makes the client re-admit the request's
  concatenated prefix (original prompt + all completed legs) on a live
  replica — exactly-once handle resolution, leg/version tags preserved,
  no completed sample ever lost.  Only the dead replica's un-delivered
  current-leg decode progress is re-computed (``lost_tokens``).
* **Elasticity** — ``add_replica`` grows the fleet mid-run (warmed with
  the last-synced weights before taking traffic — the reverse of
  ``drain``); an ``AutoscalePolicy`` drives load-triggered scaling from
  the fleet's ``queue_depth``/``active_per_replica`` stats with
  hysteresis + cooldown, retiring drained replicas on scale-down.
* **Fleet-wide weight sync** — ``update_weights[_async]`` fan out to every
  live replica; the staged variant returns an aggregate event that is set
  once all LIVE replicas acknowledge — a replica dying mid-sync has its
  ack waived instead of deadlocking the trainer.
* **Aggregated observability** — ``cache_stats``/``load``/``queue_depth``
  sum across live replicas; ``replica_stats`` exposes the per-replica view
  (state, load, active/pending, staleness, cache hits); ``fleet_audit``
  asserts the rid→replica map is consistent (and empty at quiescence) and
  runs every live engine's ``audit_pages``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.analysis.sanitizer import new_condition, new_lock, new_rlock
from repro_torch.core.faults import ReplicaDeadError
from repro_torch.core.llm_proxy import LLMProxy
from repro_torch.core.slo import SLOConfig, stamp_deadline
from repro_torch.core.types import (PRIORITY_NORMAL, GenerationResult, Rejected,
                                    RolloutTask, expand_replicas)

# Cross-class acquisition order the AST pass cannot see (concheck reads these
# declarations into its cycle check):
# lock-order: FleetSyncEvent._cond -> ProxyRouter._lock
#   (FleetSyncEvent.is_set consults router._down() under its condition; the
#   reverse never happens — the router notifies sync waiters OUTSIDE _lock)
# lock-order: ProxyRouter._lock -> LLMProxy._load_lock
#   (_place queries replica load()/can_accept() while holding the router lock)
# lock-order: ProxyRouter._lock -> FleetRadixIndex._lock
#   (_place queries best_prefix under the router lock; index listeners fire
#   from replica loop threads holding no other lock, and the index never
#   calls out while holding its own lock)

# group/session placement memory; old pins evict LRU (a group whose pin
# evicted mid-flight merely loses co-location for later members, never
# correctness — assembly keys on group_id, not placement).
_MAX_PINS = 8192


class MultiEvent:
    """Aggregate of the per-replica staged weight-sync events: ``wait``
    returns True once EVERY replica has acknowledged its swap."""

    def __init__(self, events: List[threading.Event]):
        self._events = list(events)

    def is_set(self) -> bool:
        return all(e.is_set() for e in self._events)

    def wait(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        for e in self._events:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            if not e.wait(left):
                return False
        return True


class FleetSyncEvent(MultiEvent):
    """Fleet-wide staged sync that tolerates replica death: set once every
    replica has acknowledged OR died — a crashed replica serves no traffic,
    so waiting for its ack would only deadlock the trainer.

    Push-based: each per-replica ``NotifyingEvent`` ack and every router
    death/retire event notifies this waiter's condition, so ``wait`` parks
    instead of polling.  For monitor-less fleets (nothing else would ever
    call ``mark_dead``) each wakeup also re-probes fleet health — on a
    bounded fallback cadence, not a busy spin."""

    # how long wait() parks between fallback health probes when no
    # notification arrives (monitor-less death detection latency bound)
    _PROBE_SLICE_S = 0.05

    def __init__(self, pairs: List[tuple], router: "ProxyRouter"):
        super().__init__([e for _, e in pairs])
        self._pairs = list(pairs)
        self._router = router
        self._cond = new_condition(name="FleetSyncEvent._cond")
        for _i, e in pairs:
            subscribe = getattr(e, "on_set", None)
            if subscribe is not None:    # raw Events (test doubles) fall
                subscribe(self._notify)  # back to the probe cadence
        router._watch_sync(self)

    def _notify(self) -> None:
        """Ack/death push — called from proxy-loop and router threads,
        never with ProxyRouter._lock held."""
        with self._cond:
            self._cond.notify_all()

    def _acked(self) -> bool:
        """All replicas acknowledged (no death waiver needed) — this
        waiter needs no further notifications."""
        return MultiEvent.is_set(self)

    def is_set(self) -> bool:
        down = self._router._down()
        return all(e.is_set() or i in down for i, e in self._pairs)

    def wait(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.is_set():
                return True
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                return False
            # fallback probe OUTSIDE _cond: mark_dead notifies waiters
            self._router.probe_health()
            left = (self._PROBE_SLICE_S if deadline is None
                    else min(self._PROBE_SLICE_S, deadline - time.monotonic()))
            if left <= 0:
                continue
            with self._cond:
                if not self.is_set():
                    self._cond.wait(left)


@dataclasses.dataclass
class AutoscalePolicy:
    """Load-triggered elasticity knobs (hysteresis by consecutive-tick
    patience + post-action cooldown so load breathing doesn't flap).

    Scale up when fleet queue depth exceeds ``queue_high`` pending requests
    per live replica for ``up_patience`` consecutive ticks; scale down when
    slot utilization sits below ``active_low`` with an empty queue for
    ``down_patience`` ticks (the victim drains first, retiring only once
    idle — in-flight work is never killed by the autoscaler)."""
    min_replicas: int = 1
    max_replicas: int = 8
    queue_high: float = 4.0      # pending per live replica → scale up
    active_low: float = 0.25     # active/slot utilization → scale down
    up_patience: int = 2
    down_patience: int = 3
    cooldown: int = 2            # ticks after any action with no new action


class _IndexNode:
    """One page-granular node of the fleet index: which replicas cache the
    page whose content address is the path to this node."""
    __slots__ = ("children", "replicas")

    def __init__(self):
        self.children: Dict[tuple, "_IndexNode"] = {}
        self.replicas: set = set()


class _ReplicaCacheListener:
    """Adapter bound to one replica: forwards its ``RadixCache``
    insert/evict/clear events into the router's fleet index.  Fires on the
    replica's loop thread; the index does its own locking."""
    __slots__ = ("index", "idx")

    def __init__(self, index: "FleetRadixIndex", idx: int):
        self.index = index
        self.idx = idx

    def on_insert(self, path: tuple) -> None:
        self.index.on_insert(self.idx, path)

    def on_evict(self, path: tuple) -> None:
        self.index.on_evict(self.idx, path)

    def on_clear(self) -> None:
        self.index.on_clear(self.idx)


class FleetRadixIndex:
    """Router-owned map of token-content prefixes → the replicas caching
    them: the fleet-global view of every replica's local radix prefix
    cache, maintained push-style from insert/evict/clear events.

    Content-addressed exactly like ``RadixCache``: one node per full page,
    keyed by that page's token tuple, so ``best_prefix`` answers "who holds
    the longest cached prefix of this prompt" in one walk.  Placement uses
    it for the cache-affinity tier and for picking pull sources.  The index
    holds NO page references — it is purely a map, kept honest against the
    local trees by ``fleet_audit``.

    Every method takes only the index's own lock and never calls out under
    it; see the declared ``ProxyRouter._lock -> FleetRadixIndex._lock``
    edge for how it composes with placement."""

    def __init__(self):
        self._lock = new_lock("FleetRadixIndex._lock")
        self._root = _IndexNode()          # guarded-by: _lock
        # all replicas of a fleet share one page size; recorded at attach
        self.page_size: Optional[int] = None
        self.inserts = 0                   # guarded-by: _lock
        self.evictions = 0                 # guarded-by: _lock
        self.clears = 0                    # guarded-by: _lock

    # ------------------------------------------------------ event ingestion
    def on_insert(self, replica: int, path: tuple) -> None:
        with self._lock:
            node = self._root
            for key in path:
                child = node.children.get(key)
                if child is None:
                    child = _IndexNode()
                    node.children[key] = child
                node = child
            node.replicas.add(replica)
            self.inserts += 1

    def on_evict(self, replica: int, path: tuple) -> None:
        with self._lock:
            chain = [self._root]
            node = self._root
            for key in path:
                node = node.children.get(key)
                if node is None:
                    return
                chain.append(node)
            node.replicas.discard(replica)
            self.evictions += 1
            # prune replica-less childless tails: the index tracks the
            # union of live caches, not their history
            for i in range(len(chain) - 1, 0, -1):
                n = chain[i]
                if n.children or n.replicas:
                    break
                del chain[i - 1].children[path[i - 1]]

    def on_clear(self, replica: int) -> None:
        with self._lock:
            self._scrub(self._root, replica)
            self.clears += 1

    def drop_replica(self, replica: int) -> None:
        """Forget everything a dead/retired replica cached."""
        with self._lock:
            self._scrub(self._root, replica)

    def _scrub(self, node: _IndexNode, replica: int) -> None:
        # holds: _lock
        for key in list(node.children):
            child = node.children[key]
            child.replicas.discard(replica)
            self._scrub(child, replica)
            if not child.replicas and not child.children:
                del node.children[key]

    # -------------------------------------------------------------- queries
    def best_prefix(self, tokens) -> Dict[int, int]:
        """replica → cached prefix length in TOKENS (page-aligned) for this
        prompt.  Each replica reports the deepest node it holds along the
        walk; replicas caching nothing of the prompt are absent."""
        ps = self.page_size
        if ps is None:
            return {}
        out: Dict[int, int] = {}
        with self._lock:
            node = self._root
            for i in range(len(tokens) // ps):
                key = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                node = node.children.get(key)
                if node is None:
                    break
                for r in node.replicas:
                    out[r] = (i + 1) * ps
        return out

    def paths_for(self, replica: int) -> set:
        """Every content path the index attributes to ``replica`` — the
        ``fleet_audit`` cross-check against the replica's local tree."""
        out: set = set()
        with self._lock:
            stack: List[tuple] = [(self._root, ())]
            while stack:
                node, prefix = stack.pop()
                for key, child in node.children.items():
                    p = prefix + (key,)
                    if replica in child.replicas:
                        out.add(p)
                    stack.append((child, p))
        return out


@dataclasses.dataclass
class _Home:
    """Per-request routing record: where it lives, and everything needed
    to synthesize its failover abort if that replica dies."""
    idx: int
    callback: Callable[[GenerationResult], None]
    version: int
    retained: bool = False       # parked pages (abort-with-retain victim)


class ProxyRouter:
    """N proxy/engine replicas behind the single-proxy protocol.

    ``migrate_factor`` / ``migrate_margin_tokens`` bound when an
    aborted-with-retain request migrates instead of resuming in place: the
    home replica must carry more than ``factor * min_load + margin``
    outstanding tokens (or be draining/dead).  In-place resume re-attaches
    retained pages at zero prefill cost, so migration has to buy real
    rebalancing to be worth a concatenated re-prefill.

    ``replica_factory`` builds a fresh proxy for ``add_replica()`` /
    autoscale scale-up; ``autoscale`` arms the load-triggered policy
    (ticked by the health monitor, or manually via ``autoscale_tick``).
    """

    def __init__(self, proxies: List[LLMProxy], *,
                 migrate_factor: float = 2.0,
                 migrate_margin_tokens: int = 128,
                 replica_factory: Optional[Callable[[], LLMProxy]] = None,
                 autoscale: Optional[AutoscalePolicy] = None,
                 slo: Optional[SLOConfig] = None,
                 cache_aware: bool = False,
                 cache_affinity_slack: int = 256,
                 cache_pull: bool = True,
                 page_transfer: bool = True):
        assert proxies, "router needs at least one replica"
        self.proxies = list(proxies)
        self.migrate_factor = migrate_factor
        self.migrate_margin_tokens = migrate_margin_tokens
        self.replica_factory = replica_factory
        self.autoscale = autoscale
        # cache-aware routing: a fleet-global prefix index makes placement
        # two-tier (affinity within the slack band, else least-loaded with
        # an optional prefix pull); page_transfer moves retained pages on
        # migration instead of re-prefilling the concatenated prompt.
        self.cache_aware = cache_aware
        self.cache_affinity_slack = cache_affinity_slack
        self.cache_pull = cache_pull
        self.page_transfer = page_transfer
        self.fleet_index: Optional[FleetRadixIndex] = \
            FleetRadixIndex() if cache_aware else None
        # SLO front door: queue bounds are enforced HERE fleet-wide (the
        # replicas behind a router carry an admission-stripped copy — see
        # slo.without_admission); preemption/watchdog run on the replicas.
        self.slo = slo
        self._lock = new_rlock("ProxyRouter._lock")
        self._home: Dict[int, _Home] = {}      # guarded-by: _lock — request_id -> routing record
        # requests whose callback resolved BEFORE _register could record
        # them (submit→resolve race on the proxy loop thread): _register
        # must not re-insert a mapping nobody will ever remove.
        self._early_resolved: set = set()      # guarded-by: _lock
        # rids resolved by a synthesized failover abort: a late real
        # callback from the (not-quite-dead-yet) replica must be dropped,
        # not forwarded — the failover leg already owns the handle.
        self._failed_over: set = set()         # guarded-by: _lock
        # retained rids whose parked pages died with their replica: the
        # continuation must re-prefill elsewhere, never resume in place.
        self._lost_retained: set = set()       # guarded-by: _lock
        self._group_home: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()          # guarded-by: _lock
        self._session_home: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()          # guarded-by: _lock
        self._draining: set = set()            # guarded-by: _lock
        self._dead: set = set()                # guarded-by: _lock — crashed
        self._retired: set = set()             # guarded-by: _lock — scaled down cleanly
        self._scaledown_pending: set = set()   # guarded-by: _lock — draining toward retirement
        self._started = False                  # guarded-by: _lock
        self._last_weights = None              # guarded-by: _lock — warm-start for add_replica
        # in-flight FleetSyncEvents to poke (OUTSIDE _lock) on death/retire
        self._sync_waiters: List["FleetSyncEvent"] = []  # guarded-by: _lock
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        # replica-stall detection: idx -> (steps_executed, wall time seen)
        self._progress: Dict[int, tuple] = {}  # guarded-by: _lock
        self._rejected = 0                     # guarded-by: _lock — front-door bounces
        # autoscale streaks are ticked by exactly one thread (the health
        # monitor, or manual autoscale_tick callers) — thread-owned, unlocked.
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0
        self.routed = 0                        # guarded-by: _lock
        self.migrations = 0                    # guarded-by: _lock
        self.failovers = 0                     # guarded-by: _lock — handles failed over off dead replicas
        self.lost_tokens = 0                   # guarded-by: _lock — decode progress lost to crashes
        self.replicas_failed = 0               # guarded-by: _lock
        self.replicas_added = 0                # guarded-by: _lock
        self.scale_ups = 0                     # guarded-by: _lock
        self.scale_downs = 0                   # guarded-by: _lock
        self.cache_routed = 0                  # guarded-by: _lock — affinity-tier placements
        self.cache_pulls = 0                   # guarded-by: _lock — prefix pulls initiated
        self.pages_transferred = 0             # guarded-by: _lock — cross-replica pages moved
        self.transfer_bytes = 0                # guarded-by: _lock
        if self.fleet_index is not None:
            for i, p in enumerate(self.proxies):
                self._attach_index(i, p)

    def _attach_index(self, idx: int, proxy) -> None:
        """Subscribe the fleet index to a replica's radix-cache events —
        and seed it with anything already cached (warm ``add_replica``)."""
        if self.fleet_index is None:
            return
        cache = getattr(getattr(proxy, "engine", None), "prefix_cache", None)
        if cache is None or not hasattr(cache, "paths"):
            return
        self.fleet_index.page_size = cache.page_size
        cache.listener = _ReplicaCacheListener(self.fleet_index, idx)
        for path in cache.paths():
            self.fleet_index.on_insert(idx, path)

    # ---------------------------------------------------------- lifecycle
    def _down(self) -> set:
        with self._lock:
            return self._dead | self._retired

    def _watch_sync(self, ev: "FleetSyncEvent") -> None:
        """Track an in-flight fleet sync so death/retire events can wake
        its waiters push-style.  Fully-acked syncs are pruned here (an
        abandoned, never-fully-acked sync lingers until the next sync —
        bounded by sync cadence, not by fleet lifetime)."""
        with self._lock:
            self._sync_waiters = [w for w in self._sync_waiters
                                  if not w._acked()]
            self._sync_waiters.append(ev)

    def _notify_sync_waiters(self) -> None:
        """Wake every in-flight fleet sync.  MUST be called outside
        ``_lock``: FleetSyncEvent re-checks ``is_set()`` (→ ``_down()``)
        under its own condition, so notifying under the router lock would
        invert the declared FleetSyncEvent._cond -> ProxyRouter._lock
        order."""
        with self._lock:
            waiters = list(self._sync_waiters)
        for w in waiters:
            w._notify()

    def replica_state(self, idx: int) -> str:
        with self._lock:
            if idx in self._dead:
                return "dead"
            if idx in self._retired:
                return "retired"
            if idx in self._draining:
                return "draining"
            return "healthy"

    @property
    def replicas_alive(self) -> int:
        with self._lock:
            return len(self.proxies) - len(self._dead) - len(self._retired)

    def _live(self) -> List[int]:
        """Replicas that can still execute work (healthy or draining)."""
        down = self._down()
        return [i for i in range(len(self.proxies)) if i not in down]

    def probe_health(self) -> List[int]:
        """Heartbeat sweep: ask every live replica ``healthy()``; mark the
        ones that fail (or raise) dead and fail their work over.  Returns
        the newly dead indices."""
        newly: List[int] = []
        for i in self._live():
            p = self.proxies[i]
            probe = getattr(p, "healthy", None)
            try:
                ok = probe() if probe is not None else True
            except Exception:
                ok = False
            if not ok:
                self.mark_dead(i)
                newly.append(i)
        if self.slo is not None and self.slo.replica_stall_s:
            newly.extend(self._probe_stalls())
        return newly

    def _probe_stalls(self) -> List[int]:
        """Hang detection: a replica that still answers ``healthy()`` but
        whose ``steps_executed`` counter has not moved for
        ``slo.replica_stall_s`` WALL-CLOCK seconds while it holds active
        work is wedged (hung engine loop, stuck collective) — declare it
        dead and fail its handles over like a crash.  Idle replicas are
        exempt: no active work, nothing to step."""
        grace = self.slo.replica_stall_s
        now = time.monotonic()
        newly: List[int] = []
        for i in self._live():
            p = self.proxies[i]
            try:
                active = p.num_active
                steps = p.steps_executed
            except Exception:
                continue        # liveness probe above owns hard failures
            with self._lock:
                if active <= 0:
                    self._progress.pop(i, None)
                    continue
                prev = self._progress.get(i)
                if prev is None or prev[0] != steps:
                    self._progress[i] = (steps, now)
                    continue
                stalled = now - prev[1] >= grace
                if stalled:
                    self._progress.pop(i, None)
            if stalled:         # mark_dead fires callbacks: outside _lock
                self.mark_dead(i)
                newly.append(i)
        return newly

    def mark_dead(self, idx: int) -> None:
        """Crash handling — the paper's queue-scheduling gains assume the
        dispatcher always has healthy workers; this is what keeps that true.

        Every in-flight request homed on the dead replica fails over: its
        consumer callback receives a synthesized non-resumable abort, which
        the RolloutClient continuation answers by re-admitting the
        concatenated prefix (original prompt + completed legs) on a live
        replica — exactly-once resolution, nothing completed is lost.
        Retained (parked-pages) victims are remembered in
        ``_lost_retained`` so their continuation migrates instead of
        resuming into pages that no longer exist."""
        with self._lock:
            if idx in self._dead or idx in self._retired:
                return
            self._dead.add(idx)
            self._draining.discard(idx)
            self._scaledown_pending.discard(idx)
            self.replicas_failed += 1
            if self.fleet_index is not None:
                self.fleet_index.drop_replica(idx)
            fail: List[tuple] = []
            for rid, rec in list(self._home.items()):
                if rec.idx != idx:
                    continue
                del self._home[rid]
                self._failed_over.add(rid)
                if rec.retained:
                    self._lost_retained.add(rid)
                else:
                    fail.append((rid, rec))
        # decode progress that died with the replica (sim-measurable hook)
        counts: Dict[int, int] = {}
        dc = getattr(self.proxies[idx], "decoded_counts", None)
        if dc is not None:
            try:
                counts = dc()
            except Exception:
                counts = {}
        with self._lock:
            self.failovers += len(fail)
            for rid, _rec in fail:
                self.lost_tokens += int(counts.get(rid, 0))
        for rid, rec in fail:   # consumer callbacks run OUTSIDE _lock
            rec.callback(GenerationResult(
                request_id=rid, task=None, tokens=None, logprobs=None,
                version_started=rec.version, aborted=True, partial=True,
                resumable=False))
        # a dead replica's pending ack is waived: wake in-flight syncs
        self._notify_sync_waiters()

    def add_replica(self, proxy: Optional[LLMProxy] = None, *,
                    warm: bool = True) -> int:
        """Grow the fleet mid-run (the reverse of ``drain``): append a
        replica, warm it with the last-synced weights BEFORE it takes
        traffic (a cold replica would serve the initial policy), and start
        its loop if the fleet is running.  Returns the new index."""
        if proxy is None:
            if self.replica_factory is None:
                raise RuntimeError("add_replica() needs a proxy or a "
                                   "replica_factory")
            proxy = self.replica_factory()
        with self._lock:
            weights = self._last_weights
        if warm and weights is not None:
            # pre-start staging applies inline; a started proxy stages the
            # swap and we wait for the ack so no request sees cold weights.
            proxy.update_weights_async(weights).wait(timeout=30)
        with self._lock:
            idx = len(self.proxies)
            self.proxies.append(proxy)
            self.replicas_added += 1
            started = self._started
        self._attach_index(idx, proxy)
        if started:
            proxy.start()
        return idx

    def _retire(self, idx: int) -> None:
        """Finish a scale-down: the drained replica stops and leaves the
        placement set for good (distinct from ``dead`` — not a failure)."""
        with self._lock:
            if idx in self._retired or idx in self._dead:
                return
            self._retired.add(idx)
            self._draining.discard(idx)
            self._scaledown_pending.discard(idx)
            self.scale_downs += 1
            if self.fleet_index is not None:
                self.fleet_index.drop_replica(idx)
        self.proxies[idx].stop()
        self._notify_sync_waiters()     # retired == down for sync waivers

    # --------------------------------------------------------- autoscaling
    def autoscale_tick(self) -> Optional[str]:
        """One observation of the load-triggered policy: retire drained
        scale-down victims, then scale up/down when the patience streaks
        cross their thresholds (no action during cooldown).  Returns
        "up" | "down" | None for observability."""
        pol = self.autoscale
        if pol is None:
            return None
        with self._lock:
            pending_retire = list(self._scaledown_pending)
            draining = set(self._draining)
        for i in pending_retire:
            p = self.proxies[i]
            if p.num_active == 0 and p.num_pending == 0 and p.load() == 0:
                self._retire(i)
        live = self._live()
        n = len(live)
        queue = sum(self.proxies[i].num_pending for i in live)
        active = sum(self.proxies[i].num_active for i in live)
        capacity = sum(self.proxies[i].num_active
                       + self.proxies[i].engine.num_free_slots for i in live)
        util = active / capacity if capacity else 0.0
        self._up_streak = (self._up_streak + 1
                           if n and queue > pol.queue_high * n else 0)
        self._down_streak = (self._down_streak + 1
                             if queue == 0 and util < pol.active_low else 0)
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        placeable = [i for i in live if i not in draining]
        if (self._up_streak >= pol.up_patience and n < pol.max_replicas
                and self.replica_factory is not None):
            self.add_replica()
            with self._lock:
                self.scale_ups += 1
            self._up_streak = 0
            self._cooldown = pol.cooldown
            return "up"
        if (self._down_streak >= pol.down_patience
                and len(placeable) > pol.min_replicas):
            # drain the least-loaded placeable replica; it retires on a
            # later tick once its in-flight work finishes.
            victim = min(placeable, key=lambda i: (self.proxies[i].load(), -i))
            with self._lock:
                self._draining.add(victim)
                self._scaledown_pending.add(victim)
            self._down_streak = 0
            self._cooldown = pol.cooldown
            return "down"
        return None

    def start_health_monitor(self, interval: float = 0.02) -> None:
        """Background heartbeat: probe fleet health (and tick the
        autoscaler) every ``interval`` seconds until ``stop()``."""
        if self._monitor is not None:
            return
        self._monitor_stop.clear()      # restart after a previous stop()

        def loop():
            while not self._monitor_stop.wait(interval):
                self.probe_health()
                self.autoscale_tick()
        self._monitor = threading.Thread(target=loop, name="fleet_health",
                                         daemon=True)
        self._monitor.start()

    # ---------------------------------------------------------- placement
    def _alive(self) -> List[int]:
        with self._lock:                # RLock: reentrant from _place
            down = self._dead | self._retired
            idxs = [i for i in range(len(self.proxies))
                    if i not in down and i not in self._draining]
            if idxs:
                return idxs
            # every live replica draining: they can still run work
            idxs = [i for i in range(len(self.proxies)) if i not in down]
        if not idxs:
            raise RuntimeError("no live replicas in the fleet")
        return idxs

    @staticmethod
    def _pin(pins: "collections.OrderedDict", key, idx: int) -> None:
        pins[key] = idx
        pins.move_to_end(key)
        while len(pins) > _MAX_PINS:
            pins.popitem(last=False)

    def _place(self, task: RolloutTask, *,
               exclude: Optional[int] = None) -> int:
        return self._place_with_pull(task, exclude=exclude)[0]

    def _place_with_pull(self, task: RolloutTask, *,
                         exclude: Optional[int] = None) -> tuple:
        """Pick the replica for a new submission: sessions stay where
        their radix-cached history lives, GRPO groups stay co-located,
        everything else goes least-outstanding-tokens.  A pin is honored
        only while the pinned replica can still EVER take the request —
        a session whose conversation outgrew its home's capacity (or whose
        home died) re-places (and re-pins) instead of queueing there.

        With ``cache_aware``, unpinned placement is two-tier: the replica
        holding the request's longest indexed prefix wins while its load
        is within ``cache_affinity_slack`` tokens of the fleet minimum;
        otherwise least-loaded wins and the second element of the returned
        ``(idx, pull_src)`` names a replica whose cached prefix should be
        pulled to ``idx`` before admission (None = no pull)."""
        plen = len(task.prompt_tokens)
        with self._lock:
            down = self._dead | self._retired
            sid = task.meta.get("session_id")
            if sid is not None:
                idx = self._session_home.get(sid)
                if idx is not None and idx not in self._draining \
                        and idx not in down and idx != exclude \
                        and self.proxies[idx].can_accept(
                            plen, task.max_new_tokens):
                    self.routed += 1
                    return idx, None
            gid = task.group_id
            if gid is not None and gid >= 0:
                idx = self._group_home.get(gid)
                if idx is not None and idx not in self._draining \
                        and idx not in down and idx != exclude \
                        and self.proxies[idx].can_accept(
                            plen, task.max_new_tokens):
                    self.routed += 1
                    return idx, None
            cands = [i for i in self._alive()
                     if self.proxies[i].can_accept(plen,
                                                   task.max_new_tokens)]
            if exclude is not None and len(cands) > 1:
                cands = [i for i in cands if i != exclude]
            if not cands:
                raise ValueError(
                    f"no replica can accept prompt_len={plen} "
                    f"max_new_tokens={task.max_new_tokens} (fleet of "
                    f"{len(self.proxies)}; shard capacity too small?)")
            pull_src: Optional[int] = None
            prefix: Dict[int, int] = {}
            if self.fleet_index is not None and plen > 1:
                # admission matches at most plen-1 tokens (the final token
                # always prefills for first logits) — query the same span
                prefix = self.fleet_index.best_prefix(
                    task.prompt_tokens[:plen - 1])
            if prefix:
                min_load = min(self.proxies[i].load() for i in cands)
                band = min_load + self.cache_affinity_slack
                affine = [i for i in cands if prefix.get(i, 0) > 0
                          and self.proxies[i].load() <= band]
                if affine:
                    # longest cached prefix wins inside the slack band
                    idx = max(affine, key=lambda i: (
                        prefix[i], -self.proxies[i].load(), -i))
                    self.cache_routed += 1
                else:
                    idx = min(cands, key=lambda i: (self.proxies[i].load(), i))
                    if self.cache_pull:
                        have = prefix.get(idx, 0)
                        srcs = [(n, -i) for i, n in prefix.items()
                                if i != idx and i not in down and n > have]
                        if srcs:
                            pull_src = -max(srcs)[1]
                            self.cache_pulls += 1
            else:
                idx = min(cands, key=lambda i: (self.proxies[i].load(), i))
            if sid is not None:
                self._pin(self._session_home, sid, idx)
            if gid is not None and gid >= 0:
                self._pin(self._group_home, gid, idx)
            self.routed += 1
            return idx, pull_src

    def _register(self, idx: int, rids, callback: Callable,
                  version: int) -> None:
        stranded: List[tuple] = []
        with self._lock:
            down = self._dead | self._retired
            for rid in (rids if isinstance(rids, list) else [rids]):
                if rid in self._early_resolved:
                    self._early_resolved.discard(rid)   # already resolved
                elif rid in self._home:
                    self._home[rid].idx = idx   # retained re-insert won race
                else:
                    rec = _Home(idx, callback, version)
                    if idx in down:
                        # the replica died between the dispatch liveness
                        # check and this registration: mark_dead already
                        # swept the map, so nobody else will fail this rid
                        # over — do it here or the handle hangs forever.
                        self._failed_over.add(rid)
                        stranded.append((rid, rec))
                    else:
                        self._home[rid] = rec
        if stranded:
            with self._lock:
                self.failovers += len(stranded)
        for rid, rec in stranded:   # callbacks OUTSIDE _lock
            rec.callback(GenerationResult(
                request_id=rid, task=None, tokens=None, logprobs=None,
                version_started=rec.version, aborted=True, partial=True,
                resumable=False))

    def _tracked(self, idx: int, callback: Callable,
                 version: int = 0) -> Callable:
        """Wrap the consumer callback so the rid→replica map follows each
        request's life: dropped on resolution, kept while retained pages
        park on the replica (resume/release must find them).  A request
        resolving before ``_register`` runs (the proxy loop won the race)
        is remembered so registration doesn't leave a stale entry; a
        result arriving AFTER the rid was failed over is dropped — the
        synthesized failover abort already owns the handle."""
        def cb(res: GenerationResult) -> None:
            with self._lock:
                if res.request_id in self._failed_over:
                    self._failed_over.discard(res.request_id)
                    return
                if res.aborted and res.resumable:
                    rec = self._home.get(res.request_id)
                    if rec is not None:
                        rec.retained = True
                    else:
                        self._home[res.request_id] = _Home(
                            idx, callback, res.version_started, retained=True)
                elif self._home.pop(res.request_id, None) is None:
                    self._early_resolved.add(res.request_id)
            callback(res)
        return cb

    # --------------------------------------------------- admission control
    def _admit_or_reject(self, task: RolloutTask, n: int, version: int,
                         callback: Callable) -> Optional[List[int]]:
        """Fleet front door.  Stamps the absolute deadline, then either
        admits (returns None) or resolves the submission immediately with a
        typed ``Rejected`` (returns the rejected ids, callbacks already
        fired) — expired deadline, per-class bound, or total bound with
        nothing lower-priority left to shed.  Queue depths are lock-free
        snapshots, so bounds are approximate under concurrent submitters:
        a few requests over, never silent unbounded queueing."""
        slo = self.slo
        if slo is None:
            return None
        now = slo.clock()
        deadline_at = stamp_deadline(task, now)
        priority = getattr(task, "priority", PRIORITY_NORMAL)
        reason = None
        if slo.shed_expired and deadline_at is not None and now >= deadline_at:
            reason = "expired"
        if reason is None and slo.queue_limit_per_class is not None:
            depth = self.queue_depth_by_class.get(priority, 0)
            if depth + n > slo.queue_limit_per_class:
                reason = "queue_full"
        if reason is None and slo.queue_limit_total is not None:
            if self.num_pending + n > slo.queue_limit_total:
                if not self._shed_below(priority, n):
                    reason = "queue_full"
        if reason is None:
            return None
        with self._lock:
            self._rejected += n
        rejected_ids: List[int] = []
        for t in (expand_replicas(task, n) if n > 1 else [task]):
            rejected_ids.append(t.task_id)
            callback(Rejected(request_id=t.task_id, task=t, tokens=None,
                              logprobs=None, version_started=version,
                              aborted=True, partial=True, reason=reason))
        return rejected_ids

    def _shed_below(self, priority: int, n: int) -> bool:
        """Make room at the total bound: shed up to ``n`` queued requests
        of strictly lower priority, deepest-queued replicas first.  Returns
        True if any shed was issued (the arrival is then admitted — the
        shed lands asynchronously on the replica loop)."""
        shed = 0
        order = sorted(self._live(),
                       key=lambda i: -self.proxies[i].num_pending)
        for i in order:
            by_class = getattr(self.proxies[i], "pending_by_priority", None)
            if by_class is None or not hasattr(self.proxies[i], "shed_lowest"):
                continue
            lower = sum(c for p, c in by_class.items() if p < priority)
            while lower > 0 and shed < n:
                self.proxies[i].shed_lowest(priority)
                lower -= 1
                shed += 1
            if shed >= n:
                break
        return shed > 0

    # ------------------------------------------------------ proxy protocol
    def generate(self, task: RolloutTask, version: int,
                 callback: Callable[[GenerationResult], None],
                 stream_cb: Optional[Callable] = None):
        n = int(task.meta.get("num_return_sequences", 1))
        rejected_ids = self._admit_or_reject(task, n, version, callback)
        if rejected_ids is not None:
            return rejected_ids if n > 1 else rejected_ids[0]
        kw = {"stream_cb": stream_cb} if stream_cb is not None else {}
        while True:
            idx, pull_src = self._place_with_pull(task)
            if pull_src is not None:
                self._execute_pull(pull_src, idx, task.prompt_tokens)
            try:
                rids = self.proxies[idx].generate(
                    task, version, self._tracked(idx, callback, version),
                    **kw)
            except ReplicaDeadError:
                self.mark_dead(idx)     # stale probe: detected at dispatch
                continue
            self._register(idx, rids, callback, version)
            return rids

    def _execute_pull(self, src: int, dst: int, tokens) -> None:
        """Pull ``src``'s cached prefix pages for ``tokens`` into ``dst``'s
        radix cache ahead of the request's admission there.  Best-effort on
        both sides: the source exports whatever it still caches and the
        target skips the import under page pressure or across a weight
        epoch — and with threaded loops a pull landing mid-prefill is still
        adopted at the next page boundary (the engine's cached-prefix
        extension probe).  Runs OUTSIDE the router lock; ``deliver`` fires
        on the source's loop thread."""
        export = getattr(self.proxies[src], "export_prefix", None)
        imp = getattr(self.proxies[dst], "import_prefix", None)
        if export is None or imp is None:
            return

        def deliver(record: Optional[dict]) -> None:
            if record is None:
                return
            try:
                imp(record)
            except ReplicaDeadError:
                return
            t = record["transfer"]
            with self._lock:
                self.pages_transferred += t.num_pages
                self.transfer_bytes += t.nbytes

        try:
            export(tokens, deliver)
        except ReplicaDeadError:
            self.mark_dead(src)

    def generate_group(self, tasks: List[RolloutTask], version: int,
                       callback: Callable[[GenerationResult], None]) -> List[int]:
        assert tasks, "empty group"
        if self.slo is not None:
            slo, now = self.slo, self.slo.clock()
            for t in tasks:
                stamp_deadline(t, now)
            t0 = tasks[0]
            priority = getattr(t0, "priority", PRIORITY_NORMAL)
            reason = None
            deadline_at = t0.meta.get("deadline_at")
            if slo.shed_expired and deadline_at is not None \
                    and now >= deadline_at:
                reason = "expired"
            if reason is None and slo.queue_limit_per_class is not None \
                    and self.queue_depth_by_class.get(priority, 0) \
                    + len(tasks) > slo.queue_limit_per_class:
                reason = "queue_full"
            if reason is None and slo.queue_limit_total is not None \
                    and self.num_pending + len(tasks) > slo.queue_limit_total \
                    and not self._shed_below(priority, len(tasks)):
                reason = "queue_full"
            if reason is not None:
                with self._lock:
                    self._rejected += len(tasks)
                for t in tasks:
                    callback(Rejected(
                        request_id=t.task_id, task=t, tokens=None,
                        logprobs=None, version_started=version,
                        aborted=True, partial=True, reason=reason))
                return [t.task_id for t in tasks]
        while True:
            idx = self._place(tasks[0])
            try:
                rids = self.proxies[idx].generate_group(
                    tasks, version, self._tracked(idx, callback, version))
            except ReplicaDeadError:
                self.mark_dead(idx)
                continue
            self._register(idx, rids, callback, version)
            return rids

    def generate_resumed(self, task: RolloutTask, version: int,
                         callback: Callable[[GenerationResult], None],
                         resume_from: int,
                         stream_cb: Optional[Callable] = None) -> int:
        """Resume ALWAYS lands on the replica holding the retained pages —
        they cannot re-attach anywhere else, so an unknown ``resume_from``
        is a caller bug and fails loudly (routed blind, the request would
        pend forever on a replica whose ``can_resume`` never passes).
        (Migration goes through ``generate_migrated`` instead.)  A home
        replica found dead here raises ``ReplicaDeadError`` — the client
        falls back to the concatenated re-prefill path."""
        with self._lock:
            rec = self._home.get(resume_from)
        if rec is None:
            raise ValueError(f"resume_from={resume_from} has no retained "
                             "pages on any replica known to this router")
        idx = rec.idx
        kw = {"stream_cb": stream_cb} if stream_cb is not None else {}
        try:
            rid = self.proxies[idx].generate_resumed(
                task, version, self._tracked(idx, callback, version),
                resume_from=resume_from, **kw)
        except ReplicaDeadError:
            self.mark_dead(idx)
            raise
        with self._lock:
            self._home.pop(resume_from, None)
        self._register(idx, rid, callback, version)
        return rid

    # ------------------------------------------------- resume migration
    def prefer_resume(self, resume_from: int, remaining: int) -> bool:
        """Continuation-placement feedback for the RolloutClient: True →
        resume in place (retained pages re-attach, zero re-prefill);
        False → the home replica is draining, dead, or overloaded enough
        that a concatenated re-prefill on another replica wins."""
        with self._lock:
            if resume_from in self._lost_retained:
                return False            # pages died with the replica
            rec = self._home.get(resume_from)
            if rec is None or len(self.proxies) == 1:
                return True
            idx = rec.idx
            if idx in self._draining or idx in self._dead \
                    or idx in self._retired:
                return False
            others = [i for i in self._alive() if i != idx]
        if not others:
            return True
        home_load = self.proxies[idx].load()
        low = min(self.proxies[i].load() for i in others)
        return home_load <= self.migrate_factor * low + self.migrate_margin_tokens

    def generate_migrated(self, task: RolloutTask, version: int,
                          callback: Callable[[GenerationResult], None],
                          release_from: int,
                          stream_cb: Optional[Callable] = None) -> int:
        """Cross-replica abort→resume migration, zero-re-prefill where
        possible.  The home replica's parked pages are exported to a
        host-side record, the target imports them and resumes the request
        in place — no token of the decoded prefix is recomputed.  When the
        transfer can't run (home dead/lost, loop-thread ownership, or the
        target rejects the import under page pressure / quant mismatch)
        the flow degrades to the previous behavior: route the client-built
        concatenated re-prefill (``task`` carries it in full) and let the
        target's radix cache make any previously seen prefix incremental.
        A migrated session re-pins to the target so its later turns find
        the freshly cached context.

        Placement is confirmed BEFORE the parked pages are released: when
        no replica can take the (grown) concatenated prompt this raises
        with the pages still retained, and the RolloutClient falls back to
        resuming in place.  The export is a host-side COPY, so releasing
        home's pages right after placement is safe regardless of when the
        target processes the import.  Pages that died with a crashed
        replica (``_lost_retained``) have nothing left to export or
        release."""
        with self._lock:
            rec = self._home.get(release_from)
            home = rec.idx if rec is not None else None
            lost_now = release_from in self._lost_retained
        record = None
        if (self.page_transfer and home is not None and not lost_now
                and home not in self._down()):
            export = getattr(self.proxies[home], "export_retained", None)
            if export is not None:
                try:
                    record = export(release_from)
                except ReplicaDeadError:
                    self.mark_dead(home)
                    record = None
        idx = self._place(task, exclude=home)     # may raise: nothing freed
        with self._lock:
            self._home.pop(release_from, None)
            lost = release_from in self._lost_retained
            self._lost_retained.discard(release_from)
        if home is not None and not lost and home not in self._down():
            try:
                self.proxies[home].release_retained(release_from)
            except ReplicaDeadError:
                self.mark_dead(home)
        with self._lock:
            sid = task.meta.get("session_id")
            if sid is not None:
                self._pin(self._session_home, sid, idx)
            gid = task.group_id
            if gid is not None and gid >= 0:
                self._pin(self._group_home, gid, idx)
            self.migrations += 1
        kw = {"stream_cb": stream_cb} if stream_cb is not None else {}
        while True:
            try:
                transferred = getattr(self.proxies[idx],
                                      "generate_transferred", None)
                if record is not None and transferred is not None:
                    rid = transferred(
                        task, version, self._tracked(idx, callback, version),
                        record=record, resume_from=release_from, **kw)
                    t = record["transfer"]
                    with self._lock:
                        self.pages_transferred += t.num_pages
                        self.transfer_bytes += t.nbytes
                else:
                    rid = self.proxies[idx].generate(
                        task, version, self._tracked(idx, callback, version),
                        **kw)
            except ReplicaDeadError:
                self.mark_dead(idx)
                idx = self._place(task, exclude=home)
                continue
            self._register(idx, rid, callback, version)
            return rid

    # ------------------------------------------------------------- control
    def abort(self, request_id: int, retain: bool = False) -> None:
        with self._lock:
            rec = self._home.get(request_id)
        if rec is not None:
            if rec.idx in self._down():
                return                  # already failed over / pages gone
            try:
                self.proxies[rec.idx].abort(request_id, retain=retain)
            except ReplicaDeadError:
                self.mark_dead(rec.idx)
            return
        for i in self._live():   # unknown rid: broadcast (no-op on misses)
            try:
                self.proxies[i].abort(request_id, retain=retain)
            except ReplicaDeadError:
                self.mark_dead(i)

    def abort_stale(self, min_version: int, retain: bool = False) -> None:
        for i in self._live():
            try:
                self.proxies[i].abort_stale(min_version, retain=retain)
            except ReplicaDeadError:
                self.mark_dead(i)

    def release_retained(self, request_id: int) -> None:
        with self._lock:
            rec = self._home.pop(request_id, None)
            self._lost_retained.discard(request_id)
        if rec is not None and rec.idx in self._down():
            return                      # pages died with the replica
        targets = [rec.idx] if rec is not None else self._live()
        for i in targets:
            try:
                self.proxies[i].release_retained(request_id)
            except ReplicaDeadError:
                self.mark_dead(i)

    def suspend(self) -> None:
        for i in self._live():
            self.proxies[i].suspend()

    def resume(self) -> None:
        for i in self._live():
            self.proxies[i].resume()

    def update_weights(self, params) -> None:
        with self._lock:
            self._last_weights = params
        for i in self._live():
            try:
                self.proxies[i].update_weights(params)
            except ReplicaDeadError:
                self.mark_dead(i)

    def update_weights_async(self, params) -> MultiEvent:
        """Stage the swap on EVERY live replica; the aggregate event is set
        once all of them acknowledge or die (fleet-wide overlapped sync
        that a mid-sync crash cannot deadlock)."""
        with self._lock:
            self._last_weights = params
        pairs = []
        for i in self._live():
            try:
                pairs.append((i, self.proxies[i].update_weights_async(params)))
            except ReplicaDeadError:
                self.mark_dead(i)
        return FleetSyncEvent(pairs, self)

    def drain(self, idx: int) -> None:
        """Mark a replica as draining: no new placements land on it and
        its retained abort victims migrate instead of resuming in place.
        In-flight requests run to completion."""
        with self._lock:
            self._draining.add(idx)

    def undrain(self, idx: int) -> None:
        with self._lock:
            self._draining.discard(idx)
            self._scaledown_pending.discard(idx)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ProxyRouter":
        with self._lock:
            self._started = True
        for i in self._live():
            try:
                self.proxies[i].start()
            except ReplicaDeadError:
                self.mark_dead(i)   # died before launch: fail its work over
        return self

    def stop(self) -> None:
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=10)
            self._monitor = None
        for p in self.proxies:
            p.stop()                    # dead/retired stops are no-ops
        with self._lock:
            self._started = False

    # ----------------------------------------------------------- auditing
    def fleet_audit(self, *, require_empty: bool = True) -> None:
        """``audit_pages``-style fleet invariant check (call at
        quiescence).  Asserts the rid→replica map holds no entry for a
        dead/retired replica and none the owning proxy doesn't know
        (active, pending, or retained) — the map must not leak entries for
        requests that already finished (e.g. via group-follower
        promotion).  With ``require_empty`` (default) the map must be
        EMPTY — nothing in flight, nothing parked; every live engine's
        ``audit_pages`` runs too."""
        with self._lock:
            entries = {rid: rec.idx for rid, rec in self._home.items()}
            down = self._dead | self._retired
            lost = set(self._lost_retained)
        assert not lost, f"lost-retained rids never reclaimed: {lost}"
        for rid, idx in entries.items():
            assert idx not in down, \
                f"rid {rid} still homed on down replica {idx}"
            owns = getattr(self.proxies[idx], "owns_request", None)
            assert owns is None or owns(rid), \
                f"rid {rid} leaked: replica {idx} does not know it"
        if require_empty:
            assert not entries, f"rid→replica map not empty: {entries}"
        for i in self._live():
            audit = getattr(self.proxies[i].engine, "audit_pages", None)
            if audit is not None:
                audit()
        # fleet index ↔ local radix trees: the index must attribute to each
        # live replica EXACTLY the content paths its local cache holds — no
        # stale entries surviving evictions or weight-sync flushes, nothing
        # cached that placement can't see.
        if self.fleet_index is not None:
            for i in self._live():
                cache = getattr(self.proxies[i].engine, "prefix_cache", None)
                if cache is None or not hasattr(cache, "paths"):
                    continue
                local = set(cache.paths())
                indexed = self.fleet_index.paths_for(i)
                assert local == indexed, (
                    f"fleet index out of sync for replica {i}: "
                    f"missing={local - indexed} stale={indexed - local}")

    # -------------------------------------------------------------- metrics
    def load(self) -> int:
        return sum(self.proxies[i].load() for i in self._live())

    @property
    def num_replicas(self) -> int:
        return len(self.proxies)

    @property
    def num_active(self) -> int:
        return sum(self.proxies[i].num_active for i in self._live())

    @property
    def num_pending(self) -> int:
        return sum(self.proxies[i].num_pending for i in self._live())

    @property
    def queue_depth(self) -> int:
        """Fleet-wide submitted-but-unadmitted requests (live replicas)."""
        return self.num_pending

    @property
    def queue_depth_by_class(self) -> Dict[int, int]:
        """Fleet-wide queued request count per priority class."""
        depth: Dict[int, int] = {}
        for i in self._live():
            by_class = getattr(self.proxies[i], "pending_by_priority", None)
            if by_class is None:
                continue
            for priority, count in by_class.items():
                depth[priority] = depth.get(priority, 0) + count
        return depth

    @property
    def deadline_misses(self) -> int:
        """Expired rejections + enforced deadline timeouts, fleet-wide
        (counters survive replica death — sums run over ALL replicas)."""
        return sum(int(getattr(p, "deadline_misses", 0)) for p in self.proxies)

    @property
    def preemptions(self) -> int:
        return sum(int(getattr(p, "preemptions", 0)) for p in self.proxies)

    @property
    def long_tail_defers(self) -> int:
        return sum(int(getattr(p, "long_tail_defers", 0)) for p in self.proxies)

    @property
    def stall_aborts(self) -> int:
        return sum(int(getattr(p, "stall_aborts", 0)) for p in self.proxies)

    @property
    def rejected(self) -> int:
        """Typed Rejected resolutions: front-door bounces + replica-level
        sheds/expiries."""
        with self._lock:
            front_door = self._rejected
        return front_door + sum(int(getattr(p, "rejected", 0))
                                for p in self.proxies)

    @property
    def active_per_replica(self) -> List[int]:
        return [self.proxies[i].num_active for i in self._live()]

    @property
    def steps_executed(self) -> int:
        return sum(p.steps_executed for p in self.proxies)

    @property
    def requests_completed(self) -> int:
        return sum(p.requests_completed for p in self.proxies)

    @property
    def requests_aborted(self) -> int:
        return sum(p.requests_aborted for p in self.proxies)

    @property
    def suspend_count(self) -> int:
        return sum(p.suspend_count for p in self.proxies)

    @property
    def staged_weight_updates(self) -> int:
        return sum(p.staged_weight_updates for p in self.proxies)

    @property
    def oldest_active_version(self) -> Optional[int]:
        versions = [v for v in (self.proxies[i].oldest_active_version
                                for i in self._live())
                    if v is not None]
        return min(versions) if versions else None

    @property
    def cache_hit_tokens(self) -> int:
        return sum(p.cache_hit_tokens for p in self.proxies)

    @property
    def cache_stats(self) -> Dict[str, int]:
        agg: Dict[str, int] = {}
        for p in self.proxies:
            for k, v in p.cache_stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def replica_stats(self) -> List[Dict]:
        """Per-replica state/load/occupancy/staleness/cache view."""
        return [{
            "name": p.name,
            "state": self.replica_state(i),
            "load_tokens": p.load(),
            "active": p.num_active,
            "pending": p.num_pending,
            "completed": p.requests_completed,
            "aborted": p.requests_aborted,
            "oldest_active_version": p.oldest_active_version,
            "cache_hit_tokens": p.cache_hit_tokens,
            "pages_transferred": int(getattr(p, "pages_transferred", 0)),
            "transfer_bytes": int(getattr(p, "transfer_bytes", 0)),
            "draining": self.replica_state(i) == "draining",
        } for i, p in enumerate(self.proxies)]
