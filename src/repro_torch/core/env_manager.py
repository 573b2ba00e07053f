"""EnvManager: per-environment event loop for agentic rollouts (§4.2, §5.2).

Each EnvManager mediates between its BaseEnv and the shared rollout service
through a first-class ``Session`` (`repro_torch.core.rollout_client`):
reset -> (action <- session.turn) -> step -> ... -> reward -> SampleBuffer.
The session owns the conversation context (``turn``/``full`` modes — the
latter rides the radix prefix cache as incremental prefill per turn) and
version-tags every turn; a turn interrupted by a weight sync is resumed
transparently by the client layer (paged engines re-attach the retained KV
pages), so trajectories survive weight syncs instead of being thrown away.

Running many EnvManagers concurrently against one proxy realizes
*environment-level asynchronous rollout*: while one trajectory waits on its
environment, the decode slots serve other trajectories.

``EnvManagerPool`` implements *redundant environment rollout*:
``num_env_groups x group_size`` managers run concurrently, the pool stops
at ``target_trajectories``, and stragglers/failed envs are abandoned —
fail-slow and fail-stop environments never gate the step.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.locks import new_lock
from repro_torch.core.rollout_client import GenerationHandle, RolloutClient, Session
from repro_torch.core.sample_buffer import SampleBuffer
from repro_torch.core.types import GenerationResult, Trajectory, Turn, next_uid
from repro_torch.envs.base import BaseEnv


class EnvManager(threading.Thread):
    """One environment's rollout loop — a thin consumer of Sessions.

    ``context_mode``/``max_context_tokens`` configure each trajectory's
    Session (see `repro_torch.core.rollout_client.Session`)."""

    def __init__(self, env: BaseEnv, proxy, pool: "EnvManagerPool",
                 *, env_id: int, group_id: int, max_steps: int,
                 max_new_tokens: int, context_mode: str = "turn",
                 max_context_tokens: Optional[int] = None,
                 client: Optional[RolloutClient] = None):
        super().__init__(name=f"env_manager_{env_id}", daemon=True)
        if context_mode not in ("turn", "full"):
            raise ValueError(f"context_mode must be turn|full, got {context_mode!r}")
        if context_mode == "full" and max_context_tokens is None:
            # an uncapped growing conversation would eventually overrun the
            # engine's sequence budget and assert inside the proxy thread —
            # force callers to size the cap (pipeline.py derives it from
            # max_seq_len - max_new_tokens).
            raise ValueError("context_mode='full' requires max_context_tokens")
        self.env = env
        self.pool = pool
        self.env_id = env_id
        self.group_id = group_id
        self.max_steps = max_steps
        self.max_new_tokens = max_new_tokens
        self.context_mode = context_mode
        self.max_context_tokens = max_context_tokens
        self._handle_lock = new_lock("EnvManager._handle_lock")
        self._inflight: Optional[GenerationHandle] = None  # guarded-by: _handle_lock
        if client is None and proxy is not None:
            client = RolloutClient.ensure(
                proxy,
                version_fn=lambda: self.pool.buffer.version,
                resume_gate=lambda: not (self.pool.stopped
                                         or self.pool.buffer.closed))
        self.client = client

    def _new_session(self) -> Session:
        return self.client.session(
            session_id=self.env_id, group_id=self.group_id,
            max_new_tokens=self.max_new_tokens,
            context_mode=self.context_mode,
            max_context_tokens=self.max_context_tokens)

    def _await(self, handle: GenerationHandle) -> Optional[GenerationResult]:
        """Park this manager on the turn's handle (NOT the GPU — other
        managers' requests keep the decode slots busy meanwhile).

        Push-based cancellation: the handle is registered under
        ``_handle_lock`` so ``cancel_inflight`` (pool shutdown / target
        reached) aborts it and the wait wakes immediately — no 0.1 s
        stop-flag polling.  The ordering is race-free because the pool sets
        its stop event *before* sweeping registrations: either we see
        ``stopped`` here, or the sweep sees our registered handle.  The long
        timed wait below is a belt-and-braces fallback, not a poll."""
        with self._handle_lock:
            if self.pool.stopped:
                handle.abort()        # cancel; retained pages are released
                return None
            self._inflight = handle
        try:
            while not handle.wait(timeout=5.0):
                if self.pool.stopped:
                    handle.abort()
                    return None
        finally:
            with self._handle_lock:
                self._inflight = None
        return handle.result(0)

    def cancel_inflight(self) -> None:
        """Abort whatever turn this manager is parked on (idempotent; a
        handle that already resolved ignores the abort)."""
        with self._handle_lock:
            handle = self._inflight
        if handle is not None:
            handle.abort()

    def run(self) -> None:
        while not self.pool.stopped:
            version = self.pool.buffer.begin_generation(timeout=0.1)
            if version is None:
                if self.pool.buffer.closed:
                    return
                continue
            traj = Trajectory(traj_id=next_uid(), env_id=self.env_id,
                              group_id=self.group_id, version_started=version)
            try:
                obs = self.env.reset()
            except Exception:
                traj.failed = True
                self.pool.buffer.reclaim(1)
                continue
            session = self._new_session()
            aborted = False
            for _ in range(self.max_steps):
                res = self._await(session.turn(obs))
                if res is None or res.aborted:
                    aborted = True
                    break
                action = np.asarray(res.tokens, np.int32)
                try:
                    obs, reward, done, info = self.env.step(action)
                except Exception:
                    traj.failed = True
                    break
                traj.turns.append(Turn(observation_tokens=np.asarray(obs, np.int32),
                                       action_tokens=action,
                                       logprobs=np.asarray(res.logprobs, np.float32)))
                if done:
                    traj.done = True
                    traj.reward = float(reward)
                    break
            if aborted or traj.failed or not traj.done:
                self.pool.buffer.reclaim(1)
                continue
            traj.version_finished = session.turn_versions[-1] \
                if session.turn_versions else version
            sample = traj.to_sample()
            try:
                self.pool.buffer.put(sample)
            except Exception:
                self.pool.buffer.reclaim(1)
                continue
            self.pool.on_trajectory(traj)


class EnvManagerPool:
    def __init__(self, make_env: Callable[[int], BaseEnv], proxy,
                 buffer: SampleBuffer, *, num_env_groups: int, group_size: int,
                 max_steps: int, max_new_tokens: int,
                 target_trajectories: Optional[int] = None,
                 context_mode: str = "turn",
                 max_context_tokens: Optional[int] = None):
        self.buffer = buffer
        self.client = RolloutClient.ensure(
            proxy, version_fn=lambda: buffer.version,
            resume_gate=lambda: not (self.stopped or buffer.closed))
        self.proxy = self.client.proxy
        self.num_env_groups = num_env_groups
        self.group_size = group_size
        self.target = target_trajectories
        self._stop = threading.Event()
        self._count_lock = new_lock("EnvManagerPool._count_lock")
        self._count = 0  # guarded-by: _count_lock
        self.managers: List[EnvManager] = []
        eid = 0
        for g in range(num_env_groups):
            for _ in range(group_size):
                env = make_env(eid)
                self.managers.append(EnvManager(
                    env, self.proxy, self, env_id=eid, group_id=g,
                    max_steps=max_steps, max_new_tokens=max_new_tokens,
                    context_mode=context_mode,
                    max_context_tokens=max_context_tokens,
                    client=self.client))
                eid += 1

    @property
    def total_envs(self) -> int:
        return self.num_env_groups * self.group_size

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    @property
    def trajectories_collected(self) -> int:
        with self._count_lock:
            return self._count

    def on_trajectory(self, traj: Trajectory) -> None:
        target_hit = False
        with self._count_lock:
            self._count += 1
            # redundant env rollout: stop at the target, abandon stragglers
            if self.target is not None and self._count >= self.target \
                    and not self._stop.is_set():
                self._stop.set()
                target_hit = True
        if target_hit:
            # wake every straggler NOW (outside _count_lock: aborting goes
            # through the rollout client's lock)
            for m in self.managers:
                m.cancel_inflight()

    def start(self) -> "EnvManagerPool":
        for m in self.managers:
            m.start()
        return self

    def stop(self, join: bool = True) -> None:
        # order matters: set the stop flag first, then sweep registered
        # handles — _await registers under its lock only after re-checking
        # the flag, so no turn can slip between flag and sweep.
        self._stop.set()
        for m in self.managers:
            m.cancel_inflight()
        if join:
            for m in self.managers:
                m.join(timeout=10)
