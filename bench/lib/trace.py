"""The device trace of a ``--trace 1`` run and what the host did while the
device idled.

``Tracer`` runs ``torch.profiler`` (CUDA activity only) over a window that
the driver opens and closes, and beside it a host sampler: every
``period`` s it asks whether the device's default stream has work left
(``query()``, which does not wait) and, when it has none, charges the
period to the innermost frame of the port's code in each Python thread
that is in the port's code and not waiting, as ``chip_smoke._ThreadCPU``
samples frames.  Device busy time is the
union of the device events' intervals (a copy of ``chip_smoke._busy_us``).
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

_WAITS = {"wait", "get", "sleep", "_wait_for_tstate_lock", "select", "join", "acquire"}


def busy_seconds(spans: List[Tuple[float, float]]) -> float:
    """Seconds in which at least one (start, end) interval is open."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' anonymity,
    template arguments and arguments: ``void f<int, 2>(float*)`` -> ``f``."""
    name = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    words = "".join(out).split("(")[0].split()
    return (words[-1] if words else name)[:120]


class _HostSampler:
    def __init__(self, period: float, idle_fn):
        self.period, self.idle_fn = period, idle_fn
        self.idle: Dict[str, float] = {}
        self.samples = self.idle_samples = 0
        self._halt = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="bench_sampler", daemon=True)

    def _where(self) -> List[str]:
        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for ident, frame in sys._current_frames().items():
            name = names.get(ident)
            if name in (None, "bench_sampler"):
                continue
            if frame.f_code.co_name in _WAITS and "threading" in frame.f_code.co_filename:
                continue
            while frame is not None and "repro_torch" not in frame.f_code.co_filename:
                frame = frame.f_back
            if frame is not None:                   # a thread of the program
                out.append(f"{name} {os.path.basename(frame.f_code.co_filename)}:"
                           f"{frame.f_code.co_name}")
        return out

    def _loop(self) -> None:
        while not self._halt.wait(self.period):
            self.samples += 1
            if self.idle_fn():
                self.idle_samples += 1
                for key in self._where():
                    self.idle[key] = self.idle.get(key, 0.0) + self.period

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._halt.set()
        self._thread.join()


def _device_spans(prof) -> List[Tuple[str, float, float]]:
    """(name, start s, end s) of every device event of the profile."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    try:
        events = prof.profiler.kineto_results.events()
        return [(e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
                for e in events if e.device_type() == cuda]
    except AttributeError:
        return [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                for e in prof.events() if e.device_type == cuda]


class Tracer:
    """Opens and closes one traced window; then gives the window's length,
    the device's busy seconds, seconds by kernel name and the host's frames
    while the device idled."""

    def __init__(self, device, period: float = 0.005):
        self.device, self.period = device, period
        self._prof = None
        self._sampler: Optional[_HostSampler] = None
        self.window_s: Optional[float] = None
        self.spans: List[Tuple[str, float, float]] = []
        self._t0 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        stream = torch.cuda.default_stream(self.device)
        self._sampler = _HostSampler(self.period, stream.query)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._sampler.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._sampler.stop()
        self._prof.stop()
        self.spans = _device_spans(self._prof)
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def busy_s(self) -> float:
        return busy_seconds([(a, b) for _, a, b in self.spans])

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b in self.spans:
            key = short_name(name)
            out[key] = out.get(key, 0.0) + (b - a)
        return out

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name contains ``pattern``."""
        return sum(b - a for name, a, b in self.spans if pattern in name)

    def breakdown(self, k: int = 10) -> dict:
        ops = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])[:k]
        idle = sorted(self._sampler.idle.items(), key=lambda kv: -kv[1])[:k]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle]}
