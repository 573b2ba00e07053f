"""What the host did over a measured window, for the readings that explain a
run's spread (printed, never compared): the share of the window that each
Python thread of the process spent on a CPU, the share of the machine's CPU
time that its hypervisor took away (``steal`` in ``/proc/stat``), and the
caching allocator's retries (a full free and a new allocation, which wait
for the device).  It reads ``/proc`` and changes nothing.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Tuple

_TICK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def _thread_cpu_s() -> Dict[str, float]:
    """CPU seconds (user and system) of each live Python thread, by name."""
    out = {}
    for t in threading.enumerate():
        try:
            with open(f"/proc/self/task/{t.native_id}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError, TypeError):
            continue
        out[t.name] = out.get(t.name, 0.0) + (int(fields[11]) + int(fields[12])) / _TICK
    return out


def _cpu_ticks() -> Optional[Tuple[int, int]]:
    """(steal, all) ticks of the machine's CPUs since boot."""
    try:
        with open("/proc/stat") as f:
            values = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None
    return (values[7] if len(values) > 7 else 0), sum(values[:8])


def _alloc_retries(device) -> int:
    import torch
    if getattr(device, "type", device) != "cuda":
        return 0
    return int(torch.cuda.memory_stats(device).get("num_alloc_retries", 0))


class HostWindow:
    """``start()`` where a window opens; ``read()`` where it closes, while
    the threads to be read still run."""

    def __init__(self, device):
        self.device = device
        self._t = self._cpu = self._ticks = self._retries = None

    def start(self) -> None:
        self._t, self._cpu = time.perf_counter(), _thread_cpu_s()
        self._ticks, self._retries = _cpu_ticks(), _alloc_retries(self.device)

    def read(self) -> Dict[str, float]:
        seconds = time.perf_counter() - self._t
        cpu, ticks = _thread_cpu_s(), _cpu_ticks()
        out = {f"cpu_share.{name}": (s - self._cpu[name]) / seconds
               for name, s in cpu.items() if name in self._cpu}
        if ticks and self._ticks and ticks[1] > self._ticks[1]:
            out["steal_share"] = (ticks[0] - self._ticks[0]) / (ticks[1] - self._ticks[1])
        out["alloc_retries"] = _alloc_retries(self.device) - self._retries
        return out
