"""Kernel launch counters under threads: the pipeline launches kernels from
two rollout replicas and the trainer at once, and every wrapper counts its
launches through ``build.count_launch``, under one lock, so that exact
launch checks hold."""
import sys
import threading

import pytest

from repro_torch.kernels import (build, decode_attention, flash_attention,
                                 paged_decode_attention, rglru_scan, rwkv6_scan)

COUNTERS = [
    (paged_decode_attention.paged_decode_attention, ("launches", "launches_int8")),
    (flash_attention.flash_attention, ("launches_fwd",)),
    (flash_attention.flash_attention, ("launches_bwd",)),
    (decode_attention.decode_attention, ("launches",)),
    (rwkv6_scan.rwkv6_scan, ("launches", "launches_chunked")),
    (rglru_scan.rglru_scan, ("launches", "launches_chunked")),
]


@pytest.mark.parametrize("wrapper,names", COUNTERS,
                         ids=lambda x: x if isinstance(x, str) else None)
def test_counts_from_many_threads_are_exact(wrapper, names):
    threads, calls = 8, 5000
    before = {n: getattr(wrapper, n) for n in names}
    start = threading.Barrier(threads)

    def work():
        start.wait()
        for _ in range(calls):
            build.count_launch(wrapper, *names)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)          # switch threads as often as possible
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    try:
        for n in names:
            assert getattr(wrapper, n) - before[n] == threads * calls, n
    finally:
        for n, v in before.items():
            setattr(wrapper, n, v)
