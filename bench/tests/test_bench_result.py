"""The result line: its keys, ``checks`` last, and the metrics each cell
reports, from a run of a cell at a tiny size on the CPU (the traced line
with a stand-in for the profiler, which needs the card)."""
import importlib
import os
import sys

import pytest

from bench.lib import cell
from bench.tests.conftest import ROOT, tiny_context

sys.path.insert(0, os.path.join(ROOT, "bench"))
import run  # noqa: E402

sys.path.pop(0)
BENCH = cell.benchmark(ROOT)


class FakeTracer:
    """What ``bench.lib.trace.Tracer`` hands the readers after a window."""
    window_s = 2.0
    active = False

    def busy_s(self):
        return 0.5

    def kernel_seconds(self, pattern):
        return 1e-3

    def breakdown(self, k=10):
        return {"device_ops": [["gemm", 0.4]], "idle_gaps": [["llm_proxy step", 1.0]]}


def _wanted(kind, workload):
    return {m["name"] for m in BENCH[kind]
            if "workloads" not in m or workload in m["workloads"]}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_result_line_keys_and_metrics(workload):
    ctx = tiny_context(workload)
    rec = importlib.import_module(f"bench.drivers.{ctx.mix['kind']}").run(ctx)
    out = run.result(BENCH, rec, "test card", 1, 700.0)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["metrics"]) == _wanted("end_to_end", workload)
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"] and all(set(c) == {"value", "limit"} for c in out["checks"].values())

    ctx.trace = True
    rec.tracer = FakeTracer()
    rec.flash_bound_s = rec.flash_bound_s or 1e-4
    rec.counters.update(flash_fwd=0, flash_bwd=0, flash_fwd_expected=0, flash_bwd_expected=0)
    out = run.result(BENCH, rec, "test card", 1, 700.0)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert set(out["metrics"]) == _wanted("per_layer", workload)
    assert out["device"]["busy_s"] == 0.5 and out["device"]["window_s"] == 2.0
    assert all(len(v) <= 10 for v in out["breakdown"].values())


def test_every_metric_has_a_reader_and_moves_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        base = m["name"].split(".")[0]
        assert any(os.path.exists(os.path.join(ROOT, "bench", "metrics", n + ".py"))
                   for n in (m["name"], base)), m["name"]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
