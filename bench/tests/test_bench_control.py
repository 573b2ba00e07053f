"""The control, at each cell's own size on the card: the nearest precision
below the configuration's bf16 (the program's fp8 rollout weights where
the cell serves tokens; the reference computing in e4m3 in the trainer's
place for the train step alone) must not come out correct.  It runs
``bench/control.py`` as a user would; skipped without a card."""
import json
import os
import subprocess
import sys

import pytest

from bench.lib import cell
from bench.tests.conftest import ROOT

WORKLOADS = [w["name"] for w in cell.benchmark(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size: it needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench", "control.py"),
                          "--workload", workload, "--seeds", "2718281828", "--mode", "control",
                          "--seconds", "35"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    checks = json.loads(out.stdout.strip().splitlines()[-1])["checks"]
    # a number of the comparison fails, not the guard that samples after a
    # sync were there to compare
    assert checks.get("synced_unchecked", {"value": 0})["value"] == 0, checks
    assert any(c["limit"] is not None and c["value"] > c["limit"] for c in checks.values()), checks
