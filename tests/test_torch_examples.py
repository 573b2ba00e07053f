"""The port's example twins (``examples/torch/``) run as a user runs them:
the quickstart twin on the CPU (``--device cpu``) in a subprocess, within
120 s, printing the lines ``examples/quickstart.py`` prints."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.timeout(180)
def test_quickstart_twin_runs_on_the_cpu():
    # one torch thread: the suite's parallel workers keep their cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)          # the twin finds src/ on its own
    out = subprocess.run([sys.executable, "examples/torch/quickstart.py", "--device", "cpu"],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("handle: tokens=") and "legs=[(0, 6)]" in lines[0]
    assert any(line.split()[:2] == ["step", "wait_s"] for line in lines)
    assert any(line.startswith("buffer: produced=") and "consumed=16" in line
               for line in lines)
    assert "overlapped sync: proxy never suspended: True" in lines
    assert "staleness never exceeded alpha: True" in lines
