"""No module of the benchmark imports JAX, the JAX package ``repro`` or the
old ``benchmarks`` folder.  Names are compared by their top level (before
the first dot), whole: ``repro_torch`` is not ``repro``."""
import ast
import os
import subprocess
import sys

from bench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_under_bench_imports_jax_or_the_jax_package():
    bad = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "bench")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                bad += [(path, m) for m in _imports(path) if m in FORBIDDEN]
    assert bad == []


def test_the_check_compares_whole_top_level_names():
    sys.path.insert(0, os.path.join(ROOT, "bench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_fake.x"] = object()
        assert "repro" not in run.forbidden_modules()
        sys.modules["repro.core"] = object()
        assert run.forbidden_modules() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import bench.drivers.rlvr, bench.drivers.train, bench.control; "
            "import repro_torch.launch.pipeline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (os.path.join(ROOT, "src"), ROOT, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_run_exits_non_zero_and_prints_no_result():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench", "run.py"), "--workload",
                          "train_grpo.qwen3-1.7b", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
