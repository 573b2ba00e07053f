"""The port's framework-free modules are copies of the JAX package's: each
module's syntax tree equals its counterpart's once the counterpart's
imports are rewritten (``repro.`` -> ``repro_torch.``) and the docstrings
of both are dropped.  The core modules take their lock factories from the
port's own sanitizer, ``repro_torch.analysis.sanitizer``."""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parent.parent / "src"

MODULES = ["core/sample_buffer.py", "core/faults.py", "core/rollout_client.py",
           "core/router.py", "core/scheduler.py", "core/async_controller.py",
           "envs/base.py", "envs/sim_envs.py", "envs/__init__.py",
           "core/env_manager.py", "core/types.py", "core/slo.py",
           "core/llm_proxy.py", "models/config.py", "data/dataset.py",
           "rewards/verifier.py", "core/simulator.py", "core/theory.py",
           "analysis/__init__.py", "analysis/sanitizer.py", "analysis/schedules.py",
           "analysis/static_check.py", "configs/__init__.py"]


def _drop_docstrings(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]


def _rename(module: str) -> str:
    if module.startswith("repro."):
        return "repro_torch." + module[len("repro."):]
    return module


def _tree(path: Path, rename: bool) -> str:
    tree = ast.parse(path.read_text())
    if rename:
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                node.module = _rename(node.module)
    _drop_docstrings(tree)
    return ast.dump(tree)


@pytest.mark.parametrize("module", MODULES)
def test_port_module_is_a_copy_of_its_counterpart(module):
    port = _tree(SRC / "repro_torch" / module, rename=False)
    ref = _tree(SRC / "repro" / module, rename=True)
    assert port == ref, f"repro_torch/{module} drifted from repro/{module}"

