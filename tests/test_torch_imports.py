"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU silently."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conftest import tiny
from repro_torch.models.config import ModelConfig

# tiny shapes: one torch thread, so the suite's parallel workers keep their
# cores (torch's pool would otherwise spin on all of them)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return (sorted(PORT.rglob("*.py")) + sorted((ROOT / "examples" / "torch").glob("*.py"))
            + [ROOT / "chip_smoke.py"])


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    # a subprocess: this test process already imported jax via conftest
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "assert {'repro_torch.quant', 'repro_torch.quant.core', 'repro_torch.algos',\n"
        "        'repro_torch.algos.grpo', 'repro_torch.algos.off_policy',\n"
        "        'repro_torch.algos.advantages', 'repro_torch.train',\n"
        "        'repro_torch.train.optimizer', 'repro_torch.train.trainer',\n"
        "        'repro_torch.kernels.flash_attention', 'repro_torch.rollout.engine',\n"
        "        'repro_torch.models.rwkv6', 'repro_torch.kernels.decode_attention',\n"
        "        'repro_torch.kernels.rwkv6_scan', 'repro_torch.data',\n"
        "        'repro_torch.data.dataset', 'repro_torch.rewards',\n"
        "        'repro_torch.rewards.verifier', 'repro_torch.eval',\n"
        "        'repro_torch.eval.passk', 'repro_torch.models.rglru',\n"
        "        'repro_torch.kernels.rglru_scan', 'repro_torch.core.sample_buffer',\n"
        "        'repro_torch.core.faults', 'repro_torch.core.rollout_client',\n"
        "        'repro_torch.core.router', 'repro_torch.core.scheduler',\n"
        "        'repro_torch.core.async_controller', 'repro_torch.core.env_manager',\n"
        "        'repro_torch.envs', 'repro_torch.envs.base', 'repro_torch.envs.sim_envs',\n"
        "        'repro_torch.launch', 'repro_torch.launch.pipeline',\n"
        "        'repro_torch.launch.train', 'repro_torch.core.simulator',\n"
        "        'repro_torch.core.theory', 'repro_torch.train.critic',\n"
        "        'repro_torch.checkpoint', 'repro_torch.checkpoint.store',\n"
        "        'repro_torch.analysis', 'repro_torch.analysis.sanitizer',\n"
        "        'repro_torch.analysis.schedules', 'repro_torch.analysis.static_check',\n"
        "        'repro_torch.analysis.concheck', 'repro_torch.configs.shapes',\n"
        "        'repro_torch.launch.mesh', 'repro_torch.launch.dryrun',\n"
        "        'repro_torch.models.sharding'} <= set(names), names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# the port's own modules (package inits, the JAX bridge, device choice,
# the kernel builder, the checker's command line) and the JAX module that
# is not ported (a dispatcher nothing imports)
PORT_OWN = {"__init__.py", "launch/__init__.py", "convert.py", "device.py",
            "kernels/build.py", "analysis/concheck.py"}
NOT_PORTED = {"kernels/ops.py"}


def test_port_module_list_equals_the_jax_packages():
    def modules(root):
        return {p.relative_to(root).as_posix() for p in root.rglob("*.py")
                if "__pycache__" not in p.parts}

    jax_modules = modules(ROOT / "src" / "repro")
    assert modules(PORT) == (jax_modules - NOT_PORTED) | PORT_OWN
    assert NOT_PORTED <= jax_modules and not (PORT_OWN & jax_modules)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_source_has_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


def _cfg():
    return ModelConfig(**dataclasses.asdict(tiny("qwen3-4b", dtype="float32")))


def test_entry_points_raise_without_cuda_and_without_device(monkeypatch):
    from repro_torch.models import get_api
    from repro_torch.models.transformer import init_lm
    from repro_torch.eval import evaluate_passk
    from repro_torch.rollout import DecodeEngine, PagedDecodeEngine
    from repro_torch.envs import GridTargetEnv
    from repro_torch.launch.pipeline import (PipelineSettings, build_agentic_pipeline,
                                             build_rlvr_pipeline)

    cfg = _cfg()
    api = get_api(cfg, device="cpu")
    params = api.init(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_api(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedDecodeEngine(api, params, num_slots=2, max_total_len=32,
                          page_size=8, prefill_chunk=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(api, params, num_slots=2, max_total_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_passk(api, params, num_prompts=1, n_per_prompt=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_rlvr_pipeline(cfg, PipelineSettings())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_agentic_pipeline(cfg, PipelineSettings(), make_env=GridTargetEnv,
                               num_env_groups=1, group_size=2)
    DecodeEngine(api, params, num_slots=2, max_total_len=32, device="cpu")
    # explicit CPU works, and the engine refuses a device unlike the API's
    PagedDecodeEngine(api, params, num_slots=2, max_total_len=32, page_size=8,
                      prefill_chunk=8, device="cpu")
    with pytest.raises(ValueError, match="differs"):
        PagedDecodeEngine(api, params, num_slots=2, max_total_len=32,
                          page_size=8, prefill_chunk=8, device="meta")


@pytest.mark.parametrize("kw,exc", [
    (dict(quant_mode="int4"), ValueError),
    (dict(kv_quant="fp8"), ValueError),
    (dict(quant_mode="int8", kv_quant="int4"), ValueError),
    (dict(attn_impl="kernel_interpret"), ValueError),
])
def test_engine_refuses_modes_not_ported(kw, exc):
    from repro_torch.models import get_api
    from repro_torch.rollout import PagedDecodeEngine

    api = get_api(_cfg(), device="cpu")
    with pytest.raises(exc):
        PagedDecodeEngine(api, api.init(0), num_slots=2, max_total_len=32,
                          page_size=8, prefill_chunk=8, device="cpu", **kw)
    # the quantized modes are ported: they construct, on the CPU when asked
    eng = PagedDecodeEngine(api, api.init(0), num_slots=2, max_total_len=32,
                            page_size=8, prefill_chunk=8, device="cpu",
                            quant_mode="fp8", kv_quant="int8")
    assert eng.cache.k_scales is not None


def test_other_families_are_not_ported_yet():
    """Every family of the registry is ported now: ``get_api`` takes all
    six, and only the dense and MoE families have the paged views (the
    reference's ``paged.supports_paged``)."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models import get_api
    families = {}
    for arch in REGISTRY:
        cfg = ModelConfig(**dataclasses.asdict(tiny(arch)))
        api = get_api(cfg, device="cpu")
        assert api.apply and api.prefill and api.decode_step and api.init_cache
        paged = (api.init_paged_cache, api.prefill_chunk, api.decode_paged,
                 api.cache_view)
        assert all(v is not None for v in paged) or all(v is None for v in paged)
        families.setdefault(cfg.family, set()).add(paged[0] is not None)
    assert families == {"dense": {True}, "moe": {True}, "ssm": {False},
                        "hybrid": {False}, "vlm": {False}, "audio": {False}}
    with pytest.raises(ValueError, match="family"):
        get_api(dataclasses.replace(ModelConfig(**dataclasses.asdict(tiny("qwen3-4b"))),
                                    family="diffusion"), device="cpu")