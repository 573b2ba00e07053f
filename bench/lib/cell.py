"""A cell's context (what ``BENCHMARK.json`` and its data files say) and the
record a driver hands back, from which the metric readers read."""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional

from bench.lib import traffic

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Context:
    workload: dict              # the cell's entry of BENCHMARK.json
    cfg: dict                   # the configuration file
    mix: dict                   # the traffic file
    limits: dict                # bench/limits/<workload>.json
    seed: int
    seconds: float
    trace: bool
    device: Any
    process_start: float
    # set only by the control and the tests: settings of the program's own
    # paths (e.g. ``rollout_quant``) and faults planted under the timed path
    overrides: dict = dataclasses.field(default_factory=dict)


def context(name: str, seed: int, seconds: float, trace: bool, device, process_start: float,
            bench: Optional[dict] = None, cfg_override: Optional[dict] = None) -> Context:
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = cfg_override or load_json(os.path.join(ROOT, entry["file"]))
    limits = load_json(os.path.join(BENCH, "limits", f"{name}.json"))
    return Context(w, cfg, traffic.load(w["traffic"]), limits, seed, seconds, trace, device,
                   process_start)


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file: its registry entry
    (``cfg["arch"]``) at the file's sizes."""
    from repro_torch.configs import get_config
    base = get_config(cfg["arch"])
    return dataclasses.replace(
        base, num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["head_dim"], d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], qk_norm=True, dtype=cfg["torch_dtype"])


@dataclasses.dataclass
class Record:
    """What a run measured.  Times are ``time.perf_counter()`` seconds."""
    ctx: Context
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)                  # (start, end) of the measured window
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    steps: List[dict] = dataclasses.field(default_factory=list)      # train / RL steps in the window
    flops: Optional[float] = None               # model FLOPs of the window
    tracer: Any = None                          # bench.lib.trace.Tracer of a traced run
    flash_bound_s: Optional[float] = None       # flash's least time in the traced window
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)
    checks: Dict[str, dict] = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def check(self, name: str, value: float) -> None:
        """Keep a reading; it is compared (``checks``) when the cell's
        limits name it."""
        self.readings[name] = value
        if name in self.ctx.limits:
            self.checks[name] = {"value": value, "limit": self.ctx.limits[name]}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["value"] <= c["limit"] for c in self.checks.values())


def reader(name: str) -> Callable[[Record], Optional[float]]:
    """``bench/metrics/<name>.py``'s ``read``, or where there is no such file,
    that of the name before its first dot: ``mfu.train`` is read by
    ``mfu.py`` unless ``mfu.train.py`` exists."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(BENCH, "metrics", f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, record: Record, trace: bool) -> Dict[str, dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones,
    each read by its reader; a reader that finds nothing is left out."""
    cell = record.ctx.workload["name"]
    out = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def free_device(device) -> None:
    """Release the program's tensors (a pipeline holds reference cycles)."""
    gc.collect()
    if getattr(device, "type", device) == "cuda":
        import torch
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
