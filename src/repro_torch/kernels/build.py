"""Build and load the port's CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, and loaded
with ``ctypes``.  Libraries land in ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the source and the
flags, so a changed source is rebuilt at its next use and an unchanged one
is loaded as it is.  Nothing is built at import: the first call of a kernel
builds it, or ``build_all`` builds every source at once, one ``nvcc``
process each, all started together.

``abstract_kernels()`` lets a wrapper evaluate abstractly: inside it, a
wrapper given ``meta`` tensors returns its kernel's outputs' shapes and
dtypes (on the meta device, nothing computed or launched, no count) through
one ``torch.library`` op, ``repro_torch::kernel``, registered at its first
use.  Tracers see that op as they see any other: ``FlopCounterMode``
counts each kernel's products by its ``register_abstract`` formula,
``MemTracker`` its outputs.  The dry-run (``launch/dryrun.py``) plans
steps this way.  Outside the context a meta tensor is refused, as before.
Every kernel is parallel over its batch (each input's dim 0, but
RWKV-6's ``u``): on DTensors the op runs on each device's batch rows,
every other dim gathered first.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all ``nvcc``s in
    parallel.  Returns {name: seconds} for what was built (empty = all
    cached).  The compiler's ``-Xptxas -v`` report lands beside each
    library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources().items():
        target = _target(src)
        if target.exists():
            continue
        tmp = target.with_suffix(f".tmp{os.getpid()}")
        log = open(target.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT), tmp, target, log,
            time.perf_counter())
    built = {}
    failed = []
    for name, (proc, tmp, target, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (rc {rc}, see {target.with_suffix('.log')})")
            continue
        os.replace(tmp, target)
        built[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed: " + ", ".join(failed))
    return built


def count_launch(wrapper, *counters: str) -> None:
    """Add one to each of ``wrapper``'s launch counters ``counters``.  The
    wrappers run on several threads at once (rollout replicas and the
    trainer), and ``+= 1`` on a function attribute is a read-modify-write
    that can lose an update between threads: every count goes through this
    one lock."""
    with _count_lock:
        for name in counters:
            setattr(wrapper, name, getattr(wrapper, name) + 1)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(sources()[name])
            if not target.exists():
                build_all()
            lib = _libs[name] = ctypes.CDLL(str(target))
        return lib


# ---------------------------------------------------------------------------
# abstract evaluation (shapes only) for tracers
# ---------------------------------------------------------------------------

# name -> (outputs: inputs -> [(shape, dtype)], flops: input shapes -> int)
_ABSTRACT: Dict[str, Tuple[Callable, Callable]] = {}
_abstract_state = threading.local()
_abstract_op = []


@contextlib.contextmanager
def abstract_kernels():
    """Within this context (on this thread) the wrappers take ``meta``
    tensors and evaluate abstractly (``abstract_call``).  The op and its
    FLOP formula are registered on entry: a ``FlopCounterMode`` takes a
    copy of the formulas when it is made, so make it inside."""
    _op()
    prev = getattr(_abstract_state, "on", False)
    _abstract_state.on = True
    try:
        yield
    finally:
        _abstract_state.on = prev


def is_abstract(t: torch.Tensor) -> bool:
    """True for a meta tensor inside ``abstract_kernels()``."""
    return t.device.type == "meta" and getattr(_abstract_state, "on", False)


def register_abstract(name: str, outputs: Callable, flops: Callable) -> None:
    """``outputs(inputs)`` -> the kernel's outputs as [(shape, dtype)];
    ``flops(input shapes)`` -> the products it computes, in
    ``FlopCounterMode``'s convention (2 per multiply-add of a matmul-class
    product, elementwise work not counted)."""
    _ABSTRACT[name] = (outputs, flops)


def _op():
    with _lock:
        if not _abstract_op:
            from torch.utils.flop_counter import register_flop_formula

            @torch.library.custom_op("repro_torch::kernel", mutates_args=())
            def kernel(name: str, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
                raise RuntimeError(f"{name}: the abstract kernel op has no "
                                   "implementation but its shapes")

            @kernel.register_fake
            def _outputs(name, inputs):
                return [torch.empty(shape, dtype=dtype, device=inputs[0].device)
                        for shape, dtype in _ABSTRACT[name][0](inputs)]

            @register_flop_formula(torch.ops.repro_torch.kernel)
            def _flops(name, inputs, out_shape=None, **kwargs):
                return _ABSTRACT[name][1](inputs)

            _abstract_op.append(torch.ops.repro_torch.kernel)
        return _abstract_op[0]


def abstract_call(name: str, *inputs: torch.Tensor) -> List[torch.Tensor]:
    """The outputs of kernel ``name`` on meta ``inputs``, through the
    ``repro_torch::kernel`` op.  On DTensors: each input redistributed to
    the first input's batch sharding (``Shard(0)`` on the mesh dims that
    shard its dim 0, replicated on the others; an input of another leading
    size replicated), the op run on the local tensors, and the outputs, all
    batch-first, sharded as the first input."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(inputs[0], DTensor):
        return list(_op()(name, list(inputs)))
    first = inputs[0]
    mesh = first.device_mesh
    by_batch = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                     for p in first.placements)
    everywhere = (Replicate(),) * mesh.ndim
    local = [x.redistribute(mesh, by_batch if x.shape[0] == first.shape[0] else everywhere)
             .to_local() for x in inputs]
    return [DTensor.from_local(y, mesh, by_batch, run_check=False,
                               shape=(first.shape[0],) + tuple(y.shape[1:]),
                               stride=torch.empty((first.shape[0],) + tuple(y.shape[1:]),
                                                  device="meta").stride())
            for y in _op()(name, local)]
