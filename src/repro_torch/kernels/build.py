"""Build and load the port's CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, and loaded
with ``ctypes``.  Libraries land in ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the source and the
flags, so a changed source is rebuilt at its next use and an unchanged one
is loaded as it is.  Nothing is built at import: the first call of a kernel
builds it, or ``build_all`` builds every source at once, one ``nvcc``
process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

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
