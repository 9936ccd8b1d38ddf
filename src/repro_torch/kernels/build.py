"""Build and load the hand-written Hopper kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use, by its own ``nvcc`` process, into
``build/kernels/<name>_<hash>.so`` under the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>_<hash>.so \
         src/repro_torch/csrc/<name>.cu

``<hash>`` keys the library by its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one is reused. All missing libraries are
compiled together (one process each, started at once) the first time any
of them is asked for. The result is loaded with ``ctypes``; the compiler's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
it as ``<name>_<hash>.log``. A failed build or load raises.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("elastic_dense", "flash_attention_fwd", "flash_attention_bwd",
           "grouped_matmul", "moe_dispatch", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):    # shared device helpers
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every missing kernel library in parallel; returns the
    library path of each source. Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in SOURCES}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        log = open(target.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, log)
    failed = []
    pending = dict(procs)
    while pending:                   # each source's own build time
        for name, (proc, tmp, log) in list(pending.items()):
            rc = proc.poll()
            if rc is None:
                continue
            del pending[name]
            log.close()
            build_seconds[name] = time.perf_counter() - t0
            if rc != 0:
                failed.append(name)
                continue
            os.replace(tmp, todo[name])
        if pending:
            time.sleep(0.2)
    if failed:
        report = "\n".join(
            f"--- {n} ---\n" + build_log(n)[-4000:] for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{report}")
    return targets


def build_log(name: str) -> str:
    """The compiler's report for ``name`` (registers, shared memory)."""
    path = _target(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
