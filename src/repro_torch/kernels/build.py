"""Build and load the hand-written Hopper kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use, by its own ``nvcc`` process, into
``build/kernels/<name>_<hash>.so`` under the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>_<hash>.so \
         src/repro_torch/csrc/<name>.cu

``<hash>`` keys the library by its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one is reused. Each source is built twice: the fast library
above, and the counted library ``<name>_counted_<hash>.so``, the same
source with ``-DREPRO_TILE_COUNTERS`` (``csrc/tile_counters.cuh``: every
kernel counts the tiles it executed and the operand blocks it loaded; the
define is in the hashed flags, so the two builds never share a file). All
missing libraries are compiled together (one process each, started at
once) the first time any of them is asked for; the fast ones are waited
for then, the counted ones (started at a lower priority) only when one of
them is first loaded, and any still running at exit are stopped. The
result is loaded with
``ctypes``; the compiler's ``-Xptxas -v`` report (registers, shared
memory, spills) is kept beside it as ``<name>_<hash>.log``. A failed
build or load raises.

Several processes (the ranks of a cohort group, started cold together)
build in turn: ``build_all`` holds an ``fcntl.flock`` on the build
directory while it starts the missing builds and waits for the ones it
needs, so the first process builds and the others find the libraries and
load them. A counted build still running in the background of the process
that started it is marked by ``<target>.pid``; another process does not
start it again, and waits for it if it needs it.

A counted library loads only inside ``counting()``: outside it
``library(name)`` is always the fast build, so the main path never
reaches a counter. ``reset_counters`` / ``read_counters`` zero and read the
counters of every counted library loaded so far.
"""
from __future__ import annotations

import atexit
import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import signal
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("elastic_dense", "flash_attention_fwd", "flash_attention_bwd",
           "grouped_matmul", "moe_dispatch", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
COUNTED_FLAGS = NVCC_FLAGS + ("-DREPRO_TILE_COUNTERS",)

_lock = threading.Lock()
_libs: Dict[Tuple[str, bool], ctypes.CDLL] = {}
_counting = False
_running: Dict[str, tuple] = {}      # builds started and not yet waited for
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


def _target(name: str, counted: bool = False) -> Path:
    flags = COUNTED_FLAGS if counted else NVCC_FLAGS
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):    # shared device helpers
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    kind = "_counted" if counted else ""
    return BUILD_DIR / f"{name}{kind}_{digest.hexdigest()[:16]}.so"


def _key(name: str, counted: bool) -> str:
    return f"{name}_counted" if counted else name


def _start(name: str, counted: bool, nvcc: str) -> None:
    target = _target(name, counted)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = open(target.with_suffix(".log"), "w")
    flags = COUNTED_FLAGS if counted else NVCC_FLAGS
    cmd = [nvcc, *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    target.with_suffix(".pid").write_text(str(os.getpid()))
    # each build in a process group of its own (``_stop`` ends nvcc's
    # children too); the counted builds yield the cores to the fast ones
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True,
                            preexec_fn=(lambda: os.nice(10)) if counted
                            else None)
    t0, end = time.perf_counter(), []

    def finish():             # the library lands as soon as nvcc ends
        rc = proc.wait()
        end.append(time.perf_counter())
        if rc == 0:
            os.replace(tmp, target)
        target.with_suffix(".pid").unlink(missing_ok=True)
    watcher = threading.Thread(target=finish, daemon=True)
    watcher.start()
    _running[_key(name, counted)] = (proc, watcher, log, target, t0, end)


def _building_elsewhere(target: Path) -> bool:
    """Whether another live process is building ``target`` now."""
    try:
        pid = int(target.with_suffix(".pid").read_text())
    except (OSError, ValueError):
        return False
    if pid == os.getpid():
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass
    return True


@contextlib.contextmanager
def _dir_lock():
    """An exclusive ``flock`` on the build directory: the processes that
    build at once (the ranks of a cohort group) take turns."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _wait(keys) -> None:
    """Wait for the running builds ``keys``; raises if any failed."""
    pending = [k for k in keys if k in _running]
    failed = []
    while pending:                   # each build's own time
        for key in list(pending):
            proc, watcher, log, target, t0, end = _running[key]
            if watcher.is_alive():
                continue
            pending.remove(key)
            del _running[key]
            log.close()
            build_seconds[key] = end[0] - t0
            if proc.returncode != 0:
                failed.append((key, target))
        if pending:
            time.sleep(0.2)
    if failed:
        report = "\n".join(
            f"--- {k} ---\n" + t.with_suffix(".log").read_text()[-4000:]
            for k, t in failed)
        raise RuntimeError(f"nvcc failed for {[k for k, _ in failed]}:\n"
                           f"{report}")


@atexit.register
def _stop() -> None:
    """Stop the builds still running when the process ends."""
    for proc, watcher, log, target, *_ in _running.values():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        watcher.join()
        log.close()
        target.with_suffix(f".{os.getpid()}.tmp").unlink(missing_ok=True)
    _running.clear()


def build_all(counted: bool = False) -> Dict[str, Path]:
    """Start every missing kernel library, fast and counted, in one parallel
    pass (the counted builds at a lower priority), and wait for the fast
    ones — and with ``counted`` for the counted ones too; returns the fast
    library path of each source. Raises if a build waited for fails. The
    pass holds the build directory's lock (``_dir_lock``); a build that
    another live process runs is not started again, but waited for (out
    of the lock) when it is needed, and started here if that process ends
    without it."""
    need = [(n, c) for n in SOURCES for c in (False, True)
            if counted or not c]
    while True:
        with _dir_lock():
            for name in SOURCES:
                for c in (False, True):
                    target = _target(name, c)
                    if _key(name, c) not in _running and \
                            not target.exists() and \
                            not _building_elsewhere(target):
                        _start(name, c, _nvcc())
            _wait([_key(n, c) for n, c in need])
        elsewhere = [_target(n, c) for n, c in need
                     if not _target(n, c).exists()]
        if not elsewhere:
            return {n: _target(n) for n in SOURCES}
        while any(not t.exists() and _building_elsewhere(t)
                  for t in elsewhere):
            time.sleep(0.5)


def build_log(name: str, counted: bool = False) -> str:
    """The compiler's report for ``name`` (registers, shared memory)."""
    path = _target(name, counted).with_suffix(".log")
    return path.read_text() if path.exists() else ""


@contextlib.contextmanager
def counting():
    """Within this context every kernel wrapper launches the counted build
    of its library (``csrc/tile_counters.cuh``); outside it, the fast
    one."""
    global _counting
    before, _counting = _counting, True
    try:
        yield
    finally:
        _counting = before


def counting_active() -> bool:
    return _counting


def library_target(name: str) -> Path:
    """The file ``library(name)`` loads now: the counted build inside
    ``counting()``, else the fast one (not built here)."""
    return _target(name, _counting)


def library(name: str, counted: Optional[bool] = None) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use): with
    ``counted`` None, the counted build inside ``counting()``, else the
    fast one."""
    counted = _counting if counted is None else counted
    with _lock:
        lib = _libs.get((name, counted))
        if lib is None:
            build_all(counted)
            lib = ctypes.CDLL(str(_target(name, counted)))
            if counted:
                lib.tile_counters_reset.argtypes = []
                lib.tile_counters_reset.restype = ctypes.c_int
                lib.tile_counters_read.argtypes = [
                    ctypes.POINTER(ctypes.c_ulonglong)]
                lib.tile_counters_read.restype = ctypes.c_int
            _libs[(name, counted)] = lib
        return lib


def _counted_libs():
    with _lock:
        return [lib for (_, counted), lib in _libs.items() if counted]


def reset_counters() -> None:
    """Zero the counters of every counted library loaded so far (after the
    launches queued before it have finished)."""
    for lib in _counted_libs():
        err = lib.tile_counters_reset()
        if err != 0:
            raise RuntimeError(f"tile_counters_reset failed: CUDA error "
                               f"{err}")


def read_counters() -> Tuple[int, int]:
    """(tiles executed, DMA blocks) summed over every counted library
    loaded so far, once the launches queued before it have finished."""
    tiles = dma = 0
    for lib in _counted_libs():
        out = (ctypes.c_ulonglong * 2)()
        err = lib.tile_counters_read(out)
        if err != 0:
            raise RuntimeError(f"tile_counters_read failed: CUDA error "
                               f"{err}")
        tiles += out[0]
        dma += out[1]
    return tiles, dma
