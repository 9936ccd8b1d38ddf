"""The kernel build's directory lock (``kernels/build.py``): the ranks of
a cohort group started cold together build in turn, so one process builds
and the others load. On the CPU, without the CUDA toolkit: a stand-in
``nvcc`` on the ``PATH`` writes its ``-o`` file after a pause and logs
each call, and three processes call ``build_all`` at once on one build
directory."""
import multiprocessing as mp
import os
import stat
import sys
import time

from repro_torch.kernels import build

FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(out + "\\n")
time.sleep(0.3)
open(out, "wb").write(b"not a library")
"""


def _build(build_dir, bin_dir, start):
    os.environ["PATH"] = bin_dir + os.pathsep + os.environ["PATH"]
    build.BUILD_DIR = build.Path(build_dir)
    while time.time() < start:          # every process starts together
        time.sleep(0.001)
    build.build_all()


def test_processes_built_cold_together_build_each_source_once(tmp_path):
    n = 3
    bin_dir, build_dir = tmp_path / "bin", tmp_path / "kernels"
    bin_dir.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    ctx = mp.get_context("spawn")
    start = time.time() + 3.0
    procs = [ctx.Process(target=_build, args=(str(build_dir), str(bin_dir),
                                               start)) for _ in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
        assert p.exitcode == 0
    calls = log.read_text().split()
    fast = [c for c in calls if "_counted_" not in c]
    # every fast library built once, by one process, and found by the rest
    assert len(fast) == len(set(fast)) == len(build.SOURCES), fast
    # a counted build another process runs is not started again
    counted = [c for c in calls if "_counted_" in c]
    assert len(counted) == len(set(counted)), counted
    for name in build.SOURCES:
        lib = build_dir / build._target(name).name
        assert lib.read_bytes() == b"not a library"


def test_building_elsewhere_reads_a_live_pid(tmp_path):
    target = tmp_path / "x.so"
    assert not build._building_elsewhere(target)
    target.with_suffix(".pid").write_text(str(os.getpid()))
    assert not build._building_elsewhere(target)      # this process
    target.with_suffix(".pid").write_text(str(os.getppid()))
    assert build._building_elsewhere(target)          # a live other one
    target.with_suffix(".pid").write_text("999999999")
    assert not build._building_elsewhere(target)      # gone
