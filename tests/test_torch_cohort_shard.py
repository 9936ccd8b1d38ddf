"""The port's cohort sharding (``repro_torch.sharding.cohort``, ROADMAP A17)
on a 2-rank gloo group on the CPU, against the port's unsharded path and
the reference.

One group of two ranks is spawned once for the file
(``spawn_cohort``; the rank program is ``tests/cohort_support.py``'s
``shard_program``) and returns every scenario's readings:

* the hierarchical aggregate (coverage norm on and off, participation on
  and off, sanitised with a NaN slot) against the reference's
  ``aggregate_apply_hierarchical`` on 2 fake CPU devices (a subprocess
  with ``--xla_force_host_platform_device_count=2``), ≤ 1e-6, with one
  ``all_reduce`` a call;
* a CFL round of the reduced CNN (4 clients, 2 a rank) against the port's
  unsharded round and the reference's unsharded ``run_fl_round``: ≤ 1e-5
  of the round's movement, accuracies within 1e-5; each rank's block
  bit-equal to an unsharded engine run on the block alone; both ranks'
  parameters bit-equal; one ``all_reduce`` and one ``all_gather`` a
  round;
* the reference's failing scenario (2 slots out of 4 clients, a padding
  slot), three clients on two ranks (one shard, rank 1 idle: bit-equal,
  no hang), FedAvg and IL over 2 rounds, and a reduced zoo parent's round.

Besides: ``cohort_shards=2`` without a group clamps to one shard; a
kernel launch with a tensor off the current card raises; and, on the card
only, ``init_cohort_group`` refuses two NCCL ranks on one card.
"""
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core import submodel as ref_submodel
from repro.fl import engine as ref_engine
from repro.models import cnn as ref_cnn

import cohort_support as cs
from repro_torch.fl import engine as engine_mod
from repro_torch.fl.server import CFLConfig
from repro_torch.fl.session import CFLSession
from repro_torch.kernels import backend
from repro_torch.sharding import cohort

torch.set_num_threads(2)
TOL = 1e-5
AGG_TOL = 1e-6

_REF_AGG = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, %r)
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.core.aggregate import aggregate_apply_hierarchical
from repro.sharding.cohort import cohort_mesh
inp = pickle.load(open(sys.argv[1], "rb"))
mesh = cohort_mesh(2)
out = {}
for name, case in inp["cases"].items():
    part = None if case["part"] is None else jnp.asarray(case["part"])
    new = aggregate_apply_hierarchical(
        jax.tree.map(jnp.asarray, inp["params"]),
        jax.tree.map(jnp.asarray, case["deltas"]),
        None if case["covs"] is None
        else jax.tree.map(jnp.asarray, case["covs"]),
        jnp.asarray(inp["weights"]), mesh=mesh,
        coverage_norm=case["covs"] is not None, participation=part,
        sanitize=case["sanitize"])
    out[name] = jax.tree.map(np.asarray, new)
pickle.dump(out, open(sys.argv[2], "wb"))
print(json.dumps({"devices": len(jax.devices())}))
"""


def _aggregate_inputs():
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "g": (3, 2, 4)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    covs = {n: (rng.random((4,) + s) > 0.4).astype(np.float32)
            for n, s in shapes.items()}
    deltas = {n: (0.01 * rng.standard_normal((4,) + s)).astype(np.float32)
              * covs[n] for n, s in shapes.items()}
    nan = {n: v.copy() for n, v in deltas.items()}
    nan["w"][0, 1, 2] = np.nan
    part = np.asarray([1.0, 1.0, 0.0, 1.0], np.float32)
    cases = {"flat": dict(deltas=deltas, covs=None, part=None,
                          sanitize=False),
             "cov": dict(deltas=deltas, covs=covs, part=None,
                         sanitize=False),
             "part": dict(deltas=deltas, covs=None, part=part,
                          sanitize=False),
             "cov_part": dict(deltas=deltas, covs=covs, part=part,
                              sanitize=False),
             "sanitize": dict(deltas=nan, covs=covs, part=part,
                              sanitize=True)}
    return {"params": params, "cases": cases,
            "weights": np.asarray([60.0, 45.0, 30.0, 75.0], np.float32)}


def _cnn_inputs():
    """The reduced CNN's parameters (the reference's init, biases given
    values), 4 clients of 60 samples (each tested on its first 30),
    per-client specs and seeds."""
    ref_cfg = RefCNNConfig(**cs.SMALL)
    rng = np.random.default_rng(2)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32),
        ref_cnn.init_params(jax.random.PRNGKey(0), ref_cfg))
    train = [{"x": rng.random((60, 28, 28, 1)).astype(np.float32),
              "y": rng.integers(0, 10, 60).astype(np.int32)}
             for _ in range(4)]
    test = [{"x": d["x"][:30], "y": d["y"][:30]} for d in train]
    specs = [((1, 1), (0.5, 0.5)), ((1, 2), (0.5, 1.0)), ((2, 2), (1.0, 1.0)),
             ((2, 1), (1.0, 0.5))]
    return {"params": params, "train": train, "test": test, "specs": specs,
            "seeds": [5, 6, 7, 8], "sizes": [60.0, 60.0, 60.0, 60.0]}


def _reference_round(inp):
    """The reference's unsharded CFL round on the same inputs."""
    eng = ref_engine.BatchedRoundEngine(RefCNNConfig(**cs.SMALL), lr=0.05,
                                        momentum=0.9)
    specs = [ref_submodel.SubmodelSpec(d, w) for d, w in inp["specs"]]
    new, accs, steps = eng.run_fl_round(
        inp["params"], specs, inp["train"], inp["test"], inp["sizes"],
        batch_size=32, epochs=1, seeds=inp["seeds"], coverage_norm=True)
    return jax.tree.map(np.asarray, new), accs, np.asarray(steps)


@pytest.fixture(scope="module")
def readings():
    """Both ranks' readings, the reference's hierarchical aggregate (a
    subprocess on 2 fake devices) and its unsharded round, computed while
    the ranks run."""
    agg, cnn = _aggregate_inputs(), _cnn_inputs()
    tmp = tempfile.mkdtemp(prefix="cohort_agg_")
    with open(os.path.join(tmp, "in.pkl"), "wb") as f:
        pickle.dump(agg, f)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    ref_agg = subprocess.Popen(
        [sys.executable, "-c", _REF_AGG % src, os.path.join(tmp, "in.pkl"),
         os.path.join(tmp, "out.pkl")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    ranks = {}

    def run():
        try:
            ranks["out"] = cohort.spawn_cohort(
                cs.shard_program, 2, backend="gloo", device="cpu",
                args=({"aggregate": agg, "cnn": cnn},), timeout=900)
        except BaseException as e:       # re-raised in the test process
            ranks["error"] = e
    runner = threading.Thread(target=run)
    runner.start()
    ref_round = _reference_round(cnn)
    stdout, stderr = ref_agg.communicate(timeout=900)
    runner.join()
    assert ref_agg.returncode == 0, stderr[-3000:]
    assert json.loads(stdout.strip().splitlines()[-1])["devices"] == 2
    with open(os.path.join(tmp, "out.pkl"), "rb") as f:
        ref_aggs = pickle.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    if "error" in ranks:
        raise ranks["error"]
    return {"ranks": ranks["out"], "agg": agg, "ref_agg": ref_aggs,
            "cnn": cnn, "ref_round": ref_round}


def _leaves(tree):
    return jax.tree.leaves(tree)


def _max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(_leaves(a), _leaves(b)))


def _movement(new, old):
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(_leaves(new), _leaves(old)))


def _ranks_equal(r0, r1):
    for x, y in zip(_leaves(r0), _leaves(r1)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["flat", "cov", "part", "cov_part",
                                  "sanitize"])
def test_hierarchical_aggregate_matches_reference(readings, case):
    """≤ 1e-6 of the reference's hierarchical aggregate on 2 fake devices
    (two clients a shard); the ranks agree to the bit; one all_reduce."""
    r0, r1 = (r["aggregate"][case] for r in readings["ranks"])
    want = readings["ref_agg"][case]
    err = _max_diff(r0["params"], want)
    assert err <= AGG_TOL, err
    assert all(np.isfinite(x).all() for x in _leaves(r0["params"]))
    _ranks_equal(r0["params"], r1["params"])
    assert r0["collectives"] == {"all_reduce": 1, "all_gather": 0}


def test_cnn_round_sharded_matches_unsharded_and_reference(readings):
    r0, r1 = (r["cnn"] for r in readings["ranks"])
    init = readings["cnn"]["params"]
    moved = _movement(r0["params_unsharded"], init)
    assert moved > 1e-4
    assert _max_diff(r0["params"], r0["params_unsharded"]) <= TOL * moved
    np.testing.assert_allclose(r0["accs"], r0["accs_unsharded"], atol=TOL)
    assert r0["n_steps"] == r0["n_steps_unsharded"]
    ref_new, ref_accs, ref_steps = readings["ref_round"]
    assert _max_diff(r0["params"], ref_new) <= TOL * moved
    np.testing.assert_allclose(r0["accs"], ref_accs, atol=TOL)
    assert r0["n_steps"] == [int(n) for n in ref_steps]
    _ranks_equal(r0["params"], r1["params"])
    assert r0["accs"] == r1["accs"]


def test_each_block_is_its_block_run_alone(readings):
    blocks = [r["cnn"]["block"] for r in readings["ranks"]]
    assert blocks == [[0, 2], [2, 4]]
    assert all(r["cnn"]["shards"] == 2 for r in readings["ranks"])
    assert all(r["cnn"]["block_equal"] for r in readings["ranks"])


def test_one_all_reduce_and_one_all_gather_a_round(readings):
    for r in readings["ranks"]:
        assert r["cnn"]["collectives"] == {"all_reduce": 1, "all_gather": 1}


def test_partial_participation_sharded_matches_unsharded(readings):
    """The reference's failing test's scenario: 2 slots of 4 clients,
    client 3 and a padding slot."""
    r0, r1 = (r["partial"] for r in readings["ranks"])
    assert [r0["block"], r1["block"]] == [[0, 1], [1, 2]]
    moved = _movement(r0["params_unsharded"], readings["cnn"]["params"])
    assert moved > 1e-4
    assert _max_diff(r0["params"], r0["params_unsharded"]) <= TOL * moved
    np.testing.assert_allclose(r0["accs"], r0["accs_unsharded"], atol=TOL)
    assert r0["n_steps"] == r0["n_steps_unsharded"]
    assert r0["n_steps"][1] == 0            # the padding slot
    _ranks_equal(r0["params"], r1["params"])


def test_three_clients_on_two_ranks_is_unsharded_to_the_bit(readings):
    r0, r1 = (r["three"] for r in readings["ranks"])
    assert r0["shards"] == r1["shards"] == 1
    assert (r0["block"], r1["block"]) == ([0, 3], [3, 3])   # rank 1 idle
    assert r0["equal"] and r1["equal"]
    assert r1["collectives"] == r0["collectives"] == {"all_reduce": 1,
                                                      "all_gather": 1}


def test_fedavg_and_il_sharded_match_unsharded(readings):
    r0, r1 = (r["baselines"] for r in readings["ranks"])
    fed = r0["fedavg"]
    moved = _movement(fed["params_unsharded"], fed["init"])
    assert moved > 1e-4
    assert _max_diff(fed["params"], fed["params_unsharded"]) <= TOL * moved
    np.testing.assert_allclose(np.asarray(fed["accs"]),
                               np.asarray(fed["accs_unsharded"]), atol=TOL)
    _ranks_equal(fed["params"], r1["fedavg"]["params"])
    # IL: each rank trains its block of clients; only accuracies gather
    np.testing.assert_allclose(r0["il"]["accs"], r0["il"]["accs_unsharded"],
                               atol=TOL)
    assert r0["il"]["accs"] == r1["il"]["accs"]
    assert len(r0["il"]["accs"]) == 4


def test_zoo_round_sharded_matches_unsharded(readings):
    r0, r1 = (r["zoo"] for r in readings["ranks"])
    moved = _movement(r0[1]["params"], r0["init"])
    assert moved > 1e-4
    assert _max_diff(r0[2]["params"], r0[1]["params"]) <= TOL * moved
    np.testing.assert_allclose(r0[2]["accs"], r0[1]["accs"], atol=TOL)
    _ranks_equal(r0[2]["params"], r1[2]["params"])


@pytest.mark.parametrize("how,match", [("raise", "fails on purpose"),
                                       ("exit", "exited with code 3")])
def test_a_failing_rank_fails_the_caller_without_a_hang(how, match):
    """Rank 1 raises (its traceback reaches the caller) or dies; rank 0
    waits in a barrier for it and is stopped."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=match):
        cohort.spawn_cohort(cs.failing_program, 2, backend="gloo",
                            device="cpu", args=(how,), timeout=120)
    assert time.perf_counter() - t0 < 60


_TORCHRUN_RANK = r"""
import os, socket, sys
sys.path.insert(0, %r)
with socket.socket() as s:                  # a free port on this host
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.fl.server import CFLConfig
from repro_torch.fl.session import CFLSession
from repro_torch.sharding import init_cohort_group
init_cohort_group(device="cpu")
cfg = CNNConfig(name="q", in_channels=1, image_size=28, stem_channels=8,
                stages=((16, 2), (32, 2)), groupnorm_groups=4,
                elastic_widths=(0.5, 1.0))
sess = CFLSession.from_synthetic(cfg, kind="synthmnist", n_workers=2,
                                 n_samples=64, device="cpu",
                                 fl_cfg=CFLConfig(n_workers=2, batch_size=16,
                                                  cohort_shards=2))
sess.run(1)
mesh = sess.server.engine.cohort_sharding(2).mesh
print(dist.get_backend(), mesh.world, mesh.n_shards)
dist.destroy_process_group()
"""


def test_init_cohort_group_joins_torchruns_group_on_the_cpu():
    """The torchrun path on the CPU: ``init_cohort_group(device="cpu")``
    reads RANK / WORLD_SIZE / LOCAL_RANK and the rendezvous (env://, a
    localhost port) and joins with gloo; a session with cohort_shards=2
    on that 1-rank group runs its round through the hierarchical path."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", _TORCHRUN_RANK % src],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-3:] == ["gloo", "1", "1"]


def test_cohort_shards_without_a_group_clamps_to_one_shard():
    """No process group: the documented clamp (the reference's clamp to
    its one device) — the engine runs unsharded, the session builds and
    trains, ``effective_cohort_shards`` gives 1."""
    assert not cohort.group_ready()
    assert cohort.effective_cohort_shards(4, 2) == 1
    assert cohort.effective_cohort_shards(4, 2, n_devices=2) == 2
    assert cohort.effective_cohort_shards(3, 2, n_devices=2) == 1
    assert cohort.effective_cohort_shards(6, 4, n_devices=4) == 3
    eng = engine_mod.BatchedRoundEngine(cs.CFG, lr=0.05, momentum=0.9,
                                        cohort_shards=2, device="cpu")
    assert eng.cohort_sharding(4) is None and eng.block(4) == (0, 4)
    sess = CFLSession.from_synthetic(
        cs.CFG, kind="synthmnist", n_workers=2, n_samples=64, device="cpu",
        cohort_shards=2, fl_cfg=CFLConfig(n_workers=2, batch_size=16))
    assert sess.fl.cohort_shards == 2
    sess.run(1)
    with pytest.raises(RuntimeError, match="process group"):
        cohort.cohort_mesh(2, device="cpu")


def test_shard_cohort_takes_the_block_as_views():
    """``shard_cohort``: rank r's contiguous block of every stacked leaf
    (tensors and numpy arrays) as views; a leaf already stacking the block
    passes unchanged; a rank past the shard count gets an empty block; any
    other leading size raises; no sharding returns the tree itself."""
    def sharding(rank, world, n_shards):
        return cohort.cohort_axis_sharding(cohort.CohortMesh(
            rank=rank, world=world, n_shards=n_shards,
            device=torch.device("cpu"), backend="gloo"))
    tree = {"w": torch.arange(16.0).reshape(4, 2, 2),
            "n": [np.arange(8).reshape(4, 2)]}
    assert cohort.shard_cohort(tree, None) is tree
    r1 = sharding(1, 2, 2)
    got = cohort.shard_cohort(tree, r1)
    assert torch.equal(got["w"], tree["w"][2:4])
    assert got["w"].data_ptr() == tree["w"][2].data_ptr()
    assert np.shares_memory(got["n"][0], tree["n"][0])
    np.testing.assert_array_equal(got["n"][0], tree["n"][0][2:4])
    again = cohort.shard_cohort(got, r1, 4)
    assert again["w"] is got["w"] and again["n"][0] is got["n"][0]
    idle = cohort.shard_cohort(tree, sharding(2, 3, 2))
    assert idle["w"].shape == (0, 2, 2) and idle["n"][0].shape == (0, 2)
    with pytest.raises(ValueError, match="fits neither"):
        cohort.shard_cohort({"w": torch.zeros(3, 2)}, r1, 4)


def test_launch_with_a_tensor_off_the_current_card_raises(monkeypatch):
    """The wrappers' launches go through ``backend.stream_handle``: a
    tensor on cuda:1 while cuda:0 is current raises, naming both."""
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    with pytest.raises(RuntimeError, match="cuda:1.*cuda:0"):
        backend.stream_handle(torch.device("cuda", 1))


@pytest.mark.cuda
def test_two_nccl_ranks_on_one_card_raise(monkeypatch):
    """With WORLD_SIZE 2 on one card and no explicit gloo,
    ``init_cohort_group`` raises before it joins a group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() > 1:
        pytest.skip("needs exactly one card")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="NCCL cannot put two ranks"):
        cohort.init_cohort_group()
    assert not cohort.group_ready()
