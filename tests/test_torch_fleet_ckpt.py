"""The port's fleet checkpoints (``checkpoint.fleet``, ``checkpoint.io``'s
state snapshots, ``CFLSession.save_checkpoint`` / ``restore_checkpoint``),
held against the port itself on the quickstart CNN (4 clients, 400
samples, on the CPU): what a resume guarantees is self-consistency — a
session killed after round 2 and restored into a fresh process's session
runs on to the very bits of the uninterrupted run. The reference's cases
are ``tests/test_faults.py``'s checkpoint tests; no reference program is
compiled here.
"""
import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (load_state, restore_server, save_state,
                                    snapshot_server)
from repro_torch.checkpoint.io import _to_host
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.fl.server import CFLConfig
from repro_torch.fl.session import CFLSession
from repro_torch.optim.optimizers import tree_leaves

torch.set_num_threads(2)
CFG = CNNConfig(name="quickstart", in_channels=1, image_size=28,
                stem_channels=8, stages=((16, 2), (32, 2)),
                groupnorm_groups=4, elastic_widths=(0.5, 1.0))
FAULTS = "drop=0.2,corrupt=0.15,seed=5"
# at this plan's seed the buffered run drops, retries and quarantines
ASYNC_FAULTS = "drop=0.2,straggle=0.2,corrupt=0.3,seed=2"


def session(seed=3, algorithm="cfl", **fl_kw):
    fl = CFLConfig(n_workers=4, local_epochs=1, batch_size=32, lr=0.05,
                   seed=seed, **fl_kw)
    return CFLSession.from_synthetic(
        CFG, kind="synthmnist", n_workers=4, n_samples=400,
        heterogeneity="quality", fl_cfg=fl, seed=seed, algorithm=algorithm,
        device="cpu")


def assert_params_equal(a, b):
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


def test_save_state_roundtrips_bit_for_bit(tmp_path):
    gen = torch.Generator().manual_seed(0)
    state = {"w": torch.randn((3, 5), generator=gen),
             "nested": [torch.arange(4, dtype=torch.int32),
                        (torch.tensor([np.nan, np.inf]), None)],
             "host": np.float32(1.5), "n": 7, "name": "x"}
    path = str(tmp_path / "s" / "state.ckpt")
    save_state(path, state, metadata={"round_idx": 3})
    assert sorted(os.listdir(tmp_path / "s")) == ["state.ckpt",
                                                  "state.ckpt.meta.json"]
    with open(path, "rb") as f:          # the pickle holds no tensor
        blob = f.read()
    assert b"torch" not in blob
    got = load_state(path)
    assert not any(isinstance(v, torch.Tensor)
                   for v in tree_leaves(got["nested"]))
    np.testing.assert_array_equal(got["w"], state["w"].numpy())
    assert got["w"].dtype == np.float32
    np.testing.assert_array_equal(got["nested"][0], np.arange(4))
    assert got["nested"][0].dtype == np.int32
    np.testing.assert_array_equal(got["nested"][1][0], [np.nan, np.inf])
    assert got["nested"][1][1] is None
    assert (got["host"], got["n"], got["name"]) == (1.5, 7, "x")
    assert pickle.loads(pickle.dumps(_to_host(state)))["n"] == 7


# cfl sync exercises the predictor snapshot; fedavg async with a buffer of
# two the runtime's in-flight groups and retries
@pytest.mark.parametrize("mode,algorithm,kw", [
    ("sync", "cfl", {"faults": FAULTS}),
    ("async", "fedavg", {"async_buffer": 2, "faults": ASYNC_FAULTS})])
def test_kill_and_resume_is_bit_exact(mode, algorithm, kw, tmp_path):
    def build():
        return session(mode=mode, algorithm=algorithm, **kw)
    a = build()
    a.run(4)                                     # uninterrupted
    b = build()
    b.run(2)
    if mode == "async":
        assert b.server.runtime.groups           # work in flight
    path = b.save_checkpoint(str(tmp_path / f"{mode}.ckpt"))
    c = build()                                  # a fresh process
    info = c.restore_checkpoint(path)
    assert info == {"round_idx": 2, "resharded": False,
                    "dropped_in_flight": []}
    if mode == "async":          # the machine is the one that was saved
        saved, got = load_state(path)["runtime"], \
            c.server.runtime.state_snapshot()
        for k in ("clock", "next_gid", "seq", "agg_scheduled",
                  "cohort_slots", "events", "retry_attempts", "in_backoff",
                  "dropped_since_agg", "retried_since_agg"):
            assert got[k] == saved[k], k
        assert got["groups"].keys() == saved["groups"].keys()
    c.run(2)
    assert_params_equal(a, c)
    assert len(a.history) == len(c.history) == 4
    for ra, rc in zip(a.history, c.history):
        for col in ("participants", "sim_clock", "dropped", "quarantined",
                    "staleness", "accs"):
            assert ra[col] == rc[col], col
    assert sum(r["dropped"] + r["quarantined"] for r in a.history) > 0
    if mode == "async":
        assert sum(r["retried"] for r in a.history) > 0
    np.testing.assert_array_equal(a.server.tracker.miss_counts(),
                                  c.server.tracker.miss_counts())
    if algorithm == "cfl":
        p = c.server.predictor
        assert len(p.buffer_y) == len(a.server.predictor.buffer_y)
        for x, y in zip(tree_leaves(a.server.predictor.params),
                        tree_leaves(p.params)):
            assert torch.equal(x, y)


def test_checkpoint_every_autosaves_each_round(tmp_path):
    sess = session(algorithm="fedavg", checkpoint_every=1,
                   checkpoint_dir=str(tmp_path))
    sess.run(2)
    ckpts = sorted(glob.glob(os.path.join(str(tmp_path), "*.ckpt")))
    assert [os.path.basename(p) for p in ckpts] == \
        ["round_000001.ckpt", "round_000002.ckpt"]
    assert not glob.glob(os.path.join(str(tmp_path), "*.tmp"))
    for p in ckpts:
        assert os.path.exists(p + ".meta.json")
    with open(ckpts[-1] + ".meta.json") as f:
        meta = json.load(f)
    assert meta["round_idx"] == 2 and meta["mode"] == "sync"
    assert meta["algorithm"] == "fedavg"


def test_restore_rejects_wrong_fleet_format_and_architecture(tmp_path):
    b = session(algorithm="fedavg")
    b.run(1)
    path = b.save_checkpoint(str(tmp_path / "x.ckpt"))
    fresh = session(algorithm="fedavg").server
    for key, value, match in (("n_clients", 7, "fleet"),
                              ("format_version", 99, "format"),
                              ("family", "SomeOtherConfig(name='x')",
                               "architecture")):
        snap = load_state(path)
        snap[key] = value
        with pytest.raises(ValueError, match=match):
            restore_server(fresh, snap)
    assert fresh.round_idx == 0                  # nothing was loaded


def test_reshard_path_drops_in_flight_and_continues():
    """A snapshot of another topology (its device count edited) takes the
    degraded path: the durable state survives, in-flight work is dropped
    and its clients freed, and training continues."""
    kw = dict(mode="async", async_buffer=1, algorithm="fedavg",
              selection="uniform", faults="drop=0.2,seed=5")
    b = session(**kw)
    b.run(2)                       # a buffer of one leaves groups in flight
    assert b.server.runtime.groups
    snap = snapshot_server(b.server)
    snap["n_devices"] = 2
    c = session(**kw)
    info = restore_server(c.server, snap)
    assert info["resharded"] is True
    assert info["dropped_in_flight"]
    assert not c.server.tracker.pending_mask().any()
    assert not c.server.runtime.groups
    assert c.server.round_idx == b.server.round_idx
    assert_params_equal(b, c)
    c.run(1)
    assert len(c.history) == len(b.history) + 1
    assert all(torch.isfinite(t).all() for t in tree_leaves(c.params))


def test_il_keeps_no_checkpoint(tmp_path):
    il = session(algorithm="il")
    with pytest.raises(RuntimeError, match="IL"):
        il.save_checkpoint(str(tmp_path / "il.ckpt"))
    with pytest.raises(RuntimeError, match="IL"):
        il.restore_checkpoint(str(tmp_path / "il.ckpt"))
    il = session(algorithm="il", checkpoint_every=1,
                 checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="single-shot"):
        il.run(1)
