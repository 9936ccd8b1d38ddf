"""The port's double-buffered prefetch ring (``fl.engine``'s
``stage_cohort`` / ``prefetch_*``, the servers' ``_stage_next_round``, the
runtime's ``_stage_next_dispatch``), held against the port itself on the
quickstart CNN (4 clients, 400 samples, on the CPU, where the staging
copies are plain): a ring-on run is a ring-off run to the bit, its
counters read as the staging predicts, a change of policy, fleet or mode
flushes it, a stale entry is rejected, and a checkpoint taken with a
staged cohort keeps only its derivation and resumes bit for bit. The
reference's cases are ``tests/test_overlap.py``'s; no reference program is
compiled here.
"""
import math
import os

import pytest
import torch

from repro_torch.checkpoint import (restore_fleet_checkpoint,
                                    restore_server, save_fleet_checkpoint,
                                    snapshot_server)
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.fl.server import CFLConfig
from repro_torch.fl.session import CFLSession
from repro_torch.optim.optimizers import tree_leaves

torch.set_num_threads(2)
CFG = CNNConfig(name="quickstart", in_channels=1, image_size=28,
                stem_channels=8, stages=((16, 2), (32, 2)),
                groupnorm_groups=4, elastic_widths=(0.5, 1.0))


def session(seed=0, *, overlap=False, algorithm="cfl", mode="sync",
            selection="uniform", **fl_kw):
    fl = CFLConfig(n_workers=4, local_epochs=1, batch_size=32, lr=0.05,
                   seed=seed, mode=mode, selection=selection,
                   overlap=overlap, **fl_kw)
    return CFLSession.from_synthetic(
        CFG, kind="synthmnist", n_workers=4, n_samples=400,
        heterogeneity="quality", fl_cfg=fl, seed=seed, algorithm=algorithm,
        device="cpu")


def same(a, b) -> bool:
    """History equality with NaN == NaN; host seconds are wall time."""
    if isinstance(a, dict):
        keys = set(a) - {"host_seconds"}
        return keys == set(b) - {"host_seconds"} and \
            all(same(a[k], b[k]) for k in keys)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    return a == b


def assert_bit_exact(a, b):
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert same(a.history, b.history)


def ab(rounds=3, **kw):
    a, b = session(**kw), session(overlap=True, **kw)
    a.run(rounds)
    b.run(rounds)
    return a, b


@pytest.mark.parametrize("kw,stats", [
    # every round stages the next one, every round after the first hits
    (dict(selection="uniform"), dict(staged=3, hits=2, misses=0)),
    (dict(selection="full", mode="async"), dict(staged=3, hits=2,
                                                misses=0)),
    (dict(selection="latency", algorithm="fedavg"), dict(staged=3, hits=2,
                                                         misses=0)),
    # the faulty path stages and hits as the clean one: its draws are
    # keyed by the round, not by what the round records
    (dict(selection="uniform", faults="drop=0.25,straggle=0.2,"
          "corrupt=0.15,seed=7", seed=7), dict(staged=3, hits=2, misses=0)),
])
def test_ring_on_equals_ring_off(kw, stats):
    a, b = ab(**kw)
    assert_bit_exact(a, b)
    got = b.server.engine.prefetch_stats()
    assert {k: got[k] for k in stats} == stats, got
    assert a.server.engine.prefetch_stats()["staged"] == 0


def test_ring_on_equals_ring_off_async_with_faults():
    """A buffered run under faults: deadlines and retries flush the ring
    and a dispatch at partial availability misses its staged entry; the
    results stay the ring-off run's."""
    a, b = ab(rounds=4, seed=7, mode="async", async_buffer=2,
              faults="drop=0.25,straggle=0.2,corrupt=0.15,seed=7")
    assert_bit_exact(a, b)
    got = b.server.engine.prefetch_stats()
    assert got["staged"] > 0 and got["flushes"] > 0, got


def test_state_dependent_policy_never_stages():
    """Fairness draws read what the last round recorded: nothing is
    staged, nothing goes stale, the run is the ring-off run."""
    a, b = ab(selection="fairness")
    assert_bit_exact(a, b)
    assert b.server.engine.prefetch_stats()["staged"] == 0


def test_policy_fleet_and_mode_changes_flush_the_ring():
    a, b = ab(rounds=2)
    eng = b.server.engine
    assert len(eng._prefetch_ring) == 1              # round 2's, staged
    a.server.set_selection("full")
    b.server.set_selection("full")
    assert not eng._prefetch_ring                    # a policy change
    a.run(1)
    b.run(1)
    assert len(eng._prefetch_ring) == 1
    b.server.tracker.set_fleet(b.server.clients)     # a fleet change
    a.server.tracker.set_fleet(a.server.clients)
    assert not eng._prefetch_ring
    a.run(1)
    b.run(1)
    a.server.set_mode("async")
    b.server.set_mode("async")
    assert not eng._prefetch_ring                    # a mode change
    a.run(2)
    b.run(2)
    a.server.set_mode("sync")                        # drains
    b.server.set_mode("sync")
    assert not eng._prefetch_ring
    a.run(1)
    b.run(1)
    assert_bit_exact(a, b)
    assert eng.prefetch_stats()["flushes"] >= 4


def test_stale_staged_entry_is_rejected_not_replayed():
    a, b = ab(rounds=1)
    eng, srv = b.server.engine, b.server
    eng.flush_prefetch("test")
    sel = srv.tracker.select(srv.round_idx)
    eng.stage_cohort(srv.round_idx, srv.client_data,
                     batch_size=srv.fl.batch_size,
                     epochs=srv.fl.local_epochs, seeds=[999] * len(sel.idx),
                     eval_datasets=srv.test_data, participation=sel)
    a.run(2)
    b.run(2)
    assert_bit_exact(a, b)
    assert eng.prefetch_stats()["misses"] == 1


def test_ring_depth_disable_and_the_knobs():
    sess = session(overlap=True, prefetch_depth=2)
    eng = sess.server.engine
    assert eng.prefetch_enabled and eng._prefetch_depth == 2
    sess.run(2)
    eng.enable_prefetch(1)
    assert len(eng._prefetch_ring) <= 1
    eng.enable_prefetch(0)
    assert not eng.prefetch_enabled and not eng._prefetch_ring
    eng.stage_cohort(0, sess.server.client_data, batch_size=32, epochs=1,
                     seeds=[0] * 4)
    assert not eng._prefetch_ring                    # disabled: a no-op
    sess.run(1, overlap=True)
    assert eng.prefetch_enabled and sess.server.fl.overlap
    sess.run(1, overlap=False)
    assert not eng.prefetch_enabled
    seq = session(batched_rounds=False)
    with pytest.raises(ValueError, match="batched"):
        seq.server.set_overlap(True)
    seq.server.set_overlap(False)                    # disabling is fine
    with pytest.raises(ValueError, match="IL"):
        session(algorithm="il", selection="full").run(1, overlap=True)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_checkpoint_with_a_staged_cohort_resumes_bit_exact(mode, tmp_path):
    ref = session(seed=3, overlap=True, mode=mode)
    ref.run(4)
    a = session(seed=3, overlap=True, mode=mode)
    a.run(2)
    assert len(a.server.engine._prefetch_ring) == 1
    snap = snapshot_server(a.server)
    for e in snap["prefetch"]["entries"]:            # a derivation only
        assert set(e) == {"round_idx", "batch_size", "epochs", "seeds",
                          "has_eval", "sel"}
    path = os.fspath(tmp_path / "staged.ckpt")
    save_fleet_checkpoint(path, a.server)
    b = session(seed=3, overlap=True, mode=mode)
    assert not restore_fleet_checkpoint(path, b.server)["resharded"]
    assert len(b.server.engine._prefetch_ring) == 1
    b.run(2)
    assert_bit_exact(ref, b)
    assert b.server.engine.prefetch_stats() == \
        ref.server.engine.prefetch_stats()


def test_restore_of_a_ring_off_snapshot_keeps_the_ring_usable():
    a = session(seed=5)
    a.run(2)
    snap = snapshot_server(a.server)
    assert snap["prefetch"] == {"depth": 0, "entries": [], "stats": {
        "staged": 0, "hits": 0, "misses": 0, "flushes": 0}}
    b = session(seed=5, overlap=True)
    snap["prefetch"] = None          # a writer without the ring
    restore_server(b.server, snap)
    assert b.server.engine.prefetch_enabled
    b.run(2)
    assert b.server.engine.prefetch_stats()["hits"] == 1


@pytest.mark.cuda
def test_cuda_ring_stages_on_a_side_stream_and_changes_no_bit():
    """On the card the staged copies come from pinned buffers on the
    engine's side stream, end in an event the consuming stream waits on,
    and the ring-on run is the ring-off run to the bit, K1's launches
    unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels.elastic_matmul import elastic_dense

    def run(overlap):
        fl = CFLConfig(n_workers=4, local_epochs=1, batch_size=32, lr=0.05,
                       seed=0, selection="uniform", overlap=overlap,
                       elastic_kernels=True)
        sess = CFLSession.from_synthetic(
            CFG, kind="synthmnist", n_workers=4, n_samples=400,
            heterogeneity="quality", fl_cfg=fl, seed=0, device="cuda")
        elastic_dense.launches = 0
        sess.run(3)
        torch.cuda.synchronize()
        return sess, elastic_dense.launches
    a, launches_off = run(False)
    b, launches_on = run(True)
    assert_bit_exact(a, b)
    assert launches_on == launches_off > 0
    eng = b.server.engine
    assert eng.prefetch_stats()["hits"] == 2
    (entry,) = eng._prefetch_ring                # round 3's, staged
    assert entry.event is not None and eng._side is not None
    assert all(t.is_cuda for t in entry.inputs.owned)
