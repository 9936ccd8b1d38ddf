"""The port's async rounds and fault injection (``fl.runtime``,
``fl.faults`` behind ``CFLSession``) on the quickstart CNN (4 workers,
400 samples, 2 of 4 clients a dispatch, the stage convolutions through
K1's plain version).

* Async at the sync operating point (the buffer the cohort,
  ``staleness_decay=0``) is the port's sync run to the bit: parameters
  and every history column but the host seconds and ``aggregate_lag``
  (the same difference of simulated times, which async takes on the
  absolute clock as the reference does: within 4 ulps of it), CFL and
  FedAvg.
* Against the JAX reference: CFL's buffered async run,
  ``tests/test_torch_async_buffered.py``; FedAvg's and the faulty sync
  rounds, ``tests/test_torch_async_faults*.py``.
* A buffer whose every delta is quarantined applies a no-op step (the
  parameters equal to the bit), as the reference's does.
* The runtime's checkpoints raise, naming ROADMAP A14.
"""
import math

import numpy as np
import pytest
import torch

from cnn_session_support import (CFG, EVENTS, FL, port_session,
                                 reference_session)
from repro.fl import faults as ref_faults
from repro_torch.fl import CFLConfig, CFLSession, faults
from repro_torch.optim.optimizers import tree_leaves

torch.set_num_threads(2)


@pytest.mark.parametrize("algorithm,selection", [("cfl", "uniform"),
                                                  ("cfl", "fairness"),
                                                  ("fedavg", "uniform")])
def test_async_at_the_sync_point_is_sync_to_the_bit(algorithm, selection):
    def run(mode, **kw):
        sess = CFLSession.from_synthetic(
            CFG, kind="synthmnist", n_workers=4, n_samples=400,
            algorithm=algorithm, device="cpu",
            fl_cfg=CFLConfig(**FL, selection=selection, mode=mode,
                             elastic_kernels=True, **kw))
        sess.run(2)
        return sess
    sync, asyn = run("sync"), run("async", staleness_decay=0.0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(sync.params),
                                                 tree_leaves(asyn.params)))
    for a, b in zip(sync.history, asyn.history):
        assert a["mode"] == "sync" and b["mode"] == "async"
        assert b["buffered"] == len(b["participants"]) == 2
        for k in set(a) - {"mode", "host_seconds", "aggregate_lag"}:
            assert a[k] == b[k], k
        # the same difference of simulated times, taken by async on the
        # absolute clock (t - (D + t_k)) and by sync as max_j t_j - t_k,
        # as the reference takes them: equal to a few ulps of the clock
        assert abs(a["aggregate_lag"] - b["aggregate_lag"]) <= \
            4 * math.ulp(a["sim_clock"])



def _all_corrupt_seed(m):
    """The first plan seed whose first async engagement corrupts every
    slot with NaN or Inf (outliers could pass the norm gate)."""
    for seed in range(200):
        kinds = faults.FaultPlan(seed=seed, corrupt_rate=1.0).draw(
            faults.STREAM_ASYNC, 0, m).kinds
        if np.isin(kinds, (faults.NAN, faults.INF)).all():
            return seed
    raise AssertionError("no such seed")


def test_all_quarantined_buffer_applies_a_noop_step():
    seed = _all_corrupt_seed(2)
    fl = dict(FL, selection="uniform", mode="async",
              faults=f"corrupt=1.0,seed={seed}")
    ref, init, pred0, _ = reference_session("fedavg", fl=fl, rounds=1)
    sess = port_session(ref, init, pred0, algorithm="fedavg", fl=fl,
                        elastic_kernels=True)
    sess.run(1)
    rec, want = sess.history[0], ref.history[0]
    assert rec["quarantined"] == want["quarantined"] == 2
    for col in EVENTS:
        assert rec[col] == want[col], col
    for a, b in zip(tree_leaves(sess.params),
                    tree_leaves(sess._init_params)):
        assert torch.equal(a, b)
    ref_plan = ref_faults.resolve_fault_plan(fl["faults"])
    assert ref_plan.seed == seed
    # both quarantined clients are owed a round
    assert list(sess.server.tracker.miss_counts()) == \
        list(np.asarray(ref.server.tracker.miss_counts()))


def test_runtime_checkpoints_raise():
    sess = CFLSession.from_synthetic(
        CFG, kind="synthmnist", n_workers=2, n_samples=64, device="cpu",
        fl_cfg=CFLConfig(n_workers=2, mode="async"))
    # the runtime's checkpoint surface (once raising, naming ROADMAP A14)
    # round-trips: a snapshot loaded back snapshots the same
    sess.run(1)
    rt = sess.server.runtime
    snap = rt.state_snapshot()
    rt.load_state(snap)
    again = rt.state_snapshot()
    assert again.keys() == snap.keys()
    assert again["events"] == snap["events"]
    for g in snap["groups"]:
        assert all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(again["groups"][g]["deltas"]),
            tree_leaves(snap["groups"][g]["deltas"])))
    # a switch back to sync drains the runtime: nothing stays pending
    sess.run(1, mode="sync")
    assert not sess.server.tracker.pending_mask().any()
    assert [r["mode"] for r in sess.history][-1] == "sync"
