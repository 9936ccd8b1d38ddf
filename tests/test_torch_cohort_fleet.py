"""The fleet paths of the port's cohort sharding (ROADMAP A17) on a 2-rank
gloo group on the CPU: async rounds with faults and a killed shard, async
at the sync point, fleet checkpoints and the prefetch ring.

One group of two ranks is spawned once for the file (the rank program is
``tests/cohort_support.py``'s ``fleet_program``) and returns:

* buffered async with faults and ``shard_kill_rate=1.0`` on 2 shards,
  against an unsharded run whose draws drop the same shard's slots: the
  same event columns, accuracies within 1e-5, parameters within 1e-5 of
  the movement (the aggregate sums in another order);
* async at the sync point against sync, both sharded: bit for bit;
* a fleet checkpoint taken on 2 ranks with groups in flight and resumed on
  2: bit-equal to the uninterrupted run; resumed here, in one process
  without a group: the reshard-and-rewind path (in-flight groups dropped,
  their clients freed);
* the ring on, sharded: hits ≥ 1, no miss, bit-equal to the ring off;
* every selection policy's draws identical on both ranks and to the
  unsharded run's; an idle rank (three clients on two ranks) with faults,
  sync and async, bit-equal to the unsharded run.

No reference program runs here: the reference's sharded fleet tests are
its failing multi-device ones, and the port's unsharded fleet paths are
held to the reference in ``tests/test_torch_async_*.py`` and
``tests/test_torch_fleet_ckpt.py``.
"""
import shutil
import tempfile

import numpy as np
import pytest
import torch

import cohort_support as cs
from repro_torch.checkpoint import load_state
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.sharding import cohort

torch.set_num_threads(2)
TOL = 1e-5


@pytest.fixture(scope="module")
def readings():
    tmp = tempfile.mkdtemp(prefix="cohort_fleet_")
    try:
        ranks = cohort.spawn_cohort(cs.fleet_program, 2, backend="gloo",
                                    device="cpu", args=(tmp,), timeout=900)
        # the 1-process restore reads the checkpoint the ranks wrote
        resume = _resume_alone(ranks[0]["ckpt"]["path"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ranks, resume


def _resume_alone(path):
    """The 2-rank checkpoint restored in this process (no group): the
    in-flight groups' state and the restore's info."""
    snap = load_state(path)
    fresh = cs._quick(2, mode="async", async_buffer=2,
                      faults="drop=0.2,straggle=0.2,corrupt=0.3,seed=2")
    info = fresh.restore_checkpoint(path)
    groups = snap["runtime"]["groups"]
    full_deltas = all(
        all(d.shape[0] == len(g["sel"][0]) for d in tree_leaves(g["deltas"]))
        for g in groups.values())
    out = {"info": info, "n_devices": snap["n_devices"],
           "cohort_shards": snap["cohort_shards"],
           "groups_saved": len(groups), "full_deltas": full_deltas,
           "pending": bool(np.asarray(
               fresh.server.tracker.pending_mask()).any()),
           "groups_restored": len(fresh.server.runtime.groups),
           "params": cs._np(fresh.params)}
    fresh.run(1)                       # the rewound machine runs on
    out["rounds_after"] = fresh.server.round_idx
    return out


def _max_diff(a, b):
    return max(float(np.max(np.abs(x - y)))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_async_shard_kill_matches_unsharded_drops(readings):
    (r0, r1), _ = readings
    k0 = r0["kill"]
    assert k0["shards"] == 2
    assert k0["events"] == k0["events_unsharded"]
    assert k0["events"] == r1["kill"]["events"]
    # every engagement lost a shard: its slots fail their deadlines
    assert sum(e["dropped"] for e in k0["events"]) >= 2
    for a, b in zip(k0["accs"], k0["accs_unsharded"]):
        np.testing.assert_allclose(a, b, atol=TOL)
    moved = _max_diff(k0["params_unsharded"], k0["init"])
    assert moved > 1e-4
    assert _max_diff(k0["params"], k0["params_unsharded"]) <= TOL * moved
    for x, y in zip(tree_leaves(k0["params"]),
                    tree_leaves(r1["kill"]["params"])):
        np.testing.assert_array_equal(x, y)


def test_async_at_the_sync_point_is_sync_sharded(readings):
    (r0, r1), _ = readings
    for r in (r0, r1):
        assert r["parity"]["equal"] and r["parity"]["accs_equal"]


def test_sharded_checkpoint_resumes_bit_for_bit(readings):
    (r0, r1), _ = readings
    for r in (r0, r1):
        ck = r["ckpt"]
        assert ck["in_flight"] > 0           # groups were in flight
        assert ck["info"] == {"round_idx": 2, "resharded": False,
                              "dropped_in_flight": []}
        assert ck["equal"] and ck["events_equal"]


def test_sharded_checkpoint_on_one_process_reshards(readings):
    """The file the 2 ranks wrote is an unsharded run's in form (every
    group's deltas over all its slots); restored in one process it takes
    the reshard-and-rewind path."""
    (r0, _), alone = readings
    assert alone["n_devices"] == 2 and alone["cohort_shards"] == 2
    assert alone["groups_saved"] > 0 and alone["full_deltas"]
    info = alone["info"]
    assert info["resharded"] is True and info["round_idx"] == 2
    assert info["dropped_in_flight"]     # dropped, and their clients
    assert not alone["pending"]          # freed
    assert alone["groups_restored"] == 0
    for x, y in zip(tree_leaves(alone["params"]),
                    tree_leaves(r0["ckpt"]["params_at_save"])):
        np.testing.assert_array_equal(x, y)   # the durable state survives
    assert alone["rounds_after"] == 3


def test_idle_rank_with_faults_is_unsharded_to_the_bit(readings):
    """Three clients on two ranks: rank 1 holds no slot, yet joins the
    fault round's gather and aggregate and the async gate's; the runs
    equal the unsharded ones to the bit, with faults taken."""
    (r0, r1), _ = readings
    for mode in ("sync", "async"):
        assert r0["idle"][mode]["block"] == [0, 3]
        assert r1["idle"][mode]["block"] == [3, 3]
        for r in (r0, r1):
            assert r["idle"][mode]["equal"], mode
            assert r["idle"][mode]["events_equal"], mode
        assert r0["idle"][mode]["faults"] > 0, mode


def test_selection_draws_are_the_same_on_every_rank(readings):
    """Every policy's host-side draw (participants, and the specs the
    search gives them) is identical on both ranks and equal to the
    unsharded run's."""
    (r0, r1), _ = readings
    for policy, got in r0["policies"].items():
        assert got["sharded"] == r1["policies"][policy]["sharded"], policy
        assert got["sharded"] == got["unsharded"], policy
        # a subset of the fleet: one slot a rank
        assert all(len(p) == 2 for p, _ in got["sharded"]), policy


def test_ring_on_sharded_hits_and_matches_ring_off(readings):
    (r0, r1), _ = readings
    for r in (r0, r1):
        st = r["ring"]["stats"]
        assert st["hits"] >= 1 and st["misses"] == 0, st
        assert r["ring"]["equal"]
