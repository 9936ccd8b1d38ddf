"""The port's client selection (``fl.selection``) against the JAX
reference.

* The numpy path of every policy, in both RNG modes, over a sweep of
  fleet states (never-seen clients, misses, predictions absent or given,
  a deadline quantile that leaves fewer feasible clients than slots):
  the very ``Selection`` of the reference.
* ``FleetTracker``'s columns after a scripted sequence of records,
  misses, dispatches and staleness bumps, a duplicate id included: equal.
* The device path at K = 10^5: each policy's scores and the fairness
  policy's reweighted weights within 1e-6; the port's own gumbel-top-k
  draw (torch cannot reproduce ``jax.random``): m distinct clients,
  weights summing to the mass, repeatable per seed.
* The two ``ValueError``s: legacy RNG with the device path, and a
  quality level past the fairness table.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import selection as ref_sel
from repro.fl.client import ClientInfo as RefClientInfo
from repro_torch.fl import selection
from repro_torch.fl.client import ClientInfo

torch.set_num_threads(2)
POLICIES = ("full", "uniform", "fairness", "latency")


def _clients(k, seed, quals=4):
    rng = np.random.default_rng(seed)
    return [ClientInfo(cid=i, device=("a", "b", "c")[i % 3],
                       quality=int(rng.integers(0, quals)),
                       n_samples=int(rng.integers(20, 200)),
                       latency_bound=1.0) for i in range(k)]


def _ref(clients):
    return [RefClientInfo(**dataclasses.asdict(c)) for c in clients]


def _policies(name, fraction):
    """The port's and the reference's policy of ``name`` at ``fraction``
    (the latency policy at a quantile low enough that, at the smaller
    fractions, fewer clients than slots are feasible)."""
    if name == "full":
        return selection.FullParticipation(), ref_sel.FullParticipation()
    if name == "latency":
        return (selection.LatencySelection(fraction, deadline_q=0.3),
                ref_sel.LatencySelection(fraction, deadline_q=0.3))
    return (selection.SELECTION_POLICIES[name](fraction),
            ref_sel.SELECTION_POLICIES[name](fraction))


def _equal(a, b):
    for k in ("idx", "valid", "weights"):
        got, want = getattr(a, k), getattr(b, k)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _state(rng, k, r, with_times, with_misses):
    accs = rng.random(k).astype(np.float32).astype(np.float64)
    accs[rng.random(k) < 0.3] = np.nan        # never-seen clients
    counts = rng.integers(0, r + 1, k).astype(np.int32)
    times = rng.random(k) * 5 + 0.1 if with_times else None
    misses = rng.integers(0, 3, k).astype(np.int32) if with_misses else None
    return dict(round_idx=r, last_accs=accs, participation_counts=counts,
                predicted_times=times, misses=misses)


@pytest.mark.parametrize("name", POLICIES)
def test_numpy_path_selection_equals_reference(name):
    """Every policy over a sweep of states and seeds, in both RNG modes:
    the same idx, valid and weights (dtypes included)."""
    for k, fraction in ((7, 0.5), (12, 0.25), (12, 0.75), (3, 1.0)):
        clients = _clients(k, k)
        for case in range(6):
            rng = np.random.default_rng(100 * k + case)
            st = _state(rng, k, case, case % 2 == 0, case % 3 != 0)
            got = selection.FleetState(clients, **st)
            want = ref_sel.FleetState(_ref(clients), **st)
            pol, ref_pol = _policies(name, fraction)
            for seed in (0, 5):
                for mode in ("seedseq", "legacy"):
                    t = selection.FleetTracker(clients, pol, seed=seed,
                                               rng_mode=mode)
                    rt = ref_sel.FleetTracker(_ref(clients), ref_pol,
                                              seed=seed, rng_mode=mode)
                    _equal(pol.select(got, t._round_rng(case)),
                           ref_pol.select(want, rt._round_rng(case)))


@pytest.mark.parametrize("name", POLICIES)
def test_tracker_rounds_equal_reference(name):
    """Trackers driven through four rounds (select, record with float32
    accuracies, misses, the latency predictions from the same function):
    the same cohorts round by round."""
    clients = _clients(10, 3)
    times = list(np.linspace(0.5, 4.0, 10)[::-1])
    for mode in ("seedseq", "legacy"):
        pol, ref_pol = _policies(name, 0.4)
        t = selection.FleetTracker(clients, pol, seed=2, rng_mode=mode,
                                   predicted_times_fn=lambda: times)
        rt = ref_sel.FleetTracker(_ref(clients), ref_pol, seed=2,
                                  rng_mode=mode,
                                  predicted_times_fn=lambda: times)
        for r in range(4):
            a, b = t.select(r), rt.select(r)
            _equal(a, b)
            accs = [0.1 + 0.07 * i + 0.01 * r for i in range(len(
                a.participants))]
            t.record(a.participants, accs)
            rt.record(b.participants, accs)
            t.record_miss(a.participants[:1])
            rt.record_miss(b.participants[:1])


def _columns(t):
    a = t.arrays
    return {"participation_counts": t.participation_counts,
            "last_accs": t.last_accs, "miss_counts": t.miss_counts(),
            "staleness": np.asarray(a.staleness),
            "pending": np.asarray(a.pending),
            "pending_mask": t.pending_mask()}


def test_tracker_columns_equal_reference():
    """A scripted record / miss / dispatch / staleness sequence, with a
    duplicate id in a record and a miss: every column equal."""
    clients = _clients(6, 1)
    t = selection.FleetTracker(clients, "uniform", seed=1)
    rt = ref_sel.FleetTracker(_ref(clients), "uniform", seed=1)
    script = [("record", [0, 2, 2], [0.5, 0.25, 0.75]),
              ("record_miss", [1, 1, 4]),
              ("mark_pending", [3, 5]),
              ("bump_staleness",),
              ("bump_staleness",),
              ("mark_pending", [0]),
              ("bump_staleness",),
              ("record", [5, 3], [0.1, 1.0 / 3.0]),
              ("clear_pending", [5]),
              ("record_miss", []),
              ("record_miss", [3])]
    for step in script:
        getattr(t, step[0])(*step[1:])
        getattr(rt, step[0])(*step[1:])
        got, want = _columns(t), _columns(rt)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert list(t.participation_counts) == [1, 0, 2, 1, 0, 1]
    assert list(t.miss_counts()) == [0, 2, 0, 1, 1, 0]
    assert list(t.arrays.staleness) == [1, 0, 0, 3, 0, 0]
    np.testing.assert_array_equal(
        t.state(3).staleness, np.asarray(rt.state(3).staleness))


def _fleet_arrays(k, seed):
    """The same (K,) columns as the reference's FleetArrays and the
    port's."""
    rng = np.random.default_rng(seed)
    cols = dict(
        n_samples=rng.integers(10, 500, k).astype(np.float32),
        quality=rng.integers(0, 5, k).astype(np.int32),
        last_accs=np.where(rng.random(k) < 0.2, np.nan,
                           rng.random(k)).astype(np.float32),
        participation_counts=rng.integers(0, 9, k).astype(np.int32),
        predicted_times=np.where(rng.random(k) < 0.1, np.nan,
                                 rng.random(k) * 10).astype(np.float32),
        staleness=np.zeros(k, np.int32), pending=np.zeros(k, np.float32),
        miss_counts=rng.integers(0, 4, k).astype(np.int32))
    port = selection.FleetArrays(**{n: torch.as_tensor(v)
                                    for n, v in cols.items()})
    ref = ref_sel.FleetArrays(**{n: jnp.asarray(v) for n, v in cols.items()})
    return port, ref, cols


@pytest.mark.parametrize("name", ["uniform", "fairness", "latency"])
def test_device_path_scores_and_weights_at_fleet_scale(name):
    """K = 10^5: the scores (and the fairness policy's reweighting of a
    fixed cohort) within 1e-6 of the reference's; a fleet with no
    predictions scores uniform under the latency policy."""
    k = 100_000
    port, ref, cols = _fleet_arrays(k, 7)
    pol = selection.SELECTION_POLICIES[name](0.01)
    ref_pol = ref_sel.SELECTION_POLICIES[name](0.01)
    for r in (0, 3, 40):
        got = pol.scores(port, r).numpy()
        want = np.asarray(ref_pol.scores(ref, r))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    idx = np.random.default_rng(8).choice(k, pol.cohort_size(k),
                                          replace=False)
    w = cols["n_samples"][idx]
    got = pol._array_weights(port, torch.as_tensor(idx), torch.as_tensor(w))
    want = ref_pol._array_weights(ref, jnp.asarray(idx), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    if name == "latency":
        blank = dataclasses.replace(port, predicted_times=torch.full(
            (k,), float("nan")))
        assert torch.equal(pol.scores(blank, 0), torch.ones(k))


@pytest.mark.parametrize("name", ["uniform", "fairness", "latency"])
def test_device_path_draw(name):
    """The port's gumbel-top-k draw through ``FleetTracker``
    (``device_select=True``): m distinct clients, all valid, weights
    summing to the participating mass (n_k; the fairness policy
    renormalises its reweighting to it), the same cohort for the same
    seed and round, another for another round; the latency policy picks
    only clients at or under its deadline when enough are."""
    clients = _clients(200, 11, quals=6)
    times = list(np.linspace(0.1, 2.0, 200))

    def tracker(seed):
        return selection.FleetTracker(clients, name, seed=seed,
                                      device_select=True,
                                      predicted_times_fn=lambda: times)
    a, b = tracker(4), tracker(4)
    m = a.policy.cohort_size(200)
    n = np.asarray([c.n_samples for c in clients], np.float32)
    for r in range(3):
        s1, s2 = a.select(r), b.select(r)
        _equal(s1, s2)
        assert len(set(s1.idx.tolist())) == m == len(s1.idx)
        assert (s1.valid == 1).all()
        np.testing.assert_allclose(s1.weights.sum(), n[s1.idx].sum(),
                                   rtol=1e-5)
        if name != "fairness":
            np.testing.assert_array_equal(s1.weights, n[s1.idx])
        if name == "latency":
            assert (np.asarray(times)[s1.idx] <=
                    np.quantile(times, a.policy.deadline_q)).all()
    assert not np.array_equal(a.select(0).idx, a.select(1).idx)
    assert not np.array_equal(a.select(0).idx, tracker(5).select(0).idx)
    # the auto rule: the device path from DEVICE_SELECT_THRESHOLD clients
    assert not selection.FleetTracker(clients, name)._use_device_path()


def test_selection_value_errors():
    """legacy RNG with the device path asked for, and a quality level past
    the fairness policy's group table, raise the reference's errors."""
    clients = _clients(8, 2)
    legacy = selection.FleetTracker(clients, "uniform", rng_mode="legacy",
                                    device_select=True)
    with pytest.raises(ValueError, match="rng_mode='legacy'"):
        legacy.select(0)
    ok = selection.FleetTracker(clients, "uniform", rng_mode="legacy")
    _equal(ok.select(1), ref_sel.FleetTracker(
        _ref(clients), "uniform", rng_mode="legacy").select(1))
    high = [dataclasses.replace(c, quality=8 if c.cid == 3 else c.quality)
            for c in clients]
    fair = selection.FleetTracker(high, "fairness", device_select=True)
    with pytest.raises(ValueError, match="quality levels < 8"):
        fair.select(0)
    # the numpy path takes any quality level, as the reference's does
    _equal(selection.FleetTracker(high, "fairness").select(0),
           ref_sel.FleetTracker(_ref(high), "fairness").select(0))
    with pytest.raises(ValueError, match="rng_mode"):
        selection.FleetTracker(clients, rng_mode="numpy")
    with pytest.raises(ValueError, match="unknown selection policy"):
        selection.resolve_policy("fastest")
    with pytest.raises(ValueError, match="fraction"):
        selection.UniformSelection(0.0)
