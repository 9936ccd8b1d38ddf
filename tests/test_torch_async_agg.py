"""The port's buffered aggregation and fault injection
(``core.aggregate``'s buffered half, ``fl.faults``) against the JAX
reference, on numpy-seeded stacked trees.

* ``staleness_scale`` equal; ``cohort_reduce`` (both forms of the
  denominator — the coverage as the reference's full 0/1 tree and as the
  port's broadcast factors —, participation, staleness scale, sanitize),
  ``buffer_add`` and ``buffer_apply``: within 1e-6.
* ``delta_validity`` with an even and an odd count of finite
  participating slots (the median of an even count is the mean of the
  two middle norms), NaN / Inf / norm outliers, padding slots and
  ``clip_factor <= 0``: equal flags, norms within 1e-6.
* ``inject_deltas`` bit-equal; ``FaultPlan.draw`` over many
  ``(stream, key, n)`` and ``resolve_fault_plan``'s forms: equal.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import faults as ref_faults
from repro_torch.core import aggregate
from repro_torch.fl import faults

torch.set_num_threads(2)
ref_agg = importlib.import_module("repro.core.aggregate")
TOL = 1e-6
G = 5


def _trees(seed, g=G):
    """Stacked deltas, their full-shaped 0/1 coverages (the reference's
    form) and the same coverages as broadcast factors (the port's), and
    a parent."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 4), "b": (4,), "k": (3, 2, 5)}
    deltas = {n: rng.standard_normal((g,) + s).astype(np.float32)
              for n, s in shapes.items()}
    # per-client prefix masks over the last axis: a factor (G, 1.., n)
    pre = rng.integers(0, 5, (g,))
    factors = {}
    for n, s in shapes.items():
        f = (np.arange(s[-1])[None, :] < np.minimum(
            pre, s[-1])[:, None]).astype(np.float32)
        factors[n] = f.reshape((g,) + (1,) * (len(s) - 1) + (s[-1],))
    full = {n: np.broadcast_to(factors[n], deltas[n].shape).copy()
            for n in shapes}
    deltas = {n: deltas[n] * full[n] for n in shapes}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    return deltas, full, factors, params


def _t(tree):
    return jax.tree.map(torch.as_tensor, tree)


def _close(got, want, tol=TOL):
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(np.broadcast_to(got[k].numpy(), w.shape),
                                   w, atol=tol * max(1.0, np.abs(w).max()),
                                   rtol=0, err_msg=k)


def test_staleness_scale_equal():
    for s in (0, 1, 3, 10):
        for a in (0.0, 0.5, 1.0, 2.0):
            assert aggregate.staleness_scale(s, a) == \
                ref_agg.staleness_scale(s, a)


@pytest.mark.parametrize("coverage_norm", [False, True])
@pytest.mark.parametrize("sanitize", [False, True])
def test_cohort_reduce_and_buffer_match_reference(coverage_norm, sanitize):
    """Two groups reduced (participation, staleness scale), added and
    applied; under ``coverage_norm`` the port takes its coverages as
    broadcast factors, the reference as full trees."""
    d1, full1, fac1, params = _trees(1)
    d2, full2, fac2, _ = _trees(2)
    if sanitize:
        d1["w"][1, 0, 0] = np.nan
        d2["b"][3, 1] = np.inf
    w1 = np.asarray([3.0, 1.0, 2.0, 0.0, 5.0], np.float32)
    w2 = np.asarray([1.0, 4.0, 2.0, 2.0, 1.0], np.float32)
    p1 = np.asarray([1, 1, 0, 1, 1], np.float32)
    p2 = np.asarray([0, 1, 1, 1, 0], np.float32)
    s2 = aggregate.staleness_scale(2, 0.5)
    got, want = [], []
    for d, full, fac, w, p, s in ((d1, full1, fac1, w1, p1, 1.0),
                                  (d2, full2, fac2, w2, p2, s2)):
        got.append(aggregate.cohort_reduce(
            _t(d), _t(fac) if coverage_norm else None, torch.as_tensor(w),
            coverage_norm=coverage_norm, participation=torch.as_tensor(p),
            scale=s, sanitize=sanitize))
        want.append(ref_agg.cohort_reduce(
            d, full if coverage_norm else None, jnp.asarray(w),
            coverage_norm=coverage_norm, participation=jnp.asarray(p),
            scale=jnp.float32(s), sanitize=sanitize))
        _close(got[-1][0], want[-1][0])
        if coverage_norm:
            _close(got[-1][1], want[-1][1])
        else:
            np.testing.assert_allclose(float(got[-1][1]),
                                       float(want[-1][1]), rtol=TOL)
    tot = aggregate.buffer_add(got[0], got[1])
    ref_tot = ref_agg.buffer_add(want[0], want[1])
    _close(tot[0], ref_tot[0])
    new = aggregate.buffer_apply(_t(params), *tot,
                                 coverage_norm=coverage_norm)
    ref_new = ref_agg.buffer_apply(params, *ref_tot,
                                   coverage_norm=coverage_norm)
    _close(new, ref_new)
    if sanitize:
        assert all(bool(torch.isfinite(v).all()) for v in new.values())
    # one group holding the whole cohort is aggregate_apply
    one = aggregate.buffer_apply(_t(params), *aggregate.cohort_reduce(
        _t(d1), _t(fac1) if coverage_norm else None, torch.as_tensor(w1),
        coverage_norm=coverage_norm, participation=torch.as_tensor(p1),
        sanitize=sanitize), coverage_norm=coverage_norm)
    fused = aggregate.aggregate_apply(
        _t(params), _t(d1), _t(fac1) if coverage_norm else None,
        torch.as_tensor(w1), coverage_norm=coverage_norm,
        participation=torch.as_tensor(p1), sanitize=sanitize)
    _close(one, {k: v.numpy() for k, v in fused.items()})


def test_all_quarantined_buffer_is_a_noop_step():
    """No participating mass: (0, 0) partial sums, a step of exactly 0."""
    d, _, fac, params = _trees(3)
    d["w"][0, 0, 0] = np.nan
    for cov in (False, True):
        num, den = aggregate.cohort_reduce(
            _t(d), _t(fac) if cov else None, torch.ones(G),
            coverage_norm=cov, participation=torch.zeros(G), sanitize=True)
        new = aggregate.buffer_apply(_t(params), num, den,
                                     coverage_norm=cov)
        for k in params:
            assert torch.equal(new[k], torch.as_tensor(params[k]))


def _gate_cases():
    """(deltas, participation, clip) cases: even and odd counts of finite
    participating slots, NaN / Inf / outliers, padding, clip <= 0."""
    cases = []
    for seed, n_slots in ((4, 6), (5, 7), (6, 4), (7, 5)):
        d, _, _, _ = _trees(seed, n_slots)
        part = np.ones((n_slots,), np.float32)
        part[-1] = 0.0                                # a padding slot
        d["w"][0] = d["w"][0] * 1e4                   # an outlier
        d["b"][1, 2] = np.nan
        if seed % 2:
            d["k"][2, 0, 1, 3] = -np.inf
        for clip in (6.0, 2.0, 0.0, -1.0):
            cases.append((d, part, clip))
    d, _, _, _ = _trees(8, 3)
    d["w"][:] = np.nan                               # no finite slot at all
    cases.append((d, np.ones((3,), np.float32), 6.0))
    return cases


def test_delta_validity_matches_reference():
    n_even = 0
    for d, part, clip in _gate_cases():
        ok, norm = aggregate.delta_validity(_t(d), torch.as_tensor(part),
                                            clip)
        ref_ok, ref_norm = ref_agg.delta_validity(d, jnp.asarray(part),
                                                  jnp.float32(clip))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
        fin = np.isfinite(np.asarray(ref_norm))
        np.testing.assert_allclose(norm.numpy()[fin],
                                   np.asarray(ref_norm)[fin], rtol=TOL)
        n_even += int((fin & (part > 0)).sum() % 2 == 0)
    assert n_even >= 4


def test_delta_validity_even_median_is_the_mean_of_the_middle_two():
    """Four finite slots of norms 1, 2, 4 and 9: the median is 3 (the
    lower middle value would be 2), so at clip 2.9 the 9 is rejected and
    at clip 1.4 the 4 passes (4 <= 4.2; 2.8 with the lower value) — as the
    reference decides."""
    norms = np.asarray([1.0, 2.0, 4.0, 9.0], np.float32)
    d = {"w": np.zeros((4, 3), np.float32)}
    d["w"][:, 0] = norms
    for clip, want in ((2.9, [1, 1, 1, 0]), (1.4, [1, 1, 1, 0]),
                       (1.3, [1, 1, 0, 0])):
        ok, _ = aggregate.delta_validity(_t(d), torch.ones(4), clip)
        ref_ok, _ = ref_agg.delta_validity(d, jnp.ones(4), jnp.float32(clip))
        assert ok.tolist() == want == np.asarray(ref_ok).tolist()


def test_inject_deltas_bit_equal():
    d, _, _, _ = _trees(9, 6)
    plan = faults.FaultPlan(seed=1, corrupt_rate=1.0, outlier_scale=1e6)
    for key in range(8):
        gf = plan.draw(faults.STREAM_ASYNC, key, 6)
        ref_gf = ref_faults.FaultPlan(seed=1, corrupt_rate=1.0,
                                      outlier_scale=1e6).draw(
            ref_faults.STREAM_ASYNC, key, 6)
        codes, scales = gf.codes_scales(plan.outlier_scale)
        rc, rs = ref_gf.codes_scales(1e6)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(scales.numpy(), np.asarray(rs))
        got = faults.inject_deltas(_t(d), codes, scales)
        want = ref_faults.inject_deltas(d, rc, rs)
        for k in d:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    clean = faults.inject_deltas(_t(d), torch.zeros(6, dtype=torch.int32),
                                 torch.ones(6))
    for k in d:
        assert torch.equal(clean[k], torch.as_tensor(d[k]))


def test_fault_plan_draws_equal_reference():
    plans = [dict(seed=0, drop_rate=0.2, straggle_rate=0.1,
                  corrupt_rate=0.1),
             dict(seed=7, drop_rate=0.5), dict(seed=3, corrupt_rate=0.9),
             dict(seed=1, drop_rate=0.1, straggle_rate=0.3,
                  corrupt_rate=0.2, shard_kill_rate=0.5)]
    for kw in plans:
        plan, ref_plan = faults.FaultPlan(**kw), ref_faults.FaultPlan(**kw)
        for stream in (faults.STREAM_ASYNC, faults.STREAM_SYNC):
            for key in range(12):
                for n in (1, 4, 9):
                    for shards in (1, 2):
                        a = plan.draw(stream, key, n, shards)
                        b = ref_plan.draw(stream, key, n, shards)
                        np.testing.assert_array_equal(a.kinds, b.kinds)
                        assert a.killed_shard == b.killed_shard
                        for f in ("drop", "straggle", "corrupt"):
                            np.testing.assert_array_equal(getattr(a, f),
                                                          getattr(b, f))
                        assert a.any_fault() == b.any_fault()


def test_resolve_fault_plan_equal_reference():
    for spec in (None, False, 0.25, {"drop_rate": 0.1, "seed": 4},
                 "drop=0.2,straggle=0.1,corrupt=0.05,kill=0.1,seed=3",
                 "drop=0.1, factor=4, outlier=100", "",
                 faults.FaultPlan(drop_rate=0.3)):
        ref_spec = ref_faults.FaultPlan(drop_rate=0.3) \
            if isinstance(spec, faults.FaultPlan) else spec
        got = faults.resolve_fault_plan(spec)
        want = ref_faults.resolve_fault_plan(ref_spec)
        assert (got is None) == (want is None)
        if got is not None:
            for f in ("seed", "drop_rate", "straggle_rate", "straggle_factor",
                      "corrupt_rate", "outlier_scale", "shard_kill_rate"):
                assert getattr(got, f) == getattr(want, f), f
            assert got.any_rates() == want.any_rates()
    for bad, err in (("drop", ValueError), ([0.1], TypeError),
                     ("drop=0.7,corrupt=0.5", ValueError),
                     ({"kill": 0.1}, TypeError)):
        with pytest.raises(err):
            faults.resolve_fault_plan(bad)
        with pytest.raises(err):
            ref_faults.resolve_fault_plan(bad)
    with pytest.raises(ValueError, match="shard_kill_rate"):
        faults.FaultPlan(shard_kill_rate=1.5)
