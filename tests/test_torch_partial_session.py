"""The port's ``CFLSession`` with partial participation against the JAX
reference: 2 sync rounds of the quickstart CNN (4 workers, 400 samples)
on the reference's data, initial parameters and predictor, bridged, for
CFL under each policy ("uniform", "fairness", "latency"; 2 of 4 clients
a round) and FedAvg under "fairness", on the kernel path (the stage
convolutions through K1's plain version).

* Every round's ``Selection`` (participants, padding, weights) and CFL's
  specs are identical while the accuracies are; the accuracies within
  one test sample, the simulated timing and clock equal.
* CFL's round-0 parameters within 1e-5 of the round's movement, the
  second round's within 1e-3 of the two rounds' movement; FedAvg's
  round-0 parameters within 1e-3 (at this seed the reference's own
  FedAvg round turns on a ReLU within rounding noise of 0, as
  ``tests/test_torch_baselines.py`` shows).
"""
import jax
import numpy as np
import pytest
import torch

from cnn_session_support import (FL, REF_CFG, TOL, numpy_tree, port_session,
                                 ratio)
from repro.fl import server as ref_server
from repro.fl import session as ref_session
from repro_torch.checkpoint.bridge import params_to_numpy

torch.set_num_threads(2)
CASES = [("cfl", "uniform"), ("cfl", "fairness"), ("cfl", "latency"),
         ("fedavg", "fairness")]


def _recording(tracker):
    """Keep every Selection the tracker hands out."""
    real, sels = tracker.select, []

    def select(r):
        sels.append(real(r))
        return sels[-1]
    tracker.select = select
    return sels


def _reference(algorithm, selection):
    fl = dict(FL, selection=selection)
    sess = ref_session.CFLSession.from_synthetic(
        REF_CFG, kind="synthmnist", n_workers=4, n_samples=400,
        heterogeneity="quality", seed=0, algorithm=algorithm,
        fl_cfg=ref_server.CFLConfig(**fl))
    init = numpy_tree(sess._init_params)
    pred0 = numpy_tree(sess.server.predictor.params) \
        if algorithm == "cfl" else None
    sels = _recording(sess.server.tracker)
    sess.run(1)
    after0 = numpy_tree(sess.params)
    sess.run(1)
    return sess, init, pred0, after0, sels, fl


@pytest.mark.parametrize("algorithm,selection", CASES)
def test_partial_session_matches_reference(algorithm, selection):
    ref, init, pred0, after0, ref_sels, fl = _reference(algorithm, selection)
    sess = port_session(ref, init, pred0, algorithm=algorithm, fl=fl,
                        elastic_kernels=True)
    assert sess.server.engine.kernel_path == "tile-skipping"
    sels = _recording(sess.server.tracker)
    sess.run(1)
    got0 = params_to_numpy(sess.params)
    sess.run(1)
    n_test = min(len(d["y"]) for d in ref.test_data)
    equal_so_far = True
    for r, (got, want) in enumerate(zip(sess.history, ref.history)):
        if equal_so_far:
            for k in ("idx", "valid", "weights"):
                np.testing.assert_array_equal(getattr(sels[r], k),
                                              getattr(ref_sels[r], k))
            for col in ("participants", "selection", "timing", "sim_clock",
                        "staleness", "aggregate_lag", "mode", "dropped"):
                assert got[col] == want[col], col
            if algorithm == "cfl":
                assert got["specs"] == want["specs"]
        assert len(got["participants"]) == 2
        np.testing.assert_allclose(got["accs"], want["accs"],
                                   atol=1.0 / n_test + 1e-6, rtol=0)
        equal_so_far &= got["accs"] == want["accs"]
    assert len(sels) == 2 and (sels[0].valid == 1).all()
    if algorithm == "cfl":
        assert ratio(got0, after0, init) <= TOL
        assert ratio(params_to_numpy(sess.params), numpy_tree(ref.params),
                     init) <= 1e-3
    else:
        assert ratio(got0, after0, init) <= 1e-3
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(got0))
