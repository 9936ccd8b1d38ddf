"""The paper's baselines on the port (``fl.baselines``: ``FedAvgServer``,
``independent_learning``, behind ``CFLSession(algorithm="fedavg" |
"il")``) against the JAX reference, on the quickstart CNN (4 workers, 400
samples) with the reference's data and initial parameters bridged (IL:
``tests/test_torch_il.py``).

* FedAvg, 2 rounds, on both of the port's paths (the full spec's stage
  convolutions through K1's plain version; the dense masked path):
  every client's first local step within 1e-5 of its movement of the
  reference's own first step (its batched engine's compiled program, the
  later steps masked off), round-0 parameters within 1e-3 of the round's
  movement of the reference's round (readings 1.3e-4 and 1.5e-4),
  accuracies within 1e-3 of the reference's, the same simulated timing
  and fairness keys. On the kernel path's ReLU decisions
  (``relu_replay``) the dense path's round-0 parameters are the kernel
  path's within 1e-5 of the movement.
* Why the round is not held at 1e-5 (a ReLU decision within rounding
  noise of 0): ``tests/test_torch_baselines_relu.py``.
* The drivers and the round on the card:
  ``tests/test_torch_baselines_drivers.py``.
"""
import contextlib

import numpy as np
import pytest
import torch
from jax.tree_util import tree_leaves as jax_leaves

from cnn_session_support import (FL, TOL, numpy_tree, port_session,
                                 port_tree, ratio, reference_session)
from relu_replay import ReluDecisions
from repro.fl import engine as ref_engine
from repro_torch.checkpoint.bridge import params_to_numpy
from repro_torch.fl.baselines import FedAvgServer
from repro_torch.fl.engine import pack_cohort_data

torch.set_num_threads(2)


def _streams(ref):
    """Round 0's batch streams of FedAvg (the reference's
    ``FedAvgServer.run_round`` seeds), as both engines pack them."""
    seeds = [FL["seed"] * 7 + k for k in range(len(ref.clients))]
    return ref_engine._pack_streams(
        [len(d["y"]) for d in ref.client_data], FL["batch_size"],
        epochs=FL["local_epochs"], seeds=seeds)


def reference_steps(ref, init, n):
    """Every client's parameters after the first ``n`` local steps of the
    reference's FedAvg round 0: its batched engine's own compiled program,
    the later steps masked off as the engine masks a padded stream."""
    eng = ref.server._runner
    K = len(ref.clients)
    masks = eng._cohort_masks([ref.server.family.full_spec()] * K)
    x, y = eng._cohort_data(ref.client_data)
    pack = eng._eval_pack(ref.test_data)
    idx, sv, stv, _ = _streams(ref)
    stv = stv & (np.arange(stv.shape[1]) < n)
    _, trained, _ = eng._train_eval(
        eng.broadcast_params(init, K), masks.param_mask, masks.fwd, x, y,
        idx, sv, stv, pack.x, pack.y, pack.valid)
    return numpy_tree(trained)


def reference_round(ref, init, client_data):
    """The reference's FedAvg round 0 (its engine, seeds and sizes) on
    ``client_data``."""
    K = len(ref.clients)
    params, _, _ = ref.server._runner.run_fl_round(
        init, [ref.server.family.full_spec()] * K, client_data,
        ref.test_data, [c.n_samples for c in ref.clients],
        batch_size=FL["batch_size"], epochs=FL["local_epochs"],
        seeds=[FL["seed"] * 7 + k for k in range(K)])
    return numpy_tree(params)


def port_steps(engine, ref, init, n, dtype=np.float32):
    """The same ``n`` steps on the port's batched ``engine`` in
    ``dtype``, through its ``local_step``."""
    K = len(ref.clients)
    masks = engine.family.cohort_masks([engine.family.full_spec()] * K,
                                       "cpu")
    xs, ys = pack_cohort_data(ref.client_data)
    x, y = torch.as_tensor(xs.astype(dtype)), torch.as_tensor(ys).long()
    idx, sv, stv, _ = _streams(ref)
    rows = torch.arange(K)[:, None]
    params, opt = engine.local_state(
        engine.broadcast_params(port_tree(init, dtype), K))
    for t in range(n):
        i = torch.as_tensor(idx[:, t]).long()
        engine.local_step(params, opt, masks, x[rows, i],
                          torch.as_tensor(sv[:, t], dtype=x.dtype),
                          None if stv[:, t].all()
                          else torch.as_tensor(stv[:, t]), y[rows, i])
    return params_to_numpy(params)


@pytest.fixture(scope="module")
def fedavg():
    """The reference's 2 FedAvg rounds and its first local step; the
    port's kernel path's 2 rounds with its ReLU decisions recorded."""
    ref, init, _, after0 = reference_session("fedavg")
    relus = ReluDecisions()
    kern, kern0 = _run(port_session(ref, init, algorithm="fedavg",
                                    elastic_kernels=True), relus, "record")
    return (ref, init, after0, reference_steps(ref, init, 1), relus, kern,
            kern0)


def _run(sess, relus=None, mode=None):
    """2 rounds (under ``relus(mode)`` if given); the session and its
    round-0 parameters."""
    with relus(mode) if relus is not None else contextlib.nullcontext():
        sess.run(1)
        got0 = params_to_numpy(sess.params)
        sess.run(1)
    return sess, got0


def _stacked(init, K=4):
    return [np.broadcast_to(a, (K,) + a.shape) for a in jax_leaves(init)]


@pytest.mark.parametrize("path", ["kernels", "dense"])
def test_fedavg_matches_reference(fedavg, path):
    """Every client's first local step within 1e-5 of the reference's,
    round-0 parameters within 1e-3 of the reference's round, accuracies
    within 1e-3, the same simulated timing and record; the dense path on
    the kernel path's ReLU decisions within 1e-5 of the kernel path's
    round, and free-running held as the kernel path is."""
    ref, init, after0, first, relus, sess, got0 = fedavg
    if path == "dense":
        sess, got0 = _run(port_session(ref, init, algorithm="fedavg",
                                       elastic_kernels=False),
                          relus, "replay")
        assert relus.pos == len(relus.masks)
        assert ratio(got0, fedavg[6], init) <= TOL
    assert isinstance(sess.server, FedAvgServer)
    assert sess.server.engine.kernel_path == (
        "tile-skipping" if path == "kernels" else "dense-masked")
    step1 = port_steps(sess.server.engine, ref, init, 1)
    assert ratio(step1, first, _stacked(init), 1e-4) <= TOL
    assert ratio(got0, after0, init) < 1e-3
    assert len(sess.history) == len(ref.history) == 2
    for got, want in zip(sess.history, ref.history):
        np.testing.assert_allclose(got["accs"], want["accs"], atol=1e-3,
                                   rtol=0)
        assert got["timing"] == want["timing"]
        assert got["fairness"].keys() == want["fairness"].keys()
        assert set(got) - set(want) == {"n_steps", "host_seconds"}
        assert set(got["host_seconds"]) == {"round"}
    assert sess.fairness() == sess.history[-1]["fairness"]
    acc = sess.global_accuracy(ref.test_data[0])
    assert acc == pytest.approx(ref.global_accuracy(ref.test_data[0]),
                                abs=1e-3)
    if path == "dense":                 # free-running
        sess, got0 = _run(port_session(ref, init, algorithm="fedavg",
                                       elastic_kernels=False))
        for got, want in zip(sess.history, ref.history):
            np.testing.assert_allclose(got["accs"], want["accs"], atol=1e-3,
                                       rtol=0)
        assert ratio(got0, after0, init) < 1e-3
