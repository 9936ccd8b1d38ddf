"""The port's ``CFLSession`` (``algorithm="cfl"``) against the JAX
reference: 2 rounds of the quickstart CNN (4 workers, 400 samples) on the
reference's data, initial parameters and predictor, bridged.

* The kernel path (the stage convolutions through K1's plain version on
  the CPU): identical specs in both rounds, round-0 parameters within
  1e-5 of how far the round moved them, accuracies within 1e-3, the same
  simulated timing.
* The dense masked path on the kernel path's ReLU decisions
  (``relu_replay.ReluDecisions``, recorded on the kernel path, whose
  decisions at this seed are the reference's): held exactly as the kernel
  path — round-0 parameters within 1e-5 of their movement, identical
  specs, accuracies within 1e-3.
* The free-running dense path: identical specs and accuracies within one
  test sample; its round-0 parameters within 1e-2 of their movement only,
  because at this seed the reference itself is ill-conditioned — one ulp
  more on client 2's first batch moves the reference's own first gradient
  by more than 1e-4 of its largest entry (a ReLU that flips on rounding
  noise), which is asserted.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from cnn_session_support import (CFG, FL, REF_CFG, TOL, port_session, ratio,
                                 reference_session)
from relu_replay import ReluDecisions
from repro.core import elastic as ref_elastic
from repro.core import submodel as ref_submodel
from repro.data import loader as ref_loader
from repro_torch.checkpoint.bridge import params_to_numpy
from repro_torch.fl.server import CFLConfig
from repro_torch.fl.session import CFLSession

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference():
    return reference_session()


def _run(ref, init, pred0, elastic_kernels, relus=None, mode=None):
    """The port's 2 rounds on one path, under ``relus(mode)`` if given;
    returns the session and its round-0 parameters."""
    sess = port_session(ref, init, pred0, elastic_kernels=elastic_kernels)
    assert sess.server.engine.kernel_path == (
        "tile-skipping" if elastic_kernels else "dense-masked")
    with relus(mode) if relus is not None else contextlib.nullcontext():
        sess.run(1)
        after0 = params_to_numpy(sess.params)
        sess.run(1)
    return sess, after0


@pytest.fixture(scope="module")
def kernel_run(reference):
    """The kernel path's 2 rounds, its ReLU decisions recorded."""
    ref, init, pred0, _ = reference
    relus = ReluDecisions()
    sess, after0 = _run(ref, init, pred0, True, relus, "record")
    return sess, after0, relus


def _held(sess, got0, reference):
    ref, init, _, after0 = reference
    assert ratio(got0, after0, init) <= TOL
    for got, want in zip(sess.history, ref.history):
        assert got["specs"] == want["specs"]
        np.testing.assert_allclose(got["accs"], want["accs"], atol=1e-3,
                                   rtol=0)
        assert got["fairness"].keys() == want["fairness"].keys()
        assert got["timing"] == want["timing"]
        assert abs(got["predictor_mae"] - want["predictor_mae"]) <= 1e-3


def test_session_matches_reference(reference, kernel_run):
    """The slice's path: the CNN's stage convolutions through K1 (its
    plain version on the CPU)."""
    sess, got0, relus = kernel_run
    assert len(relus.masks) > 0
    _held(sess, got0, reference)
    assert sess.fairness() == sess.history[-1]["fairness"]
    assert set(sess.history[-1]["host_seconds"]) == {"search", "predictor",
                                                    "round"}


def test_session_dense_path_against_reference(reference, kernel_run):
    """The dense masked path (grouped full-channel convolutions times
    0/1): on the kernel path's ReLU decisions it is held as the kernel
    path is (1e-5 of the movement, identical specs, accuracies within
    1e-3); free-running it holds identical specs, accuracies within one
    test sample and round-0 parameters within 1e-2 of their movement, and
    the reference's own sensitivity at this seed is asserted."""
    ref, init, pred0, after0 = reference
    _, _, relus = kernel_run
    sess, got0 = _run(ref, init, pred0, False, relus, "replay")
    assert relus.pos == len(relus.masks)          # every decision replayed
    _held(sess, got0, reference)

    sess, got0 = _run(ref, init, pred0, False)
    for got, want in zip(sess.history, ref.history):
        assert got["specs"] == want["specs"]
        n_test = min(len(d["y"]) for d in ref.test_data)
        np.testing.assert_allclose(got["accs"], want["accs"],
                                   atol=1.0 / n_test + 1e-6, rtol=0)
    # the reference's sensitivity at this seed: its first local step's
    # gradient at client 2's first batch, and at that batch plus one ulp
    fam = ref_elastic.family_for(REF_CFG)
    genes = ref.history[0]["specs"][2]
    spec = ref_submodel.SubmodelSpec(tuple(genes[:2]),
                                     tuple(g / 100 for g in genes[2:]))
    fwd = fam.spec_masks(spec).fwd
    data = ref.client_data[2]
    idx = next(ref_loader.index_batches(len(data["y"]), FL["batch_size"],
                                        seed=2))
    x, y = data["x"][idx], data["y"][idx]
    sw = np.ones((len(idx),), np.float32)

    def grad(xx):
        g = jax.grad(lambda p: fam.masked_loss(p, fwd, xx, y, sw,
                                               kernels=None))(init)
        return jax.tree.leaves(g)
    a, b = grad(x), grad(np.nextafter(x, np.float32(2)).astype(np.float32))
    spread = max(float(np.abs(u - v).max()) for u, v in zip(a, b))
    assert spread > 1e-4 * max(float(np.abs(u).max()) for u in a)
    assert ratio(got0, after0, init) < 1e-2


@pytest.mark.cuda
def test_cuda_cfl_kernel_round_repeats_to_the_bit():
    """The CNN's kernel path is deterministic on the card: one CFL round
    of the quickstart CNN, run twice in one process, gives the same
    parameters and accuracies to the bit (``resolve_device`` makes cuDNN
    pick deterministic algorithms for the stem's convolution)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")

    def one_round():
        sess = CFLSession.from_synthetic(
            CFG, n_workers=4, n_samples=400, device="cuda",
            fl_cfg=CFLConfig(**FL, elastic_kernels=True))
        sess.run(1)
        return params_to_numpy(sess.params), sess.history[0]["accs"]
    (a, accs_a), (b, accs_b) = one_round(), one_round()
    assert accs_a == accs_b
    assert all(np.array_equal(u, v) for u, v in zip(jax.tree.leaves(a),
                                                    jax.tree.leaves(b)))
