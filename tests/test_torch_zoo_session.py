"""The port's ``CFLSession`` on the transformer zoo against the JAX
reference, at the reference's own setting
(``tests/test_control_plane.py::test_cfl_session_transformer_rounds``:
granite reduced to 4 layers, d_model 64, ``seq_len=16``, 3 workers, 96
samples, ``heterogeneity="both"``), on the reference's data, initial
parameters and predictor, bridged:

* CFL, 2 rounds, on the kernel path (the kernels' plain versions on the
  CPU) and on the dense masked path: identical specs in both rounds,
  accuracies within 1e-3, the same simulated timing and predictor MAE
  within 1e-3, every client's first local step within 1e-5 of its
  movement of the reference's own first step, round-0 parameters within
  1e-5 of the round's movement, the global accuracy (``evaluate``) within
  one eval token, and every later spec within its client's latency bound
  (or the minimal fallback).

FedAvg and IL at the same setting are in
``tests/test_torch_zoo_baselines.py``, so that each file runs in under a
minute.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.bridge import params_to_numpy
from zoo_session_support import (FL, TOL, port_session, port_steps, ratio,
                                 reference_session, reference_steps,
                                 spec_of, stacked)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference():
    return reference_session()


@pytest.fixture(scope="module")
def first_steps(reference):
    """Round 0's specs and seeds, and the reference's first local step."""
    ref, init, _, _ = reference
    specs = [spec_of(g) for g in ref.history[0]["specs"]]
    seeds = [FL["seed"] * 7 + k for k in range(FL["n_workers"])]
    return specs, seeds, reference_steps(ref, init, specs, seeds)


@pytest.mark.parametrize("path", ["kernels", "dense"])
def test_cfl_session_matches_reference(reference, first_steps, path):
    ref, init, pred0, after0 = reference
    sess = port_session(ref, init, pred0,
                        elastic_kernels=path == "kernels")
    assert sess.server.engine.kernel_path == (
        "tile-skipping" if path == "kernels" else "dense-masked")
    sess.run(1)
    got0 = params_to_numpy(sess.params)
    sess.run(1)
    assert len(sess.history) == len(ref.history) == 2
    for got, want in zip(sess.history, ref.history):
        assert got["specs"] == want["specs"]
        np.testing.assert_allclose(got["accs"], want["accs"], atol=1e-3,
                                   rtol=0)
        assert got["timing"] == want["timing"]
        assert abs(got["predictor_mae"] - want["predictor_mae"]) <= 1e-3
    specs, seeds, first = first_steps
    step1 = port_steps(sess.server.engine, ref, init, specs, seeds)
    assert ratio(step1, first, stacked(init, len(specs))) <= TOL
    assert ratio(got0, after0, init) <= TOL
    tokens = ref.test_data[0]["x"].size - len(ref.test_data[0]["x"])
    assert abs(sess.global_accuracy(ref.test_data[0])
               - ref.global_accuracy(ref.test_data[0])) <= 1 / tokens + 1e-6
    minimal = sess.family.minimal_spec()
    for client, spec in zip(sess.clients, sess.server.sample_submodels()):
        lat = sess.server.latency.lookup(spec, client.device)
        assert lat < client.latency_bound or spec == minimal
