"""The port's sequential trainer for the CNN family against the JAX
reference, on the reference's data and initial parameters, bridged.

(``fl.client``'s one-client training is ``tests/test_torch_client.py``'s.)

* ``core.aggregate``'s list functions (``weighted_sum``, ``aggregate``,
  ``aggregate_coverage``, ``apply_server_update``): ≤1e-6;
* a 2-round ``batched_rounds=False`` CFL session of the quickstart CNN at
  the reference's own A/B settings (4 workers, 800 samples, fl seed 3;
  ``tests/test_fl_engine.py::test_batched_rounds_match_sequential``)
  against the reference's sequential session: identical specs,
  accuracies within 1e-3, the same simulated timing, and each client's
  first local step within 1e-5 of its movement;
* the port's sequential round against its batched dense round:
  ``tests/test_torch_sequential_round.py``.

Multi-step runs in fp32 are held to 1e-3 of their movement only
(readings 3.6e-4 for the session's round 0 and 3.2e-4 for the engines'
round): the CNN's ReLUs take a pre-activation within rounding noise of
0 to either side, and one such flip moves a step's gradient by up to
~1e-3 of its largest entry (the drift the reference records for its own
dense / kernel A/B). Where that stops the session's 1e-5 check, the
test shows the flip: at client 1's second batch the port's fp32 and
fp64 steps agree, and the reference's fp32 step differs from both.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from cnn_session_support import (TOL, assert_close, numpy_tree, port_session,
                                 port_tree, ratio, reference_session)
from repro.core import submodel as ref_submodel
from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.core import aggregate as agg
from repro_torch.core.submodel import SubmodelSpec
from repro_torch.data.loader import index_batches
from repro_torch.fl import client
from repro_torch.optim.optimizers import sgd

torch.set_num_threads(2)
ref_agg = importlib.import_module("repro.core.aggregate")


def test_aggregate_functions_match_reference():
    rng = np.random.default_rng(0)

    def tree():
        return {"a": rng.standard_normal((3, 4)).astype(np.float32),
                "b": [rng.standard_normal((5,)).astype(np.float32)]}
    deltas = [tree() for _ in range(3)]
    covs = [jax.tree.map(lambda a: (rng.random(a.shape) < 0.6)
                         .astype(np.float32), t) for t in deltas]
    deltas = [jax.tree.map(lambda d, c: d * c, d, c)
              for d, c in zip(deltas, covs)]
    sizes = [30.0, 7.0, 90.0]
    port = [params_from_numpy(t, device="cpu") for t in deltas]
    pcov = [params_from_numpy(t, device="cpu") for t in covs]
    base = tree()
    for got, want in (
            (agg.weighted_sum(port, sizes),
             ref_agg.weighted_sum(deltas, sizes)),
            (agg.aggregate(port, sizes), ref_agg.aggregate(deltas, sizes)),
            (agg.aggregate_coverage(port, pcov, sizes),
             ref_agg.aggregate_coverage(deltas, covs, sizes)),
            (agg.apply_server_update(params_from_numpy(base, device="cpu"),
                                     port[0], 0.5),
             ref_agg.apply_server_update(base, deltas[0], 0.5))):
        assert_close(got, want, 1e-6)


@pytest.fixture(scope="module")
def reference_sequential():
    """The reference's sequential session at its own A/B settings."""
    fl = dict(n_workers=4, local_epochs=1, batch_size=32, lr=0.05, seed=3,
              batched_rounds=False)
    return fl, reference_session(fl=fl, n_samples=800)


def test_sequential_session_matches_reference(reference_sequential):
    fl, (ref, init, pred0, after0) = reference_sequential
    sess = port_session(ref, init, pred0, fl=fl)
    assert sess.server.engine is None
    sess.run(1)
    got0 = params_to_numpy(sess.params)
    sess.run(1)
    for got, want in zip(sess.history, ref.history):
        assert got["specs"] == want["specs"]
        np.testing.assert_allclose(got["accs"], want["accs"], atol=1e-3,
                                   rtol=0)
        assert got["timing"] == want["timing"]
    assert len(sess.history) == 2
    assert ratio(got0, after0, init) < 1e-3
    # each client's first local step of round 0, from the same state
    fam, ref_seq = sess.family, ref.server._seq
    opt = sgd(fl["lr"], momentum=0.9)

    def port_step(p, state, x, y, ctx, dtype=np.float32):
        """The port's step from the reference's (params, momentum)."""
        xt = torch.as_tensor(x.astype(dtype))
        got, _ = client.sgd_step(
            port_tree(numpy_tree(p), dtype), opt,
            {"step": 0, "mu": port_tree(numpy_tree(state["mu"]), dtype)},
            lambda q: fam.sub_loss(q, ctx, xt, torch.as_tensor(y),
                                   torch.ones(len(y), dtype=xt.dtype)),
            5.0)
        return params_to_numpy(got)

    for k, genes in enumerate(ref.history[0]["specs"]):
        spec = SubmodelSpec(tuple(genes[:2]),
                            tuple(g / 100 for g in genes[2:]))
        ref_spec = ref_submodel.SubmodelSpec(spec.depth, spec.width)
        sub0, ref_ctx = ref_seq.family.extract(init, ref_spec)
        step = ref_seq._train_step(ref_spec, ref_ctx)
        ctx = fam.sub_ctx(spec)
        data = ref.client_data[k]
        batches = index_batches(len(data["y"]), fl["batch_size"],
                                seed=fl["seed"] * 7 + k)
        state = ref_seq._opt.init(sub0)
        idx = next(batches)
        x, y = data["x"][idx], data["y"][idx]
        want, state2 = step(sub0, state, x, y, np.ones((len(idx),),
                                                      np.float32))
        assert ratio(port_step(sub0, state, x, y, ctx), numpy_tree(want),
                     numpy_tree(sub0), 1e-4) <= TOL
        if k != 1:
            continue
        # why the round is not held at 1e-5: at client 1's second batch
        # the port's fp32 step and its fp64 step (the exact ReLU
        # decisions) agree, and the reference's fp32 step differs from
        # both: the reference takes a decision on rounding noise there
        idx = next(batches)
        x, y = data["x"][idx], data["y"][idx]
        want2, _ = step(want, state2, x, y, np.ones((len(idx),), np.float32))
        got32 = port_step(want, state2, x, y, ctx)
        got64 = port_step(want, state2, x, y, ctx, np.float64)
        assert ratio(got32, got64, numpy_tree(want), 1e-4) <= TOL
        assert ratio(got64, numpy_tree(want2), numpy_tree(want), 1e-4) > TOL
