"""Shared set-up of the CNN parity tests of the port's sessions and
trainers (``tests/test_torch_session.py``, ``test_torch_baselines*.py``,
``test_torch_sequential.py``, ``test_torch_client.py``,
``test_torch_partial*.py``, ``test_torch_async*.py``): the quickstart
CNN and round settings, the reference's session on its own synthetic
population, the port's session on the reference's data, initial
parameters and predictor, bridged, the tree comparisons, and the holds
of a buffered or faulty run and of a partial-participation session
against the reference's."""
import dataclasses

import jax
import numpy as np

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.data.synth import make_dataset
from repro.models import cnn as ref_cnn
from repro.fl import server as ref_server
from repro.fl import session as ref_session
from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.core.submodel import SubmodelSpec
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.fl.client import ClientInfo
from repro_torch.fl.server import CFLConfig
from repro_torch.fl.session import CFLSession

import jax_compile_cache  # noqa: F401  (the shared compile cache)

TOL = 1e-5
# examples/quickstart.py's CNN and round settings
QUICK = dict(name="quickstart", in_channels=1, image_size=28,
             stem_channels=8, stages=((16, 2), (32, 2)), groupnorm_groups=4,
             elastic_widths=(0.5, 1.0))
CFG, REF_CFG = CNNConfig(**QUICK), RefCNNConfig(**QUICK)
FL = dict(n_workers=4, local_epochs=2, batch_size=32, lr=0.08, seed=0)


# a full and a ragged submodel of the quickstart CNN
SPECS = {"full": SubmodelSpec((2, 2), (1.0, 1.0)),
         "ragged": SubmodelSpec((1, 2), (0.5, 1.0))}


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_tree(tree, dtype=np.float32):
    """A numpy tree as the port's CPU tensors of ``dtype``."""
    return params_from_numpy(jax.tree.map(lambda a: a.astype(dtype), tree),
                             device="cpu")


def assert_close(got, want, tol):
    """Every leaf of the port's ``got`` within ``tol`` of ``want``'s."""
    for a, b in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=0)


def params_and_clients():
    """The reference's initial quickstart parameters (key 1) and four
    clients' data of 90 synthetic MNIST samples each."""
    params = numpy_tree(ref_cnn.init_params(jax.random.PRNGKey(1), REF_CFG))
    data = make_dataset("synthmnist", 360, seed=4)
    return params, [{k: v[i * 90:(i + 1) * 90] for k, v in data.items()}
                    for i in range(4)]


def reference_session(algorithm="cfl", fl=FL, n_samples=400, seed=0,
                      rounds=2):
    """``rounds`` rounds of the reference's session (dense path) on its
    synthetic quickstart population. Returns (session, initial params,
    the predictor's initial weights, round-0 params); the last two are
    None where the algorithm has no predictor or no rounds."""
    sess = ref_session.CFLSession.from_synthetic(
        REF_CFG, kind="synthmnist", n_workers=fl["n_workers"],
        n_samples=n_samples, heterogeneity="quality", seed=seed,
        algorithm=algorithm, fl_cfg=ref_server.CFLConfig(**fl))
    init = numpy_tree(sess._init_params)
    if algorithm == "il":
        sess.run(rounds)
        return sess, init, None, None
    pred0 = numpy_tree(sess.server.predictor.params) \
        if algorithm == "cfl" else None
    sess.run(1)
    after0 = numpy_tree(sess.params)
    sess.run(rounds - 1)
    return sess, init, pred0, after0


def port_session(ref, init, pred0=None, *, algorithm="cfl", fl=FL,
                 **fl_kw):
    """The port's session on the reference session's population, data,
    initial parameters and (cfl) predictor weights, on the CPU."""
    clients = [ClientInfo(**dataclasses.asdict(c)) for c in ref.clients]
    sess = CFLSession(CFG, clients, ref.client_data, ref.test_data,
                      CFLConfig(**fl, **fl_kw),
                      params=params_from_numpy(init, device="cpu"),
                      algorithm=algorithm, device="cpu")
    if pred0 is not None:
        sess.server.predictor.load_numpy(pred0)
    return sess


def ratio(got, want, init, min_move=1e-2):
    """max |got − want| over max |want − init| (how far the round moved
    the parameters, at least ``min_move``)."""
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(want), jax.tree.leaves(init)))
    diff = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(got), jax.tree.leaves(want)))
    assert moved > min_move
    return diff / moved


# the event columns of a history row that no numerics decide
EVENTS = ("participants", "staleness", "sim_clock", "dropped", "retried",
          "quarantined", "mode", "selection", "round")
# buffered async: a buffer of one delta, FedBuff's discount, faults and
# the gate; at this plan's seed the run drops, retries and quarantines,
# and applies stale deltas
BUFFERED = dict(selection="uniform", mode="async", async_buffer=1,
                staleness_decay=0.5, validate_deltas=True,
                faults="drop=0.2,straggle=0.2,corrupt=0.3,seed=2")
FAULTY_SYNC = dict(selection="fairness",
                   faults="drop=0.1,straggle=0.1,corrupt=0.3")


def hold_faulty_run(algorithm, kw, rounds):
    """``rounds`` rounds (async: aggregates) of the port's session on the
    kernel path against the reference's, both with the settings ``kw``:
    identical event columns, accuracies within one test sample, CFL's
    specs; the first round's parameters within 1e-5 of its movement on
    CFL (1e-3 on FedAvg, whose round at this seed turns on a ReLU within
    rounding noise of 0), CFL's last within 1e-3; finite parameters."""
    import torch
    from repro_torch.optim.optimizers import tree_leaves
    fl = dict(FL, **kw)
    ref, init, pred0, after0 = reference_session(algorithm, fl=fl,
                                                 rounds=rounds)
    sess = port_session(ref, init, pred0, algorithm=algorithm, fl=fl,
                        elastic_kernels=True)
    sess.run(1)
    got0 = params_to_numpy(sess.params)
    sess.run(rounds - 1)
    assert len(sess.history) == len(ref.history) == rounds
    n_test = min(len(d["y"]) for d in ref.test_data)
    for got, want in zip(sess.history, ref.history):
        for col in EVENTS:
            assert got[col] == want[col], col
        np.testing.assert_allclose(got["accs"], want["accs"],
                                   atol=1.0 / n_test + 1e-6, rtol=0)
        if algorithm == "cfl" and got["participants"]:
            assert got["specs"] == want["specs"]
    events = {c: sum(r[c] for r in ref.history)
              for c in ("dropped", "retried", "quarantined", "staleness")}
    if kw is BUFFERED:
        assert min(events.values()) > 0
    else:
        assert events["dropped"] + events["quarantined"] > 0
    assert ratio(got0, after0, init) <= (TOL if algorithm == "cfl"
                                         else 1e-3)
    if algorithm == "cfl":
        assert ratio(params_to_numpy(sess.params), numpy_tree(ref.params),
                     init) <= 1e-3
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(sess.params))


# ---------------------------------------------------------------------------
# partial participation (tests/test_torch_partial_session*.py)
# ---------------------------------------------------------------------------
def record_selections(tracker):
    """Keep every Selection the tracker hands out."""
    real, sels = tracker.select, []

    def select(r):
        sels.append(real(r))
        return sels[-1]
    tracker.select = select
    return sels


def partial_reference(algorithm, selection):
    """2 sync rounds of the reference's session under ``selection``:
    (session, initial params, predictor weights, round-0 params, its
    Selections, the FL settings)."""
    fl = dict(FL, selection=selection)
    sess = ref_session.CFLSession.from_synthetic(
        REF_CFG, kind="synthmnist", n_workers=4, n_samples=400,
        heterogeneity="quality", seed=0, algorithm=algorithm,
        fl_cfg=ref_server.CFLConfig(**fl))
    init = numpy_tree(sess._init_params)
    pred0 = numpy_tree(sess.server.predictor.params) \
        if algorithm == "cfl" else None
    sels = record_selections(sess.server.tracker)
    sess.run(1)
    after0 = numpy_tree(sess.params)
    sess.run(1)
    return sess, init, pred0, after0, sels, fl


def hold_partial_session(algorithm, selection):
    """2 sync rounds of the port's session (kernel path) under
    ``selection`` against the reference's, as the module docstring of
    ``tests/test_torch_partial_session.py`` says."""
    ref, init, pred0, after0, ref_sels, fl = partial_reference(algorithm,
                                                              selection)
    sess = port_session(ref, init, pred0, algorithm=algorithm, fl=fl,
                        elastic_kernels=True)
    assert sess.server.engine.kernel_path == "tile-skipping"
    sels = record_selections(sess.server.tracker)
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
