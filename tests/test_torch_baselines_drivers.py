"""The baselines' drivers and FedAvg's round on the card
(``fl.baselines``; FedAvg's rounds against the JAX reference:
``tests/test_torch_baselines.py``).

* The ``run_cfl`` / ``run_fedavg`` / ``run_il`` drivers return what the
  reference's do (the server over the reference's population; the
  accuracies).
* On the card (``cuda``): one FedAvg round of the quickstart CNN, the
  kernel path twice bit-equal, the dense path on its ReLU decisions
  within 1e-3 of the round's movement.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from jax.tree_util import tree_leaves as jax_leaves

from cnn_session_support import CFG, FL, REF_CFG, ratio
from relu_replay import ReluDecisions
from repro.fl import rounds as ref_rounds
from repro_torch.checkpoint.bridge import params_to_numpy
from repro_torch.fl import CFLConfig, CFLSession, run_cfl, run_fedavg, run_il
from repro_torch.fl.baselines import FedAvgServer
from repro_torch.fl.server import CFLServer

torch.set_num_threads(2)


def test_drivers_return_what_the_reference_drivers_return():
    """The reference's drivers return ``sess.server`` (cfl, fedavg) and
    ``sess.il_accs`` (il), over the population ``build_population``
    gives; so do the port's."""
    kw = dict(kind="synthmnist", n_workers=3, n_samples=150,
              heterogeneity="quality", rounds=1, seed=1)
    fl = CFLConfig(n_workers=3, local_epochs=1, batch_size=32, seed=2)
    clients, _, _ = ref_rounds.build_population(
        REF_CFG, kind="synthmnist", n_workers=3, n_samples=150,
        heterogeneity="quality", seed=1)
    for run, server in ((run_cfl, CFLServer), (run_fedavg, FedAvgServer)):
        got = run(CFG, fl_cfg=fl, device="cpu", **kw)
        assert type(got) is server
        assert [dataclasses.asdict(c) for c in got.clients] == \
            [dataclasses.asdict(c) for c in clients]
        assert [h["round"] for h in got.history] == [0]
    accs = run_il(CFG, fl_cfg=fl, device="cpu", **kw)
    assert isinstance(accs, list) and len(accs) == 3
    assert all(isinstance(a, float) and 0.0 <= a <= 1.0 for a in accs)


@pytest.mark.cuda
def test_cuda_fedavg_round_kernel_and_dense():
    """One FedAvg round of the quickstart CNN on the card: the kernel path
    (K1 at full prefixes) twice, bit-equal; the dense path on the kernel
    path's ReLU decisions within 1e-3 of the round's movement (K1 sums
    in 3×TF32), the accuracies within one test sample."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")

    def one_round(elastic_kernels, mode=None):
        sess = CFLSession.from_synthetic(
            CFG, n_workers=4, n_samples=400, algorithm="fedavg",
            fl_cfg=CFLConfig(**FL, elastic_kernels=elastic_kernels),
            device="cuda")
        init = params_to_numpy(sess.params)
        with relus(mode) if mode else contextlib.nullcontext():
            sess.run(1)
        n_test = min(len(d["y"]) for d in sess.test_data)
        return (init, params_to_numpy(sess.params), sess.history[0]["accs"],
                n_test)

    relus = ReluDecisions()
    init, kern, accs, n_test = one_round(True, "record")
    _, again, accs2, _ = one_round(True)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax_leaves(kern), jax_leaves(again))) and accs == accs2
    _, dense, dense_accs, _ = one_round(False, "replay")
    assert relus.pos == len(relus.masks)
    assert ratio(dense, kern, init) <= 1e-3
    np.testing.assert_allclose(dense_accs, accs, atol=1.0 / n_test + 1e-6,
                               rtol=0)
