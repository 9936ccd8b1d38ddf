"""The port's zoo baselines through ``CFLSession`` against the JAX
reference, at the setting of ``tests/test_torch_zoo_session.py`` (the
reference's ``test_cfl_session_transformer_rounds``: granite reduced to 4
layers, d_model 64, ``seq_len=16``, 3 workers, 96 samples,
``heterogeneity="both"``), on the reference's data and initial parameters,
bridged, on the kernel path (the kernels' plain versions on the CPU):

* FedAvg, 1 round: parameters within 1e-5 of the round's movement,
  accuracies within 1e-3, the same simulated timing;
* IL, 1 round's budget: accuracies within 1e-3.
"""
import numpy as np
import torch

from repro_torch.checkpoint.bridge import params_to_numpy
from zoo_session_support import TOL, port_session, ratio, reference_session

torch.set_num_threads(2)


def test_fedavg_round_matches_reference():
    ref, init, _, after0 = reference_session("fedavg", rounds=1)
    sess = port_session(ref, init, algorithm="fedavg", elastic_kernels=True)
    sess.run(1)
    assert ratio(params_to_numpy(sess.params), after0, init) <= TOL
    np.testing.assert_allclose(sess.history[0]["accs"],
                               ref.history[0]["accs"], atol=1e-3, rtol=0)
    assert sess.history[0]["timing"] == ref.history[0]["timing"]


def test_il_round_matches_reference():
    ref, init, _, _ = reference_session("il", rounds=1)
    sess = port_session(ref, init, algorithm="il", elastic_kernels=True)
    sess.run(1)
    np.testing.assert_allclose(sess.il_accs, ref.il_accs, atol=1e-3, rtol=0)
