"""The sequential trainer (``batched_rounds=False``) behind the port's
``CFLSession`` on the transformer zoo against the JAX reference, at the
reference's zoo setting (``tests/zoo_session_support.py``), on its data,
initial parameters and predictor, bridged:

* a CFL round: specs identical, accuracies within 1e-3, parameters within
  1e-5 of the round's movement;
* IL, one round's budget, its accuracies through the family's
  ``evaluate``: within 1e-3.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.bridge import params_to_numpy
from zoo_session_support import port_session, ratio, reference_session

torch.set_num_threads(2)
TOL = 1e-5


@pytest.mark.parametrize("algorithm", ["cfl", "il"])
def test_sequential_session_matches_reference(algorithm):
    fl = dict(n_workers=3, local_epochs=1, batch_size=8, lr=0.05, seed=0,
              batched_rounds=False)
    ref, init, pred0, after0 = reference_session(algorithm, fl=fl, rounds=1)
    sess = port_session(ref, init, pred0, algorithm=algorithm, fl=fl)
    sess.run(1)
    if algorithm == "il":
        np.testing.assert_allclose(sess.il_accs, ref.il_accs, atol=1e-3,
                                   rtol=0)
        return
    assert sess.server.engine is None
    assert sess.history[0]["specs"] == ref.history[0]["specs"]
    np.testing.assert_allclose(sess.history[0]["accs"],
                               ref.history[0]["accs"], atol=1e-3, rtol=0)
    assert ratio(params_to_numpy(sess.params), after0, init) <= TOL
