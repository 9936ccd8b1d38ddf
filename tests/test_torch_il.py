"""Independent Learning on the port (``fl.baselines.independent_learning``
behind ``CFLSession(algorithm="il")``) against the JAX reference, on the
quickstart CNN (4 workers, 400 samples) with the reference's data and
initial parameters bridged.

* 2 rounds of local budget on the batched engine's two paths (the full
  spec's stage convolutions through K1's plain version, and the dense
  masked path) and on the sequential trainer: accuracies within 1e-3;
* IL's rules, as the reference's: single-shot, no parent parameters, no
  partial selection, no async mode, no overlap.
"""
import numpy as np
import pytest
import torch

from cnn_session_support import port_session, reference_session
from repro_torch.fl.selection import FullParticipation

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference_il():
    return reference_session("il")


@pytest.mark.parametrize("engine", ["kernels", "dense", "sequential"])
def test_il_matches_reference(reference_il, engine):
    ref, init, _, _ = reference_il
    sess = port_session(ref, init, algorithm="il",
                        elastic_kernels=engine == "kernels",
                        batched_rounds=engine != "sequential")
    assert sess.server is None
    hist = sess.run(2)
    assert len(hist) == 1 and hist[0]["round"] == 0
    np.testing.assert_allclose(sess.il_accs, ref.il_accs, atol=1e-3,
                               rtol=0)
    assert hist[0]["fairness"].keys() == ref.history[0]["fairness"].keys()
    assert sess.fairness() == hist[0]["fairness"]


def test_il_rules(reference_il):
    ref, init, _, _ = reference_il
    with pytest.raises(ValueError, match="IL has no rounds/aggregation"):
        port_session(ref, init, algorithm="il", selection="uniform")

    class Half(FullParticipation):
        name = "half"
    sess = port_session(ref, init, algorithm="il")
    with pytest.raises(RuntimeError, match="no aggregated parent"):
        sess.params
    with pytest.raises(RuntimeError, match="no rounds run yet"):
        sess.fairness()
    with pytest.raises(ValueError, match="IL has no rounds to schedule"):
        sess.run(1, mode="async")
    with pytest.raises(ValueError, match="IL has no rounds/aggregation"):
        sess.run(1, selection="fairness")
    with pytest.raises(ValueError, match="IL has no round pipeline"):
        sess.run(1, overlap=False)
    sess.run(1, selection=Half(), mode="sync")
    assert len(sess.history) == 1
    with pytest.raises(RuntimeError, match="single-shot"):
        sess.run(1)
