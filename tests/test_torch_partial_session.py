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

CFL under "uniform" and "fairness" run here, CFL under "latency" and
FedAvg in ``tests/test_torch_partial_latency_fedavg.py`` (the held run:
``cnn_session_support.hold_partial_session``).
"""
import pytest
import torch

from cnn_session_support import hold_partial_session

torch.set_num_threads(2)


@pytest.mark.parametrize("algorithm,selection", [("cfl", "uniform"),
                                                  ("cfl", "fairness")])
def test_partial_session_matches_reference(algorithm, selection):
    hold_partial_session(algorithm, selection)


