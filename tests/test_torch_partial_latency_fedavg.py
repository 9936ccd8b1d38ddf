"""The port's ``CFLSession`` with partial participation against the JAX
reference (``cnn_session_support.hold_partial_session``; the holds:
``tests/test_torch_partial_session.py``'s docstring): 2 sync rounds of the
quickstart CNN, CFL under the "latency" policy (predicted stragglers
dropped) and FedAvg under "fairness".
"""
import pytest
import torch

from cnn_session_support import hold_partial_session

torch.set_num_threads(2)


@pytest.mark.parametrize("algorithm,selection", [("cfl", "latency"),
                                                  ("fedavg", "fairness")])
def test_partial_session_matches_reference(algorithm, selection):
    hold_partial_session(algorithm, selection)
