"""FedAvg's buffered async run with fault injection against the JAX
reference, on the quickstart CNN (``cnn_session_support.hold_faulty_run``;
the faulty sync rounds are ``tests/test_torch_async_faults.py``'s): 4
aggregates of a buffer of one delta under FedBuff's staleness discount,
with drops, straggles and corruption and the quarantine gate — identical
event columns, accuracies within one test sample, the first round's
parameters within 1e-3 of its movement.
"""
import pytest
import torch

from cnn_session_support import BUFFERED, hold_faulty_run

torch.set_num_threads(2)


@pytest.mark.parametrize("algorithm,kw,rounds", [("fedavg", BUFFERED, 4)])
def test_faulty_and_buffered_rounds_match_reference(algorithm, kw, rounds):
    hold_faulty_run(algorithm, kw, rounds)
