"""The port's fault injection and buffered async rounds against the JAX
reference, on the quickstart CNN (4 workers, 400 samples, 2 of 4 clients
a dispatch, the stage convolutions through K1's plain version), on the
reference's data, initial parameters and predictor, bridged
(``cnn_session_support.hold_faulty_run``): FedAvg's buffered async run
(a buffer of one delta, FedBuff's staleness discount, drops / straggles
/ corruption, the quarantine gate), and faulty sync rounds of CFL and
FedAvg under the fairness policy — identical event columns
(participants, staleness, simulated clock, dropped, retried,
quarantined), accuracies within one test sample, parameters held as the
helper says. The faulty sync rounds run here, FedAvg's buffered run in
``tests/test_torch_async_faults_buffered.py`` (a file of its own to keep
each file's time short); CFL's buffered run is
``tests/test_torch_async_session.py``'s.
"""
import pytest
import torch

from cnn_session_support import FAULTY_SYNC, hold_faulty_run

torch.set_num_threads(2)


@pytest.mark.parametrize("algorithm,kw,rounds", [
    ("cfl", FAULTY_SYNC, 2), ("fedavg", FAULTY_SYNC, 2)])
def test_faulty_and_buffered_rounds_match_reference(algorithm, kw, rounds):
    hold_faulty_run(algorithm, kw, rounds)
