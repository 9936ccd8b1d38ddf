"""CFL's buffered async run against the JAX reference on its data,
initial parameters and predictor, bridged, on the quickstart CNN (4
workers, 400 samples, 2 of 4 clients a dispatch, the stage convolutions
through K1's plain version; ``cnn_session_support.hold_faulty_run``): a
buffer of one delta, FedBuff's staleness discount, drops / straggles /
corruption and the quarantine gate — identical event columns
(participants, staleness, simulated clock, dropped, retried,
quarantined), accuracies within one test sample, the first aggregate
within 1e-5 of its movement and the last within 1e-3. FedAvg's run and
the faulty sync rounds: ``tests/test_torch_async_faults*.py``; async at
the sync point: ``tests/test_torch_async_session.py``.
"""
import torch

from cnn_session_support import BUFFERED, hold_faulty_run

torch.set_num_threads(2)


def test_buffered_async_matches_reference():
    hold_faulty_run("cfl", BUFFERED, 4)
