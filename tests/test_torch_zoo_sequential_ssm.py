"""The checks of ``tests/test_torch_zoo_sequential.py`` for the SSM parent
(mamba2 reduced to 3 layers, d_model 64), in a file of its own so that
each file runs in under a minute: one sequential round against the
reference's ``SequentialFamilyTrainer`` (parameters within 1e-5 of the
round's movement, accuracies within 1e-3), and against the port's batched
dense round in fp64 (within 1e-5)."""
import pytest
import torch

import test_torch_zoo_sequential as base

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setting():
    return base.make_setting("ssm")


def test_sequential_round_matches_reference(setting):
    base.test_sequential_round_matches_reference(setting)


def test_sequential_round_matches_batched_fp64(setting):
    base.test_sequential_round_matches_batched_fp64(setting)
