"""The checks of ``tests/test_torch_zoo_extract.py`` for the SSM parent
(mamba2 reduced to 3 layers, d_model 64), in a file of its own so that
each file runs in under a minute:
extract / ``sub_transformer_config`` / pad equal to the reference's, the
all-ones pad equal to ``coverage_factors``, and the submodel's forward,
loss and metric within 1e-5."""
import pytest
import torch

import test_torch_zoo_extract as base

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["ssm"])
def parent(request):
    return base.make_parent(request.param)


def test_extract_and_sub_config_equal_reference(parent):
    base.test_extract_and_sub_config_equal_reference(parent)


def test_pad_equal_reference_and_coverage(parent):
    base.test_pad_equal_reference_and_coverage(parent)


def test_sub_forward_matches_reference(parent):
    base.test_sub_forward_matches_reference(parent)
