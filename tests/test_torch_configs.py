"""The port's config helpers against the JAX reference, exactly equal:

* for every ``ARCHS`` entry and its ``reduced`` variant: ``param_count``,
  ``active_param_count``, ``flops_per_token`` at several sequence
  lengths, ``supports`` on every ``INPUT_SHAPES`` entry, and
  ``config_fingerprint`` (the port's dataclasses carry the reference's
  fields in the reference's order, so the strings are the same);
* ``long_context_variant``, ``supported_pairs`` and ``INPUT_SHAPES``;
* ``config_fingerprint`` of the paper's CNN.
"""
import dataclasses

import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import reduced as ref_reduced
from repro.configs import archs as ref_archs
from repro.configs import base as ref_base
from repro.configs.paper_cnn import PAPER_CNN as REF_PAPER_CNN
from repro_torch.configs import (ARCHS, INPUT_SHAPES, config_fingerprint,
                                 flops_per_token, long_context_variant,
                                 reduced, supported_pairs)
from repro_torch.configs import base
from repro_torch.configs.paper_cnn import PAPER_CNN

SEQ_LENS = (1, 64, 4096, 32768, 524288)


def _pairs(name):
    """(port, reference) configs: the published one and two reductions."""
    return [(ARCHS[name], REF_ARCHS[name]),
            (reduced(ARCHS[name]), ref_reduced(REF_ARCHS[name])),
            (reduced(ARCHS[name], n_layers=3, d_model=64),
             ref_reduced(REF_ARCHS[name], n_layers=3, d_model=64))]


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_arch_helpers_equal_reference(name):
    for cfg, ref in _pairs(name):
        assert config_fingerprint(cfg) == ref_base.config_fingerprint(ref)
        assert cfg.param_count() == ref.param_count()
        assert cfg.active_param_count() == ref.active_param_count()
        for s in SEQ_LENS:
            assert flops_per_token(cfg, s) == ref_base.flops_per_token(ref, s)
        for shape in REF_SHAPES:
            assert cfg.supports(shape) == ref.supports(shape)
        assert config_fingerprint(long_context_variant(cfg)) == \
            ref_base.config_fingerprint(ref_archs.long_context_variant(ref))


def test_dataclass_fields_in_reference_order():
    for port_cls, ref_cls in ((base.ModelConfig, ref_base.ModelConfig),
                              (base.MoEConfig, ref_base.MoEConfig),
                              (base.SSMConfig, ref_base.SSMConfig),
                              (base.MLAConfig, ref_base.MLAConfig),
                              (base.Segment, ref_base.Segment),
                              (base.InputShape, ref_base.InputShape)):
        assert [(f.name, f.default) for f in dataclasses.fields(port_cls)] \
            == [(f.name, f.default) for f in dataclasses.fields(ref_cls)]


def test_shapes_pairs_and_long_context_equal_reference():
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}
    assert supported_pairs() == ref_archs.supported_pairs()
    # a config that names its shapes, and an encoder-only one
    cfg = dataclasses.replace(ARCHS["granite-3-8b"],
                              supported_shapes=("train_4k",))
    ref = dataclasses.replace(REF_ARCHS["granite-3-8b"],
                              supported_shapes=("train_4k",))
    assert [cfg.supports(s) for s in INPUT_SHAPES] == \
        [ref.supports(s) for s in REF_SHAPES] == [True, False, False, False]
    assert not ARCHS["hubert-xlarge"].supports("decode_32k")
    assert long_context_variant(ARCHS["granite-3-8b"]).sliding_window == 4096
    assert long_context_variant(ARCHS["mamba2-2.7b"]) is ARCHS["mamba2-2.7b"]


def test_paper_cnn_fingerprint_equal_reference():
    assert config_fingerprint(PAPER_CNN) == \
        ref_base.config_fingerprint(REF_PAPER_CNN)
    assert config_fingerprint(1.5) == ref_base.config_fingerprint(1.5)
