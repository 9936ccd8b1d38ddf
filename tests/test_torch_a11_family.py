"""The transformer family over the zoo's last three decoder parents —
deepseek-v2-lite (MLA, MoE, the dense first layer), gemma2 (``attn_pair``
segments) and zamba2 (the shared hybrid block), reduced as
``tests/a11_support.py`` says — against the JAX reference, on the
reference's parameters, bridged:

* ``extract_transformer`` equal to the reference's leaf for leaf (a pair's
  ``local`` and ``global`` trees alike, the shared block whole) and
  ``sub_transformer_config`` field by field;
* ``pad_transformer`` of a random delta equal to the reference's, zeros
  off the coverage, and the pad of all-ones equal to the broadcast of
  ``coverage_factors`` (the shared block covered by every client);
* ``checkpoint/bridge.py`` round-trips the new leaves bit-equal;
* the spec surface: ``attn_head_frac`` is elastic on gemma2 only (MLA's
  latent heads and zamba2's shared block are not prefix-sliceable), the
  forward masks equal the reference's, and ``random_spec`` draws the
  reference's specs.

One batched CFL round per parent: ``tests/test_torch_a11_rounds.py``.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

import a11_support as A
from repro.core.elastic import TransformerElasticFamily as RefFamily
from repro_torch.checkpoint.bridge import params_to_numpy
from repro_torch.core import submodel
from repro_torch.core.elastic import TransformerElasticFamily
from repro_torch.models import transformer as PT
from repro_torch.optim.optimizers import tree_map

torch.set_num_threads(2)


def _specs(fam, name):
    """The full spec, the cohort's specs, the minimal spec and 3 random
    ones."""
    rng = random.Random(5)
    return ([fam.full_spec()] + A.cohort_specs(name) + [fam.minimal_spec()]
            + [fam.random_spec(rng) for _ in range(3)])


@pytest.fixture(scope="module", params=A.PARENTS)
def parent(request):
    cfg, ref_cfg = A.configs(request.param)
    return (request.param, TransformerElasticFamily(cfg, seq_len=8),
            RefFamily(ref_cfg, seq_len=8), A.ref_params(ref_cfg, 3))


def leaves(tree):
    return jax.tree.leaves(params_to_numpy(tree))


def test_extract_and_sub_config_equal_reference(parent):
    name, fam, ref_fam, params = parent
    port = A.bridged(params)
    for spec in _specs(fam, name):
        got, cfg = fam.extract(port, spec)
        want, ref_cfg = ref_fam.extract(params, A.ref_spec(spec))
        assert jax.tree.structure(params_to_numpy(got)) == \
            jax.tree.structure(A.np_tree(want))
        for x, y in zip(leaves(got), jax.tree.leaves(want)):
            assert x.shape == y.shape
            np.testing.assert_array_equal(x, np.asarray(y))
        for f in dataclasses.fields(ref_cfg):
            assert repr(getattr(cfg, f.name)) == repr(getattr(ref_cfg,
                                                              f.name))
        assert cfg == fam.sub_ctx(spec)
        if "shared_attn" in params:           # kept whole, the same tensors
            assert all(a is b for a, b in zip(
                jax.tree.leaves(got["shared_attn"]),
                jax.tree.leaves(port["shared_attn"])))


def test_pad_equal_reference_and_coverage(parent):
    name, fam, ref_fam, params = parent
    port = A.bridged(params)
    rng = np.random.default_rng(0)
    shapes = PT.param_shapes(fam.cfg)
    for spec in _specs(fam, name):
        want_sub, _ = ref_fam.extract(params, A.ref_spec(spec))
        delta = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            want_sub)
        got = fam.pad_delta(A.bridged(delta), port, spec)
        want = ref_fam.pad_delta(delta, params, A.ref_spec(spec))
        ones = fam.pad_delta(tree_map(torch.ones_like,
                                      fam.extract(port, spec)[0]), port,
                             spec)
        factors = submodel.coverage_factors(fam.cfg, spec, shapes)
        assert jax.tree.structure(A.np_tree(want)) == \
            jax.tree.structure(factors)
        for g, w, o, f in zip(leaves(got), jax.tree.leaves(want),
                              leaves(ones), jax.tree.leaves(factors)):
            np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(o, np.broadcast_to(f, o.shape))
            assert not np.any(g[o == 0])
        if "shared_attn" in factors:          # every client covers it
            assert all(np.all(f == 1) for f in
                       jax.tree.leaves(factors["shared_attn"]))


def test_bridge_round_trips_the_new_leaves_bit_equal(parent):
    """The reference's parameters — MLA leaves, a pair's ``local`` /
    ``global`` trees, the shared block — through ``params_from_numpy`` and
    back, fp32 bit-equal, with the tree and shapes of the port's own
    ``init_params``."""
    name, fam, ref_fam, params = parent
    back = params_to_numpy(A.bridged(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    own = params_to_numpy(fam.init_params(device="cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(params)
    assert [a.shape for a in jax.tree.leaves(own)] == \
        [a.shape for a in jax.tree.leaves(params)]


def test_spec_surface_and_masks_equal_reference(parent):
    name, fam, ref_fam, params = parent
    assert fam._attn_elastic == (name == "gemma2-9b")
    specs = _specs(fam, name)
    got = fam.cohort_masks(specs, device="cpu")
    want = ref_fam.cohort_masks([A.ref_spec(s) for s in specs])
    assert set(got.fwd) == set(want.fwd)
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 got.fwd)),
                    jax.tree.leaves(A.np_tree(want.fwd))):
        np.testing.assert_array_equal(a, b)
    full = jax.tree.map(
        lambda f, p: np.broadcast_to(f.numpy(), (len(specs),) + p.shape),
        got.param_mask, params)
    for a, b in zip(jax.tree.leaves(full),
                    jax.tree.leaves(A.np_tree(want.param_mask))):
        np.testing.assert_array_equal(a, b)
    rr, rp = random.Random(11), random.Random(11)
    for _ in range(10):
        assert ref_fam.random_spec(rr).genes() == fam.random_spec(rp).genes()
