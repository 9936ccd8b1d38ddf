"""The transformer family's search surface and the zoo's LM population
against the JAX reference (host Python and numpy, exactly equal):

* ``minimal_spec``, ``random_spec``, ``mutate`` and ``crossover``
  identical under the same ``random.Random`` draws; ``featurize``
  bit-equal; ``feature_dim``, ``flops``, ``param_bytes``,
  ``flops_fraction`` and ``LatencyTable.lookup`` exactly equal — for a
  dense, a MoE and an SSM parent, reduced and at published width;
* ``search_submodel`` picks the reference's spec with both predictors
  trained on the same profiles (the reference predictor's initial
  weights bridged by ``load_numpy``), at the reference's own setting:
  granite reduced to 4 layers, d_model 64, ``seq_len=24``, a bound
  between the minimal and the full model's latency;
* ``apply_token_quality``, ``_lm_population`` and ``build_population``
  (clients and data) bit-equal.
"""
import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.core import elastic as ref_elastic
from repro.core import latency as ref_latency
from repro.core import predictor as ref_predictor
from repro.core import search as ref_search
from repro.core import submodel as ref_submodel
from repro.data import quality as ref_quality
from repro.fl import rounds as ref_rounds
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import latency, predictor, search
from repro_torch.core.elastic import TransformerElasticFamily
from repro_torch.data import quality
from repro_torch.fl import rounds

torch.set_num_threads(2)
NAMES = ("granite-3-8b", "granite-moe-1b-a400m", "mamba2-2.7b")


def ref_spec(s):
    return ref_submodel.TransformerSubSpec(s.layers, s.ff_frac, s.expert_frac,
                                           s.ssm_head_frac, s.attn_head_frac)


def families(name, full=False, seq_len=24):
    if full:
        cfg, ref_cfg = ARCHS[name], REF_ARCHS[name]
    else:
        cfg = reduced(ARCHS[name], n_layers=4, d_model=64)
        ref_cfg = ref_reduced(REF_ARCHS[name], n_layers=4, d_model=64)
    return (TransformerElasticFamily(cfg, seq_len=seq_len),
            ref_elastic.TransformerElasticFamily(ref_cfg, seq_len=seq_len))


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_search_surface_equal_reference(name, full):
    fam, ref_fam = families(name, full)
    assert fam.feature_dim == ref_fam.feature_dim
    assert predictor.feature_dim(fam) == ref_predictor.feature_dim(ref_fam)
    assert fam.minimal_spec().genes() == ref_fam.minimal_spec().genes()
    assert fam.full_spec().genes() == ref_fam.full_spec().genes()
    assert tuple(fam.lut_specs()) == tuple(ref_fam.lut_specs()) == ()
    lut = latency.LatencyTable(fam, batch_size=16)
    ref_lut = ref_latency.LatencyTable(ref_fam, batch_size=16)
    r1, r2 = random.Random(11), random.Random(11)
    for i in range(30):
        a, b = fam.random_spec(r1), ref_fam.random_spec(r2)
        assert a.genes() == b.genes()
        c, d = fam.mutate(a, r1, 0.5), ref_fam.mutate(b, r2, 0.5)
        assert c.genes() == d.genes()
        e, f = fam.crossover(a, c, r1), ref_fam.crossover(b, d, r2)
        assert e.genes() == f.genes()
        for s, t in ((a, b), (e, f), (fam.minimal_spec(),
                                      ref_fam.minimal_spec())):
            assert fam.flops(s) == ref_fam.flops(t)
            assert fam.param_bytes(s) == ref_fam.param_bytes(t)
            assert fam.param_bytes(s, 2) == ref_fam.param_bytes(t, 2)
            assert fam.flops_fraction(s) == ref_fam.flops_fraction(t)
            np.testing.assert_array_equal(fam.featurize(s),
                                          ref_fam.featurize(t))
            q = i % 5
            np.testing.assert_array_equal(
                predictor.featurize(fam, s, q),
                ref_predictor.featurize(ref_fam, t, q))
            dev = latency.EDGE_FLEET[i % 5].name
            assert lut.lookup(s, dev) == ref_lut.lookup(t, dev)
    assert lut._table == ref_lut._table


def test_search_submodel_picks_reference_spec():
    fam, ref_fam = families("granite-3-8b", seq_len=24)
    ref = ref_predictor.AccuracyPredictor(ref_fam, seed=0)
    port = predictor.AccuracyPredictor(fam, seed=0, device="cpu")
    port.load_numpy(jax.tree.map(np.asarray, ref.params))
    rng = random.Random(5)
    acc = np.random.default_rng(5)
    for _ in range(3):
        profs = [(fam.random_spec(rng), rng.randint(0, 4),
                  float(acc.random())) for _ in range(8)]
        port.add_profiles(profs)
        ref.add_profiles([(ref_spec(s), q, a) for s, q, a in profs])
        assert abs(port.train_round(epochs=4)
                   - ref.train_round(epochs=4)) <= 1e-5
    lut = latency.LatencyTable(fam)
    ref_lut = ref_latency.LatencyTable(ref_fam)
    dev = latency.EDGE_FLEET[2]
    lo = latency.train_step_latency(fam, fam.minimal_spec(), dev)
    hi = latency.train_step_latency(fam, fam.full_spec(), dev)
    assert lo == ref_latency.train_step_latency(ref_fam,
                                                ref_fam.minimal_spec(), dev)
    for quality_level, seed, bound in ((1, 3, (lo + hi) / 2),
                                       (4, 8, lo + (hi - lo) / 4),
                                       (0, 2, lo / 2)):
        kw = dict(device=dev.name, quality=quality_level,
                  latency_bound=bound, seed=seed)
        got = search.search_submodel(fam, port, lut, **kw)
        want = ref_search.search_submodel(ref_fam, ref, ref_lut, **kw)
        assert got.genes() == want.genes()
        if bound > lo:
            assert lut.lookup(got, dev.name) < bound
            assert got != fam.full_spec()
        else:                       # nothing feasible: the minimal spec
            assert got == fam.minimal_spec()


def test_token_quality_bit_equal_reference():
    toks = np.random.default_rng(0).integers(0, 50, (7, 13)).astype(np.int32)
    assert quality.TOKEN_NOISE_FRACS == ref_quality.TOKEN_NOISE_FRACS
    for level in range(5):
        for seed in (0, 4):
            got = quality.apply_token_quality(toks, level, 50, seed=seed)
            want = ref_quality.apply_token_quality(toks, level, 50,
                                                   seed=seed)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert quality.apply_token_quality(toks, 0, 50) is toks


@pytest.mark.parametrize("heterogeneity",
                         ["quality", "distribution", "both", "none"])
def test_lm_population_bit_equal_reference(heterogeneity):
    fam, ref_fam = families("granite-moe-1b-a400m", seq_len=12)
    kw = dict(n_workers=5, n_samples=90, heterogeneity=heterogeneity,
              seed=3)
    got = rounds.build_population(fam, **kw)
    want = ref_rounds.build_population(ref_fam, **kw)
    # kind=None is the LM scenario for the transformer family
    assert got[0] == rounds.build_population(fam, kind="synthlm", **kw)[0]
    assert [dataclasses.asdict(c) for c in got[0]] == \
        [dataclasses.asdict(c) for c in want[0]]
    for parts, ref_parts in zip(got[1:], want[1:]):
        for a, b in zip(parts, ref_parts):
            assert a.keys() == b.keys()
            for k in b:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    raw = rounds._lm_population(fam, 3, 40, heterogeneity, 1)
    ref_raw = ref_rounds._lm_population(ref_fam, 3, 40, heterogeneity, 1)
    assert raw[2] == ref_raw[2]
    for a, b in zip(raw[0] + raw[1], ref_raw[0] + ref_raw[1]):
        np.testing.assert_array_equal(a["x"], b["x"])
        assert a["x"].shape[1] == 12
