"""The port's partial participation (``fl.engine``'s padded cohort,
``participation=``) against the JAX reference.

* ``train_cohort`` and ``run_fl_round`` with a ``Selection`` whose slots
  pick clients out of a fleet of four (a padding slot included, which
  repeats slot 0's client and spec) on both of the port's paths: the
  quickstart CNN at 16×16 (the stage convolutions through K1's plain
  version, and the dense masked path) and a reduced dense zoo parent
  (granite-3-8b, 2 layers, d_model 64): per-slot deltas, trained
  parameters and the round's new parameters within 1e-5, the same
  per-slot local steps (the padding slot 0, the streams padded to the
  fleet-wide count) and accuracies; the padding slot's delta exactly 0.
* The sequential trainer on a partial cohort: a 2-round
  ``batched_rounds=False`` CFL session with ``selection="uniform"``
  against the reference's — the same participants and specs, accuracies
  within one test sample, the same simulated timing, round-0 parameters
  within 1e-3 of the movement (fp32 ReLU flips, as
  ``tests/test_torch_sequential.py`` explains).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from cnn_session_support import (FL, port_session, ratio,
                                 reference_session)
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core import submodel as ref_submodel
from repro.data import synth as ref_synth
from repro.fl import engine as ref_engine
from repro.fl import selection as ref_selection
from repro.models import cnn as ref_cnn
from repro.models import transformer as RT
from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core.submodel import SubmodelSpec, TransformerSubSpec
from repro_torch.fl import engine
from repro_torch.fl.selection import Selection

torch.set_num_threads(2)
TOL = 1e-5
SMALL = dict(name="small", in_channels=1, image_size=16, stem_channels=8,
             stages=((16, 2), (32, 2)), groupnorm_groups=4,
             elastic_widths=(0.5, 1.0))
# slots: fleet clients 3 and 1, then a padding slot repeating slot 0
SEL = dict(idx=[3, 1, 3], valid=[1.0, 1.0, 0.0], weights=[16.0, 9.0, 0.0])
SEEDS = [7, 8, 7]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    a, b = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=tol,
                                   rtol=0)


def _cnn_setup():
    """The CNN parent (biases given values), its specs per slot, a fleet
    of four clients of different sizes (2 to 4 steps over two epochs)."""
    ref_cfg, cfg = RefCNNConfig(**SMALL), CNNConfig(**SMALL)
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
        .astype(np.float32),
        ref_cnn.init_params(jax.random.PRNGKey(3), ref_cfg))
    sizes = [12, 9, 5, 16]
    train = [{"x": rng.random((n, 16, 16, 1)).astype(np.float32),
              "y": rng.integers(0, 10, n).astype(np.int32)} for n in sizes]
    test = [{"x": rng.random((6, 16, 16, 1)).astype(np.float32),
             "y": rng.integers(0, 10, 6).astype(np.int32)} for _ in sizes]
    specs = [SubmodelSpec((2, 2), (0.5, 1.0)), SubmodelSpec((1, 2),
                                                            (1.0, 0.5))]
    ref_specs = [ref_submodel.SubmodelSpec(s.depth, s.width) for s in specs]
    return (ref_cfg, cfg, params, train, test, specs + specs[:1],
            ref_specs + ref_specs[:1], 0.1)


def _zoo_setup():
    """A reduced dense parent, its specs per slot and a fleet of four
    clients (2 or 4 steps) of Markov sequences."""
    ref_cfg = dataclasses.replace(
        ref_reduced(REF_ARCHS["granite-3-8b"], n_layers=2, d_model=64),
        n_heads=4, n_kv_heads=2, head_dim=16)
    cfg = dataclasses.replace(
        reduced(ARCHS["granite-3-8b"], n_layers=2, d_model=64),
        n_heads=4, n_kv_heads=2, head_dim=16)
    params = _np(RT.init_params(jax.random.PRNGKey(0), ref_cfg))
    train = [ref_synth.make_lm_dataset(n, 16, 6, seed=k, chain_seed=100 + k)
             for k, n in enumerate([6, 8, 3, 9])]
    test = [ref_synth.make_lm_dataset(4, 16, 6, seed=50 + k,
                                      chain_seed=100 + k) for k in range(4)]
    specs = [TransformerSubSpec(((1,),), ff_frac=0.75, attn_head_frac=0.5),
             TransformerSubSpec(((0, 1),), ff_frac=0.5)]
    ref_specs = [ref_submodel.TransformerSubSpec(
        s.layers, s.ff_frac, s.expert_frac, s.ssm_head_frac,
        s.attn_head_frac) for s in specs]
    return (ref_cfg, cfg, params, train, test, specs + specs[:1],
            ref_specs + ref_specs[:1], 0.5)


SETUPS = {"cnn": _cnn_setup, "zoo": _zoo_setup}


@pytest.fixture(scope="module")
def reference():
    """Each family's reference cohort and round (dense path) on the
    selection, with and without coverage normalisation."""
    out = {}
    for fam, setup in SETUPS.items():
        ref_cfg, _, params, train, test, _, ref_specs, lr = setup()
        eng = ref_engine.BatchedRoundEngine(ref_cfg, lr=lr, momentum=0.9)
        sel = ref_selection.Selection(**SEL)
        kw = dict(batch_size=4, epochs=2, seeds=SEEDS)
        res = eng.train_cohort(eng.broadcast_params(params, 3), ref_specs,
                               train, eval_datasets=test,
                               participation=sel, **kw)
        rounds = {}
        for cov in (False, True):
            new, accs, n_steps = eng.run_fl_round(
                params, ref_specs, train, test, None, coverage_norm=cov,
                participation=sel, **kw)
            rounds[cov] = (_np(new), accs, np.asarray(n_steps))
        out[fam] = (_np(res.deltas), _np(res.trained), np.asarray(res.accs),
                    np.asarray(res.n_steps), rounds)
    return out


@pytest.mark.parametrize("family", ["cnn", "zoo"])
@pytest.mark.parametrize("backend", ["auto", None])
def test_partial_cohort_matches_reference(reference, family, backend):
    _, cfg, params, train, test, specs, _, lr = SETUPS[family]()
    deltas, trained, accs, n_steps, rounds = reference[family]
    eng = engine.BatchedRoundEngine(cfg, lr=lr, momentum=0.9,
                                    backend=backend, device="cpu")
    sel = Selection(**SEL)
    kw = dict(batch_size=4, epochs=2, seeds=SEEDS)
    p = params_from_numpy(params, device="cpu")
    res = eng.train_cohort(eng.broadcast_params(p, 3), specs, train,
                           eval_datasets=test, participation=sel, **kw)
    np.testing.assert_array_equal(res.n_steps, n_steps)
    assert res.n_steps[2] == 0 and max(res.n_steps) > 1
    _close(params_to_numpy(res.deltas), deltas)
    _close(params_to_numpy(res.trained), trained)
    n_eval = 6 if family == "cnn" else 4 * 15
    assert [round(a * n_eval) for a in res.accs] == \
        [round(a * n_eval) for a in accs]
    for d in jax.tree.leaves(params_to_numpy(res.deltas)):
        assert not d[2].any()                 # the padding slot: no update
    for cov in (False, True):
        new, got_accs, got_steps = eng.run_fl_round(
            p, specs, train, test, None, coverage_norm=cov,
            participation=sel, **kw)
        want, want_accs, want_steps = rounds[cov]
        np.testing.assert_array_equal(got_steps, want_steps)
        assert [round(a * n_eval) for a in got_accs] == \
            [round(a * n_eval) for a in want_accs]
        _close(params_to_numpy(new), want)
        moved = max(float(np.abs(a - b).max()) for a, b in zip(
            jax.tree.leaves(want), jax.tree.leaves(params)))
        assert moved > 1e-3


def test_partial_cohort_streams_pad_to_the_fleet():
    """A cohort of the two smallest clients still runs the fleet-wide
    step count: the streams are padded to it, the step loop stops where
    no slot steps, and the result equals the same clients' full-fleet
    round restricted to them."""
    _, cfg, params, train, test, specs, _, lr = _cnn_setup()
    eng = engine.BatchedRoundEngine(cfg, lr=lr, momentum=0.9, backend=None,
                                    device="cpu")
    p = params_from_numpy(params, device="cpu")
    sel = Selection([2, 1], [1, 1], [5, 9])
    res = eng.train_cohort(eng.broadcast_params(p, 2), specs[:2], train,
                           batch_size=4, epochs=2, seeds=[1, 2],
                           participation=sel)
    sub = eng.train_cohort(eng.broadcast_params(p, 2), specs[:2],
                           [train[2], train[1]], batch_size=4, epochs=2,
                           seeds=[1, 2])
    np.testing.assert_array_equal(res.n_steps, sub.n_steps)
    for a, b in zip(jax.tree.leaves(params_to_numpy(res.deltas)),
                    jax.tree.leaves(params_to_numpy(sub.deltas))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", ["cnn", "zoo"])
@pytest.mark.parametrize("cov", [False, True])
def test_full_selection_is_the_whole_cohort_to_the_bit(family, cov):
    """The servers train full participation through the padded-cohort
    path: a ``full`` Selection (identity gather, weights n_k, every slot
    valid) gives ``participation=None``'s round bit for bit — new
    parameters, accuracies and local steps."""
    _, cfg, params, train, test, specs, _, lr = SETUPS[family]()
    eng = engine.BatchedRoundEngine(cfg, lr=lr, momentum=0.9,
                                    backend="auto", device="cpu")
    p = params_from_numpy(params, device="cpu")
    specs = (specs[:2] * 2)[:len(train)]
    sizes = [float(len(d["y"])) for d in train]
    sel = Selection(np.arange(len(train)), np.ones(len(train)), sizes)
    kw = dict(batch_size=4, epochs=2, seeds=[5, 6, 7, 8],
              coverage_norm=cov)
    want, want_accs, want_steps = eng.run_fl_round(p, specs, train, test,
                                                   sizes, **kw)
    got, accs, steps = eng.run_fl_round(p, specs, train, test, None,
                                        participation=sel, **kw)
    assert accs == want_accs
    np.testing.assert_array_equal(steps, want_steps)
    for a, b in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(params_to_numpy(want))):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def sequential_reference():
    fl = dict(FL, batched_rounds=False, selection="uniform")
    return reference_session("cfl", fl=fl), fl


def test_sequential_partial_session_matches_reference(sequential_reference):
    (ref, init, pred0, after0), fl = sequential_reference
    sess = port_session(ref, init, pred0, fl=fl)
    assert sess.server.engine is None
    sess.run(1)
    got0 = params_to_numpy(sess.params)
    sess.run(1)
    n_test = min(len(d["y"]) for d in ref.test_data)
    for got, want in zip(sess.history, ref.history):
        assert got["participants"] == want["participants"]
        assert len(got["participants"]) == 2
        assert got["specs"] == want["specs"]
        np.testing.assert_allclose(got["accs"], want["accs"],
                                   atol=1.0 / n_test + 1e-6, rtol=0)
        assert got["timing"] == want["timing"]
        assert got["sim_clock"] == want["sim_clock"]
    assert ratio(got0, after0, init) < 1e-3
