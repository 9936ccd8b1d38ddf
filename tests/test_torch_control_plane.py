"""The port's CFL control plane against the JAX reference.

* host Python, exactly equal: ``fairness``, ``latency`` (device profiles,
  the cost model, every entry of the LUT), the CNN family's spec-space
  surface (random specs, mutation and crossover under the same
  ``random.Random`` draws, features, FLOPs, parameter bytes, the LUT's
  spec grid), the population's clients, the full-participation
  selection;
* ``adamw`` and the accuracy predictor (the reference's initial weights
  bridged by ``load_numpy``, three ``train_round``s on fixed profiles):
  ≤1e-5; then ``search_all_workers`` with both predictors: identical
  specs;
* ``CFLSession.from_synthetic`` runs on the CPU (its parity with the
  reference is ``tests/test_torch_session.py``'s);
* the transformer family's sequential surface and its LM population run;
  what is not ported raises, naming its ROADMAP item; selection, async
  rounds and faults build (their parity: ``tests/test_torch_partial*.py``,
  ``test_torch_async*.py``, ``test_torch_selection.py``).
"""
import dataclasses
import importlib
import random

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.core import elastic as ref_elastic
from repro.core import fairness as ref_fairness
from repro.core import latency as ref_latency
from repro.core import predictor as ref_predictor
from repro.core import search as ref_search
from repro.core import submodel as ref_submodel
from repro.fl import rounds as ref_rounds
from repro.fl.client import ClientInfo as RefClientInfo
from repro.fl import selection as ref_selection
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.paper_cnn import PAPER_CNN, CNNConfig
from repro_torch.core import elastic, fairness, latency, predictor, search
from repro_torch.core.submodel import SubmodelSpec
from repro_torch.fl import rounds, selection
from repro_torch.fl.server import CFLConfig
from repro_torch.fl.session import CFLSession
from repro_torch.optim import adamw

torch.set_num_threads(2)
TOL = 1e-5
ref_paper_cnn = importlib.import_module("repro.configs.paper_cnn")

# examples/quickstart.py's CNN and round settings
QUICK = dict(name="quickstart", in_channels=1, image_size=28,
             stem_channels=8, stages=((16, 2), (32, 2)), groupnorm_groups=4,
             elastic_widths=(0.5, 1.0))
CFG, REF_CFG = CNNConfig(**QUICK), RefCNNConfig(**QUICK)


def _ref_spec(s):
    return ref_submodel.SubmodelSpec(tuple(s.depth), tuple(s.width))


def _profiles(fam, n=24, seed=0):
    rng = random.Random(seed)
    acc = np.random.default_rng(seed)
    return [(fam.random_spec(rng), rng.randint(0, 4), float(acc.random()))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# host Python: exactly equal
# ---------------------------------------------------------------------------
def test_fairness_equal_reference():
    rng = np.random.default_rng(0)
    for n in (1, 4, 23):
        a = rng.random(n)
        assert fairness.accuracy_fairness(a) == \
            ref_fairness.accuracy_fairness(a)
        assert fairness.round_time_fairness(a * 10) == \
            ref_fairness.round_time_fairness(a * 10)


@pytest.mark.parametrize("paper", [False, True])
def test_latency_table_equal_reference(paper):
    cfg, ref_cfg = (PAPER_CNN, ref_paper_cnn.PAPER_CNN) if paper else \
        (CFG, REF_CFG)
    assert latency.EDGE_FLEET == tuple(
        latency.DeviceProfile(**dataclasses.asdict(p))
        for p in ref_latency.EDGE_FLEET)
    for n in (3, 8):
        assert [p.name for p in latency.fleet_for_workers(n)] == \
            [p.name for p in ref_latency.fleet_for_workers(n)]
    got = latency.LatencyTable(cfg, batch_size=16)
    want = ref_latency.LatencyTable(ref_cfg, batch_size=16)
    assert got._table == want._table
    assert len(got) == len(want) == (1728 * 5 if paper else 4 * 4 * 5)
    spec = SubmodelSpec((1,) * len(cfg.stages), (0.3,) * len(cfg.stages))
    assert got.lookup(spec, "rpi-4") == want.lookup(_ref_spec(spec),
                                                    "rpi-4")


def test_cnn_search_surface_equal_reference():
    fam = elastic.family_for(PAPER_CNN)
    ref_fam = ref_elastic.family_for(ref_paper_cnn.PAPER_CNN)
    assert fam.feature_dim == ref_fam.feature_dim
    assert predictor.feature_dim(fam) == ref_predictor.feature_dim(ref_fam)
    assert [s.genes() for s in fam.lut_specs()] == \
        [s.genes() for s in ref_fam.lut_specs()]
    assert [s.genes() for s in fam.lut_specs((1, 3))] == \
        [s.genes() for s in ref_fam.lut_specs((1, 3))]
    assert fam.minimal_spec().genes() == ref_fam.minimal_spec().genes()
    assert fam.full_spec().genes() == ref_fam.full_spec().genes()
    r1, r2 = random.Random(7), random.Random(7)
    for _ in range(40):
        a, b = fam.random_spec(r1), ref_fam.random_spec(r2)
        assert a.genes() == b.genes()
        c, d = fam.mutate(a, r1, 0.5), ref_fam.mutate(b, r2, 0.5)
        assert c.genes() == d.genes()
        e, f = fam.crossover(a, c, r1), ref_fam.crossover(b, d, r2)
        assert e.genes() == f.genes()
        assert fam.flops(e) == ref_fam.flops(f)
        assert fam.param_bytes(e) == ref_fam.param_bytes(f)
        assert fam.flops_fraction(e) == ref_fam.flops_fraction(f)
        for q in (0, 4):
            np.testing.assert_array_equal(predictor.featurize(fam, e, q),
                                          ref_predictor.featurize(ref_fam,
                                                                  f, q))


def test_population_and_selection_equal_reference():
    got_c, got_tr, got_te = rounds.build_population(
        CFG, n_workers=5, n_samples=300, heterogeneity="quality", seed=2)
    want_c, want_tr, want_te = ref_rounds.build_population(
        REF_CFG, n_workers=5, n_samples=300, heterogeneity="quality",
        seed=2)
    assert [dataclasses.asdict(c) for c in got_c] == \
        [dataclasses.asdict(c) for c in want_c]
    for a, b in zip(got_tr + got_te, want_tr + want_te):
        assert a["x"].shape == b["x"].shape and a["x"].dtype == b["x"].dtype
    c2, _, _ = rounds.build_population(
        CFG, kind="synthcifar", n_workers=3, n_samples=200,
        heterogeneity="distribution", seed=1)
    assert [c.quality for c in c2] == [0, 0, 0]
    fam, ref_fam = elastic.family_for(CFG), ref_elastic.family_for(REF_CFG)
    lut = latency.LatencyTable(fam)
    ref_lut = ref_latency.LatencyTable(ref_fam)
    ref_clients = [RefClientInfo(**dataclasses.asdict(c))
                   for c in got_c]
    assert selection.predict_full_round_times(
        fam, got_c, lut, batch_size=32, epochs=2) == \
        ref_selection.predict_full_round_times(
            ref_fam, ref_clients, ref_lut, batch_size=32, epochs=2)
    tracker = selection.FleetTracker(got_c, "full", seed=3)
    ref_tracker = ref_selection.FleetTracker(ref_clients, "full", seed=3)
    for r in range(2):
        a, b = tracker.select(r), ref_tracker.select(r)
        for k in ("idx", "valid", "weights"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        accs = [0.1 * (k + r) for k in range(5)]
        tracker.record(a.participants, accs)
        ref_tracker.record(b.participants, accs)
    np.testing.assert_array_equal(tracker.participation_counts,
                                  ref_tracker.participation_counts)
    np.testing.assert_array_equal(tracker.last_accs, ref_tracker.last_accs)


# ---------------------------------------------------------------------------
# adamw, the predictor and the search
# ---------------------------------------------------------------------------
def test_adamw_matches_reference():
    rng = np.random.default_rng(1)
    tree = [{"w": rng.standard_normal((4, 3)).astype(np.float32),
             "b": rng.standard_normal((3,)).astype(np.float32)}]
    for wd in (0.0, 0.01):
        opt, ref_opt = adamw(3e-3, weight_decay=wd), \
            ref_adamw(3e-3, weight_decay=wd)
        p = params_from_numpy(tree, device="cpu")
        rp = tree
        st, rst = opt.init(p), ref_opt.init(rp)
        for _ in range(5):
            g = [{k: rng.standard_normal(v.shape).astype(np.float32)
                  for k, v in layer.items()} for layer in tree]
            upd, st = opt.update(params_from_numpy(g, device="cpu"), st, p)
            rupd, rst = ref_opt.update(g, rst, rp)
            p = [{k: p[0][k] - upd[0][k] for k in p[0]}]
            rp = jax.tree.map(lambda a, u: a - u, rp, rupd)
        for k in ("w", "b"):
            np.testing.assert_allclose(p[0][k].numpy(), np.asarray(rp[0][k]),
                                       atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def predictors():
    """The reference predictor and the port's with its initial weights
    bridged, each after three ``train_round``s on the same profiles."""
    fam, ref_fam = elastic.family_for(CFG), ref_elastic.family_for(REF_CFG)
    ref = ref_predictor.AccuracyPredictor(ref_fam, seed=0)
    port = predictor.AccuracyPredictor(fam, seed=0, device="cpu")
    port.load_numpy(jax.tree.map(np.asarray, ref.params))
    maes = []
    for r in range(3):
        profs = _profiles(fam, 8, seed=r)
        port.add_profiles(profs)
        ref.add_profiles([(_ref_spec(s), q, a) for s, q, a in profs])
        maes.append((port.train_round(epochs=4), ref.train_round(epochs=4)))
    return fam, ref_fam, port, ref, maes


def test_predictor_matches_reference(predictors):
    fam, _, port, ref, maes = predictors
    for got, want in maes:
        assert abs(got - want) <= TOL
    for a, b in zip(port.params, ref.params):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       atol=TOL, rtol=0)
    specs = [s for s, _, _ in _profiles(fam, 12, seed=9)]
    got = port.predict_batch(specs, 2)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(
        got, ref.predict_batch([_ref_spec(s) for s in specs], 2), atol=TOL,
        rtol=0)
    assert abs(port.predict(specs[0], 1)
               - ref.predict(_ref_spec(specs[0]), 1)) <= TOL


def test_search_all_workers_identical_specs(predictors):
    fam, ref_fam, port, ref, _ = predictors
    lut, ref_lut = latency.LatencyTable(fam), \
        ref_latency.LatencyTable(ref_fam)
    devices = [p.name for p in latency.fleet_for_workers(6)]
    full = fam.full_spec()
    bounds = [lut.lookup(full, d) * f
              for d, f in zip(devices, (1.05, 0.6, 0.3, 1.0, 0.8, 0.01))]
    kw = dict(devices=devices, qualities=[0, 1, 2, 3, 4, 0],
              latency_bounds=bounds, seed=5)
    got = search.search_all_workers(fam, port, lut, **kw)
    want = ref_search.search_all_workers(ref_fam, ref, ref_lut, **kw)
    assert [s.genes() for s in got] == [s.genes() for s in want]
    # the last bound admits nothing: the minimal spec
    assert got[-1] == fam.minimal_spec()


# ---------------------------------------------------------------------------
# the session (its parity with the reference: tests/test_torch_session.py)
# ---------------------------------------------------------------------------
def test_from_synthetic_runs_on_the_cpu():
    sess = CFLSession.from_synthetic(CFG, n_workers=4, n_samples=200,
                                     device="cpu")
    assert isinstance(sess.family, elastic.CNNElasticFamily)
    hist = sess.run(2)
    assert [h["round"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["accs"]).all() for h in hist)
    assert 0.0 <= sess.fairness()["mean"] <= 1.0
    acc = sess.global_accuracy(sess.server.test_data[0])
    assert 0.0 <= acc <= 1.0


def test_unported_paths_raise():
    kw = dict(n_workers=2, n_samples=64, device="cpu")
    with pytest.raises(ValueError, match="algorithm"):
        CFLSession.from_synthetic(CFG, algorithm="sgd", **kw)
    for ek in ("tpu", "interpret"):
        with pytest.raises(ValueError, match="'dense', 'cuda'"):
            CFLSession.from_synthetic(
                CFG, fl_cfg=CFLConfig(n_workers=2, elastic_kernels=ek), **kw)
    for algorithm in ("cfl", "fedavg"):
        with pytest.raises(NotImplementedError, match="ROADMAP A17"):
            CFLSession.from_synthetic(
                CFG, fl_cfg=CFLConfig(n_workers=2, cohort_shards=2),
                algorithm=algorithm, **kw)
    # selection, async rounds and faults (once raising, naming ROADMAP
    # A12 / A13), the overlap ring and checkpoints (A14) now build; async
    # and faults need the batched engine, as in the reference
    for field, value in (("mode", "async"), ("faults", "drop=0.2"),
                         ("selection", "uniform"), ("overlap", True),
                         ("checkpoint_every", 1)):
        for algorithm in ("cfl", "fedavg"):
            CFLSession.from_synthetic(
                CFG, fl_cfg=CFLConfig(n_workers=2, **{field: value}),
                algorithm=algorithm, **kw)
    seq = CFLSession.from_synthetic(
        CFG, fl_cfg=CFLConfig(n_workers=2, batched_rounds=False), **kw)
    with pytest.raises(ValueError, match="batched engine"):
        seq.run(1, mode="async")
    with pytest.raises(ValueError, match="mode must be"):
        seq.run(1, mode="eventual")
    sess = CFLSession.from_synthetic(CFG, **kw)
    sess.run(0, overlap=True)              # the ring (once ROADMAP A14)
    assert sess.server.engine.prefetch_enabled
    with pytest.raises(ValueError, match="unknown selection policy"):
        sess.run(1, selection="fastest")
    with pytest.raises(RuntimeError, match="no rounds"):
        sess.fairness()
    # FedAvg's overlap and the runtime's checkpoints (once ROADMAP A14)
    fedavg = CFLSession.from_synthetic(CFG, algorithm="fedavg", **kw)
    assert fedavg.server.runtime.state_snapshot()["groups"] == {}
    fedavg.run(0, overlap=True)
    assert fedavg.server.engine.prefetch_enabled

    class Half(selection.SelectionPolicy):
        name = "half"
    fedavg.server.set_selection(Half())
    with pytest.raises(NotImplementedError):      # a policy with no select
        fedavg.run(1)
    # the transformer family's sequential surface and its LM population
    # (once raising, naming ROADMAP A8 / A6) now run; what the zoo still
    # lacks raises, naming its item
    fam = elastic.TransformerElasticFamily(reduced(ARCHS["granite-3-8b"],
                                                   n_layers=2, d_model=64))
    spec = fam.minimal_spec()
    params = fam.init_params(device="cpu")
    sub, ctx = fam.extract(params, spec)
    assert ctx == fam.sub_ctx(spec) and ctx.n_layers == 1
    x = torch.zeros((2, 5), dtype=torch.long)
    assert fam.sub_logits(sub, ctx, x).shape == (2, 5, ctx.padded_vocab)
    for call in (fam.sub_loss, fam.sub_metric):
        assert torch.isfinite(call(sub, ctx, x, None, torch.ones(2)))
    assert fam.pad_delta(sub, params, spec)["segments"][0]["blocks"][
        "mlp"]["wi"].shape == params["segments"][0]["blocks"]["mlp"][
        "wi"].shape
    assert fam.sub_init_params(0, spec, device="cpu")["segments"][0][
        "blocks"]["mlp"]["wi"].shape == sub["segments"][0]["blocks"][
        "mlp"]["wi"].shape
    clients, train, test = rounds.build_population(
        fam, n_workers=2, n_samples=16, heterogeneity="none")
    assert [len(d["y"]) for d in train] == [8, 8] and len(test) == 2
    # the zoo's last three decoder parents (once raising, naming ROADMAP
    # A11) build their families and run the sequential surface
    for name in ("gemma2-9b", "zamba2-1.2b", "deepseek-v2-lite-16b"):
        assert elastic.family_for(ARCHS[name]).cfg.name == name
        other = elastic.TransformerElasticFamily(
            reduced(ARCHS[name], n_layers=2, d_model=64))
        spec = other.minimal_spec()
        oparams = other.init_params(device="cpu")
        osub, octx = other.extract(oparams, spec)
        assert torch.isfinite(other.sub_loss(osub, octx, x, None,
                                             torch.ones(2)))
        assert [t.shape for t in jax.tree.leaves(other.pad_delta(
            osub, oparams, spec))] == [t.shape for t in
                                       jax.tree.leaves(oparams)]
    # the frontend archs' models are ported (ROADMAP A7 landed), but, as
    # in the reference, they have no token cohort packing for a session
    for name in ("llava-next-mistral-7b", "hubert-xlarge"):
        with pytest.raises(ValueError, match="frontend/encoder-only"):
            elastic.TransformerElasticFamily(ARCHS[name])
    assert CFLSession.from_synthetic(
        fam, n_workers=2, n_samples=16, selection="uniform",
        device="cpu").server.tracker.policy.name == "uniform"
