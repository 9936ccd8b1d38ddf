"""The port's training slice against the JAX reference.

Host modules (synthetic LM data, partitions, batch streams, cohort packing)
bit-equal to the reference's on the same seeds; coverage and forward masks
exactly equal to the reference's ``cohort_masks``; the per-client clip and
momentum SGD, ``aggregate_apply`` (≤1e-6) and the client-stacked forward
(≤1e-5) against the reference's ``vmap``; and one ``run_fl_round`` of the
port's ``BatchedRoundEngine`` on the CPU — both backends: the kernels'
plain versions behind ``"auto"`` and the dense masked path — against the
reference's engine (dense path) on bridged parameters: new parameters
≤1e-5, the same eval tokens right, the same step counts. The reduced
granite has 4 query / 2 KV heads so that the head prefix is elastic.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.core.elastic import family_for as ref_family_for
from repro.core.submodel import TransformerSubSpec as RefSpec
from repro.data import loader as ref_loader
from repro.data import partition as ref_partition
from repro.data import synth as ref_synth
from repro.fl import engine as ref_engine
from repro.models import transformer as RT
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import sgd as ref_sgd
from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.aggregate import aggregate_apply
from repro_torch.core.elastic import family_for
from repro_torch.core.submodel import TransformerSubSpec
from repro_torch.data import loader, partition, synth
from repro_torch.fl import engine
from repro_torch.fl.selection import Selection
from repro_torch.kernels.dispatch import kernel_dispatch
from repro_torch.models import transformer as PT
from repro_torch.optim import clip_by_global_norm, sgd
from repro_torch.optim.optimizers import tree_leaves

torch.set_num_threads(2)
TOL = 1e-5
AGG_TOL = 1e-6
# the reference's aggregate module (``repro.core`` re-exports a function
# of the same name)
ref_aggregate = importlib.import_module("repro.core.aggregate")


def _configs():
    ref = dataclasses.replace(
        ref_reduced(REF_ARCHS["granite-3-8b"], n_layers=2, d_model=64),
        n_heads=4, n_kv_heads=2, head_dim=16)
    port = dataclasses.replace(
        reduced(ARCHS["granite-3-8b"], n_layers=2, d_model=64),
        n_heads=4, n_kv_heads=2, head_dim=16)
    return ref, port


# the full spec, a narrow MLP, half the heads, and a dropped layer with
# both widths cut
SPECS = [TransformerSubSpec(((0, 1),)),
         TransformerSubSpec(((0, 1),), ff_frac=0.5),
         TransformerSubSpec(((0, 1),), attn_head_frac=0.5),
         TransformerSubSpec(((1,),), ff_frac=0.75, attn_head_frac=0.5)]


def _ref_specs(specs):
    return [RefSpec(s.layers, s.ff_frac, s.expert_frac, s.ssm_head_frac,
                    s.attn_head_frac) for s in specs]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_close(got, want, tol):
    a, b = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=tol,
                                   rtol=0)


# ---------------------------------------------------------------------------
# host modules
# ---------------------------------------------------------------------------
def test_data_modules_bit_equal_reference():
    for kw in (dict(n=7, seq_len=11, vocab=50, seed=3),
               dict(n=5, seq_len=9, vocab=20, seed=1, chain_seed=42)):
        got, want = synth.make_lm_dataset(**kw), ref_synth.make_lm_dataset(
            **kw)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert got["x"].dtype == want["x"].dtype
    data = ref_synth.make_lm_dataset(20, 6, 30, seed=2)
    for a, b in zip(synth.train_test_split(data, 0.3, seed=4),
                    ref_synth.train_test_split(data, 0.3, seed=4)):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    labels = np.random.default_rng(0).integers(0, 5, 200)
    for a, b in zip(partition.noniid_partition(labels, 4, seed=1),
                    ref_partition.noniid_partition(labels, 4, seed=1)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(partition.iid_partition(23, 3, seed=5),
                    ref_partition.iid_partition(23, 3, seed=5)):
        np.testing.assert_array_equal(a, b)
    for n, bs, ep, drop in ((10, 4, 3, True), (3, 4, 2, True),
                            (10, 4, 2, False)):
        got = list(loader.index_batches(n, bs, seed=7, epochs=ep,
                                        drop_remainder=drop))
        want = list(ref_loader.index_batches(n, bs, seed=7, epochs=ep,
                                             drop_remainder=drop))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_cohort_packing_bit_equal_reference():
    lengths, seeds = [6, 0, 3, 9], [1, 2, 3, 4]
    for pad in (None, 7):
        got = engine._pack_streams(lengths, 4, epochs=2, seeds=seeds,
                                   n_steps_pad=pad)
        want = ref_engine._pack_streams(lengths, 4, epochs=2, seeds=seeds,
                                        n_steps_pad=pad)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert [engine.n_stream_steps(n, 4, 3) for n in (0, 3, 9)] == \
        [ref_engine.n_stream_steps(n, 4, 3) for n in (0, 3, 9)]
    ds = [ref_synth.make_lm_dataset(n, 5, 30, seed=n) for n in (3, 6, 2)]
    for a, b in zip(engine.pack_cohort_data(ds),
                    ref_engine.pack_cohort_data(ds)):
        np.testing.assert_array_equal(a, np.asarray(b))
    got, want = engine.pack_eval(ds), ref_engine.pack_eval(ds)
    for name in ("x", "y", "valid"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------
def test_cohort_masks_equal_reference():
    """Coverage factors broadcast to each leaf's shape are exactly the
    reference's extract → pad coverage; forward masks are equal."""
    ref_cfg, cfg = _configs()
    specs = SPECS + [TransformerSubSpec(((0,),), ff_frac=0.25)]
    want = ref_family_for(ref_cfg).cohort_masks(_ref_specs(specs))
    got = family_for(cfg).cohort_masks(specs, device="cpu")
    shapes = params_to_numpy(PT.init_params(cfg, seed=0, device="cpu"))

    def shape_tree(t):
        if isinstance(t, dict):
            return {k: shape_tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shape_tree(v) for v in t]
        return tuple(t.shape)
    # the shapes the coverage is built from are init_params' own
    assert PT.param_shapes(cfg) == shape_tree(shapes)
    full = jax.tree.map(
        lambda f, p: np.broadcast_to(f.numpy(), (len(specs),) + p.shape),
        got.param_mask, shapes)
    w_leaves, w_def = jax.tree.flatten(_np(want.param_mask))
    g_leaves, g_def = jax.tree.flatten(full)
    assert g_def == w_def
    for a, b in zip(g_leaves, w_leaves):
        np.testing.assert_array_equal(a, b)
    assert set(got.fwd) == set(want.fwd)
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 got.fwd)),
                    jax.tree.leaves(_np(want.fwd))):
        np.testing.assert_array_equal(a, b)
    # the factors are small: no leaf of the mask tree is parent-sized
    n_mask = sum(t.numel() for t in jax.tree.leaves(got.param_mask))
    n_params = sum(p.size for p in jax.tree.leaves(shapes))
    assert n_mask < n_params // 10


# ---------------------------------------------------------------------------
# optimizer and aggregation
# ---------------------------------------------------------------------------
def _stacked_tree(rng, G):
    return {"a": rng.standard_normal((G, 3, 4)).astype(np.float32),
            "b": [rng.standard_normal((G, 5)).astype(np.float32)]}


def test_clip_and_sgd_per_client_match_vmapped_reference():
    rng = np.random.default_rng(0)
    grads = _stacked_tree(rng, 3)
    grads["a"][1] *= 100.0                    # one client past the clip
    mu = _stacked_tree(rng, 3)
    want_g, want_n = jax.vmap(lambda g: ref_clip(g, 5.0))(grads)
    got_g, got_n = clip_by_global_norm(
        params_from_numpy(grads, device="cpu"), 5.0)
    _leaves_close(params_to_numpy(got_g), _np(want_g), TOL)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=1e-6)
    ref_opt, opt = ref_sgd(0.05, momentum=0.9), sgd(0.05, momentum=0.9)
    want_u, want_s = jax.vmap(lambda g, m: ref_opt.update(
        g, {"step": jnp.zeros((), jnp.int32), "mu": m}))(grads, mu)
    got_u, got_s = opt.update(
        params_from_numpy(grads, device="cpu"),
        {"step": 0, "mu": params_from_numpy(mu, device="cpu")})
    _leaves_close(params_to_numpy(got_u), _np(want_u), TOL)
    _leaves_close(params_to_numpy(got_s["mu"]), _np(want_s["mu"]), TOL)


@pytest.mark.parametrize("coverage_norm,part,sanitize", [
    (False, None, False), (True, None, False), (False, [1, 0, 1, 1], False),
    (True, [1, 1, 0, 1], True)])
def test_aggregate_apply_matches_reference(coverage_norm, part, sanitize):
    rng = np.random.default_rng(1)
    G = 4
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    cov = {"w": (rng.random((G, 6, 5)) > 0.4).astype(np.float32),
           "b": (rng.random((G, 5)) > 0.5).astype(np.float32)}
    deltas = {k: rng.standard_normal(c.shape).astype(np.float32) * c
              for k, c in cov.items()}
    if sanitize:
        deltas["w"][2, 0, 0] = np.nan         # a non-participating slot
    weights = np.array([3.0, 5.0, 2.0, 7.0], np.float32)
    want = ref_aggregate.aggregate_apply(
        params, deltas, cov, jnp.asarray(weights),
        coverage_norm=coverage_norm,
        participation=None if part is None else jnp.asarray(part,
                                                            jnp.float32),
        sanitize=sanitize)
    got = aggregate_apply(
        params_from_numpy(params, device="cpu"),
        params_from_numpy(deltas, device="cpu"),
        params_from_numpy(cov, device="cpu"), torch.from_numpy(weights),
        coverage_norm=coverage_norm,
        participation=None if part is None else torch.tensor(
            part, dtype=torch.float32),
        sanitize=sanitize)
    _leaves_close(params_to_numpy(got), _np(want), AGG_TOL)


# ---------------------------------------------------------------------------
# the client-stacked forward and one round
# ---------------------------------------------------------------------------
def test_cohort_forward_matches_vmapped_reference():
    """Each client its own perturbed weights and its own masks: the port's
    stacked forward (both backends) against the reference's forward
    vmapped over clients."""
    ref_cfg, cfg = _configs()
    rng = np.random.default_rng(2)
    base = _np(RT.init_params(jax.random.PRNGKey(0), ref_cfg))
    G = len(SPECS)
    stacked = jax.tree.map(
        lambda a: (a[None] + 0.01 * rng.standard_normal(
            (G,) + a.shape)).astype(np.float32), base)
    ref_masks = ref_family_for(ref_cfg).cohort_masks(_ref_specs(SPECS))
    toks = rng.integers(0, cfg.vocab_size, (G, 2, 12)).astype(np.int32)
    want = jax.vmap(lambda p, m, t: RT.forward(p, ref_cfg, {"tokens": t},
                                               masks=m)[0])(
        stacked, ref_masks.fwd, jnp.asarray(toks))
    masks = family_for(cfg).cohort_masks(SPECS, device="cpu")
    for backend in ("auto", None):
        got = PT.forward(params_from_numpy(stacked, device="cpu"), cfg,
                         torch.from_numpy(toks).long(), masks=masks.fwd,
                         kernels=kernel_dispatch(backend).table())
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)


def _round_setup():
    ref_cfg, cfg = _configs()
    params = _np(RT.init_params(jax.random.PRNGKey(0), ref_cfg))
    sizes = [6, 8, 3, 9]        # 2 or 4 steps: padded steps in the stream
    # one Markov chain per client over 6 tokens: learnable in one round
    train = [ref_synth.make_lm_dataset(n, 16, 6, seed=k, chain_seed=100 + k)
             for k, n in enumerate(sizes)]
    test = [ref_synth.make_lm_dataset(4, 16, 6, seed=50 + k,
                                      chain_seed=100 + k) for k in range(4)]
    kw = dict(batch_size=4, epochs=2, seeds=[1, 2, 3, 4])
    return ref_cfg, cfg, params, sizes, train, test, kw


@pytest.fixture(scope="module")
def reference_rounds():
    """The reference engine's round (dense path) for both aggregation
    rules, run once for the module."""
    ref_cfg, _, params, sizes, train, test, kw = _round_setup()
    eng = ref_engine.BatchedRoundEngine(ref_cfg, lr=0.5, momentum=0.9)
    out = {}
    for cov in (False, True):
        new, accs, n_steps = eng.run_fl_round(
            params, _ref_specs(SPECS), train, test, sizes,
            coverage_norm=cov, **kw)
        out[cov] = (_np(new), accs, np.asarray(n_steps))
    return out


@pytest.mark.parametrize("backend,coverage_norm", [
    ("auto", False), ("auto", True), (None, False), (None, True)])
def test_run_fl_round_matches_reference(reference_rounds, backend,
                                        coverage_norm):
    _, cfg, params, sizes, train, test, kw = _round_setup()
    eng = engine.BatchedRoundEngine(cfg, lr=0.5, momentum=0.9,
                                    backend=backend, device="cpu")
    assert eng.kernel_path == ("tile-skipping" if backend else
                               "dense-masked")
    new, accs, n_steps = eng.run_fl_round(
        params_from_numpy(params, device="cpu"), SPECS, train, test, sizes,
        coverage_norm=coverage_norm, **kw)
    want_new, want_accs, want_steps = reference_rounds[coverage_norm]
    np.testing.assert_array_equal(n_steps, want_steps)
    assert list(n_steps) == [2, 4, 2, 4]
    # the same eval tokens right: 4 sequences of 15 predictions per client
    n_tok = 4 * 15
    assert [round(a * n_tok) for a in accs] == \
        [round(a * n_tok) for a in want_accs]
    assert max(accs) > 0.1                      # the round learned
    _leaves_close(params_to_numpy(new), want_new, TOL)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(want_new), jax.tree.leaves(params)))
    assert moved > 1e-2


def test_engine_raises_on_unported_paths():
    _, cfg, params, sizes, train, test, kw = _round_setup()
    eng = engine.BatchedRoundEngine(cfg, lr=0.5, momentum=0.9, device="cpu")
    p = params_from_numpy(params, device="cpu")
    # partial participation (once raising, naming ROADMAP A12) runs: a
    # selection's slots must match the specs
    sel = Selection([0, 1, 0], [1, 1, 0], [6, 8, 0])
    with pytest.raises(ValueError, match="padded cohort size 3"):
        eng.run_fl_round(p, SPECS, train, test, sizes, participation=sel,
                         **kw)
    # the prefetch ring (once raising, naming ROADMAP A14) runs: the hook
    # is called once a round, and the ring turns on
    calls = []
    eng.run_fl_round(p, SPECS, train, test, sizes,
                     prefetch_hook=lambda: calls.append(1), **kw)
    assert calls == [1]
    eng.enable_prefetch(1)
    assert eng.prefetch_enabled
    with pytest.raises(NotImplementedError, match="ROADMAP A17"):
        engine.BatchedRoundEngine(cfg, lr=0.5, momentum=0.9,
                                  cohort_shards=2, device="cpu")


def _loop_without_labels(eng, theta0, specs, datasets, *, batch_size,
                         epochs, seeds):
    """The local loop of ``train_cohort`` as it was before each batch's
    labels reached the family's loss: every ``local_step`` got y=None."""
    masks = eng.family.cohort_masks(specs, eng.device)
    x = torch.as_tensor(engine.pack_cohort_data(datasets)[0]).long()
    idx, sv, stv, _ = engine._pack_streams(
        [len(d["y"]) for d in datasets], batch_size, epochs=epochs,
        seeds=seeds)
    idx, sv = torch.as_tensor(idx).long(), torch.as_tensor(sv)
    rows = torch.arange(len(specs))[:, None]
    params, opt_state = eng.local_state(theta0)
    for t in range(stv.shape[1]):
        valid = None if stv[:, t].all() else torch.as_tensor(stv[:, t])
        eng.local_step(params, opt_state, masks, x[rows, idx[:, t]],
                       sv[:, t], valid)
    return [p.detach() for p in tree_leaves(params)]


@pytest.mark.parametrize("arch", ["granite-3-8b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b"])
def test_labels_leave_lm_rounds_bit_equal(arch):
    """``train_cohort`` passes each batch's labels to the family's loss
    (the CNN needs them); the LM families' losses ignore them, so their
    rounds give the same bits as the loop that passed none, whatever the
    label column holds."""
    if arch == "granite-3-8b":
        _, cfg = _configs()
        specs = SPECS
    else:
        cfg = reduced(ARCHS[arch], n_layers=2, d_model=64)
        n = cfg.segments[0].n_layers
        specs = [TransformerSubSpec((tuple(range(n)),)),
                 TransformerSubSpec(((1,),), ff_frac=0.5, expert_frac=0.5,
                                    ssm_head_frac=0.5)]
    fam = family_for(cfg)
    params = fam.init_params(seed=1, device="cpu")
    train = [synth.make_lm_dataset(n, 16, 6, seed=k, chain_seed=100 + k)
             for k, n in enumerate((6, 9, 3, 8)[:len(specs)])]
    rng = np.random.default_rng(0)
    noisy = [dict(d, y=rng.integers(0, 6, len(d["y"])).astype(np.int32))
             for d in train]
    kw = dict(batch_size=4, epochs=2, seeds=list(range(len(specs))))
    eng = engine.BatchedRoundEngine(cfg, lr=0.5, momentum=0.9,
                                    device="cpu")
    theta0 = eng.broadcast_params(params, len(specs))
    want = _loop_without_labels(eng, theta0, specs, train, **kw)
    for data in (train, noisy):
        got = tree_leaves(eng.train_cohort(theta0, specs, data,
                                           **kw).trained)
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
