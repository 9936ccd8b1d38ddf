"""The port's Mamba2 block and SSM parent against the JAX reference (the
kernels' plain versions and the ``ssd`` op: ``tests/test_torch_ssm.py``,
whose helpers and settings this file shares), at ``reduced(mamba2-2.7b,
n_layers=2, d_model=64)``:

* ``mamba_forward`` (both backends, head masks shared and per row),
  ``mamba_decode`` and prefill followed by stepwise decode, the
  client-stacked ``forward``, one ``run_fl_round`` of 3 clients and
  multi-tenant ``EdgeServer`` decode, each against the reference;
* the three repairs that came with the slice: ``random_spec`` draws the
  SSD-head fraction in the reference's place; coverage and forward masks
  carry the SSD-head dimension; the server writes every cache field of a
  segment into a slot.

Tolerances: 1e-5 for one op, one forward or one round (relative to the
largest value where the values grow past 1), identical greedy tokens and
1e-4 logits for a multi-step decode.
"""
import dataclasses
import os
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.core.elastic import family_for as ref_family_for
from repro.data import synth as ref_synth
from repro.fl import engine as ref_engine
from repro.kernels.dispatch import kernel_dispatch as ref_dispatch
from repro.models import ssm as ref_ssm
from repro.models import transformer as RT
from repro.serving import EdgeServer as RefEdgeServer
from repro.serving import Request as RefRequest
from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import ARCHS
from repro_torch.core.elastic import family_for
from repro_torch.core.submodel import TransformerSubSpec
from repro_torch.fl import engine
from repro_torch.kernels.dispatch import kernel_dispatch, ssd_op
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd
from repro_torch.models import ssm
from repro_torch.models import transformer as PT
from repro_torch.serving import EdgeServer, Request

from test_torch_ssm import (ARCH, SLICE_TOL, _close, _configs, _np,
                            _ref_specs, _scan_inputs)

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the block: forward, decode, prefill
# ---------------------------------------------------------------------------
def _block(seed=1):
    ref_cfg, cfg = _configs()
    p = _np(ref_ssm.mamba_init(jax.random.PRNGKey(seed), ref_cfg.d_model,
                               ref_cfg.ssm))
    rng = np.random.default_rng(seed)
    # perturb the zero-initialised leaves so that every term is exercised
    p["norm"]["scale"] = (0.1 * rng.standard_normal(
        p["norm"]["scale"].shape)).astype(np.float32)
    for k in ("conv_x", "conv_B", "conv_C"):
        p[k]["b"] = (0.1 * rng.standard_normal(p[k]["b"].shape)).astype(
            np.float32)
    return ref_cfg, cfg, p


@pytest.mark.parametrize("mask", ["none", "shared", "per-row"])
def test_mamba_forward_matches_reference(mask):
    """The block over 2 chunks on both of the port's paths against the
    reference's (its kernel path for a shared mask, one call per row for
    per-row masks), with the cache a fused prefill returns."""
    ref_cfg, cfg, p = _block()
    B, S, d = 2, 32, cfg.d_model
    x = np.random.default_rng(2).standard_normal((B, S, d)).astype(
        np.float32)
    masks = {"none": None, "shared": np.array([1, 1, 1, 0], np.float32),
             "per-row": np.array([[1, 1, 0, 0], [1, 1, 1, 1]], np.float32)}
    hm = masks[mask]
    rows = [hm] * B if hm is None or hm.ndim == 1 else list(hm)
    ref_k = ref_dispatch("interpret").table()["ssd"]
    want, want_c = [], []
    for b in range(B):
        m = None if rows[b] is None else jnp.asarray(rows[b])
        o, c = ref_ssm.mamba_forward(p, jnp.asarray(x[b:b + 1]),
                                     ref_cfg.ssm, head_mask=m, kernel=ref_k,
                                     return_cache=True)
        want.append(np.asarray(o))
        want_c.append(_np(c))
    want = np.concatenate(want)
    tp = params_from_numpy(p, device="cpu")
    for backend in ("auto", None):
        out, cache = ssm.mamba_forward(
            tp, torch.from_numpy(x), cfg.ssm,
            head_mask=None if hm is None else torch.from_numpy(hm),
            kernel=(kernel_dispatch(backend).table() or {}).get("ssd"),
            return_cache=True)
        _close(out, want)
        for name, got in zip(cache._fields, cache):
            _close(got, np.concatenate([getattr(c, name) for c in want_c]))


def test_mamba_decode_and_prefill_then_decode_match_reference():
    """Prefill 32 tokens, then 3 stepwise decodes with a per-row head mask
    (the reference one row at a time): outputs and caches ≤1e-5."""
    ref_cfg, cfg, p = _block(seed=3)
    B, S, d = 2, 32, cfg.d_model
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    steps = rng.standard_normal((3, B, 1, d)).astype(np.float32)
    hm = np.array([[1, 1, 1, 0], [1, 0, 0, 0]], np.float32)
    tp = params_from_numpy(p, device="cpu")
    _, cache = ssm.mamba_forward(tp, torch.from_numpy(x), cfg.ssm,
                                 head_mask=torch.from_numpy(hm),
                                 kernel=ssd_op, return_cache=True)
    outs = []
    for s in range(3):
        o, cache = ssm.mamba_decode(tp, torch.from_numpy(steps[s]), cache,
                                    cfg.ssm, head_mask=torch.from_numpy(hm))
        outs.append(o)
    for b in range(B):
        m = jnp.asarray(hm[b])
        _, rc = ref_ssm.mamba_forward(p, jnp.asarray(x[b:b + 1]),
                                      ref_cfg.ssm, head_mask=m,
                                      return_cache=True)
        for s in range(3):
            ro, rc = ref_ssm.mamba_decode(p, jnp.asarray(steps[s, b:b + 1]),
                                          rc, ref_cfg.ssm, head_mask=m)
            _close(outs[s][b:b + 1], ro)
        for name, got in zip(cache._fields, cache):
            _close(got[b:b + 1], getattr(rc, name))


# ---------------------------------------------------------------------------
# the model, masks, one round, serving
# ---------------------------------------------------------------------------
# SSD heads 4, 2, 1 of 4; layer 0 dropped on one client
SPECS = [TransformerSubSpec(((0, 1),)),
         TransformerSubSpec(((0, 1),), ssm_head_frac=0.5),
         TransformerSubSpec(((1,),), ssm_head_frac=0.25, ff_frac=0.5)]


def test_cohort_forward_matches_vmapped_reference():
    ref_cfg, cfg = _configs()
    rng = np.random.default_rng(8)
    base = _np(RT.init_params(jax.random.PRNGKey(0), ref_cfg))
    G = len(SPECS)
    stacked = jax.tree.map(
        lambda a: (a[None] + 0.01 * rng.standard_normal(
            (G,) + a.shape)).astype(np.float32), base)
    ref_masks = ref_family_for(ref_cfg).cohort_masks(_ref_specs(SPECS))
    toks = rng.integers(0, cfg.vocab_size, (G, 2, 32)).astype(np.int32)
    want = jax.jit(jax.vmap(lambda p, m, t: RT.forward(
        p, ref_cfg, {"tokens": t}, masks=m)[0]))(
        stacked, ref_masks.fwd, jnp.asarray(toks))
    masks = family_for(cfg).cohort_masks(SPECS, device="cpu")
    assert masks.fwd["ssm_heads"].sum(-1).tolist() == [4, 2, 1]
    for backend in ("auto", None):
        got = PT.forward(params_from_numpy(stacked, device="cpu"), cfg,
                         torch.from_numpy(toks).long(), masks=masks.fwd,
                         kernels=kernel_dispatch(backend).table())
        _close(got, want)


def test_coverage_and_masks_carry_the_ssd_heads():
    """Coverage factors broadcast to each leaf are exactly the reference's
    extract → pad coverage for SSD-head fractions 0.25 / 0.5 / 0.75 / 1.0
    with dropped layers; the forward masks (``ssm_heads`` all-ones at 1.0)
    equal the reference's; the bridge round-trips the ``mamba`` leaves
    bit-equal and ``init_params`` has their tree and shapes."""
    ref_cfg, cfg = _configs()
    specs = [TransformerSubSpec(((0,),), ssm_head_frac=0.25),
             TransformerSubSpec(((1,),), ssm_head_frac=0.5),
             TransformerSubSpec(((0, 1),), ssm_head_frac=0.75, ff_frac=0.5),
             TransformerSubSpec(((0, 1),))]
    want = ref_family_for(ref_cfg).cohort_masks(_ref_specs(specs))
    got = family_for(cfg).cohort_masks(specs, device="cpu")
    ref_np = _np(RT.init_params(jax.random.PRNGKey(2), ref_cfg))
    full = jax.tree.map(
        lambda f, p: np.broadcast_to(f.numpy(), (len(specs),) + p.shape),
        got.param_mask, ref_np)
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
    back = params_to_numpy(params_from_numpy(ref_np, device="cpu"))
    for a, b in zip(jax.tree.leaves(ref_np), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    own = params_to_numpy(PT.init_params(cfg, seed=0, device="cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(ref_np)
    assert [a.shape for a in jax.tree.leaves(own)] == \
        [a.shape for a in jax.tree.leaves(ref_np)]
    blocks = own["segments"][0]["blocks"]["mamba"]
    np.testing.assert_allclose(blocks["A_log"],
                               ref_np["segments"][0]["blocks"]["mamba"]
                               ["A_log"], rtol=1e-6)
    dt0 = np.log1p(np.exp(blocks["dt_bias"]))        # softplus
    assert 1e-3 <= dt0.min() and dt0.max() <= 1e-1 + 1e-6


def test_mamba_init_has_the_reference_tree_and_distributions():
    """The torch-seeded ``mamba_init``: the reference's tree and shapes,
    He-normal leaves of the reference's std, the ``A_log`` linspace, ``D``
    ones, and ``dt_bias`` the inverse softplus of a dt in [1e-3, 1e-1]."""
    ref_cfg, cfg = _configs()
    ssm_cfg = dataclasses.replace(cfg.ssm, d_state=64)
    ref_ssm_cfg = dataclasses.replace(ref_cfg.ssm, d_state=64)
    want = _np(ref_ssm.mamba_init(jax.random.PRNGKey(4), 256, ref_ssm_cfg))
    got = params_to_numpy(ssm.mamba_init(
        256, ssm_cfg, generator=torch.Generator().manual_seed(0),
        device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if w.std() > 0 and "dt_bias" not in jax.tree_util.keystr(path):
            np.testing.assert_allclose(g.std(), w.std(), rtol=0.1)
    np.testing.assert_allclose(got["A_log"], want["A_log"], rtol=1e-6)
    np.testing.assert_array_equal(got["D"], want["D"])
    dt0 = np.log1p(np.exp(got["dt_bias"]))           # softplus
    assert 1e-3 <= dt0.min() and dt0.max() <= 1e-1 + 1e-6


@pytest.mark.parametrize("arch", [ARCH, "granite-3-8b",
                                  "granite-moe-1b-a400m"])
def test_random_spec_draws_match_reference(arch):
    """The first 20 specs drawn from one ``random.Random`` are the
    reference's: on an SSM parent the SSD-head fraction is drawn between
    the expert and the attention-head fractions."""
    ref_fam = ref_family_for(REF_ARCHS[arch])
    fam = family_for(ARCHS[arch])
    rr, rp = random.Random(11), random.Random(11)
    for _ in range(20):
        assert ref_fam.random_spec(rr).genes() == fam.random_spec(rp).genes()


def _round_setup():
    ref_cfg, cfg = _configs()
    params = _np(RT.init_params(jax.random.PRNGKey(0), ref_cfg))
    sizes = [8, 6, 5]
    train = [ref_synth.make_lm_dataset(n, 32, 6, seed=k, chain_seed=100 + k)
             for k, n in enumerate(sizes)]
    test = [ref_synth.make_lm_dataset(4, 32, 6, seed=50 + k,
                                      chain_seed=100 + k) for k in range(3)]
    kw = dict(batch_size=4, epochs=2, seeds=[1, 2, 3])
    return ref_cfg, cfg, params, sizes, train, test, kw


@pytest.fixture(scope="module")
def reference_round():
    ref_cfg, _, params, sizes, train, test, kw = _round_setup()
    eng = ref_engine.BatchedRoundEngine(ref_cfg, lr=0.05, momentum=0.9)
    new, accs, n_steps = eng.run_fl_round(params, _ref_specs(SPECS), train,
                                          test, sizes, coverage_norm=True,
                                          **kw)
    return _np(new), accs, np.asarray(n_steps)


@pytest.mark.parametrize("backend", ["auto", None])
def test_run_fl_round_matches_reference(reference_round, backend):
    """One round of 3 clients with SSD-head prefixes 4 / 2 / 1 and a
    dropped layer: new parameters ≤1e-5, the same eval tokens right."""
    _, cfg, params, sizes, train, test, kw = _round_setup()
    eng = engine.BatchedRoundEngine(cfg, lr=0.05, momentum=0.9,
                                    backend=backend, device="cpu")
    new, accs, n_steps = eng.run_fl_round(
        params_from_numpy(params, device="cpu"), SPECS, train, test, sizes,
        coverage_norm=True, **kw)
    want_new, want_accs, want_steps = reference_round
    np.testing.assert_array_equal(n_steps, want_steps)
    n_tok = 4 * 31
    assert [round(a * n_tok) for a in accs] == \
        [round(a * n_tok) for a in want_accs]
    got = params_to_numpy(new)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want_new)):
        _close(a, b)
    moved = np.abs(want_new["segments"][0]["blocks"]["mamba"]["A_log"] -
                   params["segments"][0]["blocks"]["mamba"]["A_log"]).max()
    assert moved > 1e-5                       # the SSD parameters trained


def test_edge_server_matches_reference():
    """Multi-tenant decode of 4 requests with different SSD-head prefixes
    and depths on 2 slots (tenants churn, so the slot write must carry the
    state and the conv histories): identical greedy tokens, logits ≤1e-4,
    the port's kernel path (plain versions) against the reference's
    Pallas kernels in interpret mode."""
    ref_cfg, cfg = _configs()
    ref_fam, fam = ref_family_for(ref_cfg), family_for(cfg)
    ref_params = ref_fam.init_params(jax.random.PRNGKey(3))
    params = params_from_numpy(_np(ref_params), device="cpu")
    specs = SPECS + [TransformerSubSpec(((0,),), ssm_head_frac=0.75)]
    prng = np.random.default_rng(7)
    prompts = [prng.integers(0, 512, (n,)) for n in (32, 20, 40, 25)]
    budgets = [4, 3, 4, 2]
    ref_server = RefEdgeServer(ref_fam, ref_params, slots=2, prompt_len=32,
                               max_new_tokens=4, backend="interpret",
                               trace_logits=True)
    ref_specs = _ref_specs(specs)
    ref_out = ref_server.run([
        RefRequest(uid=i, spec=ref_specs[i], prompt=prompts[i],
                   max_new_tokens=budgets[i]) for i in range(4)])
    server = EdgeServer(fam, params, slots=2, prompt_len=32,
                        max_new_tokens=4, backend="auto",
                        trace_logits=True, device="cpu")
    out = server.run([Request(uid=i, spec=specs[i], prompt=prompts[i],
                              max_new_tokens=budgets[i]) for i in range(4)])
    assert [c.uid for c in out] == [c.uid for c in ref_out] == list(range(4))
    for c, r in zip(out, ref_out):
        assert c.tokens == r.tokens, c.uid
        worst = max(float(np.max(np.abs(a - b)))
                    for a, b in zip(c.logits, r.logits))
        assert worst <= SLICE_TOL, f"uid={c.uid}: {worst:.2e}"


def test_slot_write_carries_every_cache_field():
    """A tenant admitted into a slot that held another one continues from
    its own prefill: every field of the SSM cache (state, conv histories)
    is written, not only attention's k / v."""
    _, cfg = _configs()
    fam = family_for(cfg)
    params = fam.init_params(seed=4, device="cpu")
    prompt = np.random.default_rng(9).integers(0, 512, (32,))
    server = EdgeServer(fam, params, slots=2, prompt_len=32,
                        max_new_tokens=2, device="cpu")
    server._caches = type(server._caches)(
        tuple(type(c)(*(f.normal_() for f in c))
              for c in server._caches.segments), None)
    for uid in range(2):
        server.submit(Request(uid=uid, spec=None, prompt=prompt,
                              max_new_tokens=2))
    assert server.batcher.admit() == [0, 1]
    server._admit_one(1, server.batcher.request_at(1))
    _, want = PT.prefill(params, cfg, torch.as_tensor(prompt)[None],
                         server.max_len)
    for full, new in zip(server._caches.segments, want.segments):
        assert len(full) == 4
        for f, n in zip(full, new):
            torch.testing.assert_close(f[:, 1], n[:, 0], atol=0, rtol=0)


def test_serve_cli_runs_mamba_on_cpu():
    from repro_torch.launch.serve import serve
    kw = dict(batch=3, prompt_len=16, gen=3, n_layers=2, d_model=64,
              elastic=True, device="cpu")
    out, _ = serve(ARCH, backend="auto", **kw)
    dense, _ = serve(ARCH, backend=None, **kw)
    assert [len(c.tokens) for c in out] == [3, 3, 3]
    assert [c.tokens for c in out] == [c.tokens for c in dense]
    assert {c.spec.ssm_head_frac for c in out} != {1.0}


def test_ssd_kernel_wrappers_check_their_inputs():
    d = {k: torch.from_numpy(v) for k, v in
         _scan_inputs(2, 32, 4, 8, 1, 4, seed=1).items()}
    args = [d[k] for k in ("xh", "dt", "A", "Bm", "Cm")]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(*args, 12)
    with pytest.raises(ValueError, match="int32"):
        ssd_scan(*args, 16, h_active=torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="A must be"):
        ssd_scan(*args[:2], d["A"][:, :3], *args[3:], 16)
    assert ssd_scan.launches == 0 and ssd_scan_bwd.launches == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_ssd_kernels_match_plain_on_card():
    """K8 / K9 against their plain versions on the card (edges included);
    runs only where there is a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    worst = chip_smoke.phase_ssd_kernels(
        torch.device("cuda"), d_model=256, head_dim=64, d_state=32,
        clients=2, rows=2, seq=128, chunk=64, heads=[8, 3], prompt_len=64)
    assert worst["ssd_scan"] <= chip_smoke.K8_RTOL
    assert worst["ssd_scan_bwd"] <= chip_smoke.K9_RTOL
