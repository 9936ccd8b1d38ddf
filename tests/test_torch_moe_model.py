"""The port's MoE parent against the JAX reference (the kernels, their
chain and ``moe_forward``: ``tests/test_torch_moe.py``, whose helpers and
settings this file shares), at ``reduced(granite-moe-1b-a400m,
n_layers=2, d_model=64)``:

* the client-stacked ``forward`` with expert / head / depth masks, and
  coverage exactly equal to the reference's extract → pad;
* one ``run_fl_round`` of 3 clients with different expert prefixes against
  the reference engine's dense masked path, and the router's gradient on
  its own; ``EdgeServer`` multi-tenant decode against the reference's;
  the serving CLI; on the card (``cuda``) the kernels against their plain
  versions.

Tolerances: 1e-5 for one op, one forward or one round; identical greedy
tokens and 1e-4 logits for a multi-step decode.
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

from repro.core.elastic import family_for as ref_family_for
from repro.data import synth as ref_synth
from repro.fl import engine as ref_engine
from repro.models import moe as ref_moe
from repro.models import transformer as RT
from repro.serving import EdgeServer as RefEdgeServer
from repro.serving import Request as RefRequest
from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.core.elastic import family_for
from repro_torch.core.submodel import TransformerSubSpec
from repro_torch.fl import engine
from repro_torch.kernels.dispatch import kernel_dispatch
from repro_torch.models import moe
from repro_torch.models import transformer as PT
from repro_torch.optim.optimizers import tree_map
from repro_torch.serving import EdgeServer, Request

from test_torch_moe import (ARCH, SLICE_TOL, TOL, _close, _configs,
                            _leaves_close, _np, _ref_specs)

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the client-stacked forward, coverage, one round
# ---------------------------------------------------------------------------
# expert prefixes 4, 3, 2 of E = 4 (top-2 keeps at least 2), with heads and
# depth cut on some clients
SPECS = [TransformerSubSpec(((0, 1),)),
         TransformerSubSpec(((0, 1),), expert_frac=0.75, attn_head_frac=0.5),
         TransformerSubSpec(((1,),), expert_frac=0.5, ff_frac=0.5)]


def test_cohort_forward_matches_vmapped_reference():
    ref_cfg, cfg = _configs()
    rng = np.random.default_rng(4)
    base = _np(RT.init_params(jax.random.PRNGKey(0), ref_cfg))
    G = len(SPECS)
    stacked = jax.tree.map(
        lambda a: (a[None] + 0.01 * rng.standard_normal(
            (G,) + a.shape)).astype(np.float32), base)
    ref_masks = ref_family_for(ref_cfg).cohort_masks(_ref_specs(SPECS))
    toks = rng.integers(0, cfg.vocab_size, (G, 2, 12)).astype(np.int32)
    want = jax.jit(jax.vmap(lambda p, m, t: RT.forward(
        p, ref_cfg, {"tokens": t}, masks=m)[0]))(
        stacked, ref_masks.fwd, jnp.asarray(toks))
    masks = family_for(cfg).cohort_masks(SPECS, device="cpu")
    assert masks.fwd["experts"].sum(-1).tolist() == [4, 3, 2]
    for backend in ("auto", None):
        got = PT.forward(params_from_numpy(stacked, device="cpu"), cfg,
                         torch.from_numpy(toks).long(), masks=masks.fwd,
                         kernels=kernel_dispatch(backend).table())
        _close(got, want)


def test_coverage_and_masks_equal_reference():
    """Coverage factors broadcast to each leaf are exactly the reference's
    extract → pad coverage (router columns, expert blocks); forward masks
    and random specs equal the reference's; the bridge round-trips the
    ``moe`` leaves bit-equal and init_params has their shapes."""
    ref_cfg, cfg = _configs()
    specs = SPECS + [TransformerSubSpec(((0,),), expert_frac=0.25)]
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
        np.testing.assert_array_equal(a, b)
    own = params_to_numpy(PT.init_params(cfg, seed=0, device="cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(ref_np)
    assert [a.shape for a in jax.tree.leaves(own)] == \
        [a.shape for a in jax.tree.leaves(ref_np)]
    # the torch-seeded moe_init: the reference's tree, shapes and std
    moe_cfg = dataclasses.replace(cfg.moe, n_shared=1, d_ff_expert=256)
    ref_tree = _np(ref_moe.moe_init(jax.random.PRNGKey(3), 512, moe_cfg))
    own_tree = params_to_numpy(moe.moe_init(
        512, moe_cfg, generator=torch.Generator().manual_seed(0),
        device="cpu"))
    assert jax.tree.structure(own_tree) == jax.tree.structure(ref_tree)
    for a, b in zip(jax.tree.leaves(own_tree), jax.tree.leaves(ref_tree)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.1)
    rr, rp = random.Random(5), random.Random(5)
    ref_fam, fam = ref_family_for(ref_cfg), family_for(cfg)
    for _ in range(4):
        assert ref_fam.random_spec(rr).genes() == fam.random_spec(rp).genes()


def _round_setup():
    ref_cfg, cfg = _configs()
    params = _np(RT.init_params(jax.random.PRNGKey(0), ref_cfg))
    sizes = [8, 6, 5]
    train = [ref_synth.make_lm_dataset(n, 16, 6, seed=k, chain_seed=100 + k)
             for k, n in enumerate(sizes)]
    test = [ref_synth.make_lm_dataset(4, 16, 6, seed=50 + k,
                                      chain_seed=100 + k) for k in range(3)]
    kw = dict(batch_size=4, epochs=2, seeds=[1, 2, 3])
    return ref_cfg, cfg, params, sizes, train, test, kw


@pytest.fixture(scope="module")
def reference_round():
    ref_cfg, _, params, sizes, train, test, kw = _round_setup()
    eng = ref_engine.BatchedRoundEngine(ref_cfg, lr=0.5, momentum=0.9)
    new, accs, n_steps = eng.run_fl_round(params, _ref_specs(SPECS), train,
                                          test, sizes, coverage_norm=True,
                                          **kw)
    return _np(new), accs, np.asarray(n_steps)


@pytest.mark.parametrize("backend", ["auto", None])
def test_run_fl_round_matches_reference(reference_round, backend):
    """One round of 3 clients with expert prefixes 4 / 3 / 2 (the
    reference's dense masked path computes the same function as its
    kernels): new parameters ≤1e-5, the same eval tokens right."""
    _, cfg, params, sizes, train, test, kw = _round_setup()
    eng = engine.BatchedRoundEngine(cfg, lr=0.5, momentum=0.9,
                                    backend=backend, device="cpu")
    new, accs, n_steps = eng.run_fl_round(
        params_from_numpy(params, device="cpu"), SPECS, train, test, sizes,
        coverage_norm=True, **kw)
    want_new, want_accs, want_steps = reference_round
    np.testing.assert_array_equal(n_steps, want_steps)
    n_tok = 4 * 15
    assert [round(a * n_tok) for a in accs] == \
        [round(a * n_tok) for a in want_accs]
    _leaves_close(params_to_numpy(new), want_new, TOL)
    router = [np.abs(a - b).max() for a, b in zip(
        want_new["segments"][0]["blocks"]["moe"]["router"],
        params["segments"][0]["blocks"]["moe"]["router"])]
    assert min(router) > 1e-4                 # the router trained


def test_router_gradient_through_the_combine_vjp():
    """The router's only gradient comes through the combine's gate
    cotangent (the objective has no aux term). On the kernel path it flows
    through ``moe_combine``'s closed VJP (the re-gathered slot rows and the
    ``dgate`` einsum), on the dense path through autograd of the scatter:
    the two must agree, and be non-zero, for every client's router (the
    round test holds the trained router to the reference's)."""
    _, cfg = _configs(capacity_factor=0.5)          # with dropped tokens
    params = PT.init_params(cfg, seed=6, device="cpu")
    G = len(SPECS)
    masks = family_for(cfg).cohort_masks(SPECS, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (G, 3, 12))).long()
    grads = {}
    for backend in ("auto", None):
        stacked = tree_map(lambda a: a.expand((G,) + a.shape).clone(),
                           params)
        routers = [b["moe"]["router"].requires_grad_(True)
                   for b in (seg["blocks"] for seg in stacked["segments"])]
        logits = PT.forward(stacked, cfg, toks, masks=masks.fwd,
                            kernels=kernel_dispatch(backend).table())
        lp = torch.log_softmax(logits[..., :-1, :], -1)
        loss = -torch.gather(lp, -1, toks[..., 1:, None]).mean()
        grads[backend], = torch.autograd.grad(loss, routers)
    _close(grads["auto"], grads[None], 1e-7)
    for g in range(G):
        assert float(grads["auto"][g].abs().max()) > 1e-5


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def test_edge_server_matches_reference():
    """Multi-tenant decode of 4 requests with different expert prefixes on
    2 slots (tenants churn): identical greedy tokens, logits ≤1e-4, the
    port's kernel path (plain versions) against the reference's Pallas
    kernels in interpret mode."""
    ref_cfg, cfg = _configs()
    ref_fam, fam = ref_family_for(ref_cfg), family_for(cfg)
    ref_params = ref_fam.init_params(jax.random.PRNGKey(3))
    params = params_from_numpy(_np(ref_params), device="cpu")
    specs = SPECS + [TransformerSubSpec(((0,),), expert_frac=0.5)]
    prng = np.random.default_rng(7)
    prompts = [prng.integers(0, 512, (n,)) for n in (8, 5, 11, 6)]
    budgets = [4, 3, 4, 2]
    ref_server = RefEdgeServer(ref_fam, ref_params, slots=2, prompt_len=8,
                               max_new_tokens=4, backend="interpret",
                               trace_logits=True)
    ref_specs = _ref_specs(specs)
    ref_out = ref_server.run([
        RefRequest(uid=i, spec=ref_specs[i], prompt=prompts[i],
                   max_new_tokens=budgets[i]) for i in range(4)])
    server = EdgeServer(fam, params, slots=2, prompt_len=8,
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


def test_serve_cli_runs_moe_on_cpu():
    from repro_torch.launch.serve import serve
    kw = dict(batch=3, prompt_len=6, gen=3, n_layers=2, d_model=64,
              elastic=True, device="cpu")
    out, stats = serve(ARCH, backend="auto", **kw)
    dense, _ = serve(ARCH, backend=None, **kw)
    assert [len(c.tokens) for c in out] == [3, 3, 3]
    assert [c.tokens for c in out] == [c.tokens for c in dense]
    assert {c.spec.expert_frac for c in out} != {1.0}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_moe_kernels_match_plain_on_card():
    """K5 / K6 / K7 against their plain versions on the card (edges
    included); runs only where there is a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    worst = chip_smoke.phase_moe_kernels(
        torch.device("cuda"), d_model=128, d_ff=96, n_experts=6, top_k=2,
        clients=3, tokens=40, slots=2, experts=[6, 3, 2])
    assert worst["grouped_matmul"] <= chip_smoke.K5_TOL
    assert worst["gather_rows"] == 0.0
