"""``attn_pair`` segments and the gemma2 parent against the JAX reference
(``tests/a11_support.py``: gemma2-9b reduced to d_model 64, 4 query / 2
KV heads of 16, 2 (local, global) pairs with the local window 8 — it binds
at the 32 tokens used here — attention softcap 50, final softcap 30,
post-norms, scaled embeddings), on the reference's parameters, bridged:

* ``forward`` on a one-client stack and the client-stacked cohort forward
  (head prefixes, d_ff prefixes, a dropped pair) against the reference's,
  vmapped over clients, on both paths (the kernels' plain versions and
  the dense one), ≤1e-5;
* ``prefill`` (the local caches ring buffers of 8 slots, the global ones
  of ``max_len``) and decode past the window, ≤1e-5, with the greedy
  tokens of the reference;
* ``EdgeServer``: tenants with different head / d_ff prefixes and depths,
  tokens equal to each tenant's extracted submodel's decode (logits
  ≤1e-5) and to the reference's server (logits ≤1e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import a11_support as A
from repro.core.elastic import family_for as ref_family_for
from repro.models import transformer as RT
from repro.serving import EdgeServer as RefEdgeServer
from repro.serving import Request as RefRequest
from repro_torch.checkpoint.bridge import params_to_numpy
from repro_torch.core.elastic import family_for
from repro_torch.kernels.dispatch import kernel_dispatch
from repro_torch.models import transformer as PT
from repro_torch.optim.optimizers import tree_map
from repro_torch.serving import EdgeServer, Request

torch.set_num_threads(2)
NAME = "gemma2-9b"
S = 32


def _close(got, want, tol=A.TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def test_pair_tree_and_forward_match_reference():
    """The init tree (``{"local", "global"}`` stacked block trees with
    post-norms) has the reference's structure and shapes; the forward of
    one client equals the reference's on both paths, and the local window
    binds (the logits change when it is widened)."""
    cfg, ref_cfg = A.configs(NAME)
    params = A.ref_params(ref_cfg, 0)
    own = params_to_numpy(PT.init_params(cfg, device="cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(params)
    assert [a.shape for a in jax.tree.leaves(own)] == \
        [a.shape for a in jax.tree.leaves(params)]
    assert set(params["segments"][0]) == {"local", "global"}
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    want, _ = RT.forward(params, ref_cfg, {"tokens": jnp.asarray(toks)})
    one = tree_map(lambda t: t.unsqueeze(0), A.bridged(params))
    got = {}
    for backend in ("auto", None):
        got[backend] = PT.forward(
            one, cfg, torch.from_numpy(toks).long()[None],
            kernels=kernel_dispatch(backend).table())[0]
        _close(got[backend], want)
    wide = dataclasses.replace(cfg, segments=(dataclasses.replace(
        cfg.segments[0], pair_local_window=S),))
    other = PT.forward(one, wide, torch.from_numpy(toks).long()[None])[0]
    assert float((other - got[None]).abs().max()) > 1e-3


def test_pair_cohort_forward_matches_vmapped_reference():
    """Three clients, each its own jittered weights and spec (all heads;
    2 of 4 heads; one pair dropped, half of d_ff and 2 heads): the cohort
    forward equals the reference's vmapped forward under the same masks,
    on both paths."""
    cfg, ref_cfg = A.configs(NAME)
    specs = A.cohort_specs(NAME)
    G = len(specs)
    stacked = A.stacked_params(A.ref_params(ref_cfg, 2), G, 3)
    ref_masks = ref_family_for(ref_cfg).cohort_masks(
        [A.ref_spec(s) for s in specs])
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (G, 2, S)).astype(np.int32)
    want = A.ref_cohort_logits(ref_cfg, stacked, ref_masks.fwd, toks)
    masks = family_for(cfg).cohort_masks(specs, device="cpu")
    assert masks.fwd["heads"].sum(-1).tolist() == [4, 2, 2]
    for backend in ("auto", None):
        got = PT.forward(A.bridged(stacked), cfg,
                         torch.from_numpy(toks).long(), masks=masks.fwd,
                         kernels=kernel_dispatch(backend).table())
        _close(got, want)


def test_pair_prefill_and_decode_match_reference():
    """A 12-token prefill, then 20 decode steps (past the local window of
    8, so the local ring buffer wraps): caches, logits and greedy tokens
    against the reference's, under a head mask and a depth gate per row."""
    cfg, ref_cfg = A.configs(NAME)
    params = A.ref_params(ref_cfg, 5)
    pp = A.bridged(params)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    fam = family_for(cfg)
    spec = A.cohort_specs(NAME)[2]
    masks = {k: (tuple(torch.from_numpy(m) for m in v)
                 if isinstance(v, tuple) else torch.from_numpy(v))
             for k, v in fam.decode_masks(spec).items()}
    ref_masks = ref_family_for(ref_cfg).spec_masks(A.ref_spec(spec)).fwd
    lw, cw = RT.prefill(params, ref_cfg, jnp.asarray(toks), S,
                        masks=ref_masks)
    lg, cg = PT.prefill(pp, cfg, torch.from_numpy(toks).long(), S,
                        masks=masks, kernels=kernel_dispatch("auto").table())
    assert cg.segments[0]["local"].k.shape[2] == 8
    assert cg.segments[0]["global"].k.shape[2] == S
    _close(lg, lw)
    for a, b in zip(jax.tree.leaves(A.np_tree(cw)),
                    [t.numpy() for t in jax.tree.leaves(cg)]):
        _close(b, a)
    for i in range(12, S):
        tw = np.asarray(jnp.argmax(lw, -1))[:, None].astype(np.int32)
        tg = torch.argmax(lg, -1)[:, None]
        np.testing.assert_array_equal(tg.numpy(), tw)
        lw, cw = RT.decode_step(params, ref_cfg, cw, jnp.asarray(tw),
                                jnp.int32(i), masks=ref_masks)
        lg, cg = PT.decode_step(pp, cfg, cg, tg, torch.full((2,), i),
                                masks=masks,
                                kernels=kernel_dispatch("auto").table())
        _close(lg, lw)


def test_edge_server_matches_extracted_and_reference():
    """Multi-tenant decode of 3 tenants (all heads; 2 of 4; a dropped pair
    with half of d_ff) on 2 slots, 6 tokens each past a 16-token prompt
    (the local window wraps): tokens equal to each tenant's extracted
    submodel's decode (logits ≤1e-5) and to the reference server's
    (logits ≤1e-4)."""
    cfg, ref_cfg = A.configs(NAME)
    ref_fam, fam = ref_family_for(ref_cfg), family_for(cfg)
    ref_params = ref_fam.init_params(jax.random.PRNGKey(3))
    params = A.bridged(A.np_tree(ref_params))
    specs = A.cohort_specs(NAME)
    prompts = [np.random.default_rng(7 + i).integers(0, 512, (16,))
               for i in range(3)]
    P, G = 16, 6
    server = EdgeServer(fam, params, slots=2, prompt_len=P,
                        max_new_tokens=G, backend="auto", trace_logits=True,
                        device="cpu")
    out = server.run([Request(uid=i, spec=specs[i], prompt=prompts[i],
                              max_new_tokens=G) for i in range(3)])
    ref_server = RefEdgeServer(ref_fam, ref_params, slots=2, prompt_len=P,
                               max_new_tokens=G, trace_logits=True)
    ref_out = ref_server.run([
        RefRequest(uid=i, spec=A.ref_spec(specs[i]), prompt=prompts[i],
                   max_new_tokens=G) for i in range(3)])
    for c, r in zip(out, ref_out):
        assert c.tokens == r.tokens, c.uid
        assert max(float(np.abs(a - b).max())
                   for a, b in zip(c.logits, r.logits)) <= A.SLICE_TOL
        want = A.extracted_decode(fam, params, specs[c.uid],
                                  prompts[c.uid], c.tokens, P + G)
        assert len(want) == len(c.logits) == G
        assert max(float(np.abs(a - b).max())
                   for a, b in zip(c.logits, want)) <= A.TOL, c.uid
