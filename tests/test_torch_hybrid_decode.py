"""The zamba2 parent's prefill, decode and server against the JAX reference
(``tests/a11_support.py``; the shared block's init tree and ``forward``:
``tests/test_torch_hybrid.py``, whose settings this file shares), on the
reference's parameters, bridged:

* ``prefill`` and decode with the shared block's KV cache per site
  (``DecodeCaches.shared``, a ring buffer of 16 slots), ≤1e-5, greedy
  tokens equal;
* ``EdgeServer``: tenants with different SSD-head prefixes and depths,
  tokens equal to each tenant's extracted submodel's decode (logits
  ≤1e-5) and to the reference's server (logits ≤1e-4); the slot write
  carries the shared block's per-site caches.
"""
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
from repro_torch.serving import EdgeServer, Request

from test_torch_hybrid import NAME, S, _close

torch.set_num_threads(2)


def test_shared_site_caches_prefill_and_decode_match_reference():
    """A 16-token prefill fills the shared block's per-site cache (one site
    here: (1, B, 16, KV, D)) as the reference's; 16 decode steps past the
    window wrap its ring buffer: logits, every cache field and greedy
    tokens against the reference's, under a spec's masks."""
    cfg, ref_cfg = A.configs(NAME)
    params = A.ref_params(ref_cfg, 5)
    pp = A.bridged(params)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    spec = A.cohort_specs(NAME)[2]
    masks = {k: (tuple(torch.from_numpy(m) for m in v)
                 if isinstance(v, tuple) else torch.from_numpy(v))
             for k, v in family_for(cfg).decode_masks(spec).items()}
    ref_masks = ref_family_for(ref_cfg).spec_masks(A.ref_spec(spec)).fwd
    kernels = kernel_dispatch("auto").table()
    lw, cw = RT.prefill(params, ref_cfg, jnp.asarray(toks), S,
                        masks=ref_masks)
    lg, cg = PT.prefill(pp, cfg, torch.from_numpy(toks).long(), S,
                        masks=masks, kernels=kernels)
    assert cg.shared.k.shape == (1, 2, 16, cfg.n_kv_heads, cfg.head_dim)
    _close(lg, lw)

    def fields(c):
        return [np.asarray(t) for t in jax.tree.leaves(c)]
    for a, b in zip(fields(A.np_tree(cw)), fields(params_to_numpy(cg))):
        _close(b, a)
    for i in range(16, S):
        tw = np.asarray(jnp.argmax(lw, -1))[:, None].astype(np.int32)
        tg = torch.argmax(lg, -1)[:, None]
        np.testing.assert_array_equal(tg.numpy(), tw)
        lw, cw = RT.decode_step(params, ref_cfg, cw, jnp.asarray(tw),
                                jnp.int32(i), masks=ref_masks)
        lg, cg = PT.decode_step(pp, cfg, cg, tg, torch.full((2,), i),
                                masks=masks, kernels=kernels)
        _close(lg, lw)
    for a, b in zip(fields(A.np_tree(cw)), fields(params_to_numpy(cg))):
        _close(b, a)


def test_edge_server_matches_extracted_and_reference():
    """Multi-tenant decode of 3 tenants (SSD heads 4 / 2 / 1, depths cut)
    on 2 slots, 16-token prompts and 4 tokens each: the third tenant is
    admitted into a slot another held, so the slot write must carry the
    shared block's site caches. Tokens equal to each tenant's extracted
    submodel's decode (logits ≤1e-5) and to the reference server's
    (logits ≤1e-4)."""
    cfg, ref_cfg = A.configs(NAME)
    ref_fam, fam = ref_family_for(ref_cfg), family_for(cfg)
    ref_params = ref_fam.init_params(jax.random.PRNGKey(3))
    params = A.bridged(A.np_tree(ref_params))
    specs = A.cohort_specs(NAME)
    P, G = 16, 4
    prompts = [np.random.default_rng(7 + i).integers(0, 512, (P,))
               for i in range(3)]
    server = EdgeServer(fam, params, slots=2, prompt_len=P,
                        max_new_tokens=G, backend="auto", trace_logits=True,
                        device="cpu")
    server._caches.shared.k.normal_()          # a slot's stale contents
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
