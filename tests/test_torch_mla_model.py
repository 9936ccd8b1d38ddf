"""The deepseek-v2 parent's MoE and model against the JAX reference
(``tests/a11_support.py``: deepseek-v2-lite reduced to d_model 64, MLA
with kv_lora 64, nope 32, rope 16, v 32; its dense first layer, then MoE
layers with one shared expert), on the reference's parameters, bridged
(MLA attention alone: ``tests/test_torch_mla.py``):

* the MoE with its shared expert, and the model's forward, prefill and
  decode across the dense and the MoE segment, ≤1e-5;
* ``EdgeServer``: tenants with different expert and d_ff prefixes, tokens
  equal to each tenant's extracted submodel's decode (logits ≤1e-5) and
  to the reference's server (logits ≤1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import a11_support as A
from repro.core.elastic import family_for as ref_family_for
from repro.models import moe as ref_moe
from repro.models import transformer as RT
from repro.serving import EdgeServer as RefEdgeServer
from repro.serving import Request as RefRequest
from repro_torch.checkpoint.bridge import params_to_numpy
from repro_torch.core.elastic import family_for
from repro_torch.kernels.dispatch import kernel_dispatch
from repro_torch.models import moe
from repro_torch.models import transformer as PT
from repro_torch.optim.optimizers import tree_map
from repro_torch.serving import EdgeServer, Request

torch.set_num_threads(2)
NAME = "deepseek-v2-lite-16b"


def _close(got, want, tol=A.TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def test_moe_shared_expert_matches_reference():
    """deepseek's MoE with its always-on shared expert (n_shared 1: one
    expert's d_ff, a plain gated MLP added to the routed combine), a
    group per client, on both paths."""
    cfg, ref_cfg = A.configs(NAME)
    assert cfg.moe.n_shared == 1
    G, T, d = 2, 16, cfg.d_model
    rng = np.random.default_rng(7)
    base = A.np_tree(ref_moe.moe_init(jax.random.PRNGKey(8), d,
                                      ref_cfg.moe))
    assert base["shared"]["wi"].shape == (d, cfg.moe.d_ff_expert)
    p = A.stacked_params(base, G, 9)
    x = rng.standard_normal((G, T, d)).astype(np.float32)
    want, _ = jax.vmap(lambda pp, xx: ref_moe.moe_forward(
        pp, xx[None], ref_cfg.moe, act=cfg.act))(p, jnp.asarray(x))
    for backend in ("auto", None):
        got, _ = moe.moe_forward(
            A.bridged(p), torch.from_numpy(x), cfg.moe, act=cfg.act,
            kernel=(kernel_dispatch(backend).table() or {}).get("moe"))
        _close(got, np.asarray(want)[:, 0])


def test_model_forward_prefill_decode_match_reference():
    """The whole parent — the dense first layer (an ``mlp`` leaf of
    d_ff 128), then MoE layers with the shared expert — through
    ``forward`` (a one-client stack, both paths), ``prefill`` and 4
    decode steps, against the reference's; the init tree has the
    reference's structure and shapes."""
    cfg, ref_cfg = A.configs(NAME)
    params = A.ref_params(ref_cfg, 1)
    own = params_to_numpy(PT.init_params(cfg, device="cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(params)
    assert [a.shape for a in jax.tree.leaves(own)] == \
        [a.shape for a in jax.tree.leaves(params)]
    assert "mlp" in params["segments"][0]["blocks"] and \
        "shared" in params["segments"][1]["blocks"]["moe"]
    pp = A.bridged(params)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want, _ = RT.forward(params, ref_cfg, {"tokens": jnp.asarray(toks)})
    one = tree_map(lambda t: t.unsqueeze(0), pp)
    for backend in ("auto", None):
        got = PT.forward(one, cfg, torch.from_numpy(toks).long()[None],
                         kernels=kernel_dispatch(backend).table())[0]
        _close(got, want)
    lw, cw = RT.prefill(params, ref_cfg, jnp.asarray(toks[:, :12]), 16)
    lg, cg = PT.prefill(pp, cfg, torch.from_numpy(toks[:, :12]).long(), 16,
                        kernels=kernel_dispatch("auto").table())
    _close(lg, lw)
    for a, b in zip(jax.tree.leaves(A.np_tree(cw)),
                    [t.numpy() for t in jax.tree.leaves(cg)]):
        _close(b, a)
    for i in range(12, 16):
        lw, cw = RT.decode_step(params, ref_cfg, cw,
                                jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        lg, cg = PT.decode_step(pp, cfg, cg,
                                torch.from_numpy(toks[:, i:i + 1]).long(),
                                torch.full((2,), i),
                                kernels=kernel_dispatch("auto").table())
        _close(lg, lw)


def test_edge_server_matches_extracted_and_reference():
    """Multi-tenant decode of 3 tenants with different expert / d_ff
    prefixes and depths on 2 slots (one re-admitted): each tenant's tokens
    equal its extracted submodel's teacher-forced decode (logits ≤1e-5)
    and the reference server's (logits ≤1e-4). The capacity factor is
    raised so that the masked and the extracted paths route alike, as the
    reference's serving tests do."""
    cfg, ref_cfg = A.configs(NAME, capacity_factor=8.0)
    ref_fam, fam = ref_family_for(ref_cfg), family_for(cfg)
    ref_params = ref_fam.init_params(jax.random.PRNGKey(3))
    params = A.bridged(A.np_tree(ref_params))
    specs = A.cohort_specs(NAME)
    prompts = [np.random.default_rng(7 + i).integers(0, 512, (8,))
               for i in range(3)]
    G = 4
    server = EdgeServer(fam, params, slots=2, prompt_len=8,
                        max_new_tokens=G, backend="auto", trace_logits=True,
                        device="cpu")
    out = server.run([Request(uid=i, spec=specs[i], prompt=prompts[i],
                              max_new_tokens=G) for i in range(3)])
    ref_server = RefEdgeServer(ref_fam, ref_params, slots=2, prompt_len=8,
                               max_new_tokens=G, trace_logits=True)
    ref_out = ref_server.run([
        RefRequest(uid=i, spec=A.ref_spec(specs[i]), prompt=prompts[i],
                   max_new_tokens=G) for i in range(3)])
    for c, r in zip(out, ref_out):
        assert c.tokens == r.tokens, c.uid
        assert max(float(np.abs(a - b).max())
                   for a, b in zip(c.logits, r.logits)) <= A.SLICE_TOL
        want = A.extracted_decode(fam, params, specs[c.uid],
                                  prompts[c.uid], c.tokens, 8 + G)
        assert len(want) == len(c.logits) == G
        assert max(float(np.abs(a - b).max())
                   for a, b in zip(c.logits, want)) <= A.TOL, c.uid
