"""The shared hybrid block and the zamba2 parent against the JAX reference
(``tests/a11_support.py``: zamba2-1.2b reduced to d_model 64 — a segment
of 1 Mamba2 layer with the shared attention block after it, then one of 2
layers; 4 SSD heads of 32; the shared block's MHA of 2 heads of 32 and its
MLP of d_ff 128, at a window of 16 that binds at 32 tokens), on the
reference's parameters, bridged:

* the init tree (one unstacked ``shared_attn`` block) and ``forward`` on a
  one-client stack and client-stacked (SSD-head and d_ff prefixes, a
  dropped layer: the masks that reach the shared block are stripped of
  ``ff`` / ``depth`` / ``heads``), both paths, ≤1e-5;
* prefill, decode and ``EdgeServer``: ``tests/test_torch_hybrid_decode.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import a11_support as A
from repro.core.elastic import family_for as ref_family_for
from repro.models import transformer as RT
from repro_torch.checkpoint.bridge import params_to_numpy
from repro_torch.core.elastic import family_for
from repro_torch.kernels.dispatch import kernel_dispatch
from repro_torch.models import transformer as PT
from repro_torch.optim.optimizers import tree_map

torch.set_num_threads(2)
NAME = "zamba2-1.2b"
S = 32


def _close(got, want, tol=A.TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def test_shared_block_tree_and_forward_match_reference():
    """The init tree has the reference's structure and shapes, with one
    unstacked ``shared_attn`` block of ``shared_attn_d_ff``; the forward of
    one client and of a cohort of three (SSD heads 4 / 2 / 1, a dropped
    layer, d_ff cut — which must not reach the shared block) equals the
    reference's on both paths."""
    cfg, ref_cfg = A.configs(NAME)
    params = A.ref_params(ref_cfg, 0)
    own = params_to_numpy(PT.init_params(cfg, device="cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(params)
    assert [a.shape for a in jax.tree.leaves(own)] == \
        [a.shape for a in jax.tree.leaves(params)]
    assert own["shared_attn"]["mlp"]["wi"].shape == (64, 128)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    want, _ = RT.forward(params, ref_cfg, {"tokens": jnp.asarray(toks)})
    one = tree_map(lambda t: t.unsqueeze(0), A.bridged(params))
    for backend in ("auto", None):
        got = PT.forward(one, cfg, torch.from_numpy(toks).long()[None],
                         kernels=kernel_dispatch(backend).table())[0]
        _close(got, want)
    specs = A.cohort_specs(NAME)
    G = len(specs)
    stacked = A.stacked_params(params, G, 3)
    ref_masks = ref_family_for(ref_cfg).cohort_masks(
        [A.ref_spec(s) for s in specs])
    ctoks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (G, 2, S)).astype(np.int32)
    want = A.ref_cohort_logits(ref_cfg, stacked, ref_masks.fwd, ctoks)
    masks = family_for(cfg).cohort_masks(specs, device="cpu")
    assert masks.fwd["ssm_heads"].sum(-1).tolist() == [4, 2, 1]
    assert masks.fwd["ff"].sum(-1).tolist() == [128, 128, 64]
    for backend in ("auto", None):
        got = PT.forward(A.bridged(stacked), cfg,
                         torch.from_numpy(ctoks).long(), masks=masks.fwd,
                         kernels=kernel_dispatch(backend).table())
        _close(got, want)
