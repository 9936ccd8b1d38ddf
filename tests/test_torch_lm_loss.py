"""The zoo's LM training loss against the reference: input frontends,
the chunked unembedding + CE, the batch-dict forward and ``loss_fn``.

Each parent is reduced alike in both packages (2 layers, d_model 64;
hubert-xlarge at its own head dim 80) and the reference's parameters are
bridged (``checkpoint.bridge``); frames, image embeddings and tokens are
numpy-seeded and handed to both:

* ``embed_inputs`` exactly equal (tokens, audio frames, image embeddings
  spliced over the first F positions);
* ``chunked_softmax_xent`` and ``cross_entropy`` ≤1e-6 with their
  gradients, at S not a multiple of 256 (chunks of 150), with a softcap and
  a partial mask;
* ``loss_fn`` and its gradients ≤1e-5 for llava (vision mask), hubert
  (encoder-only labels and ``loss_mask``), granite-moe (the aux loss, under
  expert and depth masks) and qwen3;
* the batch-dict forward's logits and remat:
  ``tests/test_torch_lm_remat.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.models import transformer as RT
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import transformer as PT
from repro_torch.optim.optimizers import tree_leaves, tree_map

torch.set_num_threads(2)
TOL = 1e-5
B, S = 2, 24
ARCH_NAMES = ("llava-next-mistral-7b", "hubert-xlarge",
              "granite-moe-1b-a400m", "qwen3-4b")


def _configs(arch, n_layers=2):
    ref = ref_reduced(REF_ARCHS[arch], n_layers=n_layers, d_model=64)
    port = reduced(ARCHS[arch], n_layers=n_layers, d_model=64)
    if arch == "hubert-xlarge":     # the parent's head dim, 2 heads of 80
        kw = dict(head_dim=80, n_heads=2, n_kv_heads=2)
        ref, port = (dataclasses.replace(c, **kw) for c in (ref, port))
    return ref, port


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal(
                    (B, S, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (B, S)).astype(np.int32),
                "loss_mask": (rng.uniform(size=(B, S)) < 0.7).astype(
                    np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ref():
    """Per arch: (reference config, port config, the reference's numpy
    parameters, a numpy batch)."""
    out = {}
    for i, arch in enumerate(ARCH_NAMES):
        rc, pc = _configs(arch, 4 if arch.startswith("granite-moe") else 2)
        params = jax.tree.map(np.asarray,
                              RT.init_params(jax.random.PRNGKey(i), rc))
        out[arch] = (rc, pc, params, _batch(rc, i))
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads(fn, params):
    """(value, aux, grads) of fn over a bridged tree; leaves the loss does
    not reach get zeros (as ``jax.grad`` gives them)."""
    leaves = tree_map(lambda t: t.clone().requires_grad_(True),
                      params_from_numpy(params, device="cpu"))
    val, aux = fn(leaves)
    flat = tree_leaves(leaves)
    g = [torch.zeros_like(t) if x is None else x for t, x in zip(
        flat, torch.autograd.grad(val, flat, allow_unused=True))]
    return val, aux, g


def _close(got, want, tol=TOL):
    a, b = list(got), jax.tree.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)
        np.testing.assert_allclose(x, np.asarray(y), atol=tol, rtol=0)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "hubert-xlarge",
                                  "qwen3-4b"])
def test_embed_inputs_exact(ref, arch):
    rc, pc, params, batch = ref[arch]
    want = RT.embed_inputs(params, rc, _jb(batch))
    got = PT.embed_inputs(params_from_numpy(params, device="cpu"), pc,
                          _tb(batch))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if arch.startswith("llava"):
        F = batch["image_embeds"].shape[1]
        np.testing.assert_array_equal(got[:, :F].numpy(),
                                      batch["image_embeds"])


@pytest.mark.parametrize("cap", [None, 30.0])
def test_chunked_xent_and_cross_entropy_match_reference(cap):
    """S = 300 (chunks of 150), a partial mask: value and the gradients
    of x and w ≤1e-6; ``cross_entropy`` of the full logits too."""
    rng = np.random.default_rng(1)
    S_, d, V = 300, 16, 40
    x = rng.standard_normal((2, S_, d)).astype(np.float32)
    w = rng.standard_normal((d, V)).astype(np.float32)
    t = rng.integers(0, V, (2, S_)).astype(np.int32)
    m = (rng.uniform(size=(2, S_)) < 0.6).astype(np.float32)
    want, (gx, gw) = jax.value_and_grad(
        lambda a, b: RT.chunked_softmax_xent(a, b, jnp.asarray(t),
                                             jnp.asarray(m), cap=cap),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    got = PT.chunked_softmax_xent(xt, wt, torch.from_numpy(t),
                                  torch.from_numpy(m), cap=cap)
    g = torch.autograd.grad(got, (xt, wt))
    _close([got], [want], 1e-6)
    _close(g, [gx, gw], 1e-6)
    logits = x @ w if cap is None else cap * np.tanh((x @ w) / cap)
    want_ce = RT.cross_entropy(jnp.asarray(logits), jnp.asarray(t),
                               jnp.asarray(m))
    got_ce = PT.cross_entropy(torch.from_numpy(logits.astype(np.float32)),
                              torch.from_numpy(t), torch.from_numpy(m))
    _close([got_ce], [want_ce], 1e-6)


def _moe_masks(cfg):
    """granite-moe's expert prefix 3 of 4 and layer 2 of 4 dropped."""
    return {"experts": np.array([1, 1, 1, 0], np.float32),
            "depth": (np.array([1, 1, 0, 1], np.float32),)}


@pytest.mark.parametrize("arch,masked", [(a, False) for a in ARCH_NAMES] +
                         [("granite-moe-1b-a400m", True)])
def test_loss_fn_and_grads_match_reference(ref, arch, masked):
    """loss, ce, aux and every gradient ≤1e-5 (granite-moe's aux loss
    included, and under expert / depth masks: the dropped layer's aux is
    gated out)."""
    rc, pc, params, batch = ref[arch]
    masks = _moe_masks(rc) if masked else None
    (want, wm), wg = jax.value_and_grad(
        lambda p: RT.loss_fn(p, rc, _jb(batch), masks=None if masks is None
                             else jax.tree.map(jnp.asarray, masks)),
        has_aux=True)(params)
    got, gm, g = _grads(lambda p: PT.loss_fn(
        p, pc, _tb(batch), masks=None if masks is None else jax.tree.map(
            torch.from_numpy, masks)), params)
    _close([got, gm["ce"], gm["aux"]], [want, wm["ce"], wm["aux"]])
    _close(g, wg)
    if arch.startswith("granite-moe"):
        assert float(gm["aux"].detach()) > 0
