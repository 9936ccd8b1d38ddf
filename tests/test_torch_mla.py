"""MLA attention and the deepseek-v2 parent against the JAX reference
(``tests/a11_support.py``: deepseek-v2-lite reduced to d_model 64, MLA
with kv_lora 64, nope 32, rope 16, v 32; its dense first layer, then MoE
layers with one shared expert), on the reference's parameters, bridged:

* ``mla_forward`` (with and without its compressed-latent cache),
  ``mla_decode`` (absorbed, per-row positions) and the client-stacked
  ``mla_forward_cohort`` against the reference's ``mla_forward`` /
  ``mla_decode`` (``dispatch_attention`` → ``chunked_attention``), ≤1e-5;
* the MoE with its shared expert, the model's forward, prefill and decode
  and ``EdgeServer``: ``tests/test_torch_mla_model.py``.

MLA has no Pallas kernel in the reference and none here: the kernel path
and the dense path run the same attention.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import a11_support as A
from repro.models import attention as ref_attn
from repro_torch.models import attention as attn

torch.set_num_threads(2)
NAME = "deepseek-v2-lite-16b"


def _close(got, want, tol=A.TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _block(seed=0):
    cfg, ref_cfg = A.configs(NAME)
    p = A.np_tree(ref_attn.mla_init(jax.random.PRNGKey(seed), cfg.d_model,
                                    cfg.n_heads, ref_cfg.mla))
    return cfg, ref_cfg, p


def test_mla_forward_and_latent_cache_match_reference():
    """The full-sequence MLA (q · k over nope + rope at 1/sqrt(nope +
    rope), v head dim ≠ qk's) and its prefill cache (positions 0..S-1
    filled, zeros after) against the reference's; both head masks."""
    cfg, ref_cfg, p = _block()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    for hm in (None, np.array([1.0, 0.0], np.float32)):
        kw = dict(n_heads=cfg.n_heads, causal=True, norm_eps=cfg.norm_eps)
        want, wc = ref_attn.mla_forward(
            p, jnp.asarray(x), jnp.asarray(pos), mla=ref_cfg.mla,
            head_mask=None if hm is None else jnp.asarray(hm), cache_len=16,
            cache_dtype=jnp.float32, **kw)
        got, gc = attn.mla_forward(
            A.bridged(p), torch.from_numpy(x), torch.from_numpy(pos).long(),
            mla=cfg.mla, head_mask=None if hm is None else
            torch.from_numpy(hm), cache_len=16, cache_dtype=torch.float32,
            **kw)
        _close(got, want)
        for a, b in zip(gc, wc):
            _close(a, b)
        assert not gc.c_kv[:, 12:].any()
        no_cache = attn.mla_forward(A.bridged(p), torch.from_numpy(x),
                                    torch.from_numpy(pos).long(),
                                    mla=cfg.mla, **kw)
        if hm is None:
            assert torch.equal(no_cache, got)


def test_mla_decode_matches_reference_per_row():
    """Absorbed decode in the latent space after a 6-token prefill: every
    step ≤1e-5 of the reference's; rows at different positions each equal
    the reference run on that row alone."""
    cfg, ref_cfg, p = _block(2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=cfg.n_heads, norm_eps=cfg.norm_eps)
    pp = A.bridged(p)
    # row 0 prefilled with 6 tokens, row 1 with 4: positions differ
    starts = (6, 4)
    caches, ref_caches = [], []
    for b, s in enumerate(starts):
        pos = np.arange(s, dtype=np.int32)[None]
        _, wc = ref_attn.mla_forward(
            p, jnp.asarray(x[b:b + 1, :s]), jnp.asarray(pos),
            mla=ref_cfg.mla, cache_len=10, cache_dtype=jnp.float32, **kw)
        ref_caches.append(wc)
        _, gc = attn.mla_forward(pp, torch.from_numpy(x[b:b + 1, :s]),
                                 torch.from_numpy(pos).long(), mla=cfg.mla,
                                 cache_len=10, cache_dtype=torch.float32,
                                 **kw)
        caches.append(gc)
    cache = attn.MLACache(*(torch.cat(f) for f in zip(*caches)))
    hm = torch.tensor([[1.0, 1.0], [1.0, 0.0]])
    for step in range(3):
        posv = torch.tensor([s + step for s in starts])
        xt = torch.from_numpy(np.stack([x[b, s + step] for b, s in
                                        enumerate(starts)])[:, None])
        got, cache = attn.mla_decode(pp, xt, cache, posv, mla=cfg.mla,
                                     head_mask=hm, **kw)
        for b, s in enumerate(starts):
            want, ref_caches[b] = ref_attn.mla_decode(
                p, jnp.asarray(xt[b:b + 1].numpy()), ref_caches[b],
                jnp.int32(s + step), mla=ref_cfg.mla,
                head_mask=jnp.asarray(hm[b].numpy()), **kw)
            _close(got[b:b + 1], want)
            for a, w in zip(cache, ref_caches[b]):
                _close(a[b:b + 1], w)


def test_mla_cohort_forward_matches_vmapped_reference():
    """The training form: client-stacked MLA weights, x (G, B·S, d), one
    attention over the G·B sequences, against the reference's
    ``mla_forward`` vmapped over clients."""
    cfg, ref_cfg, p = _block(4)
    G, B, S = 3, 2, 8
    stacked = A.stacked_params(p, G, 5)
    x = np.random.default_rng(6).standard_normal(
        (G, B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    want = jax.vmap(lambda pp, xx: ref_attn.mla_forward(
        pp, xx, jnp.asarray(pos), n_heads=cfg.n_heads, mla=ref_cfg.mla,
        norm_eps=cfg.norm_eps))(stacked, jnp.asarray(x))
    got = attn.mla_forward_cohort(
        A.bridged(stacked), torch.from_numpy(x).reshape(G, B * S, -1), S,
        n_heads=cfg.n_heads, mla=cfg.mla, norm_eps=cfg.norm_eps)
    _close(got.reshape(G, B, S, -1), want)
