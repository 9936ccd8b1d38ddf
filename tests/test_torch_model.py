"""Port model modules against the JAX reference on the same inputs:
layers, GQA prefill/decode, fused prefill and the batched masked decode
step on a reduced granite-3-8b (2 layers, d_model 64) with the reference's
own parameters bridged in (``checkpoint.bridge``), ≤1e-5; plus the weight
bridge, the npz manifest format in both directions, and the elastic
family's spec draws and forward masks."""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import restore_checkpoint as ref_restore
from repro.checkpoint.io import save_checkpoint as ref_save
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.configs.base import Segment as RefSegment
from repro.core.elastic import family_for as ref_family_for
from repro.kernels.dispatch import kernel_dispatch as ref_dispatch
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.checkpoint.io import restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import Segment
from repro_torch.core.elastic import family_for
from repro_torch.kernels.dispatch import kernel_dispatch
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.optim.optimizers import tree_map

torch.set_num_threads(2)
TOL = 1e-5
ARCH = "granite-3-8b"


def _configs(window=None):
    """The same reduced granite in both packages (optionally with a
    sliding window, so the ring-buffer cache wraps)."""
    ref = ref_reduced(REF_ARCHS[ARCH], n_layers=2, d_model=64)
    port = reduced(ARCHS[ARCH], n_layers=2, d_model=64)
    if window is not None:
        ref = dataclasses.replace(ref, segments=(RefSegment(
            "attn", 2, sliding_window=window),))
        port = dataclasses.replace(port, segments=(Segment(
            "attn", 2, sliding_window=window),))
    return ref, port


def _ref_params(cfg, seed=0):
    return RT.init_params(jax.random.PRNGKey(seed), cfg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _port_masks(host):
    return {k: (tuple(_t(m) for m in v) if isinstance(v, tuple) else _t(v))
            for k, v in host.items()}


def _stack_masks(hosts):
    out = {}
    for k in hosts[0]:
        if isinstance(hosts[0][k], tuple):
            out[k] = tuple(torch.stack([_t(h[k][i]) for h in hosts])
                           for i in range(len(hosts[0][k])))
        else:
            out[k] = torch.stack([_t(h[k]) for h in hosts])
    return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32) * 3
    scale = rng.standard_normal((32,)).astype(np.float32) * 0.1
    _close(PL.rmsnorm({"scale": _t(scale)}, _t(x)),
           RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    pos = np.stack([np.arange(5), np.arange(40, 45)]).astype(np.int32)
    _close(PL.apply_rope(_t(x), _t(pos), 10_000.0),
           RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_kernel_and_dense_paths_match_reference(act):
    """mlp(kernel=) with per-row width masks == the reference's
    interpret-mode kernel op vmapped over rows; the dense path too."""
    rng = np.random.default_rng(1)
    d, f = 64, 200
    p = {"wi": rng.standard_normal((d, f)) / 8, "wg": rng.standard_normal(
        (d, f)) / 8, "wo": rng.standard_normal((f, d)) / 14}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((3, 4, d)).astype(np.float32)
    masks = np.zeros((3, f), np.float32)
    for i, n in enumerate([200, 56, 8]):
        masks[i, :n] = 1
    ref_op = ref_dispatch("interpret").table("transformer")["mlp"]
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    want = jax.vmap(lambda xi, mi: RL.mlp(pj, xi, act, width_mask=mi,
                                          kernel=ref_op))(
        jnp.asarray(x), jnp.asarray(masks))
    pt = {k: _t(v) for k, v in p.items()}
    op = kernel_dispatch("auto").table()["mlp"]
    _close(PL.mlp(pt, _t(x), act, width_mask=_t(masks), kernel=op), want)
    _close(PL.mlp(pt, _t(x), act, width_mask=_t(masks)), want)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _attn_kw(cfg):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_gqa_forward_with_cache_matches_reference(use_kernel):
    ref_cfg, cfg = _configs()
    bp = _np(_ref_params(ref_cfg)["segments"][0]["blocks"]["attn"])
    bp0 = {k: v[0] for k, v in bp.items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    hm = np.asarray([1, 0], np.float32)
    kw = dict(causal=True, window=4, cap=30.0, head_mask=None)
    ref_kern = ref_dispatch("interpret").table()["attention"] \
        if use_kernel else None
    out_r, cache_r = RA.gqa_forward(
        {k: jnp.asarray(v) for k, v in bp0.items()}, jnp.asarray(x),
        jnp.asarray(pos), **_attn_kw(ref_cfg), **dict(kw, head_mask=hm),
        kernel=ref_kern, cache_len=6)
    kern = kernel_dispatch("auto").table()["attention"] if use_kernel \
        else None
    out_p, cache_p = PA.gqa_forward(
        {k: _t(v) for k, v in bp0.items()}, _t(x), _t(pos), **_attn_kw(cfg),
        **dict(kw, head_mask=_t(hm)), kernel=kern, cache_len=6)
    _close(out_p, out_r)
    _close(cache_p.k, cache_r.k)
    _close(cache_p.v, cache_r.v)


@pytest.mark.parametrize("S,C", [(9, 4), (3, 8), (8, 8)])
def test_ring_pack_matches_reference(S, C):
    rng = np.random.default_rng(S * C)
    k = rng.standard_normal((2, S, 1, 4)).astype(np.float32)
    v = rng.standard_normal((2, S, 1, 4)).astype(np.float32)
    want = RA._ring_pack(jnp.asarray(k), jnp.asarray(v), C, jnp.float32)
    got = PA._ring_pack(_t(k), _t(v), C, torch.float32)
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))


def test_gqa_decode_per_row_positions_match_reference():
    """Two rows at different positions in one call (each its own ring slot
    and validity, its own head mask) == the reference per row."""
    ref_cfg, cfg = _configs()
    bp = _np(_ref_params(ref_cfg, seed=3)["segments"][0]["blocks"]["attn"])
    bp0 = {k: v[1] for k, v in bp.items()}
    rng = np.random.default_rng(4)
    C = 5
    ck = rng.standard_normal((2, C, cfg.n_kv_heads, cfg.head_dim))
    cv = rng.standard_normal((2, C, cfg.n_kv_heads, cfg.head_dim))
    ck, cv = ck.astype(np.float32), cv.astype(np.float32)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    positions = [2, 11]          # row 0: cache partly valid; row 1 wrapped
    hms = np.asarray([[1, 1], [1, 0]], np.float32)
    out_p, cache_p = PA.gqa_decode(
        {k: _t(v) for k, v in bp0.items()}, _t(x),
        PA.KVCache(_t(ck), _t(cv)), torch.tensor(positions),
        **_attn_kw(cfg), cap=20.0, head_mask=_t(hms))
    for i, pos in enumerate(positions):
        out_r, cache_r = RA.gqa_decode(
            {k: jnp.asarray(v) for k, v in bp0.items()},
            jnp.asarray(x[i:i + 1]),
            RA.KVCache(jnp.asarray(ck[i:i + 1]), jnp.asarray(cv[i:i + 1])),
            jnp.int32(pos), **_attn_kw(ref_cfg), cap=20.0,
            head_mask=jnp.asarray(hms[i]))
        _close(out_p[i:i + 1], out_r)
        _close(cache_p.k[i:i + 1], cache_r.k)
        _close(cache_p.v[i:i + 1], cache_r.v)


# ---------------------------------------------------------------------------
# the whole model: fused prefill and the batched masked decode step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 6])
def test_prefill_and_batched_decode_match_reference(window):
    ref_cfg, cfg = _configs(window)
    ref_params = _ref_params(ref_cfg, seed=5)
    params = params_from_numpy(_np(ref_params), device="cpu")
    ref_fam = ref_family_for(ref_cfg)
    fam = family_for(cfg)
    rng = random.Random(6)
    specs = [ref_fam.random_spec(rng), ref_fam.full_spec()]
    nrng = np.random.default_rng(7)
    prompts = [nrng.integers(0, cfg.vocab_size, (n,)) for n in (7, 10)]
    max_len = 12
    ref_tab = ref_dispatch("interpret").table()
    tab = kernel_dispatch("auto").table()

    port_caches = PT.init_decode_caches(cfg, 2, max_len, device="cpu")
    ref_out = []
    for i, (spec, prompt) in enumerate(zip(specs, prompts)):
        host = ref_fam.spec_masks(spec).fwd
        jfwd = jax.tree.map(jnp.asarray, host)
        logits_r, caches_r = RT.prefill(
            ref_params, ref_cfg, jnp.asarray(prompt[None], jnp.int32),
            max_len, masks=jfwd, kernels=ref_tab)
        logits_p, caches_p = PT.prefill(
            params, cfg, torch.from_numpy(prompt[None]), max_len,
            masks=_port_masks(fam.decode_masks(spec)), kernels=tab)
        _close(logits_p, logits_r)
        _close(caches_p.segments[0].k, caches_r.segments[0].k)
        _close(caches_p.segments[0].v, caches_r.segments[0].v)
        port_caches.segments[0].k[:, i] = caches_p.segments[0].k[:, 0]
        port_caches.segments[0].v[:, i] = caches_p.segments[0].v[:, 0]
        tok = int(np.argmax(np.asarray(logits_r[0])))
        logits_r, caches_r = RT.decode_step(
            ref_params, ref_cfg, caches_r, jnp.asarray([[tok]], jnp.int32),
            jnp.int32(len(prompt)), masks=jfwd, kernels=ref_tab)
        ref_out.append((tok, logits_r, caches_r))

    toks = torch.tensor([[t] for t, _, _ in ref_out])
    pos = torch.tensor([len(p) for p in prompts])
    batched = _stack_masks([fam.decode_masks(s) for s in specs])
    logits_p, port_caches = PT.decode_step(params, cfg, port_caches, toks,
                                           pos, masks=batched, kernels=tab)
    for i, (_, logits_r, caches_r) in enumerate(ref_out):
        _close(logits_p[i:i + 1], logits_r)
        _close(port_caches.segments[0].k[:, i:i + 1],
               caches_r.segments[0].k)
        _close(port_caches.segments[0].v[:, i:i + 1],
               caches_r.segments[0].v)


@pytest.mark.parametrize("window", [None, 4])
def test_fused_prefill_matches_stepwise_decode(window):
    """The port's one-shot prefill leaves the caches and last logits that
    stepping ``decode_step`` over the prompt leaves (≤1e-5) — the check the
    reference's ``launch/serve.py --check-prefill`` makes."""
    _, cfg = _configs(window)
    params = PT.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 9)))
    tab = kernel_dispatch("auto").table()
    logits_f, caches_f = PT.prefill(params, cfg, toks, 12, kernels=tab)
    caches_s = PT.init_decode_caches(cfg, 2, 12, device="cpu")
    for i in range(toks.shape[1]):
        logits_s, caches_s = PT.decode_step(params, cfg, caches_s,
                                            toks[:, i:i + 1], i, kernels=tab)
    _close(logits_f, logits_s)
    _close(caches_f.segments[0].k, caches_s.segments[0].k)
    _close(caches_f.segments[0].v, caches_s.segments[0].v)


def test_cnn_family_raises_naming_its_roadmap_item():
    """The CNN family is ported (ROADMAP A4 landed): ``family_for`` builds
    it from the port's ``CNNConfig`` and refuses the reference's config
    object. The RL gates (ROADMAP A21 landed) run on the paper's CNN in
    every mode: ``sample`` takes a generator or replayed uniforms and
    raises without either, an unknown mode raises."""
    from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
    from repro_torch.configs.paper_cnn import PAPER_CNN
    from repro_torch.core.elastic import CNNElasticFamily
    from repro_torch.models import cnn
    assert isinstance(family_for(PAPER_CNN), CNNElasticFamily)
    with pytest.raises(TypeError, match="no elastic family"):
        family_for(RefCNNConfig())
    params = cnn.init_params(PAPER_CNN, device="cpu")
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    for mode in ("soft", "hard"):
        logits, info = cnn.forward(params, PAPER_CNN, x, gate_mode=mode)
        assert logits.shape == (2, PAPER_CNN.n_classes)
        assert 0.0 <= float(info["compute_pct"]) <= 1.0
    logits, info = cnn.forward(params, PAPER_CNN, x, gate_mode="sample",
                               generator=torch.Generator().manual_seed(1))
    assert info["log_prob"].shape == (2,) and \
        bool(torch.isfinite(info["log_prob"]).all())
    with pytest.raises(ValueError, match="generator"):
        cnn.forward(params, PAPER_CNN, x, gate_mode="sample")
    with pytest.raises(ValueError, match="gate_mode"):
        cnn.forward(params, PAPER_CNN, x, gate_mode="skip")


def test_unported_configs_raise_naming_roadmap():
    """The zoo's last three decoder parents are ported (ROADMAP A11
    landed): each family builds at the published and the reduced size,
    with its forward masks — no attention-head dim on MLA (latent heads)
    or on zamba2 (its only attention is the shared block, kept whole), an
    SSD-head dim on zamba2, expert and d_ff dims on deepseek — and its
    reduced parent runs ``init_params`` / ``forward`` / ``prefill`` /
    ``decode_step`` to finite logits. What is still to come, the input
    frontends of llava and hubert (ROADMAP A7 landed), build too: their
    reduced parents run ``init_params`` and the batch-dict
    ``forward_batch`` on token / image-embedding / frame inputs to finite
    logits."""
    dims = {"gemma2-9b": {"ff", "heads", "depth"},
            "deepseek-v2-lite-16b": {"ff", "experts", "depth"},
            "zamba2-1.2b": {"ff", "ssm_heads", "depth"}}
    for arch, want in dims.items():
        assert set(family_for(ARCHS[arch]).decode_masks(
            family_for(ARCHS[arch]).full_spec())) == want
        cfg = reduced(ARCHS[arch], n_layers=2, d_model=64)
        fam = family_for(cfg)
        params = PT.init_params(cfg, seed=1, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (1, 2, 16),
                             generator=torch.Generator().manual_seed(0))
        logits = PT.forward(tree_map(lambda t: t.unsqueeze(0), params), cfg,
                            toks, masks=fam.cohort_masks(
                                [fam.full_spec()], device="cpu").fwd)
        assert logits.shape == (1, 2, 16, cfg.padded_vocab)
        last, caches = PT.prefill(params, cfg, toks[0], 20)
        step, _ = PT.decode_step(params, cfg, caches, toks[0, :, -1:],
                                 torch.full((2,), 16))
        assert torch.isfinite(last).all() and torch.isfinite(step).all()
    gen = torch.Generator().manual_seed(2)
    for arch in ("llava-next-mistral-7b", "hubert-xlarge"):
        cfg = reduced(ARCHS[arch], n_layers=2, d_model=64)
        params = PT.init_params(cfg, seed=1, device="cpu")
        if cfg.frontend == "audio":
            batch = {"frames": torch.randn((2, 16, cfg.d_model),
                                           generator=gen)}
        else:
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                             generator=gen),
                     "image_embeds": torch.randn(
                         (2, cfg.frontend_tokens, cfg.d_model),
                         generator=gen)}
        logits, aux = PT.forward_batch(params, cfg, batch)
        assert logits.shape[:2] == (2, 16 if cfg.frontend == "audio"
                                    else 24)
        assert logits.shape[-1] == cfg.padded_vocab
        assert bool(torch.isfinite(logits).all()) and float(aux) == 0.0


@pytest.mark.parametrize("reduce", [True, False])
def test_mamba2_builds_its_family(reduce):
    """The SSM parent is ported: its family builds at the reduced and the
    published size, with the SSD-head dimension in its forward masks."""
    cfg = ARCHS["mamba2-2.7b"]
    if reduce:
        cfg = reduced(cfg, n_layers=2, d_model=64)
    fam = family_for(cfg)
    masks = fam.decode_masks(fam.full_spec())
    assert masks["ssm_heads"].shape == (cfg.ssm.n_heads(cfg.d_model),)
    assert masks["ssm_heads"].all() and "heads" not in masks


# ---------------------------------------------------------------------------
# bridge, checkpoints, spec algebra
# ---------------------------------------------------------------------------
def test_bridge_round_trips_bit_equal_and_init_matches_shapes():
    ref_cfg, cfg = _configs()
    ref_np = _np(_ref_params(ref_cfg, seed=8))
    back = params_to_numpy(params_from_numpy(ref_np, device="cpu"))
    ref_leaves, ref_def = jax.tree.flatten(ref_np)
    back_leaves, back_def = jax.tree.flatten(back)
    assert ref_def == back_def
    for a, b in zip(ref_leaves, back_leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the torch-seeded stand-in has the reference's tree and shapes
    own = params_to_numpy(PT.init_params(cfg, seed=0, device="cpu"))
    own_leaves, own_def = jax.tree.flatten(own)
    assert own_def == ref_def
    assert [a.shape for a in own_leaves] == [a.shape for a in ref_leaves]


def test_npz_manifest_format_reads_both_ways(tmp_path):
    ref_cfg, cfg = _configs()
    ref_params = _ref_params(ref_cfg, seed=9)
    ref_path = str(tmp_path / "ref.npz")
    ref_save(ref_path, ref_params)
    port_tpl = PT.init_params(cfg, seed=1, device="cpu")
    restored = restore_checkpoint(ref_path, port_tpl)
    for a, b in zip(jax.tree.leaves(_np(ref_params)),
                    jax.tree.leaves(params_to_numpy(restored))):
        np.testing.assert_array_equal(a, b)
    port_path = str(tmp_path / "port.npz")
    save_checkpoint(port_path, restored)
    back = ref_restore(port_path, ref_params)
    for a, b in zip(jax.tree.leaves(ref_params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_random_spec_and_decode_masks_match_reference():
    for arch, n_layers, d_model in ((ARCH, 5, 64), ("qwen3-4b", 3, 64)):
        ref_fam = ref_family_for(ref_reduced(REF_ARCHS[arch],
                                             n_layers=n_layers,
                                             d_model=d_model))
        fam = family_for(reduced(ARCHS[arch], n_layers=n_layers,
                                 d_model=d_model))
        rr, rp = random.Random(10), random.Random(10)
        for _ in range(3):
            spec_r, spec_p = ref_fam.random_spec(rr), fam.random_spec(rp)
            assert spec_r.genes() == spec_p.genes()
            ref_fwd = ref_fam.spec_masks(spec_r).fwd
            fwd = fam.decode_masks(spec_p)
            assert set(ref_fwd) == set(fwd)
            for k in fwd:
                for a, b in zip(jax.tree.leaves(ref_fwd[k]),
                                jax.tree.leaves(fwd[k])):
                    np.testing.assert_array_equal(np.asarray(a), b)
        assert fam.full_spec().genes() == ref_fam.full_spec().genes()
