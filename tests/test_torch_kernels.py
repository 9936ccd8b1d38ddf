"""Port kernels against the JAX reference: ``elastic_dense_plain`` and
``flash_attention_fwd_plain`` (the plain versions the CPU path runs) are
held to the reference's Pallas kernels in interpret mode, on the same
numpy-seeded inputs, at ≤1e-5. The CUDA kernels themselves run only on the
card (``-m cuda``); here the wrappers must take the plain versions for
CPU tensors and launch nothing."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.elastic_matmul import elastic_dense as ref_edense
from repro.kernels.flash_attention import _block_sizes, _fwd_call
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import dispatch
from repro_torch.kernels import elastic_matmul as em
from repro_torch.kernels.elastic_matmul import (elastic_dense,
                                                elastic_dense_plain)
from repro_torch.kernels.flash_attention import (NEG_INF, flash_attention,
                                                 flash_attention_fwd_plain)

torch.set_num_threads(2)
TOL = 1e-5


def _i32(vals):
    return torch.tensor(vals, dtype=torch.int32)


def _k1_inputs(rng, G, M, K, N, bias):
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    b = rng.standard_normal((N,)).astype(np.float32) if bias else None
    return x, w, b


# (M, K, N, k_active, n_active, m_active, act, bias): prefixes
# {None = full, 0, ragged, full}, all four activations, shapes that are not
# tile multiples of the reference's 128-blocks
K1_CASES = [
    (5, 200, 130, None, None, None, None, False),
    (5, 200, 130, 0, None, None, "silu", True),
    (9, 300, 260, 137, 200, 7, "gelu", True),
    (16, 128, 256, 128, 0, None, "relu", False),
    (3, 257, 129, 256, 129, 3, "silu", False),
    (12, 64, 300, 10, 77, 0, "relu", True),
]


@pytest.mark.parametrize("M,K,N,ka,na,ma,act,bias", K1_CASES)
def test_elastic_dense_plain_matches_reference(M, K, N, ka, na, ma, act,
                                               bias):
    rng = np.random.default_rng(M * 1000 + K)
    x, w, b = _k1_inputs(rng, 1, M, K, N, bias)
    want = ref_edense(jnp.asarray(x[0]), jnp.asarray(w),
                      None if b is None else jnp.asarray(b),
                      k_active=ka, n_active=na, m_active=ma, act=act,
                      bm=8, interpret=True)
    pre = {f"{n}_active": (None if v is None else _i32([v]))
           for n, v in (("k", ka), ("n", na), ("m", ma))}
    got = elastic_dense_plain(torch.from_numpy(x), torch.from_numpy(w),
                              None if b is None else torch.from_numpy(b),
                              act=act, **pre)
    assert got.shape == (1, M, N)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_elastic_dense_per_group_prefixes_match_vmapped_reference():
    """The explicit group axis with per-group prefixes == jax.vmap of the
    reference over the group axis (how the reference batches clients)."""
    rng = np.random.default_rng(7)
    G, M, K, N = 4, 3, 200, 150
    x, w, b = _k1_inputs(rng, G, M, K, N, True)
    ka, na, ma = [200, 0, 77, 129], [150, 64, 0, 149], [3, 1, 3, 2]
    want = jax.vmap(lambda xi, k, n, m: ref_edense(
        xi, jnp.asarray(w), jnp.asarray(b), k_active=k, n_active=n,
        m_active=m, act="silu", bm=8, interpret=True))(
        jnp.asarray(x), jnp.asarray(ka, jnp.int32), jnp.asarray(na, jnp.int32),
        jnp.asarray(ma, jnp.int32))
    got = elastic_dense_plain(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), k_active=_i32(ka),
                              n_active=_i32(na), m_active=_i32(ma),
                              act="silu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_wrappers_take_plain_versions_for_cpu_tensors():
    """On CPU tensors the wrappers return the plain versions' results and
    launch no kernel; bad prefixes raise."""
    rng = np.random.default_rng(3)
    x, w, b = _k1_inputs(rng, 2, 1, 40, 24, True)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    before = elastic_dense.launches
    y = elastic_dense(xt, wt, bt, n_active=_i32([24, 5]), act="gelu")
    assert torch.equal(y, elastic_dense_plain(xt, wt, bt,
                                              n_active=_i32([24, 5]),
                                              act="gelu"))
    assert elastic_dense.launches == before
    with pytest.raises(ValueError):
        elastic_dense(xt, wt, n_active=torch.tensor([1, 2]))  # int64
    with pytest.raises(ValueError):
        elastic_dense(xt, wt, act="tanh")
    q = torch.from_numpy(rng.standard_normal((1, 8, 4, 32)).astype(np.float32))
    kv = torch.from_numpy(
        rng.standard_normal((1, 8, 2, 32)).astype(np.float32))
    before = flash_attention.launches
    o, lse = flash_attention(q, kv, kv, _i32([2]))
    o_p, lse_p = flash_attention_fwd_plain(q, kv, kv, _i32([2]))
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert flash_attention.launches == before


# (B, S, H, KV, D, h_active, causal, window, cap)
FLASH_CASES = [
    (2, 32, 4, 2, 32, 4, True, None, None),        # all heads
    (2, 32, 4, 2, 32, 2, True, 8, None),           # one GQA group, window
    (1, 24, 4, 2, 32, 0, True, None, None),        # head prefix 0
    (1, 24, 4, 4, 32, 4, False, None, 20.0),       # ragged S, softcap
    (1, 40, 8, 1, 32, 4, True, 16, 30.0),          # GQA 8:1, all options
]


def _flash_inputs(B, S, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,S,H,KV,D,ha,causal,window,cap", FLASH_CASES)
def test_flash_plain_matches_reference(B, S, H, KV, D, ha, causal, window,
                                       cap):
    """o and lse against the Pallas forward (``_fwd_call``) and o against
    the public ``flash_attention`` with a head mask."""
    q, k, v = _flash_inputs(B, S, H, KV, D, seed=S + H + ha)
    o, lse = flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        _i32([ha] * B), causal=causal, window=window, cap=cap)
    bq, bk = _block_sizes(S, S, 8, 16)
    o_ref, lse_ref = _fwd_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray([ha], jnp.int32), causal=causal, window=window, cap=cap,
        scale=1.0 / np.sqrt(D), bq=bq, bk=bk, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=TOL,
                               rtol=1e-6)
    head_mask = (np.arange(H) < ha).astype(np.float32)
    o_pub = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(head_mask), causal=causal, window=window,
                      cap=cap, bq=8, bk=16, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_pub), atol=TOL,
                               rtol=0)
    dead = np.arange(H) >= ha
    assert np.all(o.numpy()[:, :, dead] == 0)
    assert np.all(lse.numpy()[:, dead] == NEG_INF)


def test_flash_per_batch_head_prefixes():
    """A (B,) head prefix: each batch row equals the reference run on that
    row alone with its own prefix."""
    B, S, H, KV, D = 3, 16, 4, 2, 32
    q, k, v = _flash_inputs(B, S, H, KV, D, seed=11)
    has = [4, 0, 2]
    o, lse = flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        _i32(has), causal=True, window=6)
    for bi, ha in enumerate(has):
        o_ref, lse_ref = _fwd_call(
            jnp.asarray(q[bi:bi + 1]), jnp.asarray(k[bi:bi + 1]),
            jnp.asarray(v[bi:bi + 1]), jnp.asarray([ha], jnp.int32),
            causal=True, window=6, cap=None, scale=1.0 / np.sqrt(D), bq=8,
            bk=8, interpret=True)
        np.testing.assert_allclose(o[bi:bi + 1].numpy(), np.asarray(o_ref),
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(lse[bi:bi + 1].numpy(),
                                   np.asarray(lse_ref), atol=TOL, rtol=1e-6)


def test_dispatch_table_and_unported_ops():
    assert dispatch.kernel_dispatch(None).table() is None
    assert dispatch.kernel_dispatch("dense").table() is None
    table = dispatch.kernel_dispatch("auto").table("transformer")
    assert set(table) == {"mlp", "attention", "moe", "ssd"}
    # the moe op is the grouped matmul, carrying the gather pair
    moe = table["moe"]
    assert callable(moe.dispatch) and callable(moe.combine)
    eb = torch.randn(2, 3, 4, 5)
    w = torch.randn(3, 5, 6)
    ga = torch.tensor([3, 1], dtype=torch.int32)
    y = moe(eb, w, ga)
    assert y.shape == (2, 3, 4, 6)
    torch.testing.assert_close(y[0], torch.matmul(eb[0], w))
    assert not y[1, 1:].any()
    # the ssd op is the SSD chunk scan (K8), heads past the mask zero
    xh = torch.randn(2, 8, 4, 3)
    y, none = table["ssd"](xh, torch.rand(2, 8, 4), -torch.rand(4),
                           torch.randn(2, 8, 1, 5), torch.randn(2, 8, 1, 5),
                           4, head_mask=torch.tensor([1.0, 1.0, 0.0, 0.0]))
    assert none is None and y.shape == xh.shape
    assert y[:, :, :2].abs().sum() > 0 and not y[:, :, 2:].any()
    # the CNN family's table: the stage convolutions lowered onto K1
    assert set(dispatch.kernel_dispatch("auto").table("cnn")) == {"conv"}
    assert dispatch.kernel_dispatch(None).table("cnn") is None
    with pytest.raises(ValueError, match="no op table"):
        dispatch.kernel_dispatch("auto").table("gnn")
    with pytest.raises(ValueError):
        dispatch.kernel_dispatch("tpu")
    # per-row prefixes from (B, n) masks, broadcast from (n,) masks
    m = torch.tensor([[1, 1, 0, 0], [1, 1, 1, 1]], dtype=torch.float32)
    assert dispatch.active_len(m, 2).tolist() == [2, 4]
    assert dispatch.active_len(m[0], 3).tolist() == [2, 2, 2]


# K1's launch plan (``elastic_matmul._plan``), computed here without a card
# for an H100's 132 SMs: (label, G, M, K, N, layout flags, variant) at the
# main path's shapes (granite-3-8b: chip_smoke.py phases 4 and 6)
SMS = 132
MAIN_PATH_PLANS = [
    ("decode up/gate", 2, 1, 4096, 12800, 0, "skinny"),
    ("decode down", 2, 1, 12800, 4096, 0, "skinny"),
    ("prefill up/gate", 1, 32, 4096, 12800, 0, "skinny"),
    ("prefill down", 1, 32, 12800, 4096, 0, "skinny"),
    ("train up/gate fwd", 4, 512, 4096, 12800, em.W_PER_GROUP, "tile"),
    ("train down fwd", 4, 512, 12800, 4096, em.W_PER_GROUP, "tile"),
    ("train dx up", 4, 512, 12800, 4096, em.W_PER_GROUP | em.W_TRANS,
     "tile"),
    ("train dx down", 4, 512, 4096, 12800, em.W_PER_GROUP | em.W_TRANS,
     "tile"),
    ("train dw up", 4, 4096, 512, 12800, em.W_PER_GROUP | em.X_TRANS,
     "tile"),
    ("train dw down", 4, 12800, 512, 4096, em.W_PER_GROUP | em.X_TRANS,
     "tile"),
]


@pytest.mark.parametrize("label,G,M,K,N,flags,variant", MAIN_PATH_PLANS,
                         ids=[c[0] for c in MAIN_PATH_PLANS])
def test_plan_main_path_takes_tensor_core_variants(label, G, M, K, N, flags,
                                                   variant):
    """Every main-path product goes to the tile or the skinny variant; its
    split chunks are whole 32-deep stages that cover K exactly once, and a
    split's partial sums stay far below the weight they accompany."""
    plan = em._plan(G, M, K, N, flags, True, SMS)
    assert plan.variant == variant
    assert plan.kchunk % em.STAGE_K[variant] == 0
    assert (plan.splits - 1) * plan.kchunk < K <= plan.splits * plan.kchunk
    partial = plan.splits * G * M * N if plan.splits > 1 else 0
    assert partial <= 0.05 * K * N * (G if flags & em.W_PER_GROUP else 1)
    blocks = em.plan_blocks(plan, G, M, N, flags)
    if variant == "skinny":
        # every SM gets two or more blocks, and all of them fit at once
        # (one wave: each block streams an equal share of the weight)
        assert 2 * SMS <= blocks <= em.resident_blocks(
            variant, plan.bm, flags) * SMS
        assert em.shared_bytes(variant, plan.bm, flags) <= 227 * 1024
    else:
        assert blocks >= SMS and plan.splits == 1


def test_plan_never_sees_the_prefixes():
    """The plan is a function of the shapes, the layout flags, the rows'
    alignment and the SM count: no prefix reaches it, so a change of
    submodel never changes a launch (its prefixes are device tensors the
    kernel reads)."""
    import inspect
    assert list(inspect.signature(em._plan).parameters) == [
        "G", "M", "K", "N", "flags", "aligned", "sms"]
    assert list(inspect.signature(em.launch_plan).parameters) == ["x", "w"]


def test_plan_unaligned_rows_take_the_simt_tile(monkeypatch):
    """Operands whose stored rows (or group stride, or start) are not on
    16 bytes cannot be copied by cp.async: the plan picks the SIMT tile,
    by shape alone; aligned twins of the same products do not."""
    monkeypatch.setattr(em, "_sms", lambda index: SMS)
    f32 = dict(dtype=torch.float32)
    cases = [  # (x, w, aligned twin?)
        (torch.zeros(3, 37, 1000, **f32), torch.zeros(1000, 777, **f32)),
        (torch.zeros(5, 1, 257, **f32), torch.zeros(257, 130, **f32)),
        (torch.zeros(2, 36, 38, **f32).transpose(-1, -2),  # xᵀ rows of 38
         torch.zeros(2, 36, 64, **f32)),
        (torch.zeros(1 + 2 * 64).narrow(0, 1, 2 * 64).view(2, 1, 64),
         torch.zeros(64, 128, **f32)),                  # x starts off 16 B
        (torch.zeros(2, 1, 64, **f32),                  # group stride 8194
         torch.zeros(2 * (64 * 128 + 2)).as_strided((2, 64, 128),
                                                    (64 * 128 + 2, 128, 1))),
    ]
    for x, w in cases:
        flags, plan = em.launch_plan(x, w)
        assert plan.variant == "simt" and plan.bm == 64, (x.shape, w.shape)
    flags, plan = em.launch_plan(torch.zeros(2, 1, 64, **f32),
                                 torch.zeros(64, 128, **f32))
    assert plan.variant == "skinny"
    flags, plan = em.launch_plan(
        torch.zeros(2, 36, 40, **f32).transpose(-1, -2),
        torch.zeros(2, 36, 64, **f32))
    assert flags == em.X_TRANS | em.W_PER_GROUP and plan.variant == "skinny"


def test_plan_row_boundary_between_skinny_and_tile():
    """Up to 64 rows a tile (flattened rows, or rows per group with
    per-group weights) the skinny product in 16-, 32- or 64-row tiles;
    above, the 128-row tensor-core tile."""
    for rows, bm in ((1, 16), (16, 16), (17, 32), (33, 64), (63, 64),
                     (64, 64)):
        plan = em._plan(1, rows, 256, 256, 0, True, SMS)
        assert (plan.variant, plan.bm) == ("skinny", bm)
        plan = em._plan(3, rows, 256, 256, em.W_PER_GROUP, True, SMS)
        assert (plan.variant, plan.bm) == ("skinny", bm)
    assert em._plan(1, 65, 256, 256, 0, True, SMS).variant == "tile"
    assert em._plan(5, 13, 96, 136, 0, True, SMS).variant == "tile"  # R 65
    assert em._plan(5, 13, 96, 136, em.W_PER_GROUP, True,
                    SMS).variant == "skinny"


def test_launch_counters_by_variant():
    assert set(elastic_dense.launches_by_variant) == set(em.VARIANTS)
    before = dict(elastic_dense.launches_by_variant)
    x = torch.zeros(2, 1, 64)
    elastic_dense(x, torch.zeros(64, 128))       # CPU: the plain version
    assert elastic_dense.launches_by_variant == before


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_card():
    """The hand-written kernels against their plain versions on the card
    (edges included); runs only where there is a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    dev = torch.device("cuda")
    worst = chip_smoke.phase_kernels(dev, d_model=256, d_ff=640, n_heads=8,
                                     n_kv=2, head_dim=128, slots=3,
                                     prompt_len=40)
    assert worst["elastic_dense"] <= chip_smoke.K1_TOL
    assert worst["flash_attention"] <= chip_smoke.K2_TOL
