"""The kernel-layer entry points and per-arch configs against the JAX
reference, and the tile-accounting gate's plain versions against the
reference's oracles:

* ``kernels/ops.py``'s aliases (``attention_op``, ``ssd_op``,
  ``elastic_mlp_matmul``, ``model_kernels``) and the PR-1
  ``elastic_matmul`` against the reference's, run as its own tests run
  them (Pallas interpret mode) at small shapes, ≤ 1e-5;
* each ``configs/<arch>.py``'s ``get_config()`` is ``ARCHS[arch]`` and
  equals the reference's config field for field;
* at each fraction of the gate's sweep, the port's plain versions (what
  the gate holds the kernels to) against the reference's
  ``kernels/ref.py`` oracles, forward and VJP, ≤ 1e-5 with the
  reference's scale-relative ``_err``.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, config_fingerprint
from repro_torch.kernels import ops
from repro_torch.kernels.elastic_conv import elastic_conv2d_plain
from repro_torch.kernels.elastic_matmul import (elastic_dense_plain,
                                                elastic_matmul)
from repro_torch.kernels.flash_attention import flash_attention_fwd_plain
from repro_torch.kernels.grouped_matmul import grouped_matmul_plain
from repro_torch.kernels.moe_dispatch import (gather_reduce_plain,
                                              gather_rows_plain)
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.launch import elastic_kernels as ek

torch.set_num_threads(2)
TOL = 1e-5
ARCH_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b", "gemma2-9b": "gemma2_9b",
    "gemma-7b": "gemma_7b", "granite-3-8b": "granite_3_8b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "hubert-xlarge": "hubert_xlarge",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "mamba2-2.7b": "mamba2_2_7b", "qwen3-4b": "qwen3_4b",
    "zamba2-1.2b": "zamba2_1_2b"}


@pytest.fixture(scope="module")
def ref():
    """The reference's entry points, oracles and configs."""
    import types

    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as REF_ARCHS
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref as oracles
    from repro.kernels.elastic_matmul import elastic_matmul as ref_em
    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=ref_ops, ref=oracles,
                                 elastic_matmul=ref_em, archs=REF_ARCHS)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _n(t):
    return t.detach().numpy()


def _err(a, b):
    """The reference's ``_err``: max |a − b| over max(max |b|, 1)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1.0))


# ---------------------------------------------------------------------------
# ops.py and the PR-1 entry point against the reference's (interpret mode)
# ---------------------------------------------------------------------------
def test_attention_op_matches_reference(ref):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 32, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 32, 2, 32)).astype(np.float32)
            for _ in range(2))
    hm = np.array([1, 1, 1, 0], np.float32)
    want = ref.ops.attention_op(*(ref.jnp.asarray(a) for a in (q, k, v)),
                                causal=True, head_mask=ref.jnp.asarray(hm),
                                interpret=True, bq=16, bk=16)
    for backend in ("auto", None):
        got = ops.attention_op(_t(q), _t(k), _t(v), causal=True,
                               head_mask=_t(hm), backend=backend)
        assert _err(_n(got), want) <= TOL, backend


def test_ssd_op_matches_reference(ref):
    rng = np.random.default_rng(1)
    R, S, H, P, G, N = 2, 32, 4, 8, 2, 8
    xh = rng.standard_normal((R, S, H, P)).astype(np.float32)
    dt = (0.01 + 0.3 * rng.random((R, S, H))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm, Cm = (rng.standard_normal((R, S, G, N)).astype(np.float32)
              for _ in range(2))
    hm = np.array([1, 1, 1, 0], np.float32)
    want, _ = ref.ops.ssd_op(*(ref.jnp.asarray(a) for a in
                               (xh, dt, A, Bm, Cm)), 16,
                             head_mask=ref.jnp.asarray(hm), interpret=True)
    for backend in ("auto", None):
        got, state = ops.ssd_op(*(_t(a) for a in (xh, dt, A, Bm, Cm)), 16,
                                head_mask=_t(hm), backend=backend)
        assert state is None
        assert _err(_n(got), want) <= TOL, backend


@pytest.mark.parametrize("k_active", [0, 77, 130])
def test_elastic_mlp_matmul_and_pr1_entry_match_reference(ref, k_active):
    rng = np.random.default_rng(k_active)
    x = rng.standard_normal((2, 35, 200)).astype(np.float32)
    w = (rng.standard_normal((200, 130)) / 14).astype(np.float32)
    want = ref.ops.elastic_mlp_matmul(ref.jnp.asarray(x), ref.jnp.asarray(w),
                                      k_active, interpret=True)
    for backend in ("auto", None):
        got = ops.elastic_mlp_matmul(_t(x), _t(w), k_active, backend=backend)
        assert got.shape == (2, 35, 130)
        assert _err(_n(got), want) <= TOL, backend
    want = ref.elastic_matmul(ref.jnp.asarray(x[0]), ref.jnp.asarray(w),
                              k_active, interpret=True)
    got = elastic_matmul(_t(x[0]), _t(w),
                         torch.tensor(k_active, dtype=torch.int32))
    assert _err(_n(got), want) <= TOL
    assert not _n(got)[:, k_active:].any()


def test_model_kernels_table(ref):
    assert set(ops.model_kernels()) == \
        set(ref.ops.model_kernels(interpret=True))
    assert ops.model_kernels(None) is None


# ---------------------------------------------------------------------------
# the per-arch config modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCH_MODULES))
def test_arch_config_module_equals_reference(ref, arch):
    mod = importlib.import_module(f"repro_torch.configs."
                                  f"{ARCH_MODULES[arch]}")
    ref_mod = importlib.import_module(f"repro.configs.{ARCH_MODULES[arch]}")
    cfg = mod.get_config()
    assert cfg is ARCHS[arch] is mod.CONFIG
    assert ref_mod.get_config() is ref.archs[arch]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_mod.get_config())
    assert config_fingerprint(cfg) == \
        importlib.import_module("repro.configs.base").config_fingerprint(
            ref_mod.get_config())


def test_every_reference_arch_has_a_module(ref):
    assert set(ARCH_MODULES) == set(ref.archs) == set(ARCHS)


# ---------------------------------------------------------------------------
# the gate's plain versions against the reference's oracles
# ---------------------------------------------------------------------------
def _vjp_errs(ref, port_fn, ref_fn, args, cot):
    """Forward and VJP errors of the port's plain ``port_fn`` (torch)
    against the reference's ``ref_fn`` (jax) on the same numpy inputs."""
    leaves = [_t(a).requires_grad_(True) for a in args]
    y = port_fn(*leaves)
    grads = torch.autograd.grad(y, leaves, _t(cot))
    jargs = [ref.jnp.asarray(a) for a in args]
    want, vjp = ref.jax.vjp(ref_fn, *jargs)
    want_g = vjp(ref.jnp.asarray(cot))
    return [_err(_n(y), want)] + [_err(_n(g), w)
                                  for g, w in zip(grads, want_g)]


@pytest.mark.parametrize("f", ek.FRACS)
def test_plain_mlp_and_moe_match_oracles(ref, f):
    rng = np.random.default_rng(int(f * 100))
    M, K, N = 40, 96, 160
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    cot = rng.standard_normal((M, N)).astype(np.float32)
    na, ka = int(f * N), int(f * K)
    i32 = lambda v: torch.tensor([v], dtype=torch.int32)   # noqa: E731
    errs = _vjp_errs(
        ref, lambda x, w: elastic_dense_plain(x[None], w, n_active=i32(na))[0],
        lambda x, w: ref.ref.elastic_dense_ref(x, w, n_active=na),
        (x, w), cot)
    xd = x * (np.arange(K) < ka)
    errs += _vjp_errs(
        ref, lambda x, w: elastic_dense_plain(x[None], w, k_active=i32(ka))[0],
        lambda x, w: ref.ref.elastic_dense_ref(x, w, k_active=ka),
        (xd, w[:, :64].copy()), cot[:, :64].copy())
    E = 8
    ga = max(1, int(f * E))
    xs = rng.standard_normal((E, 16, 32)).astype(np.float32)
    ws = rng.standard_normal((E, 32, 24)).astype(np.float32)
    errs += _vjp_errs(
        ref, lambda xs, ws: grouped_matmul_plain(xs[None], ws, i32(ga))[0],
        lambda xs, ws: ref.ref.grouped_elastic_matmul_ref(xs, ws, ga),
        (xs, ws), rng.standard_normal((E, 16, 24)).astype(np.float32))
    assert max(errs) <= TOL, errs


@pytest.mark.parametrize("f", ek.FRACS)
def test_plain_attention_and_ssd_match_oracles(ref, f):
    rng = np.random.default_rng(10 + int(f * 100))
    B, S, H, KV, D = 2, 24, 4, 2, 16
    ha = max(1, int(f * H))
    hm = (np.arange(H) < ha).astype(np.float32)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, D)).astype(np.float32)
            for _ in range(2))
    hat = torch.full((B,), ha, dtype=torch.int32)
    errs = _vjp_errs(
        ref, lambda q, k, v: flash_attention_fwd_plain(q, k, v, hat)[0],
        lambda q, k, v: ref.ref.flash_attention_ref(q, k, v)
        * hm[None, None, :, None], (q, k, v),
        rng.standard_normal((B, S, H, D)).astype(np.float32))
    R, P, N, Q = 2, 8, 8, 8
    xh = rng.standard_normal((R, S, H, P)).astype(np.float32)
    dt = (0.01 + 0.3 * rng.random((R, S, H))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm, Cm = (rng.standard_normal((R, S, H, N)).astype(np.float32)
              for _ in range(2))
    hr = torch.full((R,), ha, dtype=torch.int32)
    errs += _vjp_errs(
        ref, lambda *a: ssd_scan_plain(*a, Q, hr),
        lambda *a: ref.ref.ssd_ref(*a)[0] * hm[None, None, :, None],
        (xh, dt, A, Bm, Cm),
        rng.standard_normal((R, S, H, P)).astype(np.float32))
    assert max(errs) <= TOL, errs


@pytest.mark.parametrize("f", ek.FRACS)
def test_plain_dispatch_and_conv_match_oracles(ref, f):
    T, k, E, cap, d = 64, 2, 8, 16, 32
    op = ek.DispatchOp(T, k, E, cap, d)
    dest, kept, src, valid = op._route(f)
    rng = np.random.default_rng(20 + int(f * 100))
    xt = rng.standard_normal((T, d)).astype(np.float32)
    gate_eff = (op._gates() * kept.reshape(T, k)).astype(np.float32)
    jnp = ref.jnp

    def dense(xt, ge):            # the reference bench's dense chain
        ebr = jnp.where(jnp.asarray(valid)[:, None] > 0,
                        xt[jnp.clip(jnp.asarray(src), 0, T - 1)], 0.0)
        yk = (ebr * 1.5)[jnp.clip(jnp.asarray(dest), 0, E * cap - 1)]
        return jnp.einsum("tj,tjd->td", ge, yk.reshape(T, k, d))

    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32)   # noqa: E731
    errs = _vjp_errs(
        ref, lambda xt, ge: gather_reduce_plain(
            gather_rows_plain(xt, i32(src), i32(valid)) * 1.5,
            i32(dest).reshape(T, k), ge), dense, (xt, gate_eff),
        rng.standard_normal((T, d)).astype(np.float32))
    C = 16
    ca = max(1, int(f * C))
    x = (rng.standard_normal((2, 6, 6, C)) * (np.arange(C) < ca)
         ).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, C)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32)
    cat = torch.tensor([ca], dtype=torch.int32)
    got = elastic_conv2d_plain(_t(x)[None], _t(w), _t(b), stride=1,
                               cin_active=cat, cout_active=cat)[0]
    want = ref.ref.elastic_conv2d_ref(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), stride=1,
                                      cin_active=ca, cout_active=ca)
    errs.append(_err(_n(got), want))
    assert max(errs) <= TOL, errs
