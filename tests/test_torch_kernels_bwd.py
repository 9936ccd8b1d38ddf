"""The backward of the port's kernels against the JAX reference.

K1's closed VJP (``elastic_dense`` through its ``autograd.Function``, the
plain version behind each product on the CPU) against ``jax.vjp`` of the
reference's ``elastic_dense`` in interpret mode, ``vmap``ped over the
group axis for per-group weights and prefixes; K3/K4's plain versions
(the explicit backward formulas) against the reference's Pallas
``_bwd_call`` in interpret mode and ``jax.grad`` of its public
``flash_attention``. Same numpy-seeded inputs, ≤1e-5. Then the
``autograd.Function``s' CPU paths under ``torch.autograd.gradcheck`` in
float64. The CUDA kernels themselves run only on the card (``-m cuda``).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.elastic_matmul import elastic_dense as ref_edense
from repro.kernels.flash_attention import _block_sizes, _bwd_call, _fwd_call
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels.elastic_matmul import elastic_dense
from repro_torch.kernels.flash_attention import (FLASH_BWD_VARIANTS,
                                                 flash_attention,
                                                 flash_attention_dkv,
                                                 flash_attention_dkv_plain,
                                                 flash_attention_dq,
                                                 flash_attention_dq_plain)

torch.set_num_threads(2)
TOL = 1e-5


def _i32(vals):
    return torch.tensor(vals, dtype=torch.int32)


# (G, M, K, N, k_active, n_active, m_active, act, per_group_w, bias):
# per-group prefixes in {0, ragged, full} that differ between groups,
# shapes that are not multiples of the reference's 128-blocks
K1_CASES = [
    (3, 5, 150, 130, [150, 0, 77], [130, 64, 0], [5, 1, 5], "silu", True,
     False),
    (2, 9, 140, 135, [137, 140], [100, 135], [7, 9], "gelu", True, True),
    (3, 4, 64, 300, [10, 64, 33], [77, 1, 300], [0, 4, 2], "relu", True,
     False),
    (2, 6, 129, 70, [129, 50], [70, 9], [6, 6], None, False, True),
    (4, 3, 40, 24, [40, 40, 0, 17], [24, 5, 24, 24], [3, 2, 3, 1], "silu",
     False, False),
]


@pytest.mark.parametrize("G,M,K,N,ka,na,ma,act,per_group,bias", K1_CASES)
def test_elastic_dense_vjp_matches_reference(G, M, K, N, ka, na, ma, act,
                                             per_group, bias):
    """dx, dw (per-group or shared w, then summed over groups) and db of
    the closed VJP against jax.vjp of the vmapped reference."""
    rng = np.random.default_rng(G * 100 + K)
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    wshape = (G, K, N) if per_group else (K, N)
    w = (rng.standard_normal(wshape) / np.sqrt(K)).astype(np.float32)
    b = rng.standard_normal((N,)).astype(np.float32) if bias else None
    dy = rng.standard_normal((G, M, N)).astype(np.float32)

    def ref(xx, ww, bb):
        return jax.vmap(
            lambda xi, wi, k, n, m: ref_edense(
                xi, wi, bb, k_active=k, n_active=n, m_active=m, act=act,
                bm=8, interpret=True),
            in_axes=(0, 0 if per_group else None, 0, 0, 0))(
            xx, ww, jnp.asarray(ka, jnp.int32), jnp.asarray(na, jnp.int32),
            jnp.asarray(ma, jnp.int32))
    args = (jnp.asarray(x), jnp.asarray(w),
            None if b is None else jnp.asarray(b))
    y_ref, vjp = jax.vjp(ref, *args)
    grads_ref = vjp(jnp.asarray(dy))

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = None if b is None else torch.from_numpy(b).requires_grad_(True)
    y = elastic_dense(xt, wt, bt, k_active=_i32(ka), n_active=_i32(na),
                      m_active=_i32(ma), act=act)
    inputs = [xt, wt] + ([bt] if bt is not None else [])
    grads = torch.autograd.grad(y, inputs, torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=TOL, rtol=0)
    for got, want in zip(grads, grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)


def test_elastic_dense_backward_launches_nothing_on_cpu():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(
        np.float32)).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(
        np.float32)).requires_grad_(True)
    before = elastic_dense.launches
    y = elastic_dense(x, w, n_active=_i32([8, 3]), act="gelu")
    y.sum().backward()
    assert elastic_dense.launches == before
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    # wrong group count of a per-group weight
    with pytest.raises(ValueError):
        elastic_dense(x, w[:1])


def _flash_inputs(B, S, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, do


# (B, S, H, KV, D, h_active per row, causal, window, cap): causal, window,
# softcap, GQA 2:1 and 4:1, per-row prefixes including 0, S not a multiple
# of the reference's blocks
FLASH_BWD_CASES = [
    (3, 24, 4, 2, 32, [4, 2, 0], True, None, None),
    (2, 21, 4, 1, 32, [4, 4], True, 6, None),
    (1, 40, 8, 2, 32, [8], True, 16, 30.0),
    (2, 13, 4, 2, 64, [0, 4], False, 5, 20.0),
]


@pytest.mark.parametrize("B,S,H,KV,D,has,causal,window,cap",
                         FLASH_BWD_CASES)
def test_flash_backward_plain_matches_reference(B, S, H, KV, D, has,
                                                causal, window, cap):
    """dq / dk / dv of the plain versions against the Pallas backward
    (``_bwd_call``, interpret mode) run row by row with each row's own
    head prefix — how the reference's vmapped cohort gives every client
    its own prefix."""
    q, k, v, do = _flash_inputs(B, S, H, KV, D, seed=S * H + D)
    scale = 1.0 / np.sqrt(D)
    bq, bk = _block_sizes(S, S, 8, 16)
    kw = dict(causal=causal, window=window, cap=cap, scale=scale, bq=bq,
              bk=bk, interpret=True)
    want = {"dq": [], "dk": [], "dv": []}
    os_, lses = [], []
    for b, ha in enumerate(has):
        sl = slice(b, b + 1)
        ha_j = jnp.asarray([ha], jnp.int32)
        o, lse = _fwd_call(jnp.asarray(q[sl]), jnp.asarray(k[sl]),
                           jnp.asarray(v[sl]), ha_j, **kw)
        dq, dk, dv = _bwd_call(jnp.asarray(q[sl]), jnp.asarray(k[sl]),
                               jnp.asarray(v[sl]), jnp.asarray(do[sl]), o,
                               lse, ha_j, **kw)
        for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
            want[name].append(np.asarray(t))
        os_.append(np.asarray(o))
        lses.append(np.asarray(lse))
    o = torch.from_numpy(np.concatenate(os_))
    lse = torch.from_numpy(np.concatenate(lses))
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    delta = torch.einsum("bshd,bshd->bhs", dot, o)
    opts = dict(causal=causal, window=window, cap=cap)
    before = (flash_attention_dq.launches, flash_attention_dkv.launches)
    got = {"dq": flash_attention_dq(qt, kt, vt, dot, lse, delta, _i32(has),
                                    **opts)}
    got["dk"], got["dv"] = flash_attention_dkv(qt, kt, vt, dot, lse, delta,
                                               _i32(has), **opts)
    assert (flash_attention_dq.launches,
            flash_attention_dkv.launches) == before
    # the wrappers took the plain versions for CPU tensors
    assert torch.equal(got["dq"], flash_attention_dq_plain(
        qt, kt, vt, dot, lse, delta, _i32(has), **opts))
    assert torch.equal(got["dk"], flash_attention_dkv_plain(
        qt, kt, vt, dot, lse, delta, _i32(has), **opts)[0])
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[name].numpy(),
                                   np.concatenate(want[name]), atol=TOL,
                                   rtol=0, err_msg=name)
    dead = np.arange(H)[None, :] >= np.asarray(has)[:, None]     # (B, H)
    assert np.all(got["dq"].numpy().transpose(0, 2, 1, 3)[dead] == 0)


def test_flash_autograd_matches_reference_grad():
    """The differentiable ``flash_attention`` (K2 forward, K3/K4 backward
    on its saved o and lse) against ``jax.grad`` of the reference's public
    ``flash_attention`` with a head mask."""
    B, S, H, KV, D = 2, 24, 4, 2, 32
    q, k, v, do = _flash_inputs(B, S, H, KV, D, seed=3)
    head_mask = np.array([1, 1, 0, 0], np.float32)

    def ref(qq, kk, vv):
        o = ref_flash(qq, kk, vv, jnp.asarray(head_mask), causal=True,
                      window=10, cap=25.0, bq=8, bk=8, interpret=True)
        return jnp.sum(o * jnp.asarray(do))
    want = jax.grad(ref, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o, _ = flash_attention(*ts, _i32([2, 2]), causal=True, window=10,
                           cap=25.0)
    got = torch.autograd.grad(o, ts, torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("per_group,act", [(True, "silu"), (True, None),
                                           (False, "gelu")])
def test_elastic_dense_gradcheck(per_group, act):
    gen = torch.Generator().manual_seed(0)
    G, M, K, N = 3, 4, 6, 5
    x = torch.randn((G, M, K), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn((G, K, N) if per_group else (K, N), generator=gen,
                    dtype=torch.float64, requires_grad=True)
    b = torch.randn((N,), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    pre = dict(k_active=_i32([6, 0, 3]), n_active=_i32([5, 2, 5]),
               m_active=_i32([4, 4, 1]))
    assert torch.autograd.gradcheck(
        lambda a, c, d: elastic_dense(a, c, d, act=act, **pre), (x, w, b))


@pytest.mark.parametrize("causal,window,cap,has", [
    (True, None, None, [4, 2]), (True, 3, 2.0, [4, 0]),
    (False, None, 3.0, None)])
def test_flash_gradcheck(causal, window, cap, has):
    gen = torch.Generator().manual_seed(1)
    B, S, H, KV, D = 2, 7, 4, 2, 4
    ts = [torch.randn(shape, generator=gen, dtype=torch.float64,
                      requires_grad=True)
          for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]
    ha = None if has is None else _i32(has)
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention(q, k, v, ha, causal=causal,
                                        window=window, cap=cap)[0], ts)


@pytest.mark.cuda
def test_cuda_backward_matches_plain_on_card():
    """K1's closed VJP and K3/K4 on the card against the same functions on
    the CPU (their plain versions): the autograd path (the plan's variant)
    and each of K3 / K4's variants called directly; runs only where there
    is a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((3, 70, 130), generator=gen)
    w = torch.randn((3, 130, 90), generator=gen) / 12
    pre = dict(k_active=_i32([130, 64, 0]), n_active=_i32([90, 3, 45]))
    dy = torch.randn((3, 70, 90), generator=gen)
    grads = []
    for d in ("cpu", dev):
        xs = x.to(d).requires_grad_(True)
        ws = w.to(d).requires_grad_(True)
        y = elastic_dense(xs, ws, act="silu",
                          **{k: v.to(d) for k, v in pre.items()})
        grads.append([g.cpu() for g in torch.autograd.grad(y, (xs, ws),
                                                           dy.to(d))])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= chip_smoke.K1_TOL
    q, k, v, do = (torch.from_numpy(a) for a in _flash_inputs(
        3, 37, 8, 2, 64, seed=4))
    grads = []
    for d in ("cpu", dev):
        ts = [t.to(d).requires_grad_(True) for t in (q, k, v)]
        o, _ = flash_attention(*ts, _i32([8, 0, 4]).to(d), causal=True,
                               window=9, cap=30.0)
        grads.append([g.cpu() for g in torch.autograd.grad(o, ts,
                                                           do.to(d))])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= chip_smoke.K34_TOL
    q, k, v = (t.detach() for t in (q, k, v))   # the loop set requires_grad
    ha = _i32([8, 0, 4])
    kw = dict(causal=True, window=9, cap=30.0)
    o, lse = flash_attention(q, k, v, ha, **kw)
    delta = torch.einsum("bshd,bshd->bhs", do, o)
    args = (q, k, v, do, lse, delta, ha)
    want = (flash_attention_dq(*args, **kw),) + flash_attention_dkv(*args,
                                                                    **kw)
    on_card = [t.to(dev) for t in args]
    for variant in FLASH_BWD_VARIANTS:
        got = (flash_attention_dq(*on_card, variant=variant, **kw),) + \
            flash_attention_dkv(*on_card, variant=variant, **kw)
        for a, b in zip(got, want):
            assert float((a.cpu() - b).abs().max()) <= chip_smoke.K34_TOL


# C3: the flash case that once missed K34_TOL on the card, looped with
# every SM's shared memory left full of NaN and ±1e30 before each launch
C3_LOOPS = 2000
C3_KW = dict(causal=True, window=9, cap=30.0)
C3_NAMES = ("autograd dq", "autograd dk", "autograd dv", "mma dq", "mma dk",
            "mma dv")


def _dirty(shape, gen, device):
    """NaN, +1e30 and -1e30 in a seeded pattern."""
    vals = torch.tensor([float("nan"), 1e30, -1e30], device=device)
    return vals[torch.randint(0, 3, shape, generator=gen).to(device)]


def c3_loop(loops, device, log=None):
    """The C3 case — S = 37, 8 / 2 heads of 64, window 9, softcap 30, head
    prefixes 8 / 0 / 4 — on the card ``loops`` times: K2 and the autograd
    backward (delta, K3, K4), then K3 / K4's mma variant on K2's lse and
    delta directly. Before each run K1 and K5 (their tensor-core tiles), K2
    and K3 / K4 (mma, at 24 rows of 128 tokens: blocks on every SM) run on
    NaN / ±1e30 inputs, so any shared memory or register a kernel reads
    before it writes holds garbage. Every run is held bit-equal to the
    first, and the first within K34_TOL of the plain versions on the CPU.
    Returns {"errors": max|card − plain| per output of the first run,
    "mismatches": [(run, output, max|Δ|, [(batch row, query row, head,
    column), ...]), ...]}; ``log`` (a callable) gets a line per mismatch."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    gen = torch.Generator().manual_seed(19)
    dirt = {n: _dirty(s, gen, device) for n, s in (
        ("x1", (2, 256, 1024)), ("w1", (2, 1024, 512)),
        ("x5", (2, 8, 160, 512)), ("w5", (2, 8, 512, 256)),
        ("q", (24, 128, 8, 64)), ("k", (24, 128, 2, 64)),
        ("v", (24, 128, 2, 64)), ("lse", (24, 8, 128)))}
    ga5 = torch.tensor([8, 5], dtype=torch.int32, device=device)

    def smear():
        elastic_dense(dirt["x1"], dirt["w1"], act="silu")
        grouped_matmul(dirt["x5"], dirt["w5"], ga5)
        qd, kd, vd = dirt["q"], dirt["k"], dirt["v"]
        flash_attention(qd, kd, vd, window=9, cap=30.0)
        bad = (qd, kd, vd, qd, dirt["lse"], dirt["lse"])
        flash_attention_dq(*bad, variant="mma", **C3_KW)
        flash_attention_dkv(*bad, variant="mma", **C3_KW)

    q, k, v, do = (torch.from_numpy(a) for a in _flash_inputs(
        3, 37, 8, 2, 64, seed=4))
    ha = _i32([8, 0, 4])
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = flash_attention(*ts, ha, **C3_KW)
    want = list(torch.autograd.grad(o, ts, do))
    delta = torch.einsum("bshd,bshd->bhs", do, o.detach())
    args = (q, k, v, do, lse.detach(), delta, ha)
    want += [flash_attention_dq(*args, **C3_KW),
             *flash_attention_dkv(*args, **C3_KW)]
    ts = [t.to(device).requires_grad_(True) for t in (q, k, v)]
    ha_d, do_d = ha.to(device), do.to(device)
    first, mismatches = None, []
    for run in range(loops):
        smear()
        o, lse = flash_attention(*ts, ha_d, **C3_KW)
        outs = list(torch.autograd.grad(o, ts, do_d))
        o, lse = o.detach(), lse.detach()
        delta = (do_d * o).sum(-1).transpose(1, 2).contiguous()
        direct = (ts[0].detach(), ts[1].detach(), ts[2].detach(), do_d, lse,
                  delta, ha_d)
        outs += [flash_attention_dq(*direct, variant="mma", **C3_KW),
                 *flash_attention_dkv(*direct, variant="mma", **C3_KW)]
        if first is None:
            first = outs
            errors = {n: float((a.cpu() - b).abs().max())
                      for n, a, b in zip(C3_NAMES, outs, want)}
            continue
        for name, a, b in zip(C3_NAMES, outs, first):
            if torch.equal(a, b):
                continue
            diff = (a - b).abs()
            where = [tuple(int(i) for i in ix)
                     for ix in diff.nan_to_num(1e30).nonzero()[:6].tolist()]
            err = float((a.cpu() - want[C3_NAMES.index(name)]).abs().max())
            mismatches.append((run, name, float(diff.max()), where, err))
            if log:
                log(f"run {run}: {name} differs from run 0 by "
                    f"{float(diff.max()):.3e} at (batch row, row, head, "
                    f"column) {where}; max|card - plain| {err:.3e}")
    return {"errors": errors, "mismatches": mismatches,
            "tol": chip_smoke.K34_TOL}


@pytest.mark.cuda
def test_cuda_flash_backward_repeats_over_dirty_shared_memory():
    """C3: K2 → delta → K3 / K4 on the case that once missed K34_TOL,
    ``C3_LOOPS`` times, each after K1, K5, K2 and K3 / K4 launches on NaN /
    ±1e30 inputs: every run bit-equal to the first, the first within
    K34_TOL of the plain versions. Runs only where there is a CUDA
    device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    report = c3_loop(C3_LOOPS, torch.device("cuda", 0))
    assert not report["mismatches"], report["mismatches"][:5]
    assert max(report["errors"].values()) <= report["tol"], report["errors"]
