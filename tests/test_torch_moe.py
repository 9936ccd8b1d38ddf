"""The port's MoE slice against the JAX reference.

Each module that holds a kernel, and the slice as a whole, on numpy-seeded
inputs at ``reduced(granite-moe-1b-a400m, n_layers=2, d_model=64)`` (32
experts become 4, top-8 becomes top-2, d_ff_expert 32; 4 query / 2 KV
heads of 16 so that the head prefix is elastic):

* K5 ``grouped_matmul`` (shared and per-group weights, prefixes 0 / ragged
  / full, shapes that are not tile multiples), forward and both gradients,
  against the reference's ``grouped_elastic_matmul`` in Pallas interpret
  mode; K6 / K7 against ``gather_rows`` / ``gather_reduce``, and the
  ``moe_dispatch → grouped matmul → moe_combine`` chain in value and
  gradient against the reference's chain;
* ``moe_forward`` (y, aux, and identical routing: the same top-k ids and
  kept flags) against the reference's vmapped over groups, with and
  without expert masks, with a shared expert, with capacity drops;
* the parent's forward, coverage, round, router gradient, server, CLI and
  the kernels on the card: ``tests/test_torch_moe_model.py``.

Tolerances: 1e-5 for one op, one forward or one round (the reference's own
per-op bound); identical greedy tokens and 1e-4 logits for a multi-step
decode. On the CPU the port runs its kernels' plain versions;
``tests/test_torch_moe_model.py``'s ``-m cuda`` test holds the kernels to them
on a card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.core.submodel import TransformerSubSpec as RefSpec
from repro.kernels.grouped_matmul import grouped_elastic_matmul
from repro.kernels.moe_dispatch import gather_reduce as ref_gather_reduce
from repro.kernels.moe_dispatch import gather_rows as ref_gather_rows
from repro.kernels.moe_dispatch import moe_combine as ref_moe_combine
from repro.kernels.moe_dispatch import moe_dispatch as ref_moe_dispatch
from repro.models import moe as ref_moe
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.dispatch import kernel_dispatch
from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                grouped_matmul_plain)
from repro_torch.kernels.moe_dispatch import (gather_reduce, gather_rows,
                                              moe_combine, moe_dispatch)
from repro_torch.models import moe

torch.set_num_threads(2)
TOL = 1e-5
SLICE_TOL = 1e-4
ARCH = "granite-moe-1b-a400m"


def _configs(**moe_kw):
    heads = dict(n_heads=4, n_kv_heads=2, head_dim=16)
    ref = ref_reduced(REF_ARCHS[ARCH], n_layers=2, d_model=64)
    port = reduced(ARCHS[ARCH], n_layers=2, d_model=64)
    ref = dataclasses.replace(ref, moe=dataclasses.replace(ref.moe, **moe_kw),
                              **heads)
    port = dataclasses.replace(port,
                               moe=dataclasses.replace(port.moe, **moe_kw),
                               **heads)
    return ref, port


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_specs(specs):
    return [RefSpec(s.layers, s.ff_frac, s.expert_frac, s.ssm_head_frac,
                    s.attn_head_frac) for s in specs]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _leaves_close(got, want, tol):
    a, b = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _close(x, y, tol)


# ---------------------------------------------------------------------------
# K5: the grouped expert-prefix matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shared", [True, False])
def test_grouped_matmul_matches_reference(shared):
    """Forward and both gradients (through the closed VJP, each product
    the plain version on the CPU) against the reference's Pallas kernel in
    interpret mode, one call per group (the reference's ``vmap``)."""
    G, E, M, K, N = 3, 4, 13, 20, 11
    ga = np.array([0, 2, 4], np.int32)          # prefix 0, ragged, full
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((G, E, M, K)).astype(np.float32)
    ws = rng.standard_normal(((E,) if shared else (G, E)) + (K, N)).astype(
        np.float32)
    dy = rng.standard_normal((G, E, M, N)).astype(np.float32)
    want_y, want_dx, want_dw = [], [], []
    for g in range(G):
        w_g = jnp.asarray(ws if shared else ws[g])

        def f(x, w, g=g):
            return grouped_elastic_matmul(x, w, jnp.int32(ga[g]), bm=8,
                                          bn=128, bk=128)
        y, vjp = jax.vjp(f, jnp.asarray(xs[g]), w_g)
        dx, dw = vjp(jnp.asarray(dy[g]))
        want_y.append(np.asarray(y))
        want_dx.append(np.asarray(dx))
        want_dw.append(np.asarray(dw))
    want_dw = np.sum(want_dw, 0) if shared else np.stack(want_dw)
    x_t = torch.from_numpy(xs).requires_grad_(True)
    w_t = torch.from_numpy(ws).requires_grad_(True)
    y = grouped_matmul(x_t, w_t, torch.from_numpy(ga))
    y.backward(torch.from_numpy(dy))
    _close(y.detach(), np.stack(want_y))
    _close(x_t.grad, np.stack(want_dx))
    _close(w_t.grad, want_dw)
    for g in range(G):                    # dead experts are exactly zero
        assert not y[g, ga[g]:].any() and not x_t.grad[g, ga[g]:].any()
    # no prefix: every expert live
    full = grouped_matmul(x_t.detach(), w_t.detach())
    _close(full, grouped_matmul_plain(x_t.detach(), w_t.detach(),
                                      torch.full((G,), E, dtype=torch.int32)))


def test_grouped_matmul_reads_transposed_and_strided_operands():
    """The VJP's operands are views: a transposed xs / ws and one layer of
    a client-stacked (G, L, E, K, N) weight give what contiguous copies
    give (the layout the kernel reads in place on the card)."""
    rng = np.random.default_rng(1)
    G, L, E, M, K, N = 2, 3, 4, 5, 7, 6
    stack = torch.from_numpy(rng.standard_normal((G, L, E, K, N)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((G, E, K, M)).astype(
        np.float32)).transpose(-1, -2)
    ga = torch.tensor([3, 1], dtype=torch.int32)
    got = grouped_matmul(x, stack[:, 1], ga)
    want = grouped_matmul(x.contiguous(), stack[:, 1].contiguous(), ga)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    wt = stack[0, 2].transpose(-1, -2).contiguous().transpose(-1, -2)
    torch.testing.assert_close(grouped_matmul(x, wt, ga),
                               grouped_matmul(x, wt.contiguous(), ga),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="int32"):
        grouped_matmul(x, wt, ga.long())
    with pytest.raises(ValueError, match="required"):
        grouped_matmul(x[0], wt, ga)


# ---------------------------------------------------------------------------
# K6 / K7 and the dispatch → compute → combine chain
# ---------------------------------------------------------------------------
def test_gather_kernels_match_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((9, 12)).astype(np.float32)
    idx = np.array([0, 8, 3, 11, 5, 2, 40], np.int32)     # two out of range
    valid = np.array([1, 1, 0, 1, 1, 0, 1], np.int32)
    got = gather_rows(torch.from_numpy(x), torch.from_numpy(idx),
                      torch.from_numpy(valid))
    want = ref_gather_rows(jnp.asarray(x), jnp.asarray(idx),
                           jnp.asarray(valid), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dest = rng.integers(0, 12, (5, 3)).astype(np.int32)
    gates = rng.random((5, 3)).astype(np.float32)
    dest[1, 2], gates[1, 2] = 99, 0.0          # out of range, gate 0
    got = gather_reduce(torch.from_numpy(x), torch.from_numpy(dest),
                        torch.from_numpy(gates))
    want = ref_gather_reduce(jnp.asarray(x), jnp.asarray(dest),
                             jnp.asarray(gates), interpret=True)
    _close(got, want, 1e-6)


def _route_tables(T, k, E, cap, ga, seed):
    """The reference test's slot / assignment tables (random expert
    choices, stable first-come-first-kept capacity, experts >= ga masked):
    numpy int32."""
    rng = np.random.RandomState(seed)
    flat = rng.randint(0, E, size=(T, k)).reshape(-1)
    pos = np.zeros(T * k, np.int64)
    counts = np.zeros(E, np.int64)
    for a in np.argsort(flat, kind="stable"):
        pos[a] = counts[flat[a]]
        counts[flat[a]] += 1
    kept = (pos < cap) & (flat < ga)
    dest = np.where(kept, flat * cap + pos, E * cap)
    slot_src = np.zeros(E * cap, np.int64)
    slot_valid = np.zeros(E * cap, np.int64)
    for a in range(T * k):
        if kept[a]:
            slot_src[dest[a]] = a // k
            slot_valid[dest[a]] = 1
    return tuple(a.astype(np.int32) for a in (kept, dest, slot_src,
                                              slot_valid))


@pytest.mark.parametrize("ga,cap", [(0, 8), (2, 3), (3, 8), (4, 3)])
def test_dispatch_matmul_combine_chain_matches_reference(ga, cap):
    """The chain (both gathers and their gather-closed VJPs, K5 between
    them) against the reference's Pallas chain: values and gradients in
    the tokens, the gates and the expert weights — dropped tokens
    (cap < demand), masked experts (ga < E), ga ∈ {0, E}."""
    T, k, E, d = 16, 2, 4, 32
    kept, dest, src, valid = _route_tables(T, k, E, cap, ga, ga * 5 + cap)
    rng = np.random.default_rng(ga + cap)
    xt = rng.standard_normal((T, d)).astype(np.float32)
    logits = rng.standard_normal((T, k)).astype(np.float32)
    gates = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ws = (rng.standard_normal((E, d, d)) / np.sqrt(d)).astype(np.float32)
    cot = rng.standard_normal((T, d)).astype(np.float32)
    keptf = kept.astype(np.float32)
    slot_gate = np.zeros(E * cap + 1, np.float32)
    slot_gate[dest] = gates.reshape(-1) * keptf
    slot_gate = slot_gate[:-1]

    def chain_r(x, g, w):
        eb = ref_moe_dispatch(x, src, valid, dest, kept, n_experts=E,
                              cap=cap, interpret=True)
        y = grouped_elastic_matmul(eb, w, jnp.int32(ga), bm=8, bn=128,
                                   bk=128)
        return ref_moe_combine(y.reshape(E * cap, d),
                               g * keptf.reshape(T, k), dest, src, valid,
                               jnp.asarray(slot_gate), interpret=True)
    want, vjp = jax.vjp(chain_r, jnp.asarray(xt), jnp.asarray(gates),
                        jnp.asarray(ws))
    want_grads = vjp(jnp.asarray(cot))

    t = {n: torch.from_numpy(a).requires_grad_(True)
         for n, a in (("x", xt), ("g", gates), ("w", ws))}
    i32 = torch.from_numpy
    eb = moe_dispatch(t["x"], i32(src), i32(valid), i32(dest), i32(kept),
                      n_experts=E, cap=cap)
    assert eb.shape == (1, E, cap, d)
    y = grouped_matmul(eb, t["w"], torch.tensor([ga], dtype=torch.int32))
    out = moe_combine(y.reshape(E * cap, d),
                      t["g"] * torch.from_numpy(keptf).reshape(T, k),
                      i32(dest), i32(src), i32(valid),
                      torch.from_numpy(slot_gate))
    out.backward(torch.from_numpy(cot))
    _close(out.detach(), want)
    for name, w in zip(("x", "g", "w"), want_grads):
        _close(t[name].grad, w)


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------
def _ref_routing(router, x, moe_cfg, mask):
    """The reference's routing of one group: top-k ids and the kept flags
    of its sort-based capacity rule (numpy, (t, j) order)."""
    logits = (jnp.asarray(x) @ jnp.asarray(router)).astype(jnp.float32)
    if mask is not None:
        logits = jnp.where(mask[None, :] > 0, logits, ref_moe.NEG_INF)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), moe_cfg.top_k)
    idx = np.asarray(idx)
    T, k, E = idx.shape[0], moe_cfg.top_k, moe_cfg.n_experts
    cap = moe.capacity(T, moe_cfg)
    ga = E if mask is None else int(np.sum(np.asarray(mask) > 0))
    flat = idx.reshape(-1)
    pos = np.zeros(T * k, np.int64)
    counts = np.zeros(E, np.int64)
    for a in np.argsort(flat, kind="stable"):
        pos[a] = counts[flat[a]]
        counts[flat[a]] += 1
    return idx, ((pos < cap) & (flat < ga)).reshape(T, k)


@pytest.mark.parametrize("mask_kind,n_shared,cap_factor", [
    (None, 0, 1.25), ("shared", 0, 1.25), ("per-group", 0, 0.5),
    ("per-group", 1, 1.25)])
def test_moe_forward_matches_vmapped_reference(mask_kind, n_shared,
                                               cap_factor):
    """y, aux and the routing (top-k ids and kept flags identical) against
    the reference's ``moe_forward`` vmapped over groups — per-group
    weights, a mask shared by the groups or one per group, a shared
    expert, and a capacity factor that drops tokens — on both of the
    port's paths (the kernels' plain versions and the dense one)."""
    ref_cfg, cfg = _configs(n_shared=n_shared, capacity_factor=cap_factor)
    G, T, d, E = 3, 24, cfg.d_model, cfg.moe.n_experts
    rng = np.random.default_rng(3)
    base = _np(ref_moe.moe_init(jax.random.PRNGKey(1), d, ref_cfg.moe))
    p = jax.tree.map(lambda a: (a[None] + 0.05 * rng.standard_normal(
        (G,) + a.shape)).astype(np.float32), base)
    x = rng.standard_normal((G, T, d)).astype(np.float32)
    masks = {None: None,
             "shared": np.array([1, 1, 1, 0], np.float32),
             "per-group": np.array([[1, 1, 0, 0], [1, 1, 1, 1],
                                    [1, 1, 1, 0]], np.float32)}
    mask = masks[mask_kind]
    gm = (np.broadcast_to(mask, (G, E)) if mask is not None
          else np.ones((G, E), np.float32))

    def one(pp, xx, mm):
        return ref_moe.moe_forward(pp, xx[None], ref_cfg.moe, act="silu",
                                   expert_mask=None if mask is None else mm)
    want_y, want_aux = jax.jit(jax.vmap(one))(p, jnp.asarray(x),
                                              jnp.asarray(gm))
    tp = params_from_numpy(p, device="cpu")
    tmask = None if mask is None else torch.from_numpy(mask)
    xt = torch.from_numpy(x)
    _, _, gates, idx = moe.route(tp["router"], xt, cfg.moe, tmask)
    tables = moe.slot_tables(idx, gates, E=E, cap=moe.capacity(T, cfg.moe),
                             expert_mask=tmask)
    kept_tj = torch.empty_like(tables.kept).scatter(1, tables.order,
                                                    tables.kept)
    for g in range(G):
        want_idx, want_kept = _ref_routing(
            p["router"][g], x[g], ref_cfg.moe,
            None if mask is None else jnp.asarray(gm[g]))
        np.testing.assert_array_equal(idx[g].numpy(), want_idx)
        np.testing.assert_array_equal(kept_tj[g].reshape(T, -1).numpy(),
                                      want_kept)
    if cap_factor < 1.0:
        assert not kept_tj.all()                     # the case drops tokens
    for backend in ("auto", None):
        y, aux = moe.moe_forward(tp, xt, cfg.moe, act="silu",
                                 expert_mask=tmask,
                                 kernel=(kernel_dispatch(backend).table()
                                         or {}).get("moe"))
        _close(y, np.asarray(want_y)[:, 0])
        for name in ("aux_loss", "z_loss"):
            _close(aux[name], np.asarray(want_aux[name]), 1e-7)
