"""K3 / K4's mma variant (``csrc/flash_attention_bwd.cu``): its launch plan,
its order of work and its shared-memory layout, on the CPU.

The card runs the flash backward as FlashAttention-2's two deterministic
halves on 3×TF32 tensor cores: K3 a block per 64 queries of a head over
32-key blocks, K4 a block per 64 keys of a KV head over the group's live
heads and their query blocks. These tests

* hold ``flash_bwd_plan`` to the main path's shapes (132 SMs): the dense
  (head_dim 128) and the MoE (head_dim 64) training shapes take the mma
  variant; rows that are not
  16-byte aligned take the simt variant; no prefix reaches the plan; two
  blocks of each kernel fit an SM;
* emulate the variant's arithmetic in plain torch on numpy-seeded inputs —
  the tiles and their skip predicates (the block's, then the warp's), S
  and dP per block summed in the tensor core (``mma3``), P and dS from
  them, dQ, dK and dV summed in 8-deep steps each promoted into fp32
  (``mma3_add``), K4's group summed in head order, every product split
  into TF32 hi + lo parts with a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi —
  and hold it to the plain versions and to the reference's Pallas
  backward (interpret mode) within ``K34_TOL``; one TF32 product alone
  misses it;
* check that the accumulator of a product is, register for register, the
  A fragment of the next one in the permuted order, and that every
  fragment read of the shared tiles (row stride D + 4) hits 32 distinct
  banks;
* on a card (``-m cuda``), hold each variant of the kernels to its plain
  version and to itself, bit for bit.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _bwd_call, _fwd_call
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (NEG_INF,
                                                 flash_attention_dkv_plain,
                                                 flash_attention_dq_plain,
                                                 flash_attention_fwd_plain,
                                                 flash_bwd_plan)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the card check's tolerances)

torch.set_num_threads(2)
SMS = 132
SMEM_PER_SM = 233472          # an SM's shared memory, bytes
LOW13 = 0x1FFF
ALL = ("lo_hi", "hi_lo", "hi_hi")


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------
# (label, B, S, H, KV, D): the attention of chip_smoke.py's phases 7 and 9
MAIN_PATH = [("dense", 16, 128, 32, 8, 128), ("moe", 16, 128, 16, 8, 64)]


@pytest.mark.parametrize("label,B,S,H,KV,D", MAIN_PATH,
                         ids=[c[0] for c in MAIN_PATH])
def test_plan_main_path_takes_the_mma_variant(label, B, S, H, KV, D):
    """Both training shapes run the tensor-core variant: K3 64-query blocks
    over 32-key steps, K4 64-key blocks over 16-query steps; two blocks of
    either kernel fit an SM's shared memory and K3's grid covers the
    card."""
    plan = flash_bwd_plan(B, S, S, H, KV, D, True)
    assert plan == fa.FlashBwdPlan("mma", (64, 32), (64, 16))
    for nbytes in fa.bwd_shared_bytes(plan, D):
        assert 2 * (nbytes + 1024) <= SMEM_PER_SM
    assert H * -(-S // plan.dq_tile[0]) * B >= SMS


def test_plan_unaligned_rows_take_the_simt_variant():
    """Operands that do not start on 16 bytes (an offset view) cannot feed
    16-byte cp.async copies: the first design's 16 × 16 tiles."""
    for D in fa.KERNEL_HEAD_DIMS:
        assert flash_bwd_plan(2, 40, 40, 8, 2, D, False) == \
            fa.FlashBwdPlan("simt", (16, 16), (16, 16))


def test_plan_never_sees_the_prefixes():
    """The plan is a function of shapes and alignment; the wrappers'
    ``bwd_launch_plan`` of the operands alone."""
    import inspect
    assert list(inspect.signature(flash_bwd_plan).parameters) == [
        "B", "Sq", "Sk", "H", "KV", "D", "aligned"]
    assert list(inspect.signature(fa.bwd_launch_plan).parameters) == [
        "q", "k", "v", "do"]


# ---------------------------------------------------------------------------
# the mma variant's order of work, emulated
# ---------------------------------------------------------------------------
def _split(v):
    """v ≈ hi + lo: hi the nearest TF32 value (ties away from zero), lo the
    rest as the tensor core reads it (truncated to TF32)."""
    bits = v.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~LOW13).view(torch.float32)
    lo = ((v - hi).contiguous().view(torch.int32) & ~LOW13).view(
        torch.float32)
    return hi, lo


def _mma(a, b, acc, promote, keep=ALL):
    """acc + a @ b (contraction on a's last axis) in 8-deep steps: with
    ``promote`` (``mma3_add``) the kept TF32 products of a step are summed,
    smallest first, into a fresh tile that is then added to acc in fp32;
    without (``mma3``) each product is accumulated into acc in turn, as
    the tensor core does."""
    ah, al = _split(a)
    bh, bl = _split(b)
    parts = {"lo_hi": (al, bh), "hi_lo": (ah, bl), "hi_hi": (ah, bh)}
    for k0 in range(0, a.shape[-1], 8):
        prods = [x[..., k0:k0 + 8] @ y[..., k0:k0 + 8, :]
                 for name, (x, y) in parts.items() if name in keep]
        if promote:
            t = torch.zeros_like(acc)
            for p in prods:
                t = t + p
            acc = acc + t
        else:
            for p in prods:
                acc = acc + p
    return acc


def _rows(x, r0, n, fill=0.0):
    """Rows [r0, r0 + n) of x's axis -2, padded past its end with
    ``fill`` (the zero-filled copies of the kernels)."""
    part = x[..., r0:r0 + n, :]
    if part.shape[-2] == n:
        return part
    pad = torch.full(part.shape[:-2] + (n - part.shape[-2],
                                        part.shape[-1]), fill)
    return torch.cat([part, pad], dim=-2)


def _grad(s, dp, ok, lse, delta, cap, scale):
    """p and ds from the accumulated dot products, in the kernels' order of
    operations: one warp of a pair turns S into p and p · s' · scale, the
    other multiplies that by dP − delta."""
    sc, dcap = s * scale, torch.ones(())
    if cap is not None:
        th = torch.tanh(sc / cap)
        sc, dcap = cap * th, 1.0 - th * th
    p = torch.where(ok, torch.exp(sc - lse), torch.zeros(()))
    return p, p * dcap * scale * (dp - delta)


def _valid(qpos, kpos, causal, window):
    ok = torch.ones(qpos.shape[0], kpos.shape[-1], dtype=torch.bool)
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        ok = ok & (qpos[:, None] - kpos[None, :] < window)
    return ok


def emulate_dq(q, k, v, do, lse, delta, ha, causal, window, cap, scale,
               keep=ALL):
    """dq of K3's mma variant in its order of work."""
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    BQ, BK = flash_bwd_plan(B, Sq, Sk, H, k.shape[2], D, True).dq_tile
    qh, oh = q.transpose(1, 2), do.transpose(1, 2)            # (B,H,S,D)
    kh = k.repeat_interleave(G, 2).transpose(1, 2)
    vh = v.repeat_interleave(G, 2).transpose(1, 2)
    dq = torch.zeros((B, H, Sq, D))
    nk = -(-Sk // BK)
    for q0 in range(0, Sq, BQ):
        lo = q0 - (window - 1) if window is not None else 0
        kb_lo = lo // BK if lo > 0 else 0
        kb_hi = min(nk, (q0 + BQ - 1) // BK + 1) if causal else nk
        for qr0 in range(q0, q0 + BQ, 16):                    # the warps
            if qr0 >= Sq:
                continue
            rows = torch.arange(qr0, qr0 + 16)
            Q, O = _rows(qh, qr0, 16), _rows(oh, qr0, 16)
            ls = _rows(lse[..., None], qr0, 16, NEG_INF)      # (B,H,16,1)
            dl = _rows(delta[..., None], qr0, 16)
            acc = torch.zeros((B, H, 16, D))
            for kb in range(kb_lo, kb_hi):
                k0 = kb * BK
                if (causal and k0 > qr0 + 15) or (
                        window is not None
                        and k0 + BK - 1 < qr0 - (window - 1)):
                    continue                              # the warp skips
                K, V = _rows(kh, k0, BK), _rows(vh, k0, BK)
                s = _mma(Q, K.transpose(-1, -2), torch.zeros((B, H, 16, BK)),
                         False, keep)
                dp = _mma(O, V.transpose(-1, -2),
                          torch.zeros((B, H, 16, BK)), False, keep)
                kpos = torch.arange(k0, k0 + BK)
                ok = _valid(rows, kpos, causal, window) & (kpos < Sk) \
                    & (ls > NEG_INF * 0.5)
                _, ds = _grad(s, dp, ok, ls, dl, cap, scale)
                acc = _mma(ds, K, acc, True, keep)
            n = min(16, Sq - qr0)
            dq[:, :, qr0:qr0 + n] = acc[:, :, :n]
    live = torch.arange(H)[None, :] < ha[:, None]
    return (dq * live[:, :, None, None]).transpose(1, 2)


def emulate_dkv(q, k, v, do, lse, delta, ha, causal, window, cap, scale,
                keep=ALL):
    """(dk, dv) of K4's mma variant in its order of work: the group's live
    heads in order, each over its query blocks."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    BK, BQ = flash_bwd_plan(B, Sq, Sk, H, KV, D, True).dkv_tile
    qg = q.transpose(1, 2).reshape(B, KV, G, Sq, D)
    og = do.transpose(1, 2).reshape(B, KV, G, Sq, D)
    lg = lse.reshape(B, KV, G, Sq, 1)
    dg = delta.reshape(B, KV, G, Sq, 1)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)            # (B,KV,S,D)
    live = (torch.arange(H)[None, :] < ha[:, None]).reshape(B, KV, G)
    dk, dv = torch.zeros((B, KV, Sk, D)), torch.zeros((B, KV, Sk, D))
    nq = -(-Sq // BQ)
    for k0 in range(0, Sk, BK):
        qb_lo = min(nq, k0 // BQ) if causal else 0
        qb_hi = min(nq, (k0 + BK - 1 + window - 1) // BQ + 1) \
            if window is not None else nq
        for kw0 in range(k0, k0 + BK, 16):                    # the warps
            if kw0 >= Sk:
                continue
            keys = torch.arange(kw0, kw0 + 16)
            K, V = _rows(kh, kw0, 16), _rows(vh, kw0, 16)
            dka, dva = torch.zeros((B, KV, 16, D)), torch.zeros((B, KV, 16, D))
            for hg in range(G):
                for qb in range(qb_lo, qb_hi):
                    q0 = qb * BQ
                    if (causal and q0 + BQ - 1 < kw0) or (
                            window is not None and q0 - (kw0 + 15) >= window):
                        continue                          # the warp skips
                    Q = _rows(qg[:, :, hg], q0, BQ)
                    O = _rows(og[:, :, hg], q0, BQ)
                    ls = _rows(lg[:, :, hg], q0, BQ).transpose(-1, -2)
                    dl = _rows(dg[:, :, hg], q0, BQ).transpose(-1, -2)
                    st = _mma(K, Q.transpose(-1, -2),
                              torch.zeros((B, KV, 16, BQ)), False, keep)
                    dpt = _mma(V, O.transpose(-1, -2),
                               torch.zeros((B, KV, 16, BQ)), False, keep)
                    qpos = torch.arange(q0, q0 + BQ)
                    ok = _valid(qpos, keys, causal, window).T \
                        & (keys < Sk)[:, None] & (qpos < Sq)[None, :] \
                        & (ls > NEG_INF * 0.5) \
                        & live[:, :, hg, None, None]
                    p, ds = _grad(st, dpt, ok, ls, dl, cap, scale)
                    dva = _mma(p, O, dva, True, keep)
                    dka = _mma(ds, Q, dka, True, keep)
            n = min(16, Sk - kw0)
            dk[:, :, kw0:kw0 + n] = dka[:, :, :n]
            dv[:, :, kw0:kw0 + n] = dva[:, :, :n]
    return dk.transpose(1, 2), dv.transpose(1, 2)


def _inputs(B, S, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return tuple(rng.standard_normal(shape).astype(f) for shape in
                 ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))


def _forward(q, k, v, do, ha, kw):
    o, lse = flash_attention_fwd_plain(q, k, v, ha, **kw)
    return lse, torch.einsum("bshd,bshd->bhs", do, o)


# (B, S, H, KV, D, h_active per row, causal, window, cap): heads past the
# prefix inside a GQA group and rows with h_active 0, window + softcap,
# non-causal, S in {37, 65, 130} (not tile multiples), every head dim
CASES = [
    (3, 37, 8, 2, 64, [0, 8, 3], True, None, None),
    (2, 65, 8, 2, 32, [8, 3], True, 17, 30.0),
    (1, 130, 4, 1, 128, [4], False, None, 25.0),
    (2, 65, 4, 2, 128, [2, 0], True, 40, None),
    (2, 37, 4, 2, 32, [4, 1], False, 5, 20.0),
    (1, 130, 4, 2, 64, [3], True, None, None),
]


@pytest.mark.parametrize("B,S,H,KV,D,has,causal,window,cap", CASES)
def test_mma_order_of_work_matches_plain_and_reference(B, S, H, KV, D, has,
                                                       causal, window, cap):
    """The emulated K3 and K4 within K34_TOL of the plain versions and of
    the reference's Pallas backward (``_bwd_call``, interpret mode, one
    block per sequence, row by row with each row's own prefix); dq of the
    heads past the prefix, and dk / dv of groups with no live head, are
    exactly zero."""
    arrays = _inputs(B, S, H, KV, D, seed=S * 10 + D + B)
    q, k, v, do = map(torch.from_numpy, arrays)
    ha = torch.tensor(has, dtype=torch.int32)
    kw = dict(causal=causal, window=window, cap=cap)
    scale = 1.0 / np.sqrt(D)
    lse, delta = _forward(q, k, v, do, ha, kw)
    args = (q, k, v, do, lse, delta, ha, causal, window, cap, scale)
    dq = emulate_dq(*args)
    dk, dv = emulate_dkv(*args)
    want = {"dq": flash_attention_dq_plain(q, k, v, do, lse, delta, ha,
                                           **kw)}
    want["dk"], want["dv"] = flash_attention_dkv_plain(q, k, v, do, lse,
                                                       delta, ha, **kw)
    got = {"dq": dq, "dk": dk, "dv": dv}
    for name in got:
        err = float((got[name] - want[name]).abs().max())
        assert err <= chip_smoke.K34_TOL, (name, err)
    dead = torch.arange(H)[None, :] >= ha[:, None]                # (B, H)
    assert not dq.transpose(1, 2)[dead].any()
    dead_kv = dead.reshape(B, KV, H // KV).all(-1)
    assert not dk.transpose(1, 2)[dead_kv].any()
    assert not dv.transpose(1, 2)[dead_kv].any()
    ref = {"dq": [], "dk": [], "dv": []}
    for b, h in enumerate(has):
        sl = slice(b, b + 1)
        opts = dict(causal=causal, window=window, cap=cap, scale=scale,
                    bq=S, bk=S, interpret=True)
        ha_j = jnp.asarray([h], jnp.int32)
        row = [jnp.asarray(a[sl]) for a in arrays]
        o_r, lse_r = _fwd_call(*row[:3], ha_j, **opts)
        for name, t in zip(("dq", "dk", "dv"),
                           _bwd_call(*row, o_r, lse_r, ha_j, **opts)):
            ref[name].append(np.asarray(t))
    for name in got:
        err = np.abs(got[name].numpy() - np.concatenate(ref[name])).max()
        assert err <= chip_smoke.K34_TOL, (name, err)


def test_one_tf32_product_misses_the_tolerance():
    """At the dense path's head dim (128) and 130 tokens, the hi·hi
    product alone misses K34_TOL on dq and on dk / dv; all three products
    stay within a tenth of it."""
    q, k, v, do = map(torch.from_numpy, _inputs(1, 130, 4, 1, 128, seed=7))
    ha = torch.tensor([4], dtype=torch.int32)
    kw = dict(causal=True, window=None, cap=None)
    lse, delta = _forward(q, k, v, do, ha, kw)
    args = (q, k, v, do, lse, delta, ha, True, None, None, 128 ** -0.5)
    want = (flash_attention_dq_plain(q, k, v, do, lse, delta, ha, **kw),) \
        + flash_attention_dkv_plain(q, k, v, do, lse, delta, ha, **kw)
    for keep, bound in ((ALL, chip_smoke.K34_TOL / 10), (("hi_hi",), None)):
        got = (emulate_dq(*args, keep=keep),) + emulate_dkv(*args, keep=keep)
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        if bound is not None:
            assert max(errs) <= bound, errs
        else:
            assert errs[0] > chip_smoke.K34_TOL, errs
            assert max(errs[1:]) > chip_smoke.K34_TOL, errs


# ---------------------------------------------------------------------------
# fragments and shared-memory banks
# ---------------------------------------------------------------------------
LANES = [(lane // 4, lane % 4) for lane in range(32)]      # (g, t)


def test_accumulator_is_the_next_products_a_fragment():
    """m16n8k8 layouts (csrc/mma_tf32.cuh): the C fragment c0 (g, 2t), c1
    (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1), handed over as a0 = c0,
    a1 = c2, a2 = c1, a3 = c3 (``acc_as_a``), is the A fragment (a0 (g, t),
    a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)) of the product over its
    8 columns when slot t holds column 2t and slot t + 4 column 2t + 1; the
    B fragment read down the tile's rows (``load_b_down``: rows 2t and
    2t + 1 in slots t and t + 4) puts the same column in the same slot."""
    perm = {s: 2 * s if s < 4 else 2 * (s - 4) + 1 for s in range(8)}
    for g, t in LANES:
        c = [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1)]
        a_from_c = [c[0], c[2], c[1], c[3]]
        a_slots = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
        assert a_from_c == [(r, perm[s]) for r, s in a_slots]
        b_rows = [2 * t, 2 * t + 1]                    # load_b_down
        assert b_rows == [perm[t], perm[t + 4]]
    # every (row, column) of the tile is read once, by one lane
    cells = {(r, col) for g, t in LANES
             for r, col in ((g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t),
                            (g + 8, 2 * t + 1))}
    assert len(cells) == 16 * 8


def _banks(words):
    return [w % 32 for w in words]


@pytest.mark.parametrize("D", fa.KERNEL_HEAD_DIMS)
def test_every_fragment_read_hits_distinct_banks(D):
    """Every shared tile of the mma variant is row-major at stride D + 4
    (≡ 4 mod 32; 20 at D = 80 — an odd multiple of 4 either way): each
    32-bit fragment load of a warp — A fragments along
    a tile's rows (K3's Q and dO, K4's K and V; rows r + g and r + g + 8,
    columns c + t and c + t + 4), B fragments along the rows (S's and
    dP's K and V, Sᵀ's and dPᵀ's Q and dO: row n + g, columns c + t and
    c + t + 4), B fragments down the rows (dQ's K, dK's Q and dV's dO:
    rows k + 2t and k + 2t + 1, column n + g) — hits 32 distinct banks at
    every offset the kernels use; so does each half warp's 64-bit access
    to a warp pair's exchange tile (row stride 8 mod 32: the step's 16 or
    32 columns + 8), and each 8-thread phase of a 16-byte cp.async row
    copy (a row's chunks numbered in slots of a multiple of 8, so that no
    phase straddles two rows)."""
    S = D + fa.BWD_ROW_PAD
    assert S % 32 == (20 if D == 80 else 4) and S % 4 == 0
    for r in (0, 16, 32, 48):                 # a warp's rows in the tile
        for c in range(0, D, 8):
            for dr, dc in ((0, 0), (8, 0), (0, 4), (8, 4)):        # load_a
                words = [(r + g + dr) * S + c + t + dc for g, t in LANES]
                assert len(set(_banks(words))) == 32
    for n in range(0, 32, 8):                 # 32 keys or queries a step
        for c in range(0, D, 8):
            for dc in (0, 4):                                 # load_b_along
                words = [(n + g) * S + c + t + dc for g, t in LANES]
                assert len(set(_banks(words))) == 32
    for k in range(0, 32, 8):
        for n in range(0, D, 8):
            for dr in (0, 1):                                  # load_b_down
                words = [(k + 2 * t + dr) * S + n + g for g, t in LANES]
                assert len(set(_banks(words))) == 32
    for XS in (16 + 8, 32 + 8):               # the pairs' exchange tiles
        for r in (0, 16, 32, 48):
            for j in range(0, 32, 8):
                for dr in (0, 8):
                    words = [(r + g + dr) * XS + j + 2 * t for g, t in LANES]
                    for half in (words[:16], words[16:]):   # 64-bit words
                        assert len(set(_banks(half + [w + 1 for w in half]))
                                   ) == 32
    chunks = D // 4                           # copy_rows: 16-byte chunks
    slots = -(-chunks // 8) * 8               # numbered in slots of 8s
    for c0 in range(0, 64 * slots, 8):
        words = []
        for c in range(c0, c0 + 8):
            i, d = divmod(c, slots)
            if d < chunks:
                words += [i * S + 4 * d + e for e in range(4)]
        assert len(set(_banks(words))) == len(words)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_flash_bwd_variants_match_plain_on_card():
    """Both variants of K3 and K4 against their plain versions on the card,
    each twice (bit for bit), every launch counted by its variant; an
    offset view takes the simt variant; runs only where there is a CUDA
    device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    for B, S, H, KV, D, has, causal, window, cap in CASES:
        q, k, v, do = (torch.from_numpy(a).to(dev)
                       for a in _inputs(B, S, H, KV, D, seed=40 + D))
        ha = torch.tensor(has, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, window=window, cap=cap)
        lse, delta = _forward(q, k, v, do, ha, kw)
        args = (q, k, v, do, lse, delta, ha)
        want = (flash_attention_dq_plain(*args, **kw),) + \
            flash_attention_dkv_plain(*args, **kw)
        assert fa.bwd_launch_plan(q, k, v, do).variant == "mma"
        for variant in fa.FLASH_BWD_VARIANTS:
            before = (fa.flash_attention_dq.launches_by_variant[variant],
                      fa.flash_attention_dkv.launches_by_variant[variant])
            runs = [(fa.flash_attention_dq(*args, variant=variant, **kw),)
                    + fa.flash_attention_dkv(*args, variant=variant, **kw)
                    for _ in range(2)]
            torch.cuda.synchronize()
            assert (fa.flash_attention_dq.launches_by_variant[variant],
                    fa.flash_attention_dkv.launches_by_variant[variant]) \
                == (before[0] + 2, before[1] + 2)
            for got, again, w in zip(*runs, want):
                assert torch.equal(got, again)
                assert float((got - w).abs().max()) <= chip_smoke.K34_TOL
    # an offset view: rows that do not start on 16 bytes
    q, k, v, do = (torch.from_numpy(a).to(dev)
                   for a in _inputs(1, 40, 4, 2, 64, seed=50))
    qo = torch.empty(q.numel() + 1, device=dev)[1:].view(q.shape)
    qo.copy_(q)
    lse, delta = _forward(qo, k, v, do, None, dict(causal=True))
    assert fa.bwd_launch_plan(qo, k, v, do).variant == "simt"
    dq = fa.flash_attention_dq(qo, k, v, do, lse, delta)
    want = flash_attention_dq_plain(q, k, v, do, lse, delta)
    assert float((dq - want).abs().max()) <= chip_smoke.K34_TOL
