"""The port's launch-geometry accounting (``repro_torch.launch.roofline``)
and the tile-accounting gate (``repro_torch.launch.elastic_kernels``):

* ``count_block_loads``, ``tile_arithmetic_intensity`` and
  ``gate_elastic_rows`` give the reference's results on the same inputs —
  the reference's own index maps at prefixes 0 / ragged / full, and rows
  that trip each rule of the gate (the failure lists equal);
* ``model_flops_for`` equals the reference's on every supported pair;
* each kernel's geometry model equals a per-block enumeration of its skip
  predicate, written here from the CUDA sources (``csrc/*.cu``): prefixes
  0 / ragged / full, per-group prefixes that differ, shapes that are not
  tile multiples, every variant;
* the gate passes on the model's rows at the reference's bench shapes and
  at the main widths, and fails on a "reverted skip" mutant whose dead
  tiles still load;
* outside ``build.counting()`` no wrapper reaches a counted library
  (checked on the paths and the wrappers' keys, without nvcc);
* on the card (``-m cuda``, skipped here) the counted kernels equal the
  model.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, INPUT_SHAPES, supported_pairs
from repro_torch.kernels import build
from repro_torch.kernels import elastic_matmul as em
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import elastic_kernels as ek
from repro_torch.launch import mesh
from repro_torch.launch import roofline as rf

torch.set_num_threads(2)
SMS = mesh.SMS


@pytest.fixture(scope="module")
def ref():
    """The reference's accounting functions, index maps and configs."""
    import types

    from repro.configs import ARCHS as REF_ARCHS
    from repro.kernels.elastic_matmul import edense_index_maps
    from repro.kernels.flash_attention import (attn_dkv_index_maps,
                                               attn_dq_index_maps,
                                               attn_fwd_index_maps)
    from repro.kernels.grouped_matmul import grouped_index_maps
    from repro.kernels.ssd_scan import ssd_bwd_index_maps, ssd_fwd_index_maps
    from repro.launch import roofline
    return types.SimpleNamespace(
        rf=roofline, archs=REF_ARCHS, edense=edense_index_maps,
        grouped=grouped_index_maps, attn_fwd=attn_fwd_index_maps,
        attn_dq=attn_dq_index_maps, attn_dkv=attn_dkv_index_maps,
        ssd_fwd=ssd_fwd_index_maps, ssd_bwd=ssd_bwd_index_maps)


# ---------------------------------------------------------------------------
# the ported functions against the reference's
# ---------------------------------------------------------------------------
ATTN_KW = dict(bq=32, bk=32, causal=True, window=None)


def _launch(ref, name, s):
    """(grid, index maps, scalars) of one of the reference's launches."""
    if name == "edense":
        xm, wm, _ = ref.edense(64, 64, 64)
        return (3, 2, 4), [xm, wm], s
    if name == "grouped":
        return (4, 2, 1, 2), list(ref.grouped()), s[:1]
    if name == "attn_fwd":
        return (8, 3, 3), ref.attn_fwd(4, 1, nk=3, **ATTN_KW), s[:1]
    if name == "attn_dq":
        return (8, 3, 3), ref.attn_dq(4, 1, nk=3, **ATTN_KW), s[:1]
    if name == "attn_dkv":
        return (8, 3, 3), ref.attn_dkv(4, 1, nq=3, **ATTN_KW), s[:1]
    if name == "ssd_fwd":
        return (8, 3), ref.ssd_fwd(4), s[:1]
    return (8, 3), ref.ssd_bwd(4, 3), s[:1]


@pytest.mark.parametrize("name", ["edense", "grouped", "attn_fwd", "attn_dq",
                                  "attn_dkv", "ssd_fwd", "ssd_bwd"])
@pytest.mark.parametrize("scalars", [[0, 0, 0], [2, 3, 100], [4, 128, 192]])
def test_count_block_loads_equals_reference(ref, name, scalars):
    grid, maps, s = _launch(ref, name, scalars)
    assert rf.count_block_loads(grid, maps, s) == \
        ref.rf.count_block_loads(grid, maps, s)


def _sweep(op, tiles, dma, pas="fwd", errs=None, path="tile-skipping"):
    return [dict(name=f"{op}_{pas}_{f}", op=op, frac=f, tiles_executed=t,
                 tiles_total=tiles[-1], dma_blocks=d, kernel_path=path,
                 max_err=0.0 if errs is None else errs[i], **{"pass": pas})
            for i, (f, t, d) in enumerate(zip(ek.FRACS, tiles, dma))]


# rows that pass, and rows that trip each rule of the gate
GATE_ROWS = {
    "proportional": _sweep("a", [25, 50, 75, 100], [50, 100, 150, 200]),
    "parity": _sweep("a", [25, 50, 75, 100], [50, 100, 150, 200],
                     errs=[0.0, 2e-5, 0.0, 1.1e-5]),
    "not increasing": _sweep("a", [25, 50, 50, 100], [50, 100, 100, 200]),
    "share": _sweep("a", [60, 70, 80, 100], [120, 140, 160, 200]),
    "dma above full": _sweep("a", [25, 50, 75, 100], [50, 300, 150, 200]),
    "intensity": _sweep("a", [25, 50, 75, 100], [200, 200, 200, 200]),
    "no dma": [dict(r, dma_blocks=None) for r in
               _sweep("a", [25, 50, 75, 100], [0, 0, 0, 0])],
    "dense rows ignored": _sweep("a", [100, 100, 100, 100], [1, 1, 1, 1],
                                 errs=[1.0] * 4, path="dense-masked"),
    "two groups": _sweep("a", [25, 50, 75, 100], [200] * 4, "bwd")
    + _sweep("b", [90, 95, 99, 100], [1, 1, 1, 100]),
}


@pytest.mark.parametrize("case", sorted(GATE_ROWS))
def test_gate_and_intensity_equal_reference(ref, case):
    rows = GATE_ROWS[case]
    for r in rows:
        assert rf.tile_arithmetic_intensity(r) == \
            ref.rf.tile_arithmetic_intensity(r)
    got = rf.gate_elastic_rows(rows)
    assert got == ref.rf.gate_elastic_rows(rows)
    assert bool(got) == (case not in ("proportional", "no dma",
                                      "dense rows ignored"))
    kw = dict(err_tol=1e-3, prop_slack=0.5, ai_floor=0.9)
    assert rf.gate_elastic_rows(rows, **kw) == \
        ref.rf.gate_elastic_rows(rows, **kw)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_for_equals_reference(ref, arch):
    pairs = [s for a, s in supported_pairs() if a == arch]
    assert pairs
    for shape in pairs:
        for kind in ("train", "prefill", "decode"):
            assert rf.model_flops_for(ARCHS[arch], shape, kind) == \
                ref.rf.model_flops_for(ref.archs[arch], shape, kind)
    assert set(INPUT_SHAPES) >= set(pairs)


# ---------------------------------------------------------------------------
# the geometry models against per-block enumerations of the sources
# ---------------------------------------------------------------------------
def _pre(p, G, full):
    return [full] * G if p is None else list(p)


def enum_edense(G, M, K, N, flags, plan, ka, na, ma):
    """csrc/elastic_dense.cu: each block's rows (row_tile), each row's
    contraction end (row_kend), the block's largest (kend_tile), then its
    chunk's K loop from k_lo to min(kend_tile, k_lo + kchunk)."""
    ka, na, ma = _pre(ka, G, K), _pre(na, G, N), _pre(ma, G, M)
    bm, bn = plan.bm, em.TILE_N[plan.variant]
    step = em.STAGE_K[plan.variant]
    grouped = flags & (em.W_PER_GROUP | em.X_TRANS)
    tiles_m = -(-M // bm)
    row_tiles = G * tiles_m if grouped else -(-(G * M) // bm)
    tiles = 0
    for by in range(row_tiles):
        if grouped:
            g = by // tiles_m
            r0, r_end = g * M + (by - g * tiles_m) * bm, g * M + M
        else:
            r0, r_end = by * bm, G * M
        for bx in range(-(-N // bn)):
            c0 = bx * bn
            kend_tile = 0
            for r in range(r0, r0 + bm):
                if r >= r_end:
                    continue
                g, m = divmod(r, M)
                if m >= ma[g] or c0 >= na[g]:
                    continue
                kend_tile = max(kend_tile, min(max(ka[g], 0), K))
            for bz in range(plan.splits):
                k_lo = bz * plan.kchunk
                k_hi = min(kend_tile, k_lo + plan.kchunk)
                tiles += len(range(k_lo, k_hi, step))
    return tiles, 2 * tiles


K1_CASES = [   # G, M, K, N, flags, aligned, prefixes (ka, na, ma)
    (3, 37, 130, 70, em.W_PER_GROUP, False,
     ([0, 65, 130], [70, 33, 70], [37, 20, 5])),
    (2, 200, 264, 200, em.W_PER_GROUP, True, ([100, 264], [200, 77],
                                              [150, 0])),
    (3, 1, 1024, 1000, 0, True, ([1024, 0, 300], [1000, 500, 129], None)),
    (2, 96, 128, 160, em.X_TRANS | em.W_TRANS | em.W_PER_GROUP, True,
     ([128, 40], [0, 160], [96, 50])),
    (4, 50, 96, 300, em.W_TRANS, True, (None, [300, 299, 1, 128], None)),
    (1, 130, 700, 64, 0, True, ([300], None, [129])),
    (2, 65, 100, 64, em.X_TRANS | em.W_PER_GROUP, True, (None, [64, 30],
                                                         [100, 7])),
]


@pytest.mark.parametrize("case", range(len(K1_CASES)))
def test_edense_model_equals_enumeration(case):
    G, M, K, N, flags, aligned, pre = K1_CASES[case]
    plans = {em._plan(G, M, K, N, flags, aligned, SMS),
             em._plan(G, M, K, N, flags, aligned, 8)}
    if aligned:                       # split chunks of the tile variant
        plans.add(em.Plan("tile", 128, -(-K // 64), 64))
    plans.add(em.Plan("simt", 64, -(-K // 64), 64))
    for plan in plans:
        geo = rf.edense_geometry(G, M, K, N, flags, plan, *pre)
        assert (geo.tiles, geo.dma) == enum_edense(G, M, K, N, flags,
                                                   plan, *pre), plan
        assert geo.total == enum_edense(G, M, K, N, flags, plan,
                                        None, None, None)[0]


def enum_gmm(G, E, M, K, N, flags, plan, ga):
    """csrc/grouped_matmul.cu: a block per (col tile × split, row tile,
    (g, e) or e); no live row (``__syncthreads_or``) -> no loads; else the
    chunk's K loop (tile / stream) or K in 16-deep steps (simt)."""
    ga = _pre(ga, G, E)
    bn = gm.TILE_N[plan.variant]
    grouped = bool(flags & (gm.W_PER_GROUP | gm.X_TRANS))
    rows = M if grouped else G * M
    tiles = 0
    for z in range(G * E if grouped else E):
        e, g_blk = (z % E, z // E) if grouped else (z, 0)
        for by in range(-(-rows // plan.bm)):
            live = False
            for r in range(by * plan.bm, min(rows, by * plan.bm + plan.bm)):
                g = g_blk if grouped else r // M
                live |= e < ga[g]
            if not live:
                continue
            for _ in range(-(-N // bn)):
                if plan.variant == "simt":
                    tiles += len(range(0, K, 16))
                    continue
                for split in range(plan.splits):
                    k_lo = split * plan.kchunk
                    tiles += len(range(k_lo, min(K, k_lo + plan.kchunk),
                                       gm.STAGE_K))
    return tiles, 2 * tiles


K5_CASES = [   # G, E, M, K, N, flags, aligned, ga
    (3, 5, 37, 64, 96, gm.W_PER_GROUP, True, [0, 3, 5]),
    (2, 4, 8, 256, 128, 0, True, [1, 4]),
    (2, 3, 10, 30, 20, gm.W_PER_GROUP, False, [2, 0]),
    (3, 6, 20, 96, 40, gm.W_TRANS, True, [6, 2, 4]),
    (2, 4, 30, 64, 64, gm.X_TRANS | gm.W_PER_GROUP, True, [3, 1]),
]


@pytest.mark.parametrize("case", range(len(K5_CASES)))
def test_gmm_model_equals_enumeration(case):
    G, E, M, K, N, flags, aligned, ga = K5_CASES[case]
    plans = {gm._plan(G, E, M, K, N, flags, aligned, SMS),
             gm._plan(G, E, M, K, N, flags, aligned, 4)}
    for plan in plans:
        geo = rf.gmm_geometry(G, E, M, K, N, flags, plan, ga)
        assert (geo.tiles, geo.dma) == enum_gmm(G, E, M, K, N, flags, plan,
                                                ga), plan
        assert geo.total == enum_gmm(G, E, M, K, N, flags, plan, None)[0]


def _key_range(q0, bq, bk, Sk, causal, window):
    """K2's / K3 mma's [kb_lo, kb_hi) (flash_attention_fwd.cu :152-159)."""
    nk = -(-Sk // bk)
    kb_lo = 0
    if window:
        lo = q0 - (window - 1)
        kb_lo = lo // bk if lo > 0 else 0
    kb_hi = min(nk, (q0 + bq - 1) // bk + 1) if causal else nk
    return range(kb_lo, kb_hi)


def _contributes(r0, c0, causal, window):
    """The simt kernels' 16 × 16 ``contributes``."""
    if causal and c0 > r0 + 15:
        return False
    return not (window and c0 + 15 < r0 - (window - 1))


def enum_flash(kind, B, S, H, KV, D, causal, window, plan, ha):
    ha = _pre(ha, B, H)
    tiles = dma = 0
    if kind == "fwd":
        bq, bk = fa.FWD_TILE
        for b in range(B):
            for h in range(H):
                if h >= ha[b]:
                    continue
                for q0 in range(0, S, bq):
                    n = len(_key_range(q0, bq, bk, S, causal, window))
                    tiles, dma = tiles + n, dma + 1 + 2 * n
        return tiles, dma
    if kind == "dq":
        bq, bk = plan.dq_tile
        for b in range(B):
            for h in range(H):
                if h >= ha[b]:
                    continue
                for q0 in range(0, S, bq):
                    if plan.variant == "mma":
                        n = len(_key_range(q0, bq, bk, S, causal, window))
                    else:
                        n = sum(_contributes(q0, k0, causal, window)
                                for k0 in range(0, S, bk))
                    tiles, dma = tiles + n, dma + 2 + 2 * n
        return tiles, dma
    kb, qb = plan.dkv_tile
    G = H // KV
    nq = -(-S // qb)
    for b in range(B):
        for kvh in range(KV):
            h_lo, h_hi = kvh * G, min(kvh * G + G, ha[b])
            if h_lo >= h_hi:
                continue
            for k0 in range(0, S, kb):
                dma += 2
                for h in range(h_lo, h_hi):
                    if plan.variant == "mma":     # :792-795, two passes at 256
                        lo = min(nq, k0 // qb) if causal else 0
                        hi = min(nq, (k0 + kb - 1 + window - 1) // qb + 1) \
                            if window else nq
                        n = max(0, hi - lo) * (2 if D > 128 else 1)
                    else:
                        n = sum(_contributes(q0, k0, causal, window)
                                for q0 in range(0, S, qb))
                    tiles, dma = tiles + n, dma + 2 * n
    return tiles, dma


FLASH_CASES = [   # B, S, H, KV, D, causal, window, ha
    (3, 100, 4, 2, 64, True, 0, [0, 3, 4]),
    (3, 100, 4, 2, 64, True, 40, [4, 1, 2]),
    (2, 70, 2, 1, 32, False, 0, [1, 2]),
    (2, 130, 4, 4, 256, True, 0, [2, 4]),
    (1, 64, 8, 2, 128, False, 33, None),
]


@pytest.mark.parametrize("case", range(len(FLASH_CASES)))
def test_flash_models_equal_enumeration(case):
    B, S, H, KV, D, causal, window, ha = FLASH_CASES[case]
    geo = rf.flash_fwd_geometry(B, S, S, H, causal, window, ha)
    assert (geo.tiles, geo.dma) == enum_flash("fwd", B, S, H, KV, D, causal,
                                              window, None, ha)
    for plan in (fa.flash_bwd_plan(B, S, S, H, KV, D, True),
                 fa._SIMT_PLAN):
        geo = rf.flash_dq_geometry(B, S, S, H, plan, causal, window, ha)
        assert (geo.tiles, geo.dma) == enum_flash(
            "dq", B, S, H, KV, D, causal, window, plan, ha), plan
        geo = rf.flash_dkv_geometry(B, S, S, H, KV, D, plan, causal, window,
                                    ha)
        assert (geo.tiles, geo.dma) == enum_flash(
            "dkv", B, S, H, KV, D, causal, window, plan, ha), plan
        assert geo.total == enum_flash("dkv", B, S, H, KV, D, causal,
                                       window, plan, None)[0]


def test_row_models_equal_enumeration():
    """moe_dispatch.cu: a row read per valid slot (K6), per kept pair with
    a gate ≠ 0 (K7), per valid assignment plus each token's z row (the
    gather-dot); nothing when there is no source row."""
    rng = np.random.default_rng(0)
    valid = (rng.random(37) < 0.6).astype(np.int32)
    gates = rng.random((50, 3)) * (rng.random((50, 3)) < 0.7)
    assert rf.gather_rows_geometry(valid, 50, 96) == \
        (int(sum(v != 0 for v in valid)), 37, int(sum(valid != 0)))
    n = sum(1 for row in gates for g in row if g != 0)
    assert rf.gather_reduce_geometry(gates, 37, 96) == (n, 150, n)
    kept = (gates.reshape(-1) != 0).astype(np.int32)
    assert rf.gather_dot_geometry(kept, 50, 3, 37, 30) == (n, 150, n + 50)
    for geo in (rf.gather_rows_geometry(valid, 0, 96),
                rf.gather_reduce_geometry(gates, 37, 0),
                rf.gather_dot_geometry(kept, 50, 3, 0, 30)):
        assert geo == rf.NO_WORK


def enum_ssd(kind, R, S, H, P, G, Q, plan, ha):
    """ssd_scan.cu: the simt scans' 64-row ``load_rows`` tiles a chunk of a
    live (row, head); the mma scan's 32-key stages a chunk of a live (row,
    head, P slice); K9 mma's dh (chunks nc−1 … 1), query-tile (dc) and
    key-tile (dbx) blocks as ``bwd_tile`` numbers them."""
    ha = _pre(ha, R, H)
    nc = S // Q
    tiles = dma = 0
    T = ss.SIMT_TILE
    for r in range(R):
        for h in range(H):
            if h >= ha[r]:
                continue
            if plan.variant == "simt":
                for _ in range(nc):
                    tiles += 1
                    for q0 in range(0, Q, T):          # C, then B and x
                        dma += 1 if kind == "fwd" else 2
                        dma += 2 * len(range(0, q0 + 1, T))
                    for k0 in range(0, Q, T):          # state update / pass B
                        dma += 2 if kind == "fwd" else \
                            2 + 2 * len(range(k0, Q, T))
                    if kind == "bwd":                  # pass C
                        dma += 2 * len(range(0, Q, T))
            elif kind == "fwd":
                for _ in range(P // plan.p_tile):
                    for _ in range(nc):
                        tiles += 1
                        dma += 2 * len(range(0, Q, 32))
            else:
                for _ in range(P // 32):
                    for _ in range(nc - 1, 0, -1):
                        tiles += 1
                        dma += 2 * len(range(0, Q, 32))
    if kind == "fwd" or plan.variant == "simt":
        return tiles, dma
    rep, hs = H // G, plan.head_slice
    ns = -(-rep // hs)
    ranks = -(-Q // 64) * 64 // ss.BWD_TILE
    for block in range(ranks * R * nc * G * ns):   # bwd_tile
        rank, rest = divmod(block, R * nc * G * ns)
        sl, rest = rest % ns, rest // ns
        grp, rest = rest % G, rest // G
        c, r = rest % nc, rest // nc
        h0 = grp * rep + sl * hs
        hlive = min(min(h0 + hs, (grp + 1) * rep), ha[r])
        if h0 >= hlive:
            continue
        t0 = (ranks - 1 - rank) * ss.BWD_TILE          # dc
        q_steps = len(range(0, min(t0 + 64, Q), 32))
        dma += 1
        for _ in range(h0, hlive):
            tiles += q_steps
            dma += 1 + 2 * q_steps + 1
        s0 = rank * ss.BWD_TILE                        # dbx
        k_steps = len(range(0, Q - s0, 32))
        dma += 1
        for _ in range(h0, hlive):
            tiles += k_steps
            dma += 1 + 2 * k_steps + (1 if c < nc - 1 else 0)
    return tiles, dma


SSD_CASES = [   # R, S, H, P, G, N, Q, ha
    (3, 96, 4, 32, 2, 16, 48, [0, 2, 4]),
    (2, 64, 3, 32, 1, 12, 32, [1, 3]),
    (2, 64, 4, 64, 1, 32, 64, [3, 1]),
    (2, 300, 6, 64, 3, 16, 100, [6, 2]),
    (1, 256, 8, 32, 2, 64, 128, None),
]


@pytest.mark.parametrize("case", range(len(SSD_CASES)))
def test_ssd_models_equal_enumeration(case):
    R, S, H, P, G, N, Q, ha = SSD_CASES[case]
    for sms in (SMS, 8):
        plan = ss.ssd_plan(R, H, P, N, Q, True, sms)
        for p in {plan, ss.SsdPlan("simt", P)}:
            geo = rf.ssd_fwd_geometry(R, S, H, P, Q, p, ha)
            assert (geo.tiles, geo.dma) == enum_ssd("fwd", R, S, H, P, G, Q,
                                                    p, ha), p
        bplan = ss.ssd_bwd_plan(R, H, P, N, Q, True, sms)
        for p in {bplan, ss.SsdBwdPlan("simt", H)}:
            geo = rf.ssd_bwd_geometry(R, S, H, P, G, Q, p, ha)
            assert (geo.tiles, geo.dma) == enum_ssd("bwd", R, S, H, P, G, Q,
                                                    p, ha), p
            assert geo.total == enum_ssd("bwd", R, S, H, P, G, Q, p,
                                         None)[0]


# ---------------------------------------------------------------------------
# the gate on the model's rows
# ---------------------------------------------------------------------------
def reverted_skip(rows):
    """The mutant whose dead tiles still load: every row's DMA blocks at
    its sweep's full-width level, its executed tiles unchanged."""
    full = {(r["op"], r["pass"]): r["dma_blocks"] for r in rows
            if r["frac"] == 1.0}
    return [dict(r, dma_blocks=full[(r["op"], r["pass"])]) for r in rows]


@pytest.mark.parametrize("set_name", ek.GATED)
def test_gate_passes_on_model_and_fails_on_reverted_skip(set_name):
    rows = ek.model_rows(set_name)
    assert {(r["op"], r["pass"]) for r in rows} == ek.REQUIRED_GROUPS
    assert ek.gate(rows) == []
    fails = ek.gate(reverted_skip(rows))
    failed = {tuple(m.split("@")[0].split("/")) for m in fails
              if "arithmetic intensity" in m}
    assert failed == ek.REQUIRED_GROUPS
    missing = [r for r in rows if (r["op"], r["pass"]) != ("conv_channels",
                                                           "fwd")]
    assert any("required sweep" in m for m in ek.gate(missing))


def test_check_passes_on_the_cpu(capsys):
    assert ek.main(["--check"]) == 0
    assert "roofline gate PASS" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the counted build never reaches the main path
# ---------------------------------------------------------------------------
def test_counted_libraries_only_inside_counting(monkeypatch):
    assert "-DREPRO_TILE_COUNTERS" in build.COUNTED_FLAGS
    assert "-DREPRO_TILE_COUNTERS" not in build.NVCC_FLAGS
    assert not build.counting_active()
    for name in build.SOURCES:
        fast = build.library_target(name)
        assert "_counted" not in fast.name
        with build.counting():
            counted = build.library_target(name)
            assert counted.name.startswith(f"{name}_counted_")
        assert build.library_target(name) == fast != counted
    for mod, fn in ((em, "_library"), (gm, "_library"), (fa, "_library"),
                    (fa, "_bwd_library"), (md, "_library"),
                    (ss, "_library")):
        seen = []
        monkeypatch.setattr(mod, f"{fn}_bound", seen.append)
        getattr(mod, fn)()
        with build.counting():
            getattr(mod, fn)()
        getattr(mod, fn)()
        assert seen == [False, True, False], (mod.__name__, fn)


@pytest.mark.cuda
def test_counted_kernels_equal_model_on_card():
    """On the card: the counted kernels' tiles and DMA blocks equal the
    model at the edges and on the bench rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from repro_torch.kernels.backend import resolve_device
    dev = resolve_device("cuda")
    _, fails = ek.edge_checks(dev)
    assert fails == []
    for op in ek.bench_ops():
        _, fails = ek.measure_op(op, "bench", dev, em._sms(dev.index),
                                 iters=1)
        assert [f for f in fails if "counted" in f] == []
