"""Launch-geometry accounting: the host half of the tile-accounting gate.

The port of the accounting half of the reference's ``launch/roofline.py``:
``model_flops_for``, ``count_block_loads``, ``tile_arithmetic_intensity``
and ``gate_elastic_rows``, line for line. Its HLO half (``parse_hlo``,
``Roofline``, ``build_roofline``) reads XLA's compiled text and has no
counterpart here.

Beside them, a geometry model of each Hopper kernel: for one launch and
its runtime prefixes, ``Geometry(tiles, total, dma)`` — the tiles whose
math the kernel issues, the tiles of the same launch at full width, and
the operand blocks it loads — as the kernels count them under
``REPRO_TILE_COUNTERS`` (``csrc/tile_counters.cuh``). Each model walks the
launch the wrapper's own plan gives (``elastic_matmul._plan``,
``grouped_matmul._plan``, ``flash_attention.flash_bwd_plan``,
``ssd_scan.ssd_plan`` / ``ssd_bwd_plan``), with the tile sizes read from
the wrapper modules, and evaluates each block's skip predicate as the
source does:

* K1 / K5: a tile is one contraction stage of a block whose math issues
  (Σ over blocks of the K loop's stages, split-K chunks apart); a stage
  loads an x and a w tile. The split-K reductions are not tiles.
* K2, K3 / K4: a tile is a (query block, key block) step of a live head
  (K4 in each of its column passes); the Q (and dO) tiles load once a
  block, K and V once a K4 block, and each step loads its K and V (K3)
  or its Q and dO (K4) tiles.
* K6 / K7: a tile is a source row read (a valid slot, a kept (token, j)
  pair); the gather-dot also loads each token's z row.
* K8 / K9: a tile is a chunk of a live (row, head) block (K8's mma P
  slices apart), or a 32-row stage of a live head in K9's query and key
  tile kernels; the blocks are the 64-row tiles (simt) or ring stages and
  tiles (mma) the source copies. The cum, C·Bᵀ, slice-sum and du helper
  kernels are not tiles.
"""
from __future__ import annotations

import itertools
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np


def model_flops_for(cfg, shape_name: str, kind: str) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D for train, 2*N_active*D for a
    forward-only (prefill) pass, 2*N_active*B for one decode token."""
    from repro_torch.configs.base import INPUT_SHAPES
    s = INPUT_SHAPES[shape_name]
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * s.global_batch * s.seq_len
    if kind == "prefill":
        return 2.0 * n * s.global_batch * s.seq_len
    return 2.0 * n * s.global_batch      # decode: one token


# ---------------------------------------------------------------------------
# launch-geometry accounting — the elastic-kernel gate
# ---------------------------------------------------------------------------
def count_block_loads(grid, index_maps, scalars) -> List[int]:
    """Per-input DMA block loads of a launch from its block index maps.

    Walks the grid in row-major order (last axis fastest) evaluating each
    map with the real scalar operand; a load is counted whenever the
    map's block index differs from the previous grid step's (the resident
    block is not requested again). Returns one count per index map."""
    s = np.asarray(scalars, dtype=np.int32).reshape(-1)
    loads = [0] * len(index_maps)
    prev: List[Optional[tuple]] = [None] * len(index_maps)
    for idx in itertools.product(*[range(int(g)) for g in grid]):
        for m, imap in enumerate(index_maps):
            blk = imap(*idx, s)
            blk = tuple(int(v) for v in blk)
            if blk != prev[m]:
                loads[m] += 1
                prev[m] = blk
    return loads


def tile_arithmetic_intensity(row: Dict) -> Optional[float]:
    """Executed compute tiles per DMA block load — the launch-geometry
    analogue of FLOPs/byte. Proportional tile-skipping keeps it roughly
    flat across active fractions; dead tiles that still load keep the DMA
    at the dense level while tiles shrink, cratering it."""
    dma = row.get("dma_blocks")
    if not dma:
        return None
    return row["tiles_executed"] / dma


def gate_elastic_rows(rows: List[Dict], *, err_tol: float = 1e-5,
                      prop_slack: float = 0.16,
                      ai_floor: float = 0.45) -> List[str]:
    """Pass/fail the elastic-kernel rows (the roofline gate).

    Per (op, pass) sweep of ``kernel_path == 'tile-skipping'`` rows:

    * parity: every row's ``max_err`` ≤ ``err_tol`` (forward AND vjp);
    * monotonicity: ``tiles_executed`` strictly increasing in ``frac``;
    * FLOP proportionality: executed-tile share ≤ frac + ``prop_slack``;
    * DMA: block loads never exceed the full-width row's;
    * arithmetic intensity: tiles/DMA-block at any fraction stays ≥
      ``ai_floor`` × the full-width value.

    Returns a list of failure messages (empty == gate passes)."""
    fails: List[str] = []
    groups: Dict[Tuple[str, str], List[Dict]] = defaultdict(list)
    for r in rows:
        if r.get("kernel_path") != "tile-skipping":
            continue
        if r.get("max_err", 0.0) > err_tol:
            fails.append(f"{r.get('name', '?')}: max_err "
                         f"{r['max_err']:.2e} > {err_tol:.0e}")
        groups[(r.get("op", "?"), r.get("pass", "fwd"))].append(r)
    for (op, pas), rs in sorted(groups.items()):
        rs = sorted(rs, key=lambda r: r["frac"])
        tex = [r["tiles_executed"] for r in rs]
        if not all(a < b for a, b in zip(tex, tex[1:])):
            fails.append(f"{op}/{pas}: tiles_executed not strictly "
                         f"increasing across fractions: {tex}")
        full = rs[-1]
        full_ai = tile_arithmetic_intensity(full)
        for r in rs:
            share = r["tiles_executed"] / max(full["tiles_executed"], 1)
            if share > r["frac"] + prop_slack:
                fails.append(
                    f"{op}/{pas}@{r['frac']:g}: executed-tile share "
                    f"{share:.3f} exceeds frac+{prop_slack:g}")
            dma = r.get("dma_blocks")
            if dma is not None and full.get("dma_blocks") is not None \
                    and dma > full["dma_blocks"]:
                fails.append(
                    f"{op}/{pas}@{r['frac']:g}: dma_blocks {dma} exceeds "
                    f"full-width {full['dma_blocks']}")
            ai = tile_arithmetic_intensity(r)
            if ai is not None and full_ai is not None \
                    and ai < ai_floor * full_ai:
                fails.append(
                    f"{op}/{pas}@{r['frac']:g}: arithmetic intensity "
                    f"{ai:.2f} tiles/block < {ai_floor:g}x full-width "
                    f"{full_ai:.2f} — skipped tiles are still paying DMA")
    return fails


# ---------------------------------------------------------------------------
# geometry models of the Hopper kernels
# ---------------------------------------------------------------------------
class Geometry(NamedTuple):
    tiles: int       # tiles executed
    total: int       # tiles of the same launch at full width
    dma: int         # operand blocks loaded

    def __add__(self, other):
        return Geometry(*(int(a) + int(b) for a, b in zip(self, other)))


NO_WORK = Geometry(0, 0, 0)


def _cdiv(a, b):
    return -(-a // b)


def _per_group(prefix, G, full):
    """(G,) int64 of a prefix tensor / array / int, or ``full`` for None."""
    if prefix is None:
        return np.full(G, full, np.int64)
    if hasattr(prefix, "detach"):                # a tensor, on any device
        prefix = prefix.detach().cpu().numpy()
    a = np.asarray(prefix, np.int64).reshape(-1)
    return np.broadcast_to(a, (G,)).copy() if a.size == 1 else a


def _geometry(fn, args, *prefixes):
    """The ``Geometry`` of the launch ``fn(*args, *prefixes)`` -> (tiles,
    DMA blocks); the total is the same launch with every prefix absent."""
    tiles, dma = fn(*args, *prefixes)
    total, _ = fn(*args, *(None,) * len(prefixes))
    return Geometry(int(tiles), int(total), int(dma))


# --- K1 --------------------------------------------------------------------
def _edense(G, M, K, N, flags, plan, ka, na, ma):
    from repro_torch.kernels import elastic_matmul as em
    if G * M <= 0 or N <= 0:
        return 0, 0
    bn, step = em.TILE_N[plan.variant], em.STAGE_K[plan.variant]
    bm = plan.bm
    # the rows of each row tile (csrc/elastic_dense.cu::row_tile)
    if flags & (em.W_PER_GROUP | em.X_TRANS):
        tiles_m = _cdiv(M, bm)
        g = np.repeat(np.arange(G), tiles_m)
        m0 = np.tile(np.arange(tiles_m) * bm, G)
        m = m0[:, None] + np.arange(bm)[None, :]
        valid = m < M
        r = g[:, None] * M + m
    else:
        r = np.arange(_cdiv(G * M, bm))[:, None] * bm + np.arange(bm)
        valid = r < G * M
    r = np.where(valid, r, 0)
    rg, rm = r // M, r % M
    kp = np.clip(_per_group(ka, G, K), 0, K)[rg]
    live_m = valid & (rm < _per_group(ma, G, M)[rg])
    n_lim = _per_group(na, G, N)[rg]
    c0 = np.arange(_cdiv(N, bn)) * bn
    # row_kend: 0 past the prefixes, else the row's clamped k prefix; a
    # block's K loop ends at the largest over its rows (kend_tile)
    live = live_m[:, :, None] & (c0[None, None, :] < n_lim[:, :, None])
    kend = np.where(live, kp[:, :, None], 0).max(axis=1)     # (RT, CT)
    k_lo = np.arange(plan.splits) * plan.kchunk
    k_hi = np.minimum(kend[:, :, None], k_lo + plan.kchunk)
    n = np.where(k_hi > k_lo, _cdiv(k_hi - k_lo, step), 0)
    tiles = int(n.sum())
    return tiles, 2 * tiles


def edense_geometry(G, M, K, N, flags, plan, ka=None, na=None, ma=None):
    """One ``elastic_dense`` launch (K1): x (G, M, K) in the layout
    ``flags``, the wrapper's ``Plan``, per-group prefixes (None: full)."""
    return _geometry(_edense, (G, M, K, N, flags, plan), ka, na, ma)


# --- K5 --------------------------------------------------------------------
def _gmm(G, E, M, K, N, flags, plan, ga):
    from repro_torch.kernels import grouped_matmul as gm
    if G <= 0 or E <= 0 or M <= 0 or N <= 0:
        return 0, 0
    bm, bn = plan.bm, gm.TILE_N[plan.variant]
    ga = _per_group(ga, G, E)
    e = np.arange(E)
    if gm._grouped(flags):
        # a block per (g, e): its rows are that pair's, all live or dead
        live_blocks = int((e[None, :] < ga[:, None]).sum()) * _cdiv(M, bm)
    else:
        # a block per (expert, row tile) of the G·M rows over every group
        r = np.arange(_cdiv(G * M, bm))[:, None] * bm + np.arange(bm)
        valid = r < G * M
        g = np.where(valid, r, 0) // M
        live = valid[None] & (e[:, None, None] < ga[g][None])
        live_blocks = int(live.any(axis=2).sum())
    if plan.variant == "simt":
        stages = _cdiv(K, 16)                    # 16-deep SIMT steps
    else:
        k_lo = np.arange(plan.splits) * plan.kchunk
        k_hi = np.minimum(K, k_lo + plan.kchunk)
        stages = int(_cdiv(k_hi - k_lo, gm.STAGE_K).sum())
    tiles = live_blocks * _cdiv(N, bn) * stages
    return tiles, 2 * tiles


def gmm_geometry(G, E, M, K, N, flags, plan, ga=None):
    """One ``grouped_matmul`` launch (K5)."""
    return _geometry(_gmm, (G, E, M, K, N, flags, plan), ga)


# --- K2, K3, K4 ------------------------------------------------------------
def _live_heads(ha, B, H):
    return np.clip(_per_group(ha, B, H), 0, H)


def _key_blocks(q0, bq, bk, Sk, causal, window):
    """[kb_lo, kb_hi) of K2's and K3 mma's loops for the query tile at q0:
    the reference predicate ``attn_block_contributes`` on whole blocks."""
    nk = _cdiv(Sk, bk)
    lo = q0 - (window - 1) if window else 0
    kb_lo = np.where(lo > 0, lo // bk, 0) if window else np.zeros_like(q0)
    kb_hi = np.minimum(nk, (q0 + bq - 1) // bk + 1) if causal else \
        np.full_like(q0, nk)
    return np.maximum(kb_hi - kb_lo, 0)


def _flash_fwd(B, Sq, Sk, H, causal, window, ha):
    from repro_torch.kernels.flash_attention import FWD_TILE
    bq, bk = FWD_TILE
    n = _key_blocks(np.arange(_cdiv(Sq, bq)) * bq, bq, bk, Sk, causal,
                    window)
    live = int(_live_heads(ha, B, H).sum())
    return live * int(n.sum()), live * int((1 + 2 * n).sum())


def flash_fwd_geometry(B, Sq, Sk, H, causal=True, window=None, ha=None):
    """One ``flash_attention`` forward launch (K2)."""
    return _geometry(_flash_fwd, (B, Sq, Sk, H, causal, window or 0), ha)


def _simt_pairs(r0, c0, causal, window, br=16, bc=16):
    """Whether the 16-row block at r0 (queries) and the 16-column block at
    c0 (keys) contribute: the simt kernels' ``contributes``."""
    ok = np.ones(np.broadcast(r0, c0).shape, bool)
    if causal:
        ok &= ~(c0 > r0 + br - 1)
    if window:
        ok &= ~(c0 + bc - 1 < r0 - (window - 1))
    return ok


def _flash_dq(B, Sq, Sk, H, causal, window, plan, ha):
    bq, bk = plan.dq_tile
    q0 = np.arange(_cdiv(Sq, bq)) * bq
    if plan.variant == "mma":
        n = _key_blocks(q0, bq, bk, Sk, causal, window)
    else:
        k0 = np.arange(_cdiv(Sk, bk)) * bk
        n = _simt_pairs(q0[:, None], k0[None, :], causal, window).sum(1)
    live = int(_live_heads(ha, B, H).sum())
    return live * int(n.sum()), live * int((2 + 2 * n).sum())


def flash_dq_geometry(B, Sq, Sk, H, plan, causal=True, window=None,
                      ha=None):
    """One ``flash_attention_dq`` launch (K3) of ``plan``."""
    return _geometry(_flash_dq, (B, Sq, Sk, H, causal, window or 0, plan),
                     ha)


def _flash_dkv(B, Sq, Sk, H, KV, D, causal, window, plan, ha):
    kb, qb = plan.dkv_tile
    G = H // KV
    k0 = np.arange(_cdiv(Sk, kb)) * kb
    nq = _cdiv(Sq, qb)
    if plan.variant == "mma":
        lo = np.minimum(nq, k0 // qb) if causal else np.zeros_like(k0)
        hi = np.minimum(nq, (k0 + kb - 1 + window - 1) // qb + 1) \
            if window else np.full_like(k0, nq)
        steps = np.maximum(hi - lo, 0) * (2 if D > 128 else 1)
    else:
        q0 = np.arange(nq) * qb
        steps = _simt_pairs(q0[None, :], k0[:, None], causal, window).sum(1)
    h_lo = np.arange(KV) * G
    ha = _per_group(ha, B, H)
    nh = np.maximum(np.minimum(h_lo[None, :] + G, ha[:, None]) - h_lo, 0)
    tiles = int(nh.sum()) * int(steps.sum())
    blocks = int((nh > 0).sum()) * len(k0)
    return tiles, 2 * blocks + 2 * tiles


def flash_dkv_geometry(B, Sq, Sk, H, KV, D, plan, causal=True, window=None,
                       ha=None):
    """One ``flash_attention_dkv`` launch (K4) of ``plan``."""
    return _geometry(_flash_dkv, (B, Sq, Sk, H, KV, D, causal, window or 0,
                                  plan), ha)


# --- K6, K7 ----------------------------------------------------------------
def gather_rows_geometry(valid, n_src, d):
    """One ``gather_rows`` launch (K6, copy or scaled): a row per valid
    slot."""
    valid = np.asarray(valid).reshape(-1)
    if valid.size == 0 or n_src <= 0 or d <= 0:
        return NO_WORK
    n = int((valid != 0).sum())
    return Geometry(n, valid.size, n)


def gather_dot_geometry(valid, T, k, n_src, d):
    """One ``gather_dot`` launch (K6's contraction): a row per valid
    assignment and each token's z row."""
    valid = np.asarray(valid).reshape(-1)
    if T <= 0 or k <= 0 or n_src <= 0 or d <= 0:
        return NO_WORK
    n = int((valid[:T * k] != 0).sum())
    return Geometry(n, T * k, n + T)


def gather_reduce_geometry(gates, n_src, d):
    """One ``gather_reduce`` launch (K7): a row per (token, j) whose gate
    is not 0."""
    gates = np.asarray(gates)
    if gates.size == 0 or n_src <= 0 or d <= 0:
        return NO_WORK
    n = int((gates != 0).sum())
    return Geometry(n, gates.size, n)


# --- K8, K9 ----------------------------------------------------------------
def _ssd_fwd(R, S, H, P, Q, plan, ha):
    from repro_torch.kernels.ssd_scan import SIMT_TILE
    nc = S // Q
    live = int(_live_heads(ha, R, H).sum())
    if plan.variant == "simt":
        nqt = _cdiv(Q, SIMT_TILE)
        pairs = nqt * (nqt + 1) // 2
        return live * nc, live * nc * (3 * nqt + 2 * pairs)
    n_kt = _cdiv(Q, 32)                          # 32-key ring stages
    live *= P // plan.p_tile
    return live * nc, live * nc * 2 * n_kt


def ssd_fwd_geometry(R, S, H, P, Q, plan, ha=None):
    """One ``ssd_scan`` launch (K8) of ``plan``."""
    return _geometry(_ssd_fwd, (R, S, H, P, Q, plan), ha)


def _ssd_bwd(R, S, H, P, G, Q, plan, ha):
    from repro_torch.kernels.ssd_scan import (BWD_STEP, BWD_TILE, CB_TILE,
                                              SIMT_TILE)
    nc = S // Q
    ha = _per_group(ha, R, H)
    if plan.variant == "simt":
        live = int(np.clip(ha, 0, H).sum())
        nqt = _cdiv(Q, SIMT_TILE)
        pairs = nqt * (nqt + 1) // 2
        return live * nc, live * nc * (6 * nqt + 4 * pairs)
    tiles = dma = 0
    if nc > 1:                                   # dh, chunks 1 .. nc − 1
        live = int(np.clip(ha, 0, H).sum()) * (P // 32)
        tiles += live * (nc - 1)
        dma += live * (nc - 1) * 2 * _cdiv(Q, 32)
    rep, hs = H // G, plan.head_slice
    t0 = np.arange(_cdiv(Q, CB_TILE) * CB_TILE // BWD_TILE) * BWD_TILE
    q_steps = _cdiv(np.minimum(t0 + BWD_TILE, Q), BWD_STEP)   # dc
    k_steps = _cdiv(Q - t0, BWD_STEP)                          # dbx
    for r in range(R):
        for grp in range(G):
            for sl in range(_cdiv(rep, hs)):
                h0 = grp * rep + sl * hs
                h1 = min(h0 + hs, (grp + 1) * rep)
                nh = max(0, min(h1, ha[r]) - h0)
                if not nh:
                    continue
                tiles += nc * nh * int(q_steps.sum() + k_steps.sum())
                dma += nc * int((1 + nh * (2 + 2 * q_steps)).sum())
                dma += int((nc * (1 + nh * (1 + 2 * k_steps))).sum()) \
                    + (nc - 1) * nh * len(t0)
    return tiles, dma


def ssd_bwd_geometry(R, S, H, P, G, Q, plan, ha=None):
    """One ``ssd_scan_bwd`` launch (K9) of ``plan``: its dh, query and key
    tile kernels (mma) or its scan (simt)."""
    return _geometry(_ssd_bwd, (R, S, H, P, G, Q, plan), ha)
