"""K9's mma variant (``csrc/ssd_scan.cu``): its launch plan and its order of
work, on the CPU.

The card runs the SSD chunk scan's backward as a short sequential pass and
then the chunks in parallel: cum per (row, head, chunk) in fp64 and C·Bᵀ
once per (row, group, chunk) (K8's own kernels, launched again); dh, the
cotangent of the state leaving each chunk, carried across the chunks in
reverse; a query-tile and a key-tile kernel that loop over a head slice of
a group in head order, summing the slice's dC and dB in registers (the
slices' partials then summed in slice order); and the fp64 du pass. These
tests

* hold ``ssd_bwd_plan`` to the main path's shapes (132 SMs): the training
  shape takes the mma variant with head slices of 5, shapes the variant
  does not take run the simt variant, and no prefix reaches the plan;
* emulate the variant's arithmetic in plain torch on numpy-seeded inputs —
  per-chunk dh, C·Bᵀ per group, every product split into TF32 hi + lo
  parts with a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, each 8-deep step
  summed apart and promoted into the fp32 accumulator, dB / dC summed over
  a slice's heads in head order and the slices' partials in slice order —
  and hold it to ``ssd_scan_bwd_raw_plain`` and to the reference's Pallas
  ``ssd_scan_bwd`` (interpret mode) within ``K9_RTOL`` of each output's
  largest value (dA of Σ_s |du·dt|), at head prefixes 0 / ragged / full,
  one and two groups, one and four chunks and a chunk whose Σ|dt·A| passes
  88; one TF32 product alone misses the tolerance;
* on a card (``-m cuda``), hold each variant of the kernel to its plain
  version, each twice and bit-equal.
"""
import inspect
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan_bwd as ref_ssd_scan_bwd
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.ssd_scan import (chunk_cumsum, ssd_bwd_plan,
                                          ssd_scan_bwd_raw_plain,
                                          ssd_scan_plain)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the card check's tolerances)

torch.set_num_threads(2)
SMS = 132
LOW13 = 0x1FFF
ALL = ("lo_hi", "hi_lo", "hi_hi")
SMEM_PER_SM = 233472     # an H100 SM's shared memory, 1 KB a block reserved


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------
def test_plan_training_shape_takes_the_mma_variant():
    """mamba2-2.7b's SSD at the training slice (16 rows, 80 heads of 64,
    d_state 128, chunk 256): the mma variant, head slices of 5 (16 a
    group), about eight tile blocks an SM counting one chunk (the slice
    count rounds to whole heads), and two blocks of the tile kernels fit
    an SM's shared memory."""
    plan = ssd_bwd_plan(16, 80, 64, 128, 256, True, SMS)
    assert plan == ss.SsdBwdPlan("mma", 5)
    assert ss.bwd_slices(plan, 80, 1) == 16
    assert 16 * (256 // ss.BWD_TILE) * ss.bwd_slices(plan, 80, 1) >= 7 * SMS
    assert 2 * (ss.bwd_shared_bytes(64, 128, 256) + 1024) <= SMEM_PER_SM


def test_plan_slices_follow_the_grid():
    """Fewer (row, tile) pairs give narrower slices, down to one head (one
    row of the prefill's shape); a grid that fills the card alone keeps
    the whole group in one slice (no partials)."""
    assert ssd_bwd_plan(1, 80, 64, 128, 256, True, SMS) == ("mma", 1)
    assert ssd_bwd_plan(32, 80, 64, 128, 256, True, SMS) == ("mma", 9)
    assert ssd_bwd_plan(264, 8, 64, 128, 256, True, SMS) == ("mma", 8)
    assert ss.bwd_slices(ss.SsdBwdPlan("mma", 8), 8, 1) == 1
    assert ss.bwd_slices(ss.SsdBwdPlan("mma", 3), 8, 2) == 2


def test_plan_unsupported_shapes_take_the_simt_variant():
    """d_state not a multiple of 8 (20), a chunk above 256 (320) or
    operands that are not 16-byte aligned: the first design."""
    for args in ((2, 4, 32, 20, 32, True), (1, 2, 64, 64, 320, True),
                 (16, 80, 64, 128, 256, False)):
        assert ssd_bwd_plan(*args, SMS) == ss.SsdBwdPlan("simt", args[1])


def test_plan_never_sees_the_prefixes():
    """The plan is a function of shapes, alignment and the SM count; the
    wrapper's ``bwd_launch_plan`` of the operands alone."""
    assert list(inspect.signature(ssd_bwd_plan).parameters) == [
        "R", "H", "P", "N", "Q", "aligned", "sms"]
    assert list(inspect.signature(ss.bwd_launch_plan).parameters) == [
        "xh", "Bm", "Cm", "states", "dy", "chunk"]


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


def _mma3(a, b, acc, keep=ALL):
    """acc + a @ b (contraction on a's last axis), as ``mma3_add`` steps:
    8 terms at a time, the kept TF32 products summed smallest first into a
    fresh tile, then added to acc in fp32."""
    K = a.shape[-1]
    ah, al = _split(a)
    bh, bl = _split(b)
    parts = {"lo_hi": (al, bh), "hi_lo": (ah, bl), "hi_hi": (ah, bh)}
    for k0 in range(0, K, 8):
        t = torch.zeros_like(acc)
        for name in ALL:
            if name in keep:
                x, y = parts[name]
                t = t + x[..., k0:k0 + 8] @ y[..., k0:k0 + 8, :]
        acc = acc + t
    return acc


def _zeros(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def emulate_bwd_mma(xh, dt, A, Bm, Cm, states, dy, Q, head_slice,
                    h_active=None, keep=ALL):
    """dx, ddt, du and dB / dC per group of K9's mma variant in its order
    of work (see the module docstring), batched over rows; a head past a
    row's prefix adds exact zeros."""
    R, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, nc = H // G, S // Q
    A = A.expand(R, H) if A.dim() == 1 else A
    live = torch.ones((R, H), dtype=torch.bool) if h_active is None else \
        torch.arange(H)[None, :] < h_active[:, None]
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    cum = chunk_cumsum(dt.reshape(R, nc, Q, H) * A[:, None, None, :], 2)
    # C·Bᵀ once per (row, group, chunk): (R, nc, G, Q, Q)
    Cg = Cm.reshape(R, nc, Q, G, N).transpose(2, 3)
    Bg = Bm.reshape(R, nc, Q, G, N).transpose(2, 3)
    cb = _mma3(Cg, Bg.transpose(-1, -2), _zeros(R, nc, G, Q, Q), keep)
    # dh leaving each chunk (0 after the last), chunks in reverse
    dhs = _zeros(R, nc, H, P, N)
    dh = _zeros(R, H, P, N)
    for c in range(nc - 1, 0, -1):
        sl = slice(c * Q, (c + 1) * Q)
        e = cum[:, c].exp()                                   # (R, Q, H)
        dye = (dy[:, sl] * e[..., None]).permute(0, 2, 3, 1)  # (R,H,P,Q)
        Ch = Cg[:, c].repeat_interleave(rep, dim=1)           # (R,H,Q,N)
        hacc = _mma3(dye, Ch, _zeros(R, H, P, N), keep)
        dh = dh * cum[:, c, -1].exp()[..., None, None] + hacc
        dhs[:, c - 1] = dh
    dx, ddt, du = _zeros(R, S, H, P), _zeros(R, S, H), _zeros(R, S, H)
    dB, dC = _zeros(R, S, G, N), _zeros(R, S, G, N)
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        for g in range(G):
            B_g, C_g, cb_g = Bg[:, c, g], Cg[:, c, g], cb[:, c, g]
            db_parts, dc_parts = [], []
            for h0 in range(g * rep, (g + 1) * rep, head_slice):
                dbacc, dcacc = _zeros(R, Q, N), _zeros(R, Q, N)
                for h in range(h0, min(h0 + head_slice, (g + 1) * rep)):
                    m = live[:, h, None, None]
                    x_h, dt_h, dy_h = xh[:, sl, h], dt[:, sl, h], dy[:, sl, h]
                    cum_h = cum[:, c, :, h]                       # (R, Q)
                    xdt = x_h * dt_h[..., None]
                    # query tiles: dG, dCB, row sums, dC, dy·h_in
                    dG = _mma3(dy_h, xdt.transpose(1, 2), _zeros(R, Q, Q),
                               keep)
                    diff = cum_h[:, :, None] - cum_h[:, None, :]
                    L = diff.masked_fill(~tri, -np.inf).exp()
                    dCB = torch.where(tri, dG * L, torch.zeros(()))
                    DL = dCB * cb_g
                    dcacc = _mma3(dCB * m, B_g, dcacc, keep)
                    dyh = _mma3(dy_h, states[:, c, h], _zeros(R, Q, N), keep)
                    e = cum_h.exp()
                    dcacc = dcacc + e[..., None] * dyh * m
                    inter = (C_g * dyh).sum(-1) * e
                    # key tiles: dB, dxdt, column sums, the state terms
                    Mt = torch.where(tri, cb_g * L,
                                     torch.zeros(())).transpose(1, 2)
                    dbacc = _mma3(dCB.transpose(1, 2) * m, C_g, dbacc, keep)
                    dxdt = _mma3(Mt, dy_h, _zeros(R, Q, P), keep)
                    tw = _zeros(R, Q)
                    dhh = torch.zeros((R,), dtype=torch.float64)
                    if c < nc - 1:
                        w = (cum_h[:, -1:] - cum_h).exp()
                        XD = _mma3(xdt, dhs[:, c, h], _zeros(R, Q, N), keep)
                        dbacc = dbacc + w[..., None] * XD * m
                        tw = (XD * B_g).sum(-1) * w
                        BH = _mma3(B_g, dhs[:, c, h].transpose(1, 2),
                                   _zeros(R, Q, P), keep)
                        dxdt = dxdt + w[..., None] * BH
                        dhh = (dhs[:, c, h].double()
                               * states[:, c, h].double()).sum((1, 2))
                    # du in fp64, ddt, dx
                    d = ((DL.sum(2) - DL.sum(1)) + inter) - tw
                    d64 = d.double()
                    last = cum_h[:, -1].exp().double() * dhh + \
                        tw.double().sum(1)
                    u = ((d64.sum(1, keepdim=True) + last[:, None])
                         - torch.cumsum(d64, 1) + d64).float()
                    lv = live[:, h, None]
                    du[:, sl, h] = torch.where(lv, u, torch.zeros(()))
                    ddt[:, sl, h] = torch.where(
                        lv, (dxdt * x_h).sum(-1) + u * A[:, h, None],
                        torch.zeros(()))
                    dx[:, sl, h] = dxdt * dt_h[..., None] * lv[..., None]
                db_parts.append(dbacc)
                dc_parts.append(dcacc)
            dbs, dcs = db_parts[0], dc_parts[0]
            for pb, pc in zip(db_parts[1:], dc_parts[1:]):  # slice order
                dbs, dcs = dbs + pb, dcs + pc
            dB[:, sl, g], dC[:, sl, g] = dbs, dcs
    return dx, ddt, du, dB, dC


def _inputs(R, S, H, P, G, N, seed, dt_range=(0.01, 0.3)):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((R, S, H, P)).astype(f),
            rng.uniform(*dt_range, (R, S, H)).astype(f),
            -rng.uniform(1.0, 16.0, (R, H)).astype(f),
            rng.standard_normal((R, S, G, N)).astype(f),
            rng.standard_normal((R, S, G, N)).astype(f),
            rng.standard_normal((R, S, H, P)).astype(f))


def _errors(got, want, dt):
    """Each output's max|got − want| over max|want|; dA = Σ_s du·dt over
    Σ_s |du·dt| (the sum cancels along s), as phase 3c of chip_smoke.py
    holds the kernel."""
    err = {n: chip_smoke._rel_err(a, b) for n, a, b in
           zip(("dx", "ddt", "du", "dB", "dC"), got, want)}
    dA, dA_w = (torch.einsum("rsh,rsh->rh", u, dt) for u in (got[2],
                                                             want[2]))
    err["dA"] = float((dA - dA_w).abs().max()) / max(float(
        torch.einsum("rsh,rsh->rh", want[2].abs(), dt).max()), 1e-30)
    return err


# (label, R, S, H, P, G, N, Q, h_active, head_slice, dt range)
CASES = [
    ("prefix 0/ragged/full", 3, 128, 4, 32, 1, 16, 32, [0, 3, 4], 2,
     (0.01, 0.3)),
    ("groups 2", 2, 128, 4, 32, 2, 16, 32, [4, 3], 1, (0.01, 0.3)),
    ("one chunk", 2, 32, 4, 32, 1, 16, 32, [4, 1], 3, (0.01, 0.3)),
    ("sum|dt A| > 88", 1, 128, 2, 32, 1, 16, 64, None, 1, (1.0, 1.0)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mma_order_of_work_matches_plain_and_reference(case):
    """The emulated mma variant within K9_RTOL of the plain version and of
    the reference's Pallas kernel (row by row, interpret mode), dead heads
    exactly zero."""
    label, R, S, H, P, G, N, Q, ha, hs, dtr = case
    arrays = _inputs(R, S, H, P, G, N, seed=len(label), dt_range=dtr)
    xh, dt, A, Bm, Cm, dy = map(torch.from_numpy, arrays)
    hat = None if ha is None else torch.tensor(ha, dtype=torch.int32)
    _, st = ssd_scan_plain(xh, dt, A, Bm, Cm, Q, hat, True)
    got = emulate_bwd_mma(xh, dt, A, Bm, Cm, st, dy, Q, hs, hat)
    want = ssd_scan_bwd_raw_plain(xh, dt, A, Bm, Cm, st, dy, Q, hat)
    err = _errors(got, want, dt)
    assert max(err.values()) <= chip_smoke.K9_RTOL, err
    assert all(bool(torch.isfinite(t).all()) for t in got)
    for r, n in enumerate(ha or []):
        assert not any(bool(t[r, :, n:].any()) for t in got[:3])
    for r in range(R):
        ref = ref_ssd_scan_bwd(
            *(jnp.asarray(a[r:r + 1]) for a in arrays[:2]),
            jnp.asarray(arrays[2][r]),
            *(jnp.asarray(a[r:r + 1]) for a in arrays[3:5]),
            jnp.asarray(st[r:r + 1].numpy()), jnp.asarray(arrays[5][r:r + 1]),
            Q, h_active=jnp.int32(H if ha is None else ha[r]),
            interpret=True)
        dx_w, ddt_w, dA_w, dB_w, dC_w = (torch.from_numpy(np.array(t))
                                         for t in ref)
        for n, a, w in (("dx", got[0][r:r + 1], dx_w),
                        ("ddt", got[1][r:r + 1], ddt_w),
                        ("dB", got[3][r:r + 1], dB_w),
                        ("dC", got[4][r:r + 1], dC_w)):
            if w.abs().max() > 0:
                assert chip_smoke._rel_err(a, w) <= chip_smoke.K9_RTOL, n
            else:
                assert not a.any(), n
        dA = torch.einsum("sh,sh->h", got[2][r], dt[r])
        scale = float(torch.einsum("sh,sh->h", want[2][r].abs(),
                                   dt[r]).max())
        assert float((dA - dA_w).abs().max()) <= \
            chip_smoke.K9_RTOL * max(scale, 1e-30)


def test_one_tf32_product_misses_the_tolerance():
    """At the main path's chunk (256), d_state (128) and two chunks, the
    hi·hi product alone misses K9_RTOL; all three products stay within
    it."""
    arrays = _inputs(1, 512, 1, 32, 1, 128, seed=31)
    xh, dt, A, Bm, Cm, dy = map(torch.from_numpy, arrays)
    _, st = ssd_scan_plain(xh, dt, A, Bm, Cm, 256, None, True)
    want = ssd_scan_bwd_raw_plain(xh, dt, A, Bm, Cm, st, dy, 256)
    e3 = _errors(emulate_bwd_mma(xh, dt, A, Bm, Cm, st, dy, 256, 1),
                 want, dt)
    e1 = _errors(emulate_bwd_mma(xh, dt, A, Bm, Cm, st, dy, 256, 1,
                                 keep=("hi_hi",)), want, dt)
    assert max(e3.values()) <= chip_smoke.K9_RTOL / 5, e3
    assert max(e1.values()) > chip_smoke.K9_RTOL, e1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_ssd_bwd_variants_match_plain_on_card():
    """Each variant of K9 — mma (with one and with several head slices a
    group) and simt — against the plain version on the card, twice and
    bit-equal, every launch counted by its variant; runs only where there
    is a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    cases = [((2, 512, 80, 64, 1, 128), 256, ["mma", "simt"]),
             ((2, 128, 8, 32, 2, 16), 32, ["mma", "simt"]),
             ((2, 64, 4, 32, 1, 20), 32, ["simt"])]
    for (R, S, H, P, G, N), Q, variants in cases:
        xh, dt, A, Bm, Cm, dy = (torch.from_numpy(a).to(dev) for a in
                                 _inputs(R, S, H, P, G, N, seed=40))
        ha = torch.tensor([H, H // 2 + 1], dtype=torch.int32, device=dev)
        _, st = ss.ssd_scan(xh, dt, A, Bm, Cm, Q, h_active=ha,
                            return_states=True)
        assert ss.bwd_launch_plan(xh, Bm, Cm, st, dy, Q).variant == \
            variants[0]
        want = ssd_scan_bwd_raw_plain(xh, dt, A, Bm, Cm, st, dy, Q, ha)
        for variant in variants:
            before = ss.ssd_scan_bwd.launches_by_variant[variant]
            got = ss.ssd_scan_bwd_raw(xh, dt, A, Bm, Cm, st, dy, Q,
                                      h_active=ha, variant=variant)
            again = ss.ssd_scan_bwd_raw(xh, dt, A, Bm, Cm, st, dy, Q,
                                        h_active=ha, variant=variant)
            torch.cuda.synchronize()
            assert ss.ssd_scan_bwd.launches_by_variant[variant] == before + 2
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            err = _errors(got, want, dt)
            assert max(err.values()) <= chip_smoke.K9_RTOL, (variant, err)
            assert not any(bool(t[1, :, H // 2 + 1:].any())
                           for t in got[:3])
