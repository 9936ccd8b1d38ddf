"""K8's mma variant (``csrc/ssd_scan.cu``): its launch plan and its order of
work, on the CPU.

The card runs the SSD chunk scan as three kernels: cum per (row, head,
chunk) in fp64, C·Bᵀ once per (row, group, chunk), and the scan with its
three per-head products on 3×TF32 tensor cores, a block per (row, head,
slice of P). These tests

* hold ``ssd_plan`` to the main path's shapes (132 SMs): the training and
  the prefill shapes take the mma variant with P split in slices of 32,
  a grid smaller than the card halves the slice, shapes the variant does
  not take run the simt variant, and no prefix reaches the plan;
* emulate the variant's arithmetic in plain torch on numpy-seeded inputs —
  C·Bᵀ once per group, every product split into TF32 hi + lo parts with
  a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, each 8-deep step summed apart
  and promoted into the fp32 accumulator, y's state term first, the P
  slices computed apart — and hold it to ``ssd_scan_plain`` and to the
  reference's Pallas ``ssd_scan`` (interpret mode) within ``K8_RTOL`` of
  the largest |y| (and of the largest state); the P split is exact (bit
  for bit), and one TF32 product alone misses the tolerance;
* on a card (``-m cuda``), hold each variant of the kernel to its plain
  version.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.ssd_scan import (chunk_cumsum, ssd_plan,
                                          ssd_scan_plain)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the card check's tolerances)

torch.set_num_threads(2)
SMS = 132
LOW13 = 0x1FFF
ALL = ("lo_hi", "hi_lo", "hi_hi")


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------
# (label, R, H, P, N, Q): mamba2-2.7b's SSD at chip_smoke.py's phases 11-13
MAIN_PATH = [("train", 16, 80, 64, 128, 256), ("prefill", 1, 80, 64, 128, 256)]


@pytest.mark.parametrize("label,R,H,P,N,Q", MAIN_PATH,
                         ids=[c[0] for c in MAIN_PATH])
def test_plan_main_path_takes_the_mma_variant_with_p_split(label, R, H, P,
                                                           N, Q):
    """Training and the prefill run the tensor-core variant, P split into
    slices of 32 (two blocks per (row, head)), at least one block per SM,
    and two of its blocks fit an SM's shared memory."""
    plan = ssd_plan(R, H, P, N, Q, True, SMS)
    assert plan == ss.SsdPlan("mma", 32)
    assert P // plan.p_tile == 2
    assert ss.plan_blocks(plan, R, H, P) >= SMS
    assert 2 * (ss.shared_bytes(plan.p_tile, N, Q) + 1024) <= 233472


def test_plan_small_grid_halves_the_p_tile():
    """Fewer (row, head, 32-column) blocks than SMs: slices of 16, so that
    twice as many blocks share the work; never below 16."""
    assert ssd_plan(2, 4, 64, 128, 64, True, SMS) == ss.SsdPlan("mma", 16)
    assert ssd_plan(1, 40, 32, 64, 128, True, SMS) == ss.SsdPlan("mma", 16)
    assert ssd_plan(1, 132, 32, 64, 128, True, SMS) == ss.SsdPlan("mma", 32)
    assert ss.plan_blocks(ss.SsdPlan("mma", 16), 2, 4, 64) == 32


def test_plan_unsupported_shapes_take_the_simt_variant():
    """d_state not a multiple of 8 or above 128, a chunk above 256 or
    operands that are not 16-byte aligned: the first design."""
    for args in ((2, 4, 32, 20, 32, True), (1, 2, 64, 64, 320, True),
                 (16, 80, 64, 128, 256, False)):
        assert ssd_plan(*args, SMS) == ss.SsdPlan("simt", args[2])


def test_plan_never_sees_the_prefixes():
    """The plan is a function of shapes, alignment and the SM count; the
    wrapper's ``launch_plan`` of the operands alone."""
    import inspect
    assert list(inspect.signature(ssd_plan).parameters) == [
        "R", "H", "P", "N", "Q", "aligned", "sms"]
    assert list(inspect.signature(ss.launch_plan).parameters) == [
        "xh", "Bm", "Cm", "chunk"]


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


def emulate_mma(xh, dt, A, Bm, Cm, Q, p_tile, h_active=None, keep=ALL):
    """y and the per-chunk states of K8's mma variant in its order of
    work (see the module docstring)."""
    R, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, nc = H // G, S // Q
    A = A.expand(R, H) if A.dim() == 1 else A
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    ys, states = torch.zeros_like(xh), torch.zeros((R, nc, H, P, N))
    for p0 in range(0, P, p_tile):               # the P slices, apart
        h = torch.zeros((R, H, p_tile, N))
        for c in range(nc):
            sl = slice(c * Q, (c + 1) * Q)
            Cc, Bc = Cm[:, sl].transpose(1, 2), Bm[:, sl].transpose(1, 2)
            # C·Bᵀ once per (row, group, chunk): (R, G, Q, Q)
            cb = _mma3(Cc, Bc.transpose(-1, -2), torch.zeros((R, G, Q, Q)),
                       keep)
            cb = cb.repeat_interleave(rep, dim=1)          # each head reads
            cum = chunk_cumsum(dt[:, sl] * A[:, None, :], 1).transpose(1, 2)
            diff = cum[..., :, None] - cum[..., None, :]
            lcb = torch.where(tri, cb * diff.masked_fill(~tri, -np.inf)
                              .exp(), torch.zeros(()))
            x = xh[:, sl, :, p0:p0 + p_tile].transpose(1, 2)   # (R,H,Q,pt)
            d = dt[:, sl].transpose(1, 2)[..., None]          # (R,H,Q,1)
            xdt = x * d
            states[:, c, :, p0:p0 + p_tile] = h
            Ch = Cc.repeat_interleave(rep, dim=1)             # (R,H,Q,N)
            ev = cum.exp()[..., None]
            acc = _mma3(Ch, h.transpose(-1, -2),
                        torch.zeros((R, H, Q, p_tile)), keep) * ev
            acc = _mma3(lcb, xdt, acc, keep)
            ys[:, sl, :, p0:p0 + p_tile] = acc.transpose(1, 2)
            wend = (cum[..., -1:] - cum).exp()[..., None]
            Bh = Bc.repeat_interleave(rep, dim=1)
            hacc = _mma3((xdt * wend).transpose(-1, -2), Bh,
                         torch.zeros((R, H, p_tile, N)), keep)
            h = h * cum[..., -1].exp()[..., None, None] + hacc
    if h_active is not None:
        live = torch.arange(H)[None, :] < h_active[:, None]
        ys = ys * live[:, None, :, None]
        states = states * live[:, None, :, None, None]
    return ys, states


def _inputs(R, S, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((R, S, H, P)).astype(f),
            rng.uniform(0.01, 0.3, (R, S, H)).astype(f),
            -rng.uniform(1.0, 16.0, (R, H)).astype(f),
            rng.standard_normal((R, S, G, N)).astype(f),
            rng.standard_normal((R, S, G, N)).astype(f))


def _rel(got, want):
    """max|got − want| over max|want| (states of a first chunk are zero)."""
    return chip_smoke._rel_err(got, want)


@pytest.mark.parametrize("G", [1, 2])
def test_mma_order_of_work_matches_plain_and_reference(G):
    """The emulated mma variant within K8_RTOL of the plain version and of
    the reference's Pallas kernel (row by row, interpret mode) at two
    chunks of 64, P 64 in two slices, d_state 32, a ragged head prefix."""
    R, S, H, P, N, Q = 3, 128, 4, 64, 32, 64
    arrays = _inputs(R, S, H, P, G, N, seed=20 + G)
    xh, dt, A, Bm, Cm = map(torch.from_numpy, arrays)
    ha = torch.tensor([4, 1, 3], dtype=torch.int32)
    y, st = emulate_mma(xh, dt, A, Bm, Cm, Q, 32, ha)
    y_p, st_p = ssd_scan_plain(xh, dt, A, Bm, Cm, Q, ha, True)
    assert _rel(y, y_p) <= chip_smoke.K8_RTOL
    assert _rel(st, st_p) <= chip_smoke.K8_RTOL
    assert not y[1, :, 1:].any() and not st[1, :, 1:].any()
    for r in range(R):
        want_y, want_st = ref_ssd_scan(
            *(jnp.asarray(a[r:r + 1]) for a in (arrays[0], arrays[1])),
            jnp.asarray(arrays[2][r]),
            *(jnp.asarray(a[r:r + 1]) for a in (arrays[3], arrays[4])), Q,
            h_active=jnp.int32(int(ha[r])), interpret=True,
            return_states=True)
        assert _rel(y[r:r + 1], torch.from_numpy(np.array(want_y))) \
            <= chip_smoke.K8_RTOL
        assert _rel(st[r:r + 1], torch.from_numpy(np.array(want_st))) \
            <= chip_smoke.K8_RTOL


def test_p_split_is_exact():
    """Each column of P is computed by the same operations whatever slice
    it lies in: slices of 16 and of 32 give the same bits."""
    xh, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(2, 64, 2, 64, 1, 16,
                                                      seed=30))
    y16, st16 = emulate_mma(xh, dt, A, Bm, Cm, 32, 16)
    y32, st32 = emulate_mma(xh, dt, A, Bm, Cm, 32, 32)
    assert torch.equal(y16, y32) and torch.equal(st16, st32)


def test_one_tf32_product_misses_the_tolerance():
    """At the main path's chunk (256) and d_state (128), the hi·hi product
    alone misses K8_RTOL; all three products stay within it."""
    xh, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(1, 256, 1, 16, 1, 128,
                                                      seed=31))
    y_p = ssd_scan_plain(xh, dt, A, Bm, Cm, 256)
    y3, _ = emulate_mma(xh, dt, A, Bm, Cm, 256, 16)
    y1, _ = emulate_mma(xh, dt, A, Bm, Cm, 256, 16, keep=("hi_hi",))
    assert _rel(y3, y_p) <= chip_smoke.K8_RTOL / 5
    assert _rel(y1, y_p) > chip_smoke.K8_RTOL


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_ssd_variants_match_plain_on_card():
    """Each plan of K8 — mma with P slices of 32 and of 16, simt — against
    the plain version on the card, every launch counted by its variant;
    runs only where there is a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    cases = [((2, 256, 80, 64, 1, 128), 256, "mma", 32),
             ((2, 128, 4, 64, 2, 32), 64, "mma", 16),
             ((2, 64, 4, 32, 1, 20), 32, "simt", 32)]
    for (R, S, H, P, G, N), Q, variant, p_tile in cases:
        xh, dt, A, Bm, Cm = (torch.from_numpy(a).to(dev)
                             for a in _inputs(R, S, H, P, G, N, seed=40))
        ha = torch.tensor([H, H // 2], dtype=torch.int32, device=dev)
        assert ss.launch_plan(xh, Bm, Cm, Q) == (variant, p_tile)
        before = ss.ssd_scan.launches_by_variant[variant]
        y, st = ss.ssd_scan(xh, dt, A, Bm, Cm, Q, h_active=ha,
                            return_states=True)
        y_p, st_p = ssd_scan_plain(xh, dt, A, Bm, Cm, Q, ha, True)
        torch.cuda.synchronize()
        assert ss.ssd_scan.launches_by_variant[variant] == before + 1
        assert _rel(y, y_p) <= chip_smoke.K8_RTOL
        assert _rel(st, st_p) <= chip_smoke.K8_RTOL
        assert not y[1, :, H // 2:].any()
