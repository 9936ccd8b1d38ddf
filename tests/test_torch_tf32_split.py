"""The 3×TF32 arithmetic of the Hopper kernels K1 (``csrc/elastic_dense.cu``)
and K2 (``csrc/flash_attention_fwd.cu``), emulated in plain torch.

``csrc/mma_tf32.cuh`` splits every fp32 operand v into hi, the TF32 value
nearest v (round to nearest on the low 13 mantissa bits, ties away from
zero, as ``cvt.rna.tf32.f32``), and lo = v - hi, which the tensor core reads
truncated to TF32; a product is taken as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi.
On numpy-seeded inputs at K1's longest contraction ((32, 12800) @
(12800, 64), the down projection of granite-3-8b) and at K2's D = 128
attention scores, these tests hold the emulation to an fp64 product: the
three products stay within ``chip_smoke.py``'s K1_TOL / K2_TOL, while one
TF32 product does not, nor any two of the three — a kernel that dropped a
product would miss its tolerance on the card.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the card check's tolerances)

torch.set_num_threads(2)
LOW13 = 0x1FFF


def rna_tf32(x):
    """fp32 -> the nearest TF32 value (ties away from zero): add half of the
    dropped range to the bits, then clear it (a carry into the exponent is
    the rounding up it should be)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~LOW13).view(torch.float32)


def trunc_tf32(x):
    """fp32 -> TF32 by dropping the low 13 mantissa bits (what the tensor
    core does with an operand that is not a TF32 value)."""
    return (x.contiguous().view(torch.int32) & ~LOW13).view(torch.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, trunc_tf32(x - hi)


def products(a, b, keep):
    """a @ b from the TF32 products named in ``keep`` (of "lo_hi", "hi_lo",
    "hi_hi"), each exact (11-bit significands), summed in fp32 as the
    kernels' promoted accumulators do."""
    ah, al = split(a)
    bh, bl = split(b)
    parts = {"lo_hi": (al, bh), "hi_lo": (ah, bl), "hi_hi": (ah, bh)}
    y = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for name in ("lo_hi", "hi_lo", "hi_hi"):     # smallest first
        if name in keep:
            y = y + parts[name][0] @ parts[name][1]
    return y


def k1_operands():
    """x (32, 12800), w (12800, 64) ~ N(0, 1/K): outputs O(1), as the
    port's K1 cases."""
    rng = np.random.default_rng(15)
    K = 12800
    x = rng.standard_normal((32, K)).astype(np.float32)
    w = (rng.standard_normal((K, 64)) / np.sqrt(K)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w), None, chip_smoke.K1_TOL


def k2_operands():
    """q (64, 128) and kᵀ (128, 64) ~ N(0, 1), the scores scaled by
    1/sqrt(D) as K2 scales them."""
    rng = np.random.default_rng(16)
    D = 128
    q = rng.standard_normal((64, D)).astype(np.float32)
    k = rng.standard_normal((64, D)).astype(np.float32)
    return (torch.from_numpy(q), torch.from_numpy(k.T.copy()), 1 / np.sqrt(D),
            chip_smoke.K2_TOL)


OPERANDS = {"k1_down_K12800": k1_operands, "k2_scores_D128": k2_operands}
ALL = ("lo_hi", "hi_lo", "hi_hi")


def _err(name, keep):
    a, b, scale, tol = OPERANDS[name]()
    want = a.double() @ b.double()
    got = products(a, b, keep).double()
    if scale is not None:
        want, got = want * scale, got * scale
    return float((got - want).abs().max()), tol


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11),
                      1.0 + 3 * 2 ** -11, 3.0, -2.5e-3], dtype=torch.float32)
    hi = rna_tf32(x)
    # ties (exactly half a TF32 ulp, 2^-11 at 1.0) go away from zero
    assert hi[0] == 1.0 + 2 ** -10 and hi[2] == -(1.0 + 2 ** -10)
    assert hi[1] == 1.0 and hi[3] == 1.0 + 2 * 2 ** -10 and hi[4] == 3.0
    assert not (hi.view(torch.int32) & LOW13).any()
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal(10000).astype(np.float32))
    h, lo = split(v)
    assert bool(((v - rna_tf32(v)).abs() <= 2.0 ** -11 * v.abs()).all())
    # hi + lo recovers v to 2^-21 of it (lo truncated to TF32)
    assert bool(((h.double() + lo.double() - v.double()).abs()
                 <= 2.0 ** -21 * v.abs().double()).all())


@pytest.mark.parametrize("name", sorted(OPERANDS))
def test_three_tf32_products_stay_within_tolerance(name):
    err, tol = _err(name, ALL)
    assert err <= tol / 10, (name, err, tol)


@pytest.mark.parametrize("keep", [("hi_hi",), ("hi_lo", "hi_hi"),
                                  ("lo_hi", "hi_hi")],
                         ids=["one_product", "without_lo_hi",
                              "without_hi_lo"])
@pytest.mark.parametrize("name", sorted(OPERANDS))
def test_fewer_tf32_products_miss_tolerance(name, keep):
    err, tol = _err(name, keep)
    assert err > tol, (name, keep, err, tol)
