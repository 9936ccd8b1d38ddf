"""K2, K3 and K4 at head_dim 80 (hubert-xlarge, the zoo's only
non-causal parent).

* The launch plans: 80 is a kernel head dim, hubert's training attention
  takes the mma variant with the tiles of D ≤ 64, and two blocks of each
  kernel fit an SM's shared memory (``fwd_shared_bytes``,
  ``bwd_shared_bytes``).
* The plain versions the CPU path runs, against the reference's Pallas
  forward and backward in interpret mode at D = 80 (non-causal with head
  prefixes, a ragged S; causal GQA with a window and a softcap), ≤1e-5.
* On a card (``-m cuda``): K2 and both variants of K3 / K4 against their
  plain versions at hubert's attention, non-causal, each twice and
  bit-equal, within ``chip_smoke``'s K2_TOL / K34_TOL.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _block_sizes, _bwd_call, _fwd_call
from repro_torch.kernels import flash_attention as fa

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the card check's tolerances)

torch.set_num_threads(2)
TOL = 1e-5
D = 80
SM_SMEM = 233472               # an H100 SM's shared memory, bytes
BLOCK_RESERVED = 1024          # the runtime's share of each block's


def test_d80_plans_fit_two_blocks_an_sm():
    """80 is a kernel head dim; hubert's training attention (4 rows of 512
    frames, 16 / 16 heads) takes the mma variant at the tiles of every
    other head dim, an unaligned view the simt one; K2 (66,560 B, K / V
    double-buffered), K3 (96,256 B) and K4 (70,912 B) fit two blocks an
    SM, as at D = 64 (rows of D + 8 and D + 4 floats)."""
    assert D in fa.KERNEL_HEAD_DIMS
    plan = fa.flash_bwd_plan(4, 512, 512, 16, 16, D, True)
    assert plan == fa.FlashBwdPlan("mma", (64, 32), (64, 16))
    assert fa.flash_bwd_plan(4, 512, 512, 16, 16, D, False).variant == \
        "simt"
    sizes = (fa.fwd_shared_bytes(D),) + fa.bwd_shared_bytes(plan, D)
    assert sizes == (66560, 96256, 70912)
    assert all(2 * (n + BLOCK_RESERVED) <= SM_SMEM for n in sizes)
    # D = 64 keeps its sizes
    assert fa.fwd_shared_bytes(64) == 54272
    assert fa.bwd_shared_bytes(plan, 64) == (79872, 58624)


def _inputs(B, S, H, KV, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32),
            rng.standard_normal((B, S, H, D)).astype(np.float32))


# (B, S, H, KV, h_active per row, causal, window, cap): hubert's MHA,
# non-causal, with head prefixes 2 and 1 and a ragged S; causal GQA 2:1
# with a window that binds and a softcap
CASES = [
    (2, 32, 2, 2, [2, 1], False, None, None),
    (1, 21, 2, 2, [2], False, None, None),
    (2, 40, 4, 2, [4, 1], True, 9, 30.0),
]


@pytest.mark.parametrize("B,S,H,KV,has,causal,window,cap", CASES)
def test_d80_plain_matches_reference(B, S, H, KV, has, causal, window,
                                      cap):
    """o, lse, dq, dk, dv of the plain versions against the reference's
    Pallas forward and backward (interpret mode), row by row with each
    row's head prefix."""
    q, k, v, do = _inputs(B, S, H, KV, seed=S + H)
    bq, bk = _block_sizes(S, S, 8, 16)
    kw = dict(causal=causal, window=window, cap=cap, scale=1.0 / np.sqrt(D),
              bq=bq, bk=bk, interpret=True)
    want = {n: [] for n in ("o", "lse", "dq", "dk", "dv")}
    for b, ha in enumerate(has):
        sl = slice(b, b + 1)
        args = [jnp.asarray(a[sl]) for a in (q, k, v)]
        ha_j = jnp.asarray([ha], jnp.int32)
        o, lse = _fwd_call(*args, ha_j, **kw)
        dq, dk, dv = _bwd_call(*args, jnp.asarray(do[sl]), o, lse, ha_j,
                               **kw)
        for n, t in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk),
                     ("dv", dv)):
            want[n].append(np.asarray(t))
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    ha = torch.tensor(has, dtype=torch.int32)
    opts = dict(causal=causal, window=window, cap=cap)
    o, lse = fa.flash_attention_fwd_plain(qt, kt, vt, ha, **opts)
    delta = (dot * o).sum(-1).transpose(1, 2).contiguous()
    got = {"o": o, "lse": lse,
           "dq": fa.flash_attention_dq(qt, kt, vt, dot, lse, delta, ha,
                                       **opts)}
    got["dk"], got["dv"] = fa.flash_attention_dkv(qt, kt, vt, dot, lse,
                                                  delta, ha, **opts)
    for n, t in got.items():
        np.testing.assert_allclose(t.numpy(), np.concatenate(want[n]),
                                   atol=TOL, rtol=1e-6 if n == "lse" else 0,
                                   err_msg=n)


# (label, B, S, H, KV, causal, window, cap): chip_smoke.py phase 3f's
# shapes, fewer rows
CARD_CASES = [("hubert", 2, 512, 16, 16, False, None, None),
              ("hubert-ragged", 2, 77, 16, 16, False, None, None),
              ("causal-gqa", 2, 130, 8, 2, True, 17, 30.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("label,B,S,H,KV,causal,window,cap", CARD_CASES,
                         ids=[c[0] for c in CARD_CASES])
def test_cuda_d80_kernels_match_plain_on_card(label, B, S, H, KV, causal,
                                              window, cap):
    """K2 and both variants of K3 / K4 at D = 80 against their plain
    versions on the card, with ragged head prefixes, each kernel twice and
    bit-equal; runs only where there is a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    q, k, v, do = (torch.from_numpy(a).to(dev)
                   for a in _inputs(B, S, H, KV, seed=len(label)))
    ha = torch.tensor([H - (H // 2) * (i % 2) for i in range(B)],
                      dtype=torch.int32, device=dev)
    opts = dict(causal=causal, window=window, cap=cap)
    before = fa.flash_attention.launches
    runs = [fa.flash_attention(q, k, v, ha, **opts) for _ in range(2)]
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    o_want, lse_want = fa.flash_attention_fwd_plain(q, k, v, ha, **opts)
    for got in runs:
        assert torch.equal(got[0], runs[0][0])
        assert float((got[0] - o_want).abs().max()) <= chip_smoke.K2_TOL
    o, lse = runs[0]
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, ha)
    want = (fa.flash_attention_dq_plain(*args, **opts),) + \
        fa.flash_attention_dkv_plain(*args, **opts)
    assert fa.bwd_launch_plan(q, k, v, do).variant == "mma"
    for variant in fa.FLASH_BWD_VARIANTS:
        runs = [(fa.flash_attention_dq(*args, variant=variant, **opts),) +
                fa.flash_attention_dkv(*args, variant=variant, **opts)
                for _ in range(2)]
        torch.cuda.synchronize()
        for got, again, w in zip(*runs, want):
            assert torch.equal(got, again)
            assert float((got - w).abs().max()) <= chip_smoke.K34_TOL, \
                variant
