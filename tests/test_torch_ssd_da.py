"""dA of the SSD backward on the reference bench's inputs (ROADMAP C8), on
the CPU.

dA = Σ_s du·dt cancels: on the bench's inputs (dt = softplus(N(0, 1)), one
A shared by the rows) at mamba2's head_dim, d_state and chunk, its terms
are ~15 times its total here (~1e3 times at the main widths). K9 and its
plain version now emit each (row, head, chunk)'s partial in fp64, from a
du formed in fp64 with the row and column sums of DL (the decay-weighted
dG∘CB of the chunk) taken in fp64; the fp32 sums and the fp32 du stay as
they were. These tests hold the plain version's dA against the fp64
oracle (autograd of the plain forward on fp64 leaves, as the gate's parity
runs it), show the old reduction (Σ over the fp32 du) and the reference's
own backward (its interpret-mode Pallas kernel, Σ over its fp32 du) miss
by more on the same inputs, and check the partials' contract: dead heads
exactly 0, their sum equal to ``ssd_scan_bwd``'s dA.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan_bwd as ref_ssd_scan_bwd
from repro_torch.kernels import ssd_scan as ss

torch.set_num_threads(2)
# 4 rows of 512 tokens, 16 heads of 64, one group, d_state 128, chunk 256
R, S, H, P, G, N, Q = 4, 512, 16, 64, 1, 128, 256
TOL = 1e-5          # the tile-accounting gate's parity bound


@pytest.fixture(scope="module")
def bench():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((R, S, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((R, S, H), generator=g))
    A = -torch.exp(0.3 * torch.randn((H,), generator=g))
    Bm, Cm = (torch.randn((R, S, G, N), generator=g) for _ in range(2))
    dy = torch.randn((R, S, H, P), generator=g)
    _, st = ss.ssd_scan_plain(x, dt, A, Bm, Cm, Q, None, True)
    raw = ss.ssd_scan_bwd_raw_plain(x, dt, A, Bm, Cm, st, dy, Q)
    lv = [t.double().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    oracle = torch.autograd.grad(ss.ssd_scan_plain(*lv, Q), lv,
                                 dy.double())[2]
    ref = ref_ssd_scan_bwd(*(jnp.asarray(t.numpy()) for t in
                             (x, dt, A, Bm, Cm, st, dy)), Q, interpret=True)
    return dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, dy=dy, st=st, raw=raw,
                oracle=oracle, ref_dA=torch.from_numpy(np.array(ref[2])))


def _err(got, oracle):
    return float((got.double() - oracle).abs().max()) / max(
        float(oracle.abs().max()), 1.0)


def test_plain_dA_holds_fp64_where_the_old_sum_and_the_reference_miss(
        bench):
    raw, oracle, dt = bench["raw"], bench["oracle"], bench["dt"]
    new = ss._reduce_bwd(raw, bench["x"], dt, bench["A"], bench["Bm"],
                         bench["Cm"])[2]
    old = torch.einsum("rsh,rsh->h", raw[2], dt)       # Σ of the fp32 du
    terms = float(torch.einsum("rsh,rsh->h", raw[2].abs(), dt).max())
    assert terms > 10 * float(oracle.abs().max())      # the sum cancels
    e_new, e_old = _err(new, oracle), _err(old, oracle)
    e_ref = _err(bench["ref_dA"], oracle)
    # readings on this host: new 3.9e-6, old 7.9e-6, reference 1.5e-5
    assert e_new <= TOL / 2, e_new
    assert e_old > 1.5 * e_new, (e_old, e_new)
    assert e_ref > TOL, e_ref            # the reference's own miss


def test_partials_contract(bench):
    """(R, H, S/Q) fp64 partials; a dead head's are exactly 0; their sum
    is ``ssd_scan_bwd``'s dA, which keeps A's dtype and shape."""
    x, dt, A, Bm, Cm = (bench[k] for k in ("x", "dt", "A", "Bm", "Cm"))
    dap = bench["raw"][5]
    assert dap.shape == (R, H, S // Q) and dap.dtype == torch.float64
    ha = torch.tensor([H, 5, 0, 9], dtype=torch.int32)
    raw = ss.ssd_scan_bwd_raw_plain(x[:, :Q], dt[:, :Q], A, Bm[:, :Q],
                                    Cm[:, :Q], bench["st"][:, :1],
                                    bench["dy"][:, :Q], Q, ha)
    for r, n in enumerate(ha.tolist()):
        assert not raw[5][r, n:].any()
        assert n == 0 or bool((raw[5][r, :n] != 0).all())
    grads = ss.ssd_scan_bwd(x, dt, A, Bm, Cm, bench["st"], bench["dy"], Q)
    assert grads[2].shape == A.shape and grads[2].dtype == A.dtype
    torch.testing.assert_close(grads[2], dap.sum((0, 2)).float(), rtol=0,
                               atol=0)
