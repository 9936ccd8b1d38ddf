"""The port's SSM slice against the JAX reference.

Each module that holds a kernel, and the slice as a whole, on numpy-seeded
inputs at ``reduced(mamba2-2.7b, n_layers=2, d_model=64)`` (d_inner 128:
4 SSD heads of 32, d_state 16, chunk 16; sequences of 2–3 chunks):

* K8 / K9's plain versions (``ssd_scan`` / ``ssd_scan_bwd``) against the
  reference's Pallas kernels in interpret mode, row by row with the row's
  own A and head prefix (0, ragged, full), one and two groups, three
  chunks;
* the ``ssd`` op's gradients (through K9's plain version) and the dense
  ``ssd_chunked`` against the reference's Pallas ``ssd`` op — also where
  a chunk's Σ|dt·A| passes 88: the reference's own dense path then gives
  NaN gradients, the port's dense path stays finite and agrees;
* the block, the parent, its round and its server, and the slice's
  repairs: ``tests/test_torch_ssm_model.py``.

Tolerances: 1e-5 for one op, one forward or one round (relative to the
largest value where the values grow past 1), identical greedy tokens and
1e-4 logits for a multi-step decode. On the CPU the port runs its kernels'
plain versions; ``tests/test_torch_ssm_model.py``'s ``-m cuda`` test holds the
kernels to them on a card.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.core.submodel import TransformerSubSpec as RefSpec
from repro.kernels.dispatch import kernel_dispatch as ref_dispatch
from repro.kernels.ssd_scan import ssd_scan as ref_ssd_scan
from repro.kernels.ssd_scan import ssd_scan_bwd as ref_ssd_scan_bwd
from repro.models import ssm as ref_ssm
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.dispatch import ssd_op
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_bwd,
                                          ssd_scan_bwd_plain,
                                          ssd_scan_plain)
from repro_torch.models import ssm

torch.set_num_threads(2)
TOL = 1e-5
SLICE_TOL = 1e-4
ARCH = "mamba2-2.7b"


def _configs():
    return (ref_reduced(REF_ARCHS[ARCH], n_layers=2, d_model=64),
            reduced(ARCHS[ARCH], n_layers=2, d_model=64))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_specs(specs):
    return [RefSpec(s.layers, s.ff_frac, s.expert_frac, s.ssm_head_frac,
                    s.attn_head_frac) for s in specs]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _rel_close(got, want, tol=TOL):
    """max|got − want| ≤ tol · max(1, max|want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{err:.3e} > {tol:g} x {scale:.3g}"


def _scan_inputs(R, S, H, P, G, N, seed, dt_scale=(0.01, 0.3)):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        xh=rng.standard_normal((R, S, H, P)).astype(f),
        dt=rng.uniform(*dt_scale, (R, S, H)).astype(f),
        A=-rng.uniform(1.0, 16.0, (R, H)).astype(f),
        Bm=rng.standard_normal((R, S, G, N)).astype(f),
        Cm=rng.standard_normal((R, S, G, N)).astype(f))


# ---------------------------------------------------------------------------
# K8 / K9
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_scan_plain_versions_match_reference_kernels(G):
    """K8 (with the per-chunk states) and K9 against the reference's Pallas
    kernels in interpret mode, one call per row (each row its own A and
    head prefix: 0, ragged, full), 3 chunks of 16."""
    R, S, H, P, N, Q = 3, 48, 4, 8, 6, 16
    ha = np.array([0, 3, 4], np.int32)
    d = _scan_inputs(R, S, H, P, G, N, seed=G)
    dy = np.random.default_rng(10 + G).standard_normal(
        (R, S, H, P)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    hat = torch.from_numpy(ha)
    y, st = ssd_scan(t["xh"], t["dt"], t["A"], t["Bm"], t["Cm"], Q,
                     h_active=hat, return_states=True)
    torch.testing.assert_close(
        y, ssd_scan_plain(t["xh"], t["dt"], t["A"], t["Bm"], t["Cm"], Q,
                          hat), atol=0, rtol=0)
    grads = ssd_scan_bwd(t["xh"], t["dt"], t["A"], t["Bm"], t["Cm"], st,
                         torch.from_numpy(dy), Q, h_active=hat)
    for r in range(R):
        one = {k: jnp.asarray(v[r:r + 1]) for k, v in d.items() if k != "A"}
        A_r = jnp.asarray(d["A"][r])
        want_y, want_st = ref_ssd_scan(
            one["xh"], one["dt"], A_r, one["Bm"], one["Cm"], Q,
            h_active=jnp.int32(ha[r]), interpret=True, return_states=True)
        _rel_close(y[r:r + 1], want_y)
        _rel_close(st[r:r + 1], want_st)
        want = ref_ssd_scan_bwd(
            one["xh"], one["dt"], A_r, one["Bm"], one["Cm"], want_st,
            jnp.asarray(dy[r:r + 1]), Q, h_active=jnp.int32(ha[r]),
            interpret=True)
        for name, got, w in zip(("dx", "ddt", "dA", "dB", "dC"), grads,
                                want):
            got_r = got[r] if name == "dA" else got[r:r + 1]
            _rel_close(got_r, w)
        assert not grads[0][r, :, ha[r]:].any()        # dead heads: zero
    assert not y[0].any() and not st[0].any()


def test_port_import_warms_cpu_math_on_one_thread():
    """The repair of a first-call difference: in a fresh process under
    load, the first ``torch.exp`` that torch split over its threads came
    back with ~1e-4 errors in one thread's part (the decay of the scan
    above, whose ``y`` then missed its exact match with
    ``ssd_scan_plain``). Importing the port now calls each transcendental
    function of its CPU paths once, on one element (fp32, then fp64),
    before any plain version runs."""
    code = (
        "import torch\n"
        "seen = []\n"
        "real = torch.exp\n"
        "torch.exp = lambda x, *a, **k: (seen.append((x.numel(), x.dtype)),"
        " real(x, *a, **k))[1]\n"
        "import repro_torch\n"
        "assert seen == [(1, torch.float32), (1, torch.float64)], seen\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_ssd_scan_bwd_plain_is_not_autograd_but_agrees_with_it():
    """K9's plain version (the transposed-scan algebra) agrees with
    autograd through K8's plain version, A shared by the rows."""
    d = _scan_inputs(2, 32, 4, 8, 2, 5, seed=3)
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in d.items()}
    t["A"] = torch.from_numpy(d["A"][0]).requires_grad_(True)
    ha = torch.tensor([2, 4], dtype=torch.int32)
    args = [t[k] for k in ("xh", "dt", "A", "Bm", "Cm")]
    y = ssd_scan_plain(*args, 16, ha)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(y, args, dy)
    _, st = ssd_scan_plain(*[a.detach() for a in args], 16, ha, True)
    got = ssd_scan_bwd_plain(*[a.detach() for a in args], st, dy, 16, ha)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _rel_close(g, w)


# ---------------------------------------------------------------------------
# the ssd op and the dense path
# ---------------------------------------------------------------------------
def _ssd_grads_port(fn, d, dyw, head_mask=None):
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in d.items()}
    args = [t[k] for k in ("xh", "dt", "A", "Bm", "Cm")]
    y = fn(*args, head_mask)
    (y * torch.from_numpy(dyw)).sum().backward()
    return y.detach(), [a.grad for a in args]


def _ssd_grads_ref(fn, d, dyw):
    args = [jnp.asarray(d[k]) for k in ("xh", "dt", "A", "Bm", "Cm")]
    y, vjp = jax.vjp(fn, *args)
    return y, vjp(jnp.asarray(dyw))


@pytest.mark.parametrize("mask", [None, (1, 1, 0, 0)])
def test_ssd_op_gradients_match_reference_kernel(mask):
    """y and all five gradients of the port's ``ssd`` op (K8 / K9 plain
    versions behind the autograd Function) and of its dense
    ``ssd_chunked`` against the reference's Pallas ``ssd`` op (interpret
    mode), 3 chunks, two groups, with and without a head mask."""
    R, S, H, P, G, N, Q = 2, 48, 4, 8, 2, 6, 16
    d = _scan_inputs(R, S, H, P, G, N, seed=5)
    d["A"] = d["A"][0]
    dyw = np.random.default_rng(6).standard_normal(
        (R, S, H, P)).astype(np.float32)
    hm = None if mask is None else np.asarray(mask, np.float32)
    ref_op = ref_dispatch("interpret").table()["ssd"]
    want_y, want = _ssd_grads_ref(
        lambda *a: ref_op(*a, Q, head_mask=None if hm is None
                          else jnp.asarray(hm))[0], d, dyw)
    y, got = _ssd_grads_port(
        lambda *a: ssd_op(*a[:5], Q, head_mask=a[5])[0], d, dyw,
        None if hm is None else torch.from_numpy(hm))
    _rel_close(y, want_y)
    for g, w in zip(got, want):
        _rel_close(g, w)
    if hm is None:
        y, got = _ssd_grads_port(
            lambda *a: ssm.ssd_chunked(*a[:5], Q)[0], d, dyw)
        _rel_close(y, want_y)
        for g, w in zip(got, want):
            _rel_close(g, w)


def test_dense_path_stays_finite_where_the_reference_overflows():
    """dt = 1, A = (−1, −16), chunk 32: a chunk's Σ|dt·A| reaches 512, so
    the reference's dense ``ssd_chunked`` (``where(tri, exp(diff), 0)``)
    gives NaN dt and A gradients. The port masks the decay before the
    exponential: its dense path and its op stay finite and equal the
    reference's Pallas op (which never reaches exp in the upper
    triangle)."""
    R, S, H, P, N, Q = 1, 64, 2, 8, 4, 32
    rng = np.random.default_rng(7)
    f = np.float32
    d = dict(xh=rng.standard_normal((R, S, H, P)).astype(f),
             dt=np.ones((R, S, H), f), A=np.array([-1.0, -16.0], f),
             Bm=rng.standard_normal((R, S, 1, N)).astype(f),
             Cm=rng.standard_normal((R, S, 1, N)).astype(f))
    dyw = rng.standard_normal((R, S, H, P)).astype(f)
    _, ref_dense = _ssd_grads_ref(
        lambda *a: ref_ssm.ssd_chunked(*a, Q)[0], d, dyw)
    assert not all(np.isfinite(np.asarray(g)).all() for g in ref_dense)
    ref_op = ref_dispatch("interpret").table()["ssd"]
    want_y, want = _ssd_grads_ref(lambda *a: ref_op(*a, Q)[0], d, dyw)
    for fn in (lambda *a: ssm.ssd_chunked(*a[:5], Q)[0],
               lambda *a: ssd_op(*a[:5], Q)[0]):
        y, got = _ssd_grads_port(fn, d, dyw)
        _rel_close(y, want_y)
        for g, w in zip(got, want):
            _rel_close(g, w)
