"""K6's scaled gather and gather-dot, and the launch plans of K6 / K7's
redesign (``kernels/moe_dispatch.py``, ``csrc/moe_dispatch.cu``).

The combine's VJP (the reference's ``_make_combine`` bwd) gathers each
slot's token cotangent times the slot's gate, and contracts the token
cotangent with the slot rows each assignment pointed at. The port runs
each in one K6 pass: ``gather_rows(..., scale=)`` and ``gather_dot``. On
numpy-seeded inputs these tests hold

* both plain versions to ``jax.vjp`` of the reference's ``moe_combine``
  (interpret mode) at k ∈ {1, 6, 8}, d not a multiple of 4, dropped
  assignments and an expert prefix of 0: the slot cotangent bit-equal,
  the gate cotangent within 1e-5 of each entry's Σ_d |z·x| (another order
  of the same fp32 sum), dead slots exactly 0;
* the port's ``moe_combine`` / ``moe_dispatch`` gradients on the CPU
  bit-equal to the composition they replaced (the copy times the gates,
  the re-gathered rows and an einsum);
* the K6 / K7 launch plans as pure functions of the shapes and the SM
  count, at the main path's shapes (132 SMs);
* on a card (``-m cuda``), each variant against its plain version, twice
  and bit-equal run to run.
"""
import inspect
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_dispatch import moe_combine as ref_moe_combine
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels.moe_dispatch import (gather_dot, gather_dot_plain,
                                              gather_reduce, gather_rows,
                                              gather_rows_plain,
                                              moe_combine, moe_dispatch)

torch.set_num_threads(2)
SMS = 132
DOT_RTOL = 1e-5      # the gate cotangent, relative to Σ_d |z·x| per entry


def _route_tables(T, k, E, cap, ga, seed):
    """Slot / assignment tables as ``models.moe`` builds them: random
    expert choices, first come first kept up to ``cap``, experts >= ga
    masked (numpy int32: kept, dest, slot_src, slot_valid)."""
    rng = np.random.RandomState(seed)
    flat = rng.randint(0, E, size=T * k)
    pos = np.zeros(T * k, np.int64)
    counts = np.zeros(E, np.int64)
    for a in np.argsort(flat, kind="stable"):
        pos[a] = counts[flat[a]]
        counts[flat[a]] += 1
    kept = (pos < cap) & (flat < ga)
    dest = np.where(kept, flat * cap + pos, E * cap)
    slot_src = np.zeros(E * cap, np.int64)
    slot_valid = np.zeros(E * cap, np.int64)
    for a in np.flatnonzero(kept):
        slot_src[dest[a]] = a // k
        slot_valid[dest[a]] = 1
    return tuple(a.astype(np.int32) for a in (kept, dest, slot_src,
                                              slot_valid))


def _combine_inputs(T, k, E, cap, ga, d, seed):
    kept, dest, src, valid = _route_tables(T, k, E, cap, ga, seed)
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, k)).astype(np.float32)
    gates = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    gate_eff = (gates * kept.reshape(T, k)).astype(np.float32)
    slot_gate = np.zeros(E * cap + 1, np.float32)
    slot_gate[dest] = gate_eff.reshape(-1)
    return dict(y=rng.standard_normal((E * cap, d)).astype(np.float32),
                gate_eff=gate_eff, dest=dest, src=src, valid=valid,
                slot_gate=slot_gate[:-1],
                dout=rng.standard_normal((T, d)).astype(np.float32))


def _dot_close(got, x, idx, valid, z, k, want):
    """|got − want| ≤ DOT_RTOL · Σ_d |z·x| per entry (a floor of 1e-30)."""
    rows = gather_rows_plain(x, idx, valid).reshape(z.shape[0], k, -1)
    mag = torch.einsum("td,tjd->tj", z.abs().double(), rows.abs().double())
    err = (got.double() - torch.from_numpy(np.array(want)).double()).abs()
    assert bool((err <= DOT_RTOL * mag.clamp_min(1e-30)).all()), \
        float((err / mag.clamp_min(1e-30)).max())


# (T, k, E, cap, ga, d): k 1 / 6 / 8, d not a multiple of 4, caps below
# the demand (dropped assignments), an expert prefix of 0 and a ragged one
CASES = [(12, 1, 4, 2, 4, 13), (10, 6, 8, 5, 5, 30), (9, 8, 6, 8, 0, 33),
         (16, 8, 8, 9, 6, 18)]


@pytest.mark.parametrize("T,k,E,cap,ga,d", CASES)
def test_combine_vjp_plain_versions_match_reference(T, k, E, cap, ga, d):
    """The scaled gather and the gather-dot (their plain versions, which
    the CPU runs) against ``jax.vjp`` of the reference's Pallas
    ``moe_combine`` in interpret mode."""
    a = _combine_inputs(T, k, E, cap, ga, d, seed=T * k + d)

    def combine(y, g):
        return ref_moe_combine(y, g, a["dest"], a["src"], a["valid"],
                               jnp.asarray(a["slot_gate"]), interpret=True)
    _, vjp = jax.vjp(combine, jnp.asarray(a["y"]), jnp.asarray(a["gate_eff"]))
    want_dy, want_dgate = vjp(jnp.asarray(a["dout"]))

    t = {n: torch.from_numpy(v) for n, v in a.items()}
    dy = gather_rows(t["dout"], t["src"], t["valid"], scale=t["slot_gate"])
    np.testing.assert_array_equal(dy.numpy(), np.asarray(want_dy))
    assert not dy[t["valid"] == 0].any()            # dead slots: exactly 0
    live = (t["gate_eff"].reshape(-1) != 0).to(torch.int32)
    dgate = gather_dot(t["y"], t["dest"], live, t["dout"], k)
    assert dgate.shape == (T, k) and dgate.dtype == torch.float32
    _dot_close(dgate, t["y"], t["dest"], live, t["dout"], k, want_dgate)
    assert not dgate.reshape(-1)[live == 0].any()   # dropped: exactly 0


@pytest.mark.parametrize("T,k,E,cap,ga,d", CASES[1:3])
def test_port_gradients_bit_equal_to_the_replaced_composition(T, k, E, cap,
                                                              ga, d):
    """``moe_combine``'s gradients (through ``combine_vjp``) and
    ``moe_dispatch``'s on the CPU, bit for bit what the VJPs computed
    before the fusion: the copy times ``slot_gate``, the re-gathered slot
    rows contracted by an einsum, and K7 for the dispatch."""
    a = _combine_inputs(T, k, E, cap, ga, d, seed=7 * k + d)
    t = {n: torch.from_numpy(v) for n, v in a.items()}
    y = t["y"].clone().requires_grad_(True)
    g = t["gate_eff"].clone().requires_grad_(True)
    out = moe_combine(y, g, t["dest"], t["src"], t["valid"], t["slot_gate"])
    dy, dgate = torch.autograd.grad(out, (y, g), t["dout"])
    old_dy = gather_rows(t["dout"], t["src"], t["valid"]) * \
        t["slot_gate"][:, None]
    yg = gather_rows(t["y"], t["dest"],
                     (t["gate_eff"].reshape(-1) != 0).to(torch.int32))
    old_dgate = torch.einsum("td,tjd->tj", t["dout"].float(),
                             yg.reshape(T, k, -1).float())
    assert torch.equal(dy, old_dy) and torch.equal(dgate, old_dgate)

    kept = t["gate_eff"].reshape(-1) != 0
    xt = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (T, d)).astype(np.float32)).requires_grad_(True)
    eb = moe_dispatch(xt, t["src"], t["valid"], t["dest"],
                      kept.to(torch.int32), n_experts=E, cap=cap)
    deb = torch.from_numpy(np.random.default_rng(k).standard_normal(
        tuple(eb.shape)).astype(np.float32))
    dxt, = torch.autograd.grad(eb, xt, deb)
    old_dxt = gather_reduce(deb.reshape(-1, d), t["dest"].reshape(T, k),
                            kept.reshape(T, k).float())
    assert torch.equal(dxt, old_dxt)


def test_launch_plans_are_functions_of_shapes_and_sms():
    """K6 / K7 / the gather-dot's launches take the shapes, the 16-byte
    vector flag and the SM count — never the indices — and at the MoE
    path's shapes (granite-moe: d 1024, top-8, 4 clients × 32 experts ×
    160 slots from 2048 tokens; a 2-slot decode step: 512 slots, 2 tokens)
    give a block an SM or more."""
    assert list(inspect.signature(md.gather_plan).parameters) == ["R", "sms"]
    for plan in (md.reduce_plan, md.dot_plan):
        assert list(inspect.signature(plan).parameters) == [
            "T", "d", "vec", "sms"]
    # K6: the training dispatch 8 warps a block; the decode dispatch 2
    assert md.gather_plan(20480, SMS) == md.GatherPlan(8)
    assert md.gather_plan(512, SMS) == md.GatherPlan(2)
    assert -(-512 // md.gather_plan(512, SMS).warps) >= SMS
    assert md.gather_plan(3, SMS) == md.GatherPlan(1)
    # K7: the training combine 8 warps a block (2048 blocks); a decode step
    # 16 one-warp blocks (256 column vectors a token, 32 a warp)
    assert md.reduce_plan(2048, 1024, True, SMS) == md.GatherPlan(8)
    assert md.reduce_plan(2, 1024, True, SMS) == md.GatherPlan(1)
    assert 2 * -(-1024 // 4 // 32) >= 16
    assert md.reduce_plan(2, 1024, False, SMS) == md.GatherPlan(1)
    # the gather-dot: two warps a token at training, four where tokens are
    # few, one where a row has too few vectors to share
    assert md.dot_plan(2048, 1024, True, SMS) == md.DotPlan(2)
    assert md.dot_plan(2, 1024, True, SMS) == md.DotPlan(4)
    assert md.dot_plan(2, 33, False, SMS) == md.DotPlan(1)
    assert md.dot_plan(200, 1024, True, SMS) == md.DotPlan(4)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Shapes that do not fit, a scale for the first design (CPU tensors
    never reach the variants), and the launch counters untouched by the
    plain versions."""
    x = torch.zeros((4, 8))
    idx = torch.zeros(6, dtype=torch.int32)
    before = (gather_rows.launches, gather_dot.launches,
              gather_reduce.launches)
    with pytest.raises(ValueError):
        gather_rows(x, idx, idx, scale=torch.zeros(5))
    with pytest.raises(ValueError):
        gather_dot(x, idx, idx, torch.zeros((2, 8)), 2)
    assert gather_dot(x, idx, idx, torch.zeros((3, 8)), 2).shape == (3, 2)
    assert gather_rows(x, idx, idx, scale=torch.ones(6)).shape == (6, 8)
    assert (gather_rows.launches, gather_dot.launches,
            gather_reduce.launches) == before
    assert md.GATHER_VARIANTS[-1] == "unrolled" and \
        md.REDUCE_VARIANTS[-1] == "split"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_gather_variants_match_plain_on_card():
    """Every K6 / K7 variant (copy in both designs, scaled, gather-dot; K7
    in both designs) against its plain version on the card at k 1, 2, 6, 8
    and two generic values (3, and 10: two groups of 8), d 1024 and 33,
    twice each and bit-equal run to run; K7's designs bit-equal to each
    other. Runs only where there is a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    dev = torch.device("cuda")
    for k in (1, 2, 6, 8, 3, 10):
        for d in (1024, 33):
            a = _combine_inputs(50, k, 8, 40, 6, d, seed=k * d)
            t = {n: torch.from_numpy(v).to(dev) for n, v in a.items()}
            live = (t["gate_eff"].reshape(-1) != 0).to(torch.int32)
            tables = dict(xt=t["dout"], src=t["src"], valid=t["valid"],
                          dest=t["dest"], kept=live, gate_eff=t["gate_eff"],
                          y=t["y"], slot_gate=t["slot_gate"])
            problems = chip_smoke.check_gathers(dev, tables, k, f"k={k}",
                                                d, {})
            assert not problems, problems
