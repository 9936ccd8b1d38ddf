"""The paper's RL gates' training against the reference (the forward, the
loss and ``sample``'s replayed draws: ``tests/test_torch_gating.py``,
whose small CNN, reference fixture and helpers this file shares):

* one ``make_gate_train_step`` step per mode: the loss ≤1e-5, adamw's
  moments (the clipped gradients) within 1e-5 of their largest, an sgd
  step's parameters ≤1e-5;
* ``train_gates``' first warm-up steps: the history's keys and phases
  identical, values ≤1e-5;
* ``gate_depth_policy``: depth and rates identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gating as ref_gating
from repro.optim import adamw as ref_adamw
from repro.optim import sgd as ref_sgd
from repro_torch.checkpoint.bridge import params_to_numpy
from repro_torch.core import (GateTrainConfig, gate_depth_policy,
                              make_gate_train_step, train_gates)
from repro_torch.optim import adamw, sgd

from test_torch_gating import (B, CFG, REF_CFG, TOL, _batch, _close, _port,
                               ref, ref_uniforms)

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["soft", "sample", "hard"])
def test_gate_train_step_matches_reference(ref, mode):
    """One ``make_gate_train_step`` step per mode. With ``adamw`` (2e-3,
    the gates' optimizer): the loss ≤1e-5 and the first moments — 0.1 ×
    the clipped gradients — within 1e-5 of each leaf's largest. Adam's
    first update is lr · g / (|g| + 1e-8), ±lr wherever |g| is at rounding
    noise (single conv weights whose gradient crosses 0 move by up to 1.4e-5
    apart here while their moments agree to 1e-9), so its parameters are
    held through an ``sgd`` step (lr 0.05) instead: ≤1e-5."""
    batch = _batch(ref, 2 * B)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    draws = ref_uniforms(ref["key"], CFG.n_blocks, B) \
        if mode == "sample" else None
    for ref_opt, opt in ((ref_adamw(2e-3), adamw(2e-3)),
                         (ref_sgd(0.05), sgd(0.05))):
        rstep = ref_gating.make_gate_train_step(REF_CFG, ref_opt, mode,
                                                0.15)
        rp, rst, rl, rm = rstep(ref["params"], ref_opt.init(ref["params"]),
                                jb, ref["key"])
        step = make_gate_train_step(CFG, opt, mode, 0.15)
        params = _port(ref["params"])
        p, st, l, m = step(params, opt.init(params), batch, draws)
        _close(l, rl)
        _close(m["compute_pct"], rm["compute_pct"])
        if "m" in rst:
            for got, want in zip(jax.tree.leaves(st["m"]),
                                 jax.tree.leaves(rst["m"])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=0,
                    atol=TOL * max(float(np.abs(want).max()), 1e-30))
        else:
            _close(p, rp)


def test_train_gates_warmup_history_matches_reference(ref):
    """``train_gates``' first warm-up steps (soft gates, no draws): the
    history's keys and phases identical, its values ≤1e-5 (the trained
    parameters are not held: Adam turns rounding noise in a gradient near
    0 into ±lr, see the step test)."""
    tcfg = dict(warmup_steps=3, rl_steps=0, lr=2e-3, compute_penalty=0.15)
    batches = [_batch(ref, i * B) for i in range(3)]
    _, rhist = ref_gating.train_gates(
        ref["params"], REF_CFG,
        iter([{k: jnp.asarray(v) for k, v in b.items()} for b in batches]),
        ref_gating.GateTrainConfig(**tcfg), seed=0)
    _, hist = train_gates(_port(ref["params"]), CFG, iter(batches),
                          GateTrainConfig(**tcfg), seed=0)
    assert [sorted(h) for h in hist] == [sorted(h) for h in rhist]
    assert [(h["step"], h["phase"]) for h in hist] == \
        [(h["step"], h["phase"]) for h in rhist]
    for h, r in zip(hist, rhist):
        for k in ("loss", "acc", "compute_pct"):
            assert abs(h[k] - r[k]) <= TOL, (k, h, r)


def test_gate_depth_policy_matches_reference(ref):
    """Depth and per-block rates identical, on the bridged parameters with
    the gates' fc2 biases shifted so that the rates differ by block."""
    params = jax.tree.map(np.copy, ref["params"])
    for si, stage in enumerate(params["stages"]):
        for bi, bp in enumerate(stage["blocks"]):
            bp["gate"]["fc2"]["b"] += np.float32(0.4 * (si - bi) - 0.1)
    sample = {"x": ref["x"][:32]}
    want = ref_gating.gate_depth_policy(params, REF_CFG,
                                        {"x": jnp.asarray(sample["x"])})
    got = gate_depth_policy(_port(params), CFG, sample)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert params_to_numpy(_port(params)).keys() == params.keys()
