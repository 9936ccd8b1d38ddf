"""The CNN's forward, masked forward and round against the JAX reference
(the host modules and ``elastic_conv2d``: ``tests/test_torch_cnn.py``,
whose small CNN, specs and helpers this file shares), on bridged
parameters and masks:

* ``groupnorm``, the CNN forward and loss, and ``masked_forward`` on both
  paths (dense masked, and the ``conv`` op) against the reference's:
  ≤1e-5; the masked parent against the extracted submodel;
* one ``run_fl_round`` of the CNN family on both paths against the
  reference engine's dense path: ≤1e-5, the same eval samples right.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import elastic as ref_elastic
from repro.fl import engine as ref_engine
from repro.models import cnn as ref_cnn
from repro.models.layers import groupnorm as ref_groupnorm
from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.core import elastic
from repro_torch.fl import engine
from repro_torch.kernels.dispatch import kernel_dispatch
from repro_torch.models import cnn
from repro_torch.models.layers import groupnorm
from repro_torch.optim.optimizers import tree_leaves, tree_map

from test_torch_cnn import (CFG, REF_CFG, SPECS, _close, _equal, _np,
                            _ref_specs)

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the model and the masked family
# ---------------------------------------------------------------------------
def _params():
    ref = _np(ref_cnn.init_params(jax.random.PRNGKey(3), REF_CFG))
    # the reference initialises biases to zero: give them values, so the
    # bias paths are held too
    rng = np.random.default_rng(3)
    ref = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape)
                       .astype(np.float32), ref)
    return ref, params_from_numpy(ref, device="cpu")


def test_groupnorm_and_cnn_forward_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 6, 5, 8)).astype(np.float32)
    _close(groupnorm(torch.as_tensor(x), 4).numpy(),
           np.asarray(ref_groupnorm(jnp.asarray(x), 4)))
    ref_p, p = _params()
    imgs = rng.random((5, 16, 16, 1)).astype(np.float32)
    labels = rng.integers(0, 10, 5).astype(np.int32)
    for depth in (None, (1, 2)):
        want, _ = ref_cnn.forward(ref_p, REF_CFG, jnp.asarray(imgs),
                                  depth=depth)
        got, info = cnn.forward(p, CFG, torch.as_tensor(imgs), depth=depth)
        _close(got.numpy(), np.asarray(want))
        assert float(info["compute_pct"]) == 1.0
    want_loss, want_m = ref_cnn.loss_fn(
        ref_p, REF_CFG, {"x": jnp.asarray(imgs), "y": jnp.asarray(labels)})
    got_loss, got_m = cnn.loss_fn(p, CFG, {"x": torch.as_tensor(imgs),
                                           "y": torch.as_tensor(labels)})
    _close(float(got_loss), float(want_loss))
    assert float(got_m["acc"]) == float(want_m["acc"])
    for depth, widths in ((None, None), ((1, 2), (0.5, 1.0))):
        assert cnn.flops(CFG, depth, widths) == \
            ref_cnn.flops(REF_CFG, depth, widths)
    # the RL gates' modes (ROADMAP A21 landed): soft and hard as the
    # reference's, sample on the reference's own uniforms replayed
    key = jax.random.PRNGKey(4)
    uniforms = []
    for _ in range(CFG.n_blocks):
        key, sub = jax.random.split(key)
        uniforms.append(torch.tensor(np.asarray(
            jax.random.uniform(sub, (len(labels),), jnp.float32))))
    for mode in ("soft", "sample", "hard"):
        want, want_info = ref_cnn.forward(
            ref_p, REF_CFG, jnp.asarray(imgs), gate_mode=mode,
            gate_key=jax.random.PRNGKey(4))
        got, info = cnn.forward(p, CFG, torch.as_tensor(imgs),
                                gate_mode=mode, gate_uniforms=uniforms)
        _close(got.numpy(), np.asarray(want))
        _close(info["log_prob"].numpy(), np.asarray(want_info["log_prob"]))
        _close(float(info["compute_pct"]),
               float(want_info["compute_pct"]))
    fresh = cnn.init_params(CFG, seed=0, device="cpu")
    assert jax.tree.structure(params_to_numpy(fresh)) == \
        jax.tree.structure(ref_p)
    _equal(jax.tree.map(np.shape, params_to_numpy(fresh)),
           jax.tree.map(np.shape, ref_p))


@pytest.mark.parametrize("backend", ["auto", None])
def test_masked_forward_matches_reference(backend):
    ref_p, p = _params()
    G = len(SPECS)
    rng = np.random.default_rng(4)
    x = rng.random((G, 3, 16, 16, 1)).astype(np.float32)
    ref_fam = ref_elastic.family_for(REF_CFG)
    fam = elastic.family_for(CFG)
    ref_masks = ref_fam.cohort_masks(_ref_specs(SPECS))
    ref_stacked = jax.tree.map(lambda a: np.broadcast_to(a, (G,) + a.shape),
                               ref_p)
    want = jax.vmap(lambda pp, fwd, xx: ref_elastic.masked_forward(
        pp, REF_CFG, xx, fwd["ch"], fwd["gn"], fwd["depth"]))(
            ref_stacked, ref_masks.fwd, jnp.asarray(x))
    masks = fam.cohort_masks(SPECS, "cpu")
    _equal(params_to_numpy(masks.fwd), _np(ref_masks.fwd))
    stacked = tree_map(lambda a: a.expand((G,) + a.shape), p)
    kernels = kernel_dispatch(backend).table("cnn")
    got = fam.masked_logits(stacked, masks.fwd, torch.as_tensor(x), kernels)
    _close(got.numpy(), np.asarray(want))
    # each client's masked parent is its extracted submodel
    for k, spec in enumerate(SPECS):
        sub, sub_cfg = fam.extract(p, spec)
        logits, _ = cnn.forward(sub, sub_cfg, torch.as_tensor(x[k]))
        _close(got[k].numpy(), logits.numpy())


@pytest.fixture(scope="module")
def reference_round():
    """The reference engine's CNN round (dense path), once for the
    module: 4 clients of different sizes (2 or 3 steps, padded steps in
    the stream), two local epochs."""
    ref_p, _ = _params()
    rng = np.random.default_rng(6)
    sizes = [12, 9, 5, 16]
    train = [{"x": rng.random((n, 16, 16, 1)).astype(np.float32),
              "y": rng.integers(0, 10, n).astype(np.int32)} for n in sizes]
    test = [{"x": rng.random((6, 16, 16, 1)).astype(np.float32),
             "y": rng.integers(0, 10, 6).astype(np.int32)} for _ in sizes]
    kw = dict(batch_size=4, epochs=2, seeds=[1, 2, 3, 4])
    eng = ref_engine.BatchedRoundEngine(REF_CFG, lr=0.1, momentum=0.9)
    new, accs, n_steps = eng.run_fl_round(
        ref_p, _ref_specs(SPECS), train, test, sizes, coverage_norm=True,
        **kw)
    return (ref_p, sizes, train, test, kw), (_np(new), accs,
                                             np.asarray(n_steps))


@pytest.mark.parametrize("backend", ["auto", None])
def test_cnn_round_matches_reference(reference_round, backend):
    (ref_p, sizes, train, test, kw), (want, want_accs, want_steps) = \
        reference_round
    eng = engine.BatchedRoundEngine(CFG, lr=0.1, momentum=0.9,
                                    backend=backend, device="cpu")
    new, accs, n_steps = eng.run_fl_round(
        params_from_numpy(ref_p, device="cpu"), SPECS, train, test, sizes,
        coverage_norm=True, **kw)
    np.testing.assert_array_equal(n_steps, want_steps)
    assert [round(a * 6) for a in accs] == [round(a * 6) for a in want_accs]
    _close(params_to_numpy(new), want)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(want), jax.tree.leaves(ref_p)))
    assert moved > 1e-2
    # the labels reached the loss: other labels train other parameters
    swapped = [dict(d, y=(d["y"] + 1) % 10) for d in train]
    other, _, _ = eng.run_fl_round(
        params_from_numpy(ref_p, device="cpu"), SPECS, swapped, test, sizes,
        coverage_norm=True, **kw)
    assert max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(other), tree_leaves(new))) > 1e-3
