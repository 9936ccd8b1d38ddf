"""The paper's RL gates (§III-C, Fig. 7) against the reference.

On the small CNN of ``tests/test_gating.py``, with the reference's
parameters bridged (``checkpoint.bridge``) and numpy-seeded images:

* ``soft`` / ``hard`` forward, and ``loss_fn`` with its gradients ≤1e-5;
* ``sample`` with the reference's ``jax.random`` draws replayed (the test
  walks the key chain ``split`` → ``uniform`` itself and hands the
  uniforms to the port): the gate decisions identical, loss, log-probs
  and the REINFORCE gradients ≤1e-5; the port's own draws from a
  ``torch.Generator`` give valid decisions;
* the gate train step, ``train_gates``' warm-up and
  ``gate_depth_policy``: ``tests/test_torch_gate_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CNNConfig as RefCNNConfig
from repro.models import cnn as ref_cnn
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.models import cnn

torch.set_num_threads(2)
TOL = 1e-5
SMALL = dict(name="gate-test", in_channels=1, image_size=28,
             stem_channels=8, stages=((16, 2), (32, 2)), groupnorm_groups=4)
CFG, REF_CFG = CNNConfig(**SMALL), RefCNNConfig(**SMALL)
B = 16


@pytest.fixture(scope="module")
def ref():
    """The reference's parameters, numpy images and labels, and its gate
    key."""
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray,
                          ref_cnn.init_params(jax.random.PRNGKey(1),
                                              REF_CFG))
    x = rng.uniform(0, 1, (4 * B, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 4 * B).astype(np.int32)
    return dict(params=params, x=x, y=y, key=jax.random.PRNGKey(3))


def _port(params):
    return params_from_numpy(params, device="cpu")


def _close(got, want, tol=TOL):
    a, b = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(a) == len(b)
    for u, w in zip(a, b):
        u = u.detach().numpy() if torch.is_tensor(u) else np.asarray(u)
        np.testing.assert_allclose(u, np.asarray(w), atol=tol, rtol=0)


def ref_uniforms(key, n_blocks, batch):
    """The uniforms behind the reference's ``sample`` gates: one
    ``split`` of the key a block, then ``bernoulli(sub, p)`` =
    ``uniform(sub, p.shape) < p``."""
    out = []
    for _ in range(n_blocks):
        key, sub = jax.random.split(key)
        out.append(torch.tensor(np.asarray(
            jax.random.uniform(sub, (batch,), jnp.float32))))
    return out


def _batch(ref, lo=0, n=B):
    return ({"x": ref["x"][lo:lo + n], "y": ref["y"][lo:lo + n]})


def _port_loss_and_grads(params, batch, **kw):
    leaves = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                          _port(params))
    loss, m = cnn.loss_fn(leaves, CFG, {k: torch.from_numpy(v)
                                        for k, v in batch.items()}, **kw)
    flat = jax.tree.leaves(leaves)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        flat, torch.autograd.grad(loss, flat, allow_unused=True))]
    return loss, m, jax.tree.unflatten(jax.tree.structure(leaves),
                                       list(grads))


def _ref_loss_and_grads(params, batch, **kw):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, m), g = jax.value_and_grad(
        lambda p: ref_cnn.loss_fn(p, REF_CFG, jb, **kw), has_aux=True)(
        params)
    return loss, m, g


@pytest.mark.parametrize("mode", ["off", "soft", "hard"])
def test_forward_and_loss_match_reference(ref, mode):
    """Logits, compute fractions and the loss with its gradients ≤1e-5;
    the hard gates' decisions (per-example compute) identical."""
    batch = _batch(ref)
    want_logits, want_info = ref_cnn.forward(
        ref["params"], REF_CFG, jnp.asarray(batch["x"]), gate_mode=mode)
    got_logits, got_info = cnn.forward(_port(ref["params"]), CFG,
                                       torch.from_numpy(batch["x"]),
                                       gate_mode=mode)
    _close(got_logits, want_logits)
    for k in ("compute_pct", "per_example_compute", "log_prob"):
        _close(got_info[k], want_info[k])
    if mode == "hard":
        np.testing.assert_array_equal(
            got_info["per_example_compute"].numpy(),
            np.asarray(want_info["per_example_compute"]))
    loss, m, grads = _port_loss_and_grads(ref["params"], batch,
                                          gate_mode=mode,
                                          compute_penalty=0.15)
    rloss, rm, rgrads = _ref_loss_and_grads(ref["params"], batch,
                                            gate_mode=mode,
                                            compute_penalty=0.15)
    _close(loss, rloss)
    _close({k: m[k] for k in rm}, rm)
    _close(grads, rgrads)


def test_sample_replays_reference_draws(ref):
    """``sample`` on the reference's uniforms: the Bernoulli decisions
    identical, log-probs, loss and the REINFORCE gradients ≤1e-5; the
    port's own generator draws valid 0/1 gates."""
    batch = _batch(ref, B)
    u = ref_uniforms(ref["key"], CFG.n_blocks, B)
    _, want_info = ref_cnn.forward(ref["params"], REF_CFG,
                                   jnp.asarray(batch["x"]),
                                   gate_mode="sample", gate_key=ref["key"])
    _, got_info = cnn.forward(_port(ref["params"]), CFG,
                              torch.from_numpy(batch["x"]),
                              gate_mode="sample", gate_uniforms=u)
    np.testing.assert_array_equal(
        got_info["per_example_compute"].numpy(),
        np.asarray(want_info["per_example_compute"]))
    _close(got_info["log_prob"], want_info["log_prob"])
    loss, m, grads = _port_loss_and_grads(ref["params"], batch,
                                          gate_mode="sample",
                                          gate_uniforms=u,
                                          compute_penalty=0.15)
    rloss, rm, rgrads = _ref_loss_and_grads(ref["params"], batch,
                                            gate_mode="sample",
                                            gate_key=ref["key"],
                                            compute_penalty=0.15)
    _close(loss, rloss)
    _close(grads, rgrads)
    # the REINFORCE term moves the gate parameters (soft does too; hard
    # and off give them no gradient)
    gate_g = grads["stages"][0]["blocks"][0]["gate"]["fc2"]["w"]
    assert float(gate_g.abs().max()) > 0
    gen = torch.Generator().manual_seed(0)
    _, info = cnn.forward(_port(ref["params"]), CFG,
                          torch.from_numpy(batch["x"]), gate_mode="sample",
                          generator=gen)
    frac = info["per_example_compute"] * CFG.n_blocks
    assert torch.equal(frac, frac.round())
    with pytest.raises(ValueError, match="generator"):
        cnn.forward(_port(ref["params"]), CFG, torch.from_numpy(batch["x"]),
                    gate_mode="sample")
