"""The LM train step, its schedules and the train driver against the
reference.

* ``constant`` / ``linear_warmup_cosine`` / ``cosine_decay`` and the
  optimizers' ``_lr_at`` at every step of a run: equal to the reference's
  (the cosine within one fp32 ulp: XLA's fp32 ``cos`` and the port's
  correctly rounded one part at a few arguments); ``sgd`` with weight decay
  on a schedule ≤1e-6;
* ``synthetic_lm_batches`` identical to the reference's (tokens, a vision
  frontend's zero image embeddings, an audio frontend's frames and labels);
* ``make_train_step`` on reduced qwen3, bridged parameters: the fp32
  step's gradients (adamw's first moments, 0.1 × g) within 1e-5 of
  ``jax.value_and_grad`` of the reference's ``loss_fn``; the bf16 step's
  loss within 2e-2 of the reference's bf16 ``make_train_step``; microbatch
  2 against 1 ≤1e-6; a kernel table with a non-fp32 dtype raises;
* ``train()`` on reduced qwen3 runs on the CPU and its loss falls.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.launch import steps as RS
from repro.launch import train as RTR
from repro.models import transformer as RT
from repro.optim import optimizers as RO
from repro.optim import schedule as RSCH
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.dispatch import kernel_dispatch
from repro_torch.launch import steps as PS
from repro_torch.launch import train as PTR
from repro_torch.optim import optimizers as PO
from repro_torch.optim import schedule as PSCH
from repro_torch.optim.optimizers import tree_leaves

torch.set_num_threads(2)
ARCH = "qwen3-4b"
ULP = np.finfo(np.float32).eps


@pytest.fixture(scope="module")
def ref():
    """Reduced qwen3 in both packages, the reference's parameters and one
    synthetic batch of each package."""
    rc = ref_reduced(REF_ARCHS[ARCH], n_layers=2, d_model=64)
    pc = reduced(ARCHS[ARCH], n_layers=2, d_model=64)
    params = jax.tree.map(np.asarray,
                          RT.init_params(jax.random.PRNGKey(0), rc))
    rb = next(RTR.synthetic_lm_batches(rc, 4, 32, seed=3))
    pb = next(PTR.synthetic_lm_batches(pc, 4, 32, seed=3, device="cpu"))
    return dict(rc=rc, pc=pc, params=params, rb=rb, pb=pb)


SCHEDULES = [("constant", (3e-4,), 0),
             ("cosine_decay", (3e-4, 100), 1),
             ("cosine_decay", (1e-3, 37, 0.0), 1),
             ("linear_warmup_cosine", (3e-4, 10, 100), 1),
             ("linear_warmup_cosine", (2e-3, 7, 50, 0.2), 1)]


@pytest.mark.parametrize("name,args,ulps", SCHEDULES)
def test_schedules_and_lr_at_match_reference(name, args, ulps):
    """Every step from 0 past the end: the constant rate and the warm-up
    ramp exactly, the cosine within one ulp (and exactly at most steps);
    ``_lr_at`` gives the schedule's value, or the float itself."""
    want_f, got_f = getattr(RSCH, name)(*args), getattr(PSCH, name)(*args)
    exact = 0
    steps = range(0, 130)
    for step in steps:
        want = float(want_f(jnp.asarray(step, jnp.int32)))
        got = float(got_f(step))
        assert abs(got - want) <= ulps * ULP * abs(want), (step, got, want)
        exact += got == want
        assert float(PO._lr_at(got_f, step)) == got
    assert exact >= 0.9 * len(steps)
    assert PO._lr_at(3e-4, 5) == RO._lr_at(3e-4, 5) == 3e-4


def test_sgd_weight_decay_on_a_schedule_matches_reference():
    """Three ``sgd`` steps (momentum 0.9, weight decay 0.01, warm-up
    cosine) on a small tree ≤1e-6."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)]}
    sched = (2e-2, 2, 10)
    ropt = RO.sgd(RSCH.linear_warmup_cosine(*sched), 0.9, 0.01)
    popt = PO.sgd(PSCH.linear_warmup_cosine(*sched), 0.9, 0.01)
    rp, pp = jax.tree.map(jnp.asarray, tree), jax.tree.map(
        torch.from_numpy, tree)
    rs, ps = ropt.init(rp), popt.init(pp)
    for i in range(3):
        g = jax.tree.map(lambda a: np.float32(i + 1) * np.sin(a), tree)
        ru, rs = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        pu, ps = popt.update(jax.tree.map(torch.from_numpy, g), ps, pp)
        rp, pp = RO.apply_updates(rp, ru), PO.apply_updates(pp, pu)
    for a, b in zip(jax.tree.leaves(pp), jax.tree.leaves(rp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    assert ps["step"] == int(rs["step"]) == 3


@pytest.mark.parametrize("arch", ["qwen3-4b", "llava-next-mistral-7b",
                                  "hubert-xlarge"])
def test_synthetic_lm_batches_identical(arch):
    rc = ref_reduced(REF_ARCHS[arch], n_layers=2, d_model=64)
    pc = reduced(ARCHS[arch], n_layers=2, d_model=64)
    r_it = RTR.synthetic_lm_batches(rc, 3, 20, seed=5)
    p_it = PTR.synthetic_lm_batches(pc, 3, 20, seed=5, device="cpu")
    for _ in range(2):
        rb, pb = next(r_it), next(p_it)
        assert sorted(rb) == sorted(pb)
        for k in rb:
            np.testing.assert_array_equal(pb[k].numpy(), np.asarray(rb[k]))


def _first_moments(state):
    return [m.numpy() for m in tree_leaves(state["m"])]


def test_train_step_fp32_grads_match_reference(ref):
    """One fp32 ``make_train_step`` step (remat on): adamw's first moments
    are 0.1 × the gradients; within 1e-5 · 0.1 of the reference's
    ``jax.value_and_grad(loss_fn)``, and the loss ≤1e-5."""
    (want, _), wg = jax.value_and_grad(
        lambda p: RT.loss_fn(p, ref["rc"], ref["rb"]), has_aux=True)(
        ref["params"])
    step, opt = PS.make_train_step(ref["pc"], activation_dtype=torch.float32)
    params = params_from_numpy(ref["params"], device="cpu")
    _, state, m = step(params, opt.init(params), ref["pb"])
    assert abs(float(m["loss"]) - float(want)) <= 1e-5
    for got, g in zip(_first_moments(state), jax.tree.leaves(wg)):
        np.testing.assert_allclose(got, 0.1 * np.asarray(g), atol=1e-6,
                                   rtol=0)
    assert set(m) == {"loss", "ce", "aux"}


def test_train_step_bf16_loss_near_reference(ref):
    """The default (bf16 activations) step's loss within 2e-2 of the
    reference's bf16 ``make_train_step``, and of the port's fp32 loss."""
    rstep, ropt = RS.make_train_step(ref["rc"], remat=False)
    rparams = jax.tree.map(jnp.asarray, ref["params"])
    _, _, rm = rstep(rparams, ropt.init(rparams), ref["rb"])
    params = params_from_numpy(ref["params"], device="cpu")
    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        step, opt = PS.make_train_step(ref["pc"], remat=False,
                                       activation_dtype=dtype)
        _, _, m = step(params, opt.init(params), ref["pb"])
        got[dtype] = float(m["loss"])
    assert abs(got[torch.bfloat16] - float(rm["loss"])) <= 2e-2
    assert abs(got[torch.bfloat16] - got[torch.float32]) <= 2e-2


def test_microbatch_matches_one_batch_and_kernel_dtype_raises(ref):
    """Microbatch 2 against 1 (fp32): the mean loss and the gradients
    (first moments) ≤1e-6; its metrics the reference's (ce = loss, aux
    0). A kernel table with bf16 raises."""
    params = params_from_numpy(ref["params"], device="cpu")
    out = {}
    for mb in (1, 2):
        step, opt = PS.make_train_step(ref["pc"], microbatch=mb,
                                       activation_dtype=torch.float32)
        _, state, m = step(params, opt.init(params), ref["pb"])
        out[mb] = (m, _first_moments(state))
    assert abs(float(out[1][0]["loss"]) - float(out[2][0]["loss"])) <= 1e-6
    for a, b in zip(out[1][1], out[2][1]):
        np.testing.assert_allclose(a, b, atol=1e-7, rtol=0)
    assert float(out[2][0]["aux"]) == 0.0
    assert float(out[2][0]["ce"]) == float(out[2][0]["loss"])
    table = kernel_dispatch("auto").table("transformer")
    with pytest.raises(ValueError, match="fp32"):
        PS.make_train_step(ref["pc"], kernels=table)
    with pytest.raises(ValueError, match="fp32"):
        PS.make_prefill_step(ref["pc"], kernels=table)


def test_train_driver_runs_on_cpu():
    """``train()`` on reduced qwen3 (40 steps of 8 × 32 tokens, bf16
    activations): every step logged, finite, and the last three steps'
    mean loss below the first three's."""
    _, hist = PTR.train(ARCH, steps=40, batch=8, seq=32, lr=3e-3,
                        n_layers=2, d_model=64, log_every=1, device="cpu")
    assert [h["step"] for h in hist] == list(range(40))
    loss = [h["loss"] for h in hist]
    assert all(np.isfinite(loss))
    assert np.mean(loss[-3:]) < np.mean(loss[:3]) - 0.05
