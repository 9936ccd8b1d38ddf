"""Cold-start personalization: distil the parent into an unseen spec — the
port of the reference's ``serving/distill.py``.

A client that never joined training still gets a personalized submodel:
the teacher is the *masked parent* under the full spec (the parent-space
forward the fleet trained under, with the caller's kernel table, so on
the card it runs the hand-written kernels), the student is the client's
extracted submodel (``sub_logits``, the plain forward), and the objective
is a temperature-scaled KL on logits over the client's own data pack. The
student starts from the extracted weights, so it beats a random-init
submodel.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.optim.optimizers import (apply_updates, sgd, tree_leaves,
                                          tree_map)


def _kl_logits(teacher_logits, student_logits, tau: float):
    """Mean KL(teacher ‖ student) over all positions, τ²-scaled (Hinton)."""
    tl = teacher_logits.to(torch.float32) / tau
    sl = student_logits.to(torch.float32) / tau
    tlp = F.log_softmax(tl, dim=-1)
    kl = torch.sum(torch.exp(tlp) * (tlp - F.log_softmax(sl, dim=-1)),
                   dim=-1)
    return (tau * tau) * torch.mean(kl)


def distill_to_spec(family, parent_params, spec, data: Dict[str, Any], *,
                    steps: int = 50, batch_size: int = 8, lr: float = 0.1,
                    momentum: float = 0.9, temperature: float = 2.0,
                    seed: int = 0, student_init: str = "extract",
                    kernels: Optional[Any] = None
                    ) -> Tuple[Any, Any, List[float]]:
    """Distil ``parent_params`` into ``spec``'s submodel on ``data``.

    ``data``: the client pack, ``{"x": (N, ...) numpy inputs}`` (token ids
    for the LM families, images for the CNN); the targets are the
    teacher's logits. ``student_init``: "extract" (warm-start from the
    extracted submodel — the cold-start path) or "random" (the ablation
    baseline, ``family.sub_init_params(seed, ...)``). ``kernels``: the
    teacher's op table (``kernels.dispatch``) or None for the dense masked
    path. Batches are drawn from ``np.random.default_rng(seed)`` as the
    reference draws them. Everything runs on the parent's device.

    Returns ``(sub_params, sub_ctx, history)`` with the per-step KL."""
    if student_init not in ("extract", "random"):
        raise ValueError(f"unknown student_init {student_init!r}")
    x_all = np.asarray(data["x"])
    n = len(x_all)
    if n == 0:
        raise ValueError("empty distillation pack")
    batch_size = min(batch_size, n)
    dev = tree_leaves(parent_params)[0].device

    # the teacher: the masked parent under the full spec, one-client stack
    teacher_params = tree_map(lambda t: t.unsqueeze(0), parent_params)
    teacher_fwd = family.cohort_masks([family.full_spec()], dev).fwd
    if student_init == "extract":
        sub_params, sub_ctx = family.extract(parent_params, spec)
    else:
        sub_params = family.sub_init_params(seed, spec, device=dev)
        sub_ctx = family.sub_ctx(spec)
    sub_params = tree_map(lambda t: t.detach(), sub_params)

    opt = sgd(lr, momentum=momentum)
    opt_state = opt.init(sub_params)
    rng = np.random.default_rng(seed)
    history: List[float] = []
    for _ in range(steps):
        idx = rng.choice(n, size=batch_size, replace=n < batch_size)
        x = torch.as_tensor(x_all[idx], device=dev)
        with torch.no_grad():
            t_logits = family.masked_logits(teacher_params, teacher_fwd,
                                            x.unsqueeze(0), kernels)[0]
        p = tree_map(lambda t: t.requires_grad_(True), sub_params)
        kl = _kl_logits(t_logits, family.sub_logits(p, sub_ctx, x),
                        temperature)
        raw = iter(torch.autograd.grad(kl, tree_leaves(p)))
        grads = tree_map(lambda _: next(raw), p)
        with torch.no_grad():
            upd, opt_state = opt.update(grads, opt_state, p)
            sub_params = apply_updates(tree_map(lambda t: t.detach(), p),
                                       upd)
        history.append(float(kl.detach()))
    return sub_params, sub_ctx, history
