"""FL client: metadata and the local training of one (sub)model — the port
of the reference's ``fl/client.py`` for ``CNNConfig``: ``ClientInfo``,
``local_train`` (E local epochs of momentum SGD, returning the update
ω_0 − ω_E) and ``evaluate``.

A step is the forward, the loss, ``torch.autograd.grad``, the global-norm
clip at 5.0 and momentum SGD (``sgd_step``, which the sequential trainer
of ``fl.engine`` shares). Eager PyTorch needs no per-config compile cache.
Everything runs on the device of ``params``; the batched engine trains
every client at once instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.data.loader import batches, eval_batches
from repro_torch.models import cnn
from repro_torch.optim.optimizers import (apply_updates, clip_by_global_norm,
                                          sgd, tree_leaves, tree_map)


@dataclasses.dataclass
class ClientInfo:
    cid: int
    device: str               # DeviceProfile name
    quality: int              # dominant data-quality level
    n_samples: int
    latency_bound: float      # l_k in Alg. 1 (seconds per local step)


def _or_zeros(grad, like):
    return torch.zeros_like(like) if grad is None else grad


def sgd_step(params, opt, opt_state, loss_of, grad_clip: float):
    """One local step of one (unstacked) model: the gradients of the
    scalar ``loss_of(params)`` (a leaf the loss never reads, as the CNN's
    RL gates, gets 0, as ``jax.grad`` gives it), clipped to global norm
    ``grad_clip``, then ``opt``. Returns (params, opt_state); ``params``'s
    tensors are left as they were."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(p)
    raw = iter(torch.autograd.grad(loss_of(p), leaves, allow_unused=True))
    grads = tree_map(lambda t: _or_zeros(next(raw), t), p)
    # the global norm over every leaf: one client's, as a leading axis of 1
    grads, _ = clip_by_global_norm(tree_map(lambda g: g[None], grads),
                                   grad_clip)
    with torch.no_grad():
        upd, opt_state = opt.update(tree_map(lambda g: g[0], grads),
                                    opt_state)
        return apply_updates(tree_map(torch.Tensor.detach, p), upd), \
            opt_state


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def local_train(params, cfg: CNNConfig, data: Dict[str, np.ndarray], *,
                epochs: int = 1, batch_size: int = 32, lr: float = 0.05,
                momentum: float = 0.9, seed: int = 0):
    """E local epochs of ``models.cnn.loss_fn`` on ``data`` (numpy ``x``,
    ``y``); returns (delta = ω_0 − ω_E, n_steps)."""
    opt = sgd(lr, momentum=momentum)
    dev = _device(params)
    p, state = params, opt.init(params)
    n_steps = 0
    for batch in batches(data, batch_size, seed=seed, epochs=epochs):
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        p, state = sgd_step(p, opt, state,
                            lambda q: cnn.loss_fn(q, cfg, b)[0], 5.0)
        n_steps += 1
    delta = tree_map(lambda a, b_: a - b_, params, p)
    return delta, n_steps


def evaluate(params, cfg: CNNConfig, data: Dict[str, np.ndarray],
             batch_size: int = 128, *, depth=None) -> float:
    """Top-1 accuracy of the model on ``data``, in batches."""
    dev = _device(params)
    correct = total = 0
    with torch.no_grad():
        for b in eval_batches(data, batch_size):
            logits, _ = cnn.forward(params, cfg,
                                    torch.as_tensor(b["x"], device=dev),
                                    depth=depth)
            pred = torch.argmax(logits, -1).cpu().numpy()
            correct += int((pred == b["y"]).sum())
            total += len(b["y"])
    return correct / max(total, 1)
