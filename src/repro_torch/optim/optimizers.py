"""Minimal optimizers over client-stacked parameter trees.

The port of the reference's ``optim/optimizers.py`` (``sgd``,
``adamw``, ``clip_by_global_norm``, ``apply_updates``, the schedule hook
``_lr_at``). In the batched
engine every leaf carries a leading client axis (G, ...) — the axis the
reference gets from ``vmap``; ``adamw`` (the accuracy predictor's) is
elementwise and takes any tree. The API mirrors the reference's (and optax's):
``opt.init(params) -> state``, ``opt.update(grads, state, params) ->
(updates, state)``; updates are *subtracted* by ``apply_updates``. The
global norm of ``clip_by_global_norm`` is taken per client.

Trees are nested dicts, lists and tuples of tensors (the layout of
``models.transformer.init_params``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

# a learning rate: a float, or a schedule step -> rate (``optim.schedule``)
Schedule = Union[float, Callable]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _lr_at(lr: Schedule, step):
    """The rate at ``step`` (the step count after this update, from 1):
    the schedule's value, or the float itself."""
    return lr(step) if callable(lr) else lr


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the nesting; None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *[r[i] for r in rest])
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree):
    """The tensors of ``tree`` in the nesting's order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [] if tree is None else [tree]


def value_and_grad(fn, params, *args):
    """(value, aux, grads) of ``value, aux = fn(params, *args)`` over the
    tensors of ``params`` (a tree, not modified): value and aux detached,
    grads a tree like ``params``. A leaf the value does not reach gets a
    zero gradient, as ``jax.grad`` gives it."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    value, aux = fn(leaves, *args)
    flat = tree_leaves(leaves)
    grads = iter([torch.zeros_like(t) if g is None else g for t, g in zip(
        flat, torch.autograd.grad(value, flat, allow_unused=True))])
    return value.detach(), tree_map(torch.Tensor.detach, aux), \
        tree_map(lambda _: next(grads), leaves)


def _client(v, like):
    """A (G,) per-client value shaped to broadcast over ``like`` (G, ...)."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def sgd(lr: Schedule, momentum: float = 0.0, weight_decay: float = 0.0):
    """SGD with optional momentum and (L2, added to the gradient) weight
    decay; ``lr`` a float or a schedule of the step count."""
    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return {"step": 0, "mu": mu}

    def update(grads, state, params=None):
        step = state["step"] + 1
        if weight_decay and params is not None:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads,
                             params)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            upd = mu
        else:
            mu = None
            upd = grads
        rate = _lr_at(lr, step)
        upd = tree_map(lambda u: rate * u, upd)
        return upd, {"step": step, "mu": mu}

    return Optimizer(init, update)


def adamw(lr: Schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
    """Adam with decoupled weight decay; moments kept in fp32, the bias
    corrections ``1 - b^step`` computed in fp32, as the reference's;
    ``lr`` a float or a schedule of the step count."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def init(params):
        return {"step": 0, "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                     state["v"], grads)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** step
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** step
        rate = _lr_at(lr, step)

        def upd_leaf(m_, v_, p):
            bc1_, bc2_ = bc1.to(m_.device), bc2.to(m_.device)
            u = (m_ / bc1_) / (torch.sqrt(v_ / bc2_) + eps)
            if weight_decay and p is not None:
                u = u + weight_decay * p.float()
            return (rate * u).to(p.dtype if p is not None else u.dtype)

        if params is None:
            upd = tree_map(lambda m_, v_: upd_leaf(m_, v_, None), m, v)
        else:
            upd = tree_map(upd_leaf, m, v, params)
        return upd, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p - u).to(p.dtype), params, updates)


def clip_by_global_norm(grads, max_norm: float):
    """Scale each client's gradients so that their global L2 norm (over
    every leaf) is at most ``max_norm``. Returns (grads, norms (G,))."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(g.float().square().flatten(1).sum(1)
                        for g in leaves))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g * _client(scale, g).to(g.dtype), grads), gn
