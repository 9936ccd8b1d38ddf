"""Step builders for one model (train / prefill / serve), the port of the
reference's ``launch/steps.py``.

The reference trains in bf16 (``PARAM_DTYPE`` / ``ACT_DTYPE``). The port's
kernels take fp32 only (``kernels/elastic_matmul.py``,
``kernels/flash_attention.py``), so every builder takes the activation
dtype: bf16 by default (the reference's) on the dense path
(``kernels=None``); with a kernel table it must be fp32, and a builder
given another raises instead of casting. The ``ShapeDtypeStruct`` specs of
the reference (``batch_spec`` and the others) belong to its compile-only
dry run and are not ported here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, apply_updates
from repro_torch.optim.optimizers import (tree_leaves, tree_map,
                                          value_and_grad)

ACT_DTYPE = torch.bfloat16


def _check_dtype(kernels, activation_dtype) -> None:
    if kernels is not None and activation_dtype != torch.float32:
        raise ValueError(
            f"the kernel path runs in fp32 only, not {activation_dtype}: "
            "pass activation_dtype=torch.float32, or kernels=None for the "
            "dense path")


def make_train_step(cfg: ModelConfig, *, lr=3e-4, weight_decay=0.01,
                    remat: bool = True, kernels=None, microbatch: int = 1,
                    activation_dtype=ACT_DTYPE):
    """``(train_step, opt)``: ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` — one ``adamw`` step (``lr`` a float or
    a schedule) on ``models.transformer.loss_fn``; metrics ``loss``,
    ``ce``, ``aux``. ``microbatch > 1``: the gradients accumulate in fp32
    over that many slices of the batch and are averaged (activation memory
    divided at unchanged math); its metrics are then the mean loss as
    ``ce`` and a zero ``aux``, as the reference's. ``kernels``: a
    ``kernel_dispatch(...).table("transformer")`` table, which requires
    ``activation_dtype=torch.float32``."""
    _check_dtype(kernels, activation_dtype)
    opt = adamw(lr, weight_decay=weight_decay)

    def loss_on(p, b):
        return T.loss_fn(p, cfg, b, remat=remat, kernels=kernels,
                         activation_dtype=activation_dtype)

    def train_step(params, opt_state, batch):
        if microbatch == 1:
            loss, metrics, grads = value_and_grad(loss_on, params, batch)
        else:
            slices = [{k: v.reshape((microbatch, v.shape[0] // microbatch)
                                    + v.shape[1:])[i]
                       for k, v in batch.items()}
                      for i in range(microbatch)]
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), device=tree_leaves(params)[0].device)
            for b in slices:
                l, _, g = value_and_grad(loss_on, params, b)
                grads = tree_map(lambda a, x: a + x, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / microbatch, grads)
            loss = loss / microbatch
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(tree_map(torch.Tensor.detach, params),
                               updates)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step, opt


def make_prefill_step(cfg: ModelConfig, *, kernels=None,
                      activation_dtype=ACT_DTYPE, mesh=None):
    """``prefill_step(params, batch) -> (B, V)``: the last position's
    logits of the batch-dict forward (what a server samples from).
    ``mesh`` (``launch.mesh.make_host_mesh``): ``params`` is this rank's
    block (``sharding.specs.shard_params``), the batch the whole batch;
    every rank returns the whole (B, V) logits."""
    _check_dtype(kernels, activation_dtype)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = T.forward_batch(params, cfg, batch, kernels=kernels,
                                    activation_dtype=activation_dtype,
                                    last_only=True, mesh=mesh)
        return logits[:, -1, :]
    return prefill_step


def make_serve_step(cfg: ModelConfig, *, kernels=None, mesh=None):
    """``serve_step(params, caches, token, pos) -> (logits, caches)``: one
    cached decode step (``models.transformer.decode_step``) at the
    precision of the parameters and caches. ``mesh``: ``params`` and
    ``caches`` are this rank's blocks (``shard_params``, ``prefill`` or
    ``init_decode_caches`` with the mesh), ``token`` / ``pos`` the whole
    batch's; every rank returns the whole (B, V) logits."""
    @torch.no_grad()
    def serve_step(params, caches, token, pos):
        return T.decode_step(params, cfg, caches, token, pos,
                             kernels=kernels, mesh=mesh)
    return serve_step
