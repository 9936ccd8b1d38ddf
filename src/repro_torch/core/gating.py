"""RL-gate training for the data-quality-aware parent model (paper §III-C)
— the port of the reference's ``core/gating.py``.

Hybrid learning per SkipNet: a supervised warm-up with *soft* gates, then
joint supervised + REINFORCE fine-tuning with *sampled* hard gates; reward
= −(task loss + λ · computed-layer fraction). The paper pre-trains this on
the server on a small public set at the worst quality level, then uses
the gate policy during submodel sampling.

The gates run on the plain forward (``models.cnn.forward``: ``F.conv2d``),
as the reference runs them on ``lax.conv``; the step is eager autograd,
global-norm clipping at 1.0 and ``adamw``, on an unstacked parameter tree.
A sampled step draws its uniforms from a ``torch.Generator``, or takes
them from the caller (``uniforms``: one (B,) tensor per executed block)
where a test replays the reference's ``jax.random`` draws.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.models import cnn
from repro_torch.models.layers import groupnorm
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm
from repro_torch.optim.optimizers import (tree_leaves, tree_map,
                                          value_and_grad)


@dataclasses.dataclass
class GateTrainConfig:
    warmup_steps: int = 60
    rl_steps: int = 60
    lr: float = 1e-3
    compute_penalty: float = 0.1


def _device_of(params):
    return tree_leaves(params)[0].device


def _as_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch's ``x`` and ``y`` (numpy or tensors) on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device)
            for k, v in batch.items() if k in ("x", "y")}


def _clip(grads, max_norm: float):
    """``clip_by_global_norm`` of one model's gradients: the port's clip
    is per client, so the tree goes through it as a one-client stack."""
    one = tree_map(lambda g: g.unsqueeze(0), grads)
    clipped, norm = clip_by_global_norm(one, max_norm)
    return tree_map(lambda g: g[0], clipped), norm[0]


def make_gate_train_step(cfg: CNNConfig, opt, mode: str,
                         compute_penalty: float):
    """``step(params, opt_state, batch, draws) -> (params, opt_state,
    loss, metrics)``: one step of ``models.cnn.loss_fn`` in gate ``mode``,
    gradients clipped to global norm 1.0, then ``opt``. ``draws`` (used by
    ``mode="sample"`` only): a ``torch.Generator`` on the parameters'
    device, or the list of per-block uniforms to replay."""
    def step(params, opt_state, batch, draws=None):
        b = _as_batch(batch, _device_of(params))
        kw = {}
        if mode == "sample":
            kw = ({"generator": draws} if isinstance(draws, torch.Generator)
                  else {"gate_uniforms": draws})
        # the gates take no gradient under "hard": zeros, as jax.grad's
        loss, metrics, grads = value_and_grad(
            lambda p: cnn.loss_fn(p, cfg, b, gate_mode=mode,
                                  compute_penalty=compute_penalty, **kw),
            params)
        g, _ = _clip(grads, 1.0)
        upd, opt_state = opt.update(g, opt_state, params)
        params = apply_updates(tree_map(torch.Tensor.detach, params), upd)
        return params, opt_state, loss, metrics
    return step


def train_gates(params, cfg: CNNConfig, batches: Iterator[Dict],
                tcfg: GateTrainConfig = GateTrainConfig(), seed: int = 0):
    """Warm-up (soft gates) then the hybrid REINFORCE phase. Returns
    (params, history), history one entry a step: ``step``, ``loss``,
    ``acc``, ``compute_pct``, ``phase`` ("warmup" | "rl"). The sampled
    steps draw from a generator seeded with ``seed`` on the parameters'
    device."""
    opt = adamw(tcfg.lr)
    opt_state = opt.init(params)
    generator = torch.Generator(device=_device_of(params))
    generator.manual_seed(seed)
    hist = []
    soft = make_gate_train_step(cfg, opt, "soft", tcfg.compute_penalty)
    hard = make_gate_train_step(cfg, opt, "sample", tcfg.compute_penalty)
    for i in range(tcfg.warmup_steps + tcfg.rl_steps):
        batch = next(batches)
        fn = soft if i < tcfg.warmup_steps else hard
        params, opt_state, l, m = fn(params, opt_state, batch, generator)
        hist.append({"step": i, "loss": float(l),
                     "acc": float(m["acc"]),
                     "compute_pct": float(m["compute_pct"]),
                     "phase": "warmup" if i < tcfg.warmup_steps else "rl"})
    return params, hist


@torch.no_grad()
def gate_depth_policy(params, cfg: CNNConfig, sample_batch,
                      threshold: float = 0.5):
    """Run the gates on a quality-representative batch and turn each
    block's execution rate (the share of examples whose gate probability
    passes ``threshold``) into a static depth per stage: the blocks whose
    rate passes 0.5, at least one. Every block runs ungated while the
    rates are read. Returns (depth tuple, rates list)."""
    g = cfg.groupnorm_groups
    x = _as_batch({"x": sample_batch["x"]}, _device_of(params))["x"]
    x = F.relu(groupnorm(cnn._conv(params["stem"], x), g))
    rates, depth = [], []
    for stage in params["stages"]:
        x = F.relu(groupnorm(cnn._conv(stage["down"], x, stride=2), g))
        keep = 0
        for bp in stage["blocks"]:
            logit = cnn._gate_logit(bp, x)
            rate = float(torch.mean((torch.sigmoid(logit) > threshold)
                                    .float()))
            rates.append(rate)
            if rate > 0.5:
                keep += 1
            x = cnn._block(bp, x, g)
        depth.append(max(1, keep))
    return tuple(depth), rates
