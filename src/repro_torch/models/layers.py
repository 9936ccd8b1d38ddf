"""Shared neural-net layers (plain functions over dicts of tensors).

The port of the reference's ``models/layers.py``. Hazards kept as the
reference has them: rmsnorm is gemma-style ``(1 + scale)`` with the
variance in fp32 and ``inv`` cast back to the input dtype; ``gelu`` is the
tanh approximation; RoPE rotates split halves, not interleaved pairs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(params, x, eps=1e-6):
    var = torch.mean(x.square().float(), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    g = (1.0 + params["scale"]).to(x.dtype)
    return g * x * inv


def layernorm(params, x, eps=1e-6):
    mu = torch.mean(x.float(), dim=-1, keepdim=True).to(x.dtype)
    var = torch.mean((x - mu).square().float(), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    y = (x - mu) * inv
    return params["scale"].to(x.dtype) * y + params["bias"].to(x.dtype)


# ---------------------------------------------------------------------------
# activations / caps
# ---------------------------------------------------------------------------
# one activation table: the elastic_dense kernel fuses the same functions
# (csrc/elastic_dense.cu) and its plain version reads this table
ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def act_fn(name: str):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(name) from None


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                   device=device) / dim)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) integer tensor."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (d/2,)
    ang = positions[..., None].float() * freqs              # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (optionally gated / GLU)
# ---------------------------------------------------------------------------
def _row_mask(mask, x):
    """A (n,) or (B, n) 0/1 mask shaped to broadcast over x (B, S, n)."""
    m = mask.to(x.dtype)
    return m[:, None, :] if m.dim() == 2 else m


def mlp(params, x, act="silu", *, width_mask=None, kernel=None):
    """width_mask: optional (d_ff,) or per-row (B, d_ff) 0/1 mask — CFL
    elastic width. kernel: optional ``mlp`` op (``kernels.dispatch``) —
    masked width is then *skipped* inside ``elastic_dense`` instead of
    multiplied by zero."""
    if kernel is not None:
        return kernel(params, x, act, width_mask)
    a = act_fn(act)
    h = x @ params["wi"].to(x.dtype)
    if "wg" in params:
        h = a(x @ params["wg"].to(x.dtype)) * h
    else:
        h = a(h)
    if width_mask is not None:
        h = h * _row_mask(width_mask, h)
    return h @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------
def embed(params, ids, *, scale=False):
    t = params["table"]
    out = t[ids]
    if scale:
        out = out * math.sqrt(t.shape[-1])
    return out


def unembed(params, x, *, cap=None):
    logits = x @ params["table"].T.to(x.dtype)
    return softcap(logits, cap)
