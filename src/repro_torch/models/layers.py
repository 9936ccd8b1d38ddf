"""Shared neural-net layers (plain functions over dicts of tensors).

The port of the reference's ``models/layers.py``. Hazards kept as the
reference has them: rmsnorm is gemma-style ``(1 + scale)`` with the
variance in fp32 and ``inv`` cast back to the input dtype; ``gelu`` is the
tanh approximation; RoPE rotates split halves, not interleaved pairs.

Every layer also takes client-stacked parameters — a leading client axis
G on the weights, matched by a leading G on the activations — the layout
the batched round engine trains in (the reference's ``vmap`` written out).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def _feature(p, x):
    """A (d,) norm parameter as it is, or a client-stacked (G, d) one
    shaped to broadcast over x (G, ..., d)."""
    if p.dim() == 1:
        return p
    return p.reshape((p.shape[0],) + (1,) * (x.dim() - 2) + (p.shape[-1],))


def rmsnorm(params, x, eps=1e-6):
    var = torch.mean(x.square().float(), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    g = (1.0 + _feature(params["scale"], x)).to(x.dtype)
    return g * x * inv


def layernorm(params, x, eps=1e-6):
    mu = torch.mean(x.float(), dim=-1, keepdim=True).to(x.dtype)
    var = torch.mean((x - mu).square().float(), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    y = (x - mu) * inv
    return _feature(params["scale"], x).to(x.dtype) * y + \
        _feature(params["bias"], x).to(x.dtype)


def at_least_fp32(x):
    """x in fp32, or in its own dtype where that is wider (fp64): the CNN
    path's statistics and losses, as the reference's fp32, and exact on an
    fp64 forward."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def groupnorm(x, groups, eps=1e-5):
    """Channel-last group norm of the CNN parent (no learned affine: the
    affine lives in the conv that follows). x (..., H, W, C): statistics
    per leading index and group, over H, W and the group's C / groups
    channels, in at least fp32."""
    *lead, h, w, c = x.shape
    xg = at_least_fp32(x.reshape(*lead, h, w, groups, c // groups))
    dims = (-4, -3, -1)                      # H, W, channels of a group
    mu = torch.mean(xg, dim=dims, keepdim=True)
    var = torch.mean((xg - mu).square(), dim=dims, keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(x.shape).to(x.dtype)


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


def mlp(params, x, act="silu", *, width_mask=None, kernel=None, mesh=None,
        d_ff=None):
    """width_mask: optional (d_ff,) or per-row (B, d_ff) 0/1 mask — CFL
    elastic width. kernel: optional ``mlp`` op (``kernels.dispatch``) —
    masked width is then *skipped* inside ``elastic_dense`` instead of
    multiplied by zero. Client-stacked weights (G, d, d_ff) take x
    (G, T, d) and a (G, d_ff) mask: each client its own product.

    ``mesh`` (a ``sharding.mesh.HostMesh``): tensor parallel over its
    ``model`` axis — ``wi`` / ``wg`` hold this rank's block of the
    ``d_ff`` columns and ``wo`` of its rows; the width mask is sliced to
    the block (the local prefix; a block past it still runs, and adds
    zeros) and the partial products meet in one all-reduce."""
    if mesh is not None and mesh.sharded(d_ff):
        lo, hi = mesh.block(d_ff)
        local = None if width_mask is None else width_mask[..., lo:hi]
        return mesh.all_reduce(mlp(params, x, act, width_mask=local,
                                   kernel=kernel))
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
def embed(params, ids, *, scale=False, mesh=None, vocab=None):
    """ids (...) -> (..., d); a client-stacked table (G, V, d) takes ids
    (G, ...) and looks each client's rows up in its own table. ``mesh``:
    the table holds this model rank's block of the ``vocab`` rows — each
    rank gathers the ids in its block (zeros elsewhere) and one all-reduce
    over ``model`` sums the one nonzero row (the reference's vocab-parallel
    lookup, exact for any block)."""
    t = params["table"]
    if mesh is not None and mesh.sharded(vocab):
        lo, hi = mesh.block(vocab)
        local = ids - lo
        ok = (local >= 0) & (local < hi - lo)
        out = t[local.clamp(0, hi - lo - 1)]
        out = mesh.all_reduce(torch.where(ok[..., None], out,
                                          out.new_zeros(())))
    elif t.dim() == 3:
        lead = torch.arange(t.shape[0], device=ids.device)
        out = t[lead.reshape((-1,) + (1,) * (ids.dim() - 1)), ids]
    else:
        out = t[ids]
    if scale:
        out = out * math.sqrt(t.shape[-1])
    return out


def unembed(params, x, *, cap=None):
    logits = x @ params["table"].T.to(x.dtype)
    return softcap(logits, cap)
