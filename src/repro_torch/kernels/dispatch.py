"""Backend-aware kernel dispatch — the op table the model forwards consume.

The port of the reference's ``kernels/dispatch.py``.
``kernel_dispatch(backend).table("transformer")`` returns the per-op
callables ``models.transformer`` takes as ``kernels=``, and
``table("cnn")`` the ``conv`` op the CNN family's masked forward
(``core.elastic.masked_forward``) takes; either is None for the dense
masked path (see ``kernels/backend.py``).

Every op derives its runtime prefixes from the 0/1 prefix masks the spec
table ships, as (B,) int32 *tensors* (``(mask > 0).sum(-1)``), never as
Python ints: a batch whose rows are different submodels runs one launch,
and spec churn changes tensor values only.

=============  ==============================================================
op             contract
=============  ==============================================================
``mlp``        ``op(params, x, act, width_mask)``, x (B, S, d), width_mask
               None, (d_ff,) or (B, d_ff); or client-stacked weights
               (G, d, d_ff) with x (G, T, d) and a (G, d_ff) mask. Up/gate
               projections skip output columns past ``k = sum(width_mask)``;
               the down projection skips contraction past the same ``k``.
               Activation fused into the gate (or up) launch. Three
               ``elastic_dense`` launches forward; differentiable, with
               seven more in the backward (dx and dw of each projection,
               and the gate's pre-activation recomputed).
``attention``  ``op(q, k, v, *, causal, window, cap, head_mask)``, head_mask
               None, (H,) or (B, H): query heads past ``sum(head_mask)`` are
               skipped inside ``flash_attention``. One launch forward;
               differentiable, with one ``flash_attention_dq`` and one
               ``flash_attention_dkv`` launch in the backward.
``moe``        ``op(eb, w, g_active)``: the grouped expert-prefix matmul
               ``grouped_matmul`` over an expert buffer eb (G, E, cap, d)
               and expert weights (E, d, f) shared or (G, E, d, f) per
               group, skipping experts past ``g_active`` — a (G,) int32
               tensor (the sum of each group's expert mask) or None. One
               launch; differentiable, with two more in the backward. The
               op carries ``op.dispatch`` / ``op.combine``, the K6 / K7
               token-movement pair (``kernels.moe_dispatch``) whose VJPs
               are each other's kernels: ``models.moe`` routes its wide
               (·, d) row traffic through them when present.
``ssd``        ``op(xh, dt, A, Bm, Cm, chunk, head_mask=None) -> (y, None)``,
               xh (R, S, H, P), A (H,) or one per row (R, H), head_mask
               None, (H,) or (R, H): the SSD chunk scan ``ssd_scan`` (K8),
               heads past ``sum(head_mask)`` skipped. One launch forward;
               differentiable, the backward rerunning K8 for the per-chunk
               initial states (no O(S·P) activations kept) and then the
               transposed scan ``ssd_scan_bwd`` (K9) under the same prefix.
``conv``       (the ``"cnn"`` table) ``op(params, x, stride, cin_active,
               cout_active)``: a SAME conv of client-stacked x (G, B, H, W,
               Cin) with ``params`` {"w": (G, 3, 3, Cin, Cout), "b":
               (G, Cout)}, lowered by ``kernels.elastic_conv`` onto one
               ``elastic_dense`` launch (K1) that skips input channels past
               ``cin_active`` and output channels past ``cout_active``
               ((G,) int32 tensors or None), bias fused. Differentiable,
               with two more launches in the backward (dx, dw).
=============  ==============================================================
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.elastic_conv import elastic_conv2d
from repro_torch.kernels.elastic_matmul import elastic_dense
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.kernels.moe_dispatch import moe_combine, moe_dispatch
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd


def active_len(mask: torch.Tensor, batch: int) -> torch.Tensor:
    """(batch,) int32 prefix lengths of a 0/1 prefix mask of shape (n,) or
    (batch, n) — computed on the mask's device, no host sync."""
    n = (mask > 0).sum(dim=-1).to(torch.int32)
    return n.expand(batch).contiguous() if n.dim() == 0 else n


def mlp_op(params, x, act, width_mask):
    B = x.shape[0]
    ka = None if width_mask is None else active_len(width_mask, B)
    wi = params["wi"].to(x.dtype)
    wo = params["wo"].to(x.dtype)
    if "wg" in params:
        h = elastic_dense(x, wi, n_active=ka)
        h = elastic_dense(x, params["wg"].to(x.dtype), n_active=ka,
                          act=act) * h
    else:
        h = elastic_dense(x, wi, n_active=ka, act=act)
    return elastic_dense(h, wo, k_active=ka)


def attention_op(q, k, v, *, causal=True, window=None, cap=None,
                 head_mask=None):
    ha = None if head_mask is None else active_len(head_mask, q.shape[0])
    o, _ = flash_attention(q, k, v, ha, causal=causal, window=window,
                           cap=cap)
    return o


def moe_op(eb, w, g_active):
    return grouped_matmul(eb, w.to(eb.dtype), g_active)


moe_op.dispatch = moe_dispatch
moe_op.combine = moe_combine


class _SSD(torch.autograd.Function):
    """The reference's ``_make_ssd_prefix`` custom VJP: K8 forward; the
    backward reruns K8 for the per-chunk initial states, then K9 under the
    same head prefix."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm, chunk, h_active):
        ctx.save_for_backward(xh, dt, A, Bm, Cm, h_active)
        ctx.chunk = chunk
        return ssd_scan(xh, dt, A, Bm, Cm, chunk, h_active=h_active)

    @staticmethod
    def backward(ctx, dy):
        xh, dt, A, Bm, Cm, ha = ctx.saved_tensors
        _, states = ssd_scan(xh, dt, A, Bm, Cm, ctx.chunk, h_active=ha,
                             return_states=True)
        grads = ssd_scan_bwd(xh, dt, A, Bm, Cm, states, dy.contiguous(),
                             ctx.chunk, h_active=ha)
        return grads + (None, None)


def ssd_op(xh, dt, A, Bm, Cm, chunk, head_mask=None):
    ha = None if head_mask is None else active_len(head_mask, xh.shape[0])
    args = (xh.contiguous(), dt.float().contiguous(), A, Bm.contiguous(),
            Cm.contiguous(), int(chunk), ha)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in args[:5]):
        return _SSD.apply(*args), None
    return ssd_scan(*args[:6], h_active=ha), None


def conv_op(params, x, stride, cin_active, cout_active):
    return elastic_conv2d(x, params["w"].to(x.dtype),
                          params["b"].to(x.dtype), stride=stride,
                          cin_active=cin_active, cout_active=cout_active)


@dataclasses.dataclass(frozen=True)
class KernelDispatch:
    """Resolved backend; ``table(family)`` returns the op dict a family's
    forward consumes, or None for the dense masked path."""

    backend: str

    def table(self, family: str = "transformer") -> Optional[Dict]:
        if self.backend == "dense":
            return None
        if family == "cnn":
            return {"conv": conv_op}
        if family != "transformer":
            raise ValueError(f"no op table for family {family!r}")
        return {"mlp": mlp_op, "attention": attention_op, "moe": moe_op,
                "ssd": ssd_op}


def kernel_dispatch(backend: Optional[str] = "auto") -> KernelDispatch:
    """'auto' / 'cuda' -> the hand-kernel table; None / 'dense' -> no
    table. Raises ValueError on unknown names."""
    return KernelDispatch(resolve_backend(backend))
