"""Kernel wrappers with model-facing signatures: the port of the reference's
``kernels/ops.py``.

Thin aliases over ``kernels.dispatch`` (the backend-aware op tables), kept
so that call sites written against the reference's early entry points
work. The reference's ``interpret`` flag becomes ``backend``: ``"auto"``
or ``"cuda"`` for the hand-written kernels (their plain versions for CPU
tensors), None or ``"dense"`` for the dense masked path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.backend import resolve_backend
from repro_torch.kernels.elastic_matmul import (elastic_dense,
                                                elastic_dense_plain)


def attention_op(q, k, v, *, causal=True, window=None, cap=None,
                 head_mask=None, backend: Optional[str] = "auto"):
    """(B,Sq,H,D) x (B,Sk,KV,D) -> (B,Sq,H,D); the contract of the dense
    path's ``models.attention.dense_attention``. Differentiable and elastic
    over ``head_mask`` ((H,) or (B, H) runtime head prefix) — an alias of
    the dispatch table's ``attention`` op."""
    if resolve_backend(backend) == "dense":
        from repro_torch.models.attention import dense_attention
        return dense_attention(q, k, v, causal=causal, window=window,
                               cap=cap, head_mask=head_mask)
    return dispatch.attention_op(q, k, v, causal=causal, window=window,
                                 cap=cap, head_mask=head_mask)


def ssd_op(xh, dt, A, Bm, Cm, chunk, *, head_mask=None,
           backend: Optional[str] = "auto"):
    """The contract of ``models.ssm.ssd_chunked`` (returns (y, None): the
    final state is only used by decode, which has its own path), elastic
    over ``head_mask`` — an alias of the dispatch table's differentiable
    ``ssd`` op."""
    if resolve_backend(backend) == "dense":
        from repro_torch.models.ssm import ssd_chunked
        y, _ = ssd_chunked(xh, dt.float(), A, Bm, Cm, chunk)
        if head_mask is not None:
            m = head_mask.to(y.dtype)
            y = y * (m[:, None, :, None] if m.dim() == 2
                     else m[None, None, :, None])
        return y, None
    return dispatch.ssd_op(xh, dt, A, Bm, Cm, chunk, head_mask=head_mask)


def elastic_mlp_matmul(x, w, k_active, *, backend: Optional[str] = "auto"):
    """(…, K) @ (K, N) with the active output prefix ``k_active`` (the CFL
    width; an int or an int32 scalar tensor) — an alias over the
    differentiable ``elastic_dense``."""
    lead, K = x.shape[:-1], x.shape[-1]
    na = torch.as_tensor(k_active, dtype=torch.int32,
                         device=x.device).reshape(1)
    fn = elastic_dense_plain if resolve_backend(backend) == "dense" \
        else elastic_dense
    return fn(x.reshape(1, -1, K), w, n_active=na).reshape(
        *lead, w.shape[-1])


def model_kernels(backend: Optional[str] = "auto"):
    """The model-facing op dict: the dispatch table's ``mlp``, ``moe``,
    ``ssd`` and ``attention`` ops (None for the dense masked path)."""
    return dispatch.kernel_dispatch(backend).table("transformer")
