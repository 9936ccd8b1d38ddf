"""Alg. 3 + Alg. 4: submodel alignment, aggregation and the server step —
the port of the reference's ``core/aggregate.py``.

The sequential path's functions take lists of parameter trees, each
client's update already zero-padded to parent coordinates:

* ``aggregate`` — the paper's rule, Δ = Σ_k (n_k / n) Δ_k
  (``weighted_sum``);
* ``aggregate_coverage`` — beyond the paper (HeteroFL-style), each entry
  normalised by the weight of the clients that covered it;
* ``apply_server_update`` — ω ← ω − Δ.

``aggregate_apply`` is the fused server step of the batched round engine.
Every client's update
Δ_k = ω_0 − ω_E is already in parent coordinates (masked to its coverage),
stacked along a leading client axis (G, ...), and

* the paper's rule averages the updates by data size,
  Δ = Σ_k n_k Δ_k / Σ_k n_k;
* ``coverage_norm`` (beyond the paper, HeteroFL-style) divides each entry
  by the weight of the clients that covered it,
  Δ[i] = Σ_k n_k Δ_k[i] / max(Σ_k n_k c_k[i], eps) (Δ_k is already 0
  where c_k is);

then ω ← ω − Δ. Coverages may be broadcast factors (``core.elastic``):
the denominator is summed in their shape and broadcast in the division.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.optim.optimizers import tree_map

EPS = 1e-8       # floor of the denominators: an all-absent cohort is a no-op


def weighted_sum(trees: Sequence, weights: Sequence[float]):
    """Σ_k (w_k / Σ w) · tree_k, leaf by leaf, in the reference's order."""
    total = sum(weights)
    out = tree_map(lambda a: a * (weights[0] / total), trees[0])
    for t, w in zip(trees[1:], weights[1:]):
        out = tree_map(lambda acc, a, w=w: acc + a * (w / total), out, t)
    return out


def aggregate(padded_deltas: Sequence, data_sizes: Sequence[float]):
    """The paper's rule (Alg. 3, last line): Δ = Σ (n_k / n) Δ_k over
    aligned (already padded) updates."""
    return weighted_sum(padded_deltas, list(data_sizes))


def aggregate_coverage(padded_deltas: Sequence, coverages: Sequence,
                       data_sizes: Sequence[float], eps: float = EPS):
    """Entry-wise Δ[i] = Σ_k n_k c_k[i] Δ_k[i] / max(Σ_k n_k c_k[i], eps);
    ``coverages`` are 0/1 trees of the deltas' structure (Δ_k is already 0
    where c_k is)."""
    n = list(data_sizes)
    num = tree_map(lambda a: a * n[0], padded_deltas[0])
    den = tree_map(lambda c: c * n[0], coverages[0])
    for t, c, w in zip(padded_deltas[1:], coverages[1:], n[1:]):
        num = tree_map(lambda acc, a, w=w: acc + a * w, num, t)
        den = tree_map(lambda acc, a, w=w: acc + a * w, den, c)
    return tree_map(lambda nu, de: nu / torch.clamp(de, min=eps), num, den)


def apply_server_update(params, delta, server_lr: float = 1.0):
    """ω_{t+1} = ω_t − Δ_t (Alg. 4); Δ carries the clients' sign
    convention (ω_0 − ω_E)."""
    return tree_map(lambda p, d: (p - server_lr * d).to(p.dtype), params,
                    delta)


def aggregate_apply(params, stacked_deltas, stacked_coverages, weights, *,
                    coverage_norm: bool = False, participation=None,
                    sanitize: bool = False):
    """Fused Alg. 3 + Alg. 4 server step over a stacked cohort.

    ``weights`` (G,) data sizes; ``participation`` optional (G,) 0/1 flags
    (absent slots drop out of the numerator and the coverage
    denominator); ``sanitize`` zeroes non-finite delta entries inside the
    weighted sums (``0 * NaN`` would poison the sum otherwise), leaving
    finite deltas bit-identical. Weighted sums reduce in fp32.
    ``stacked_coverages`` may be None when ``coverage_norm`` is False.
    """
    w = weights.to(torch.float32)
    if participation is not None:
        w = w * participation.to(torch.float32)

    def wsum(d):
        d = d.to(torch.float32)
        if sanitize:
            d = torch.where(torch.isfinite(d), d, torch.zeros((),
                                                              device=d.device))
        return torch.sum(d * w.reshape((-1,) + (1,) * (d.dim() - 1)), 0)

    if coverage_norm:
        delta_t = tree_map(
            lambda d, c: wsum(d) / torch.clamp(
                torch.sum(c.to(torch.float32) *
                          w.reshape((-1,) + (1,) * (c.dim() - 1)), 0),
                min=EPS),
            stacked_deltas, stacked_coverages)
    else:
        mass = torch.clamp(torch.sum(w), min=EPS)
        delta_t = tree_map(lambda d: wsum(d) / mass, stacked_deltas)
    return tree_map(lambda p, d: (p - d).to(p.dtype), params, delta_t)
