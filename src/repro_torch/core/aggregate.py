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

The async runtime's buffered (FedBuff-style) step splits it in three:
``cohort_reduce`` turns one dispatch group into partial sums ``(num,
den)`` (scaled by ``staleness_scale``), ``buffer_add`` adds groups up,
``buffer_apply`` serves Δ = num / den. ``delta_validity`` is the
quarantine gate in front of every aggregate: non-finite deltas and norm
outliers past ``clip_factor`` × the median norm.

``aggregate_apply`` with a cohort ``mesh`` (the reference's
``aggregate_apply_hierarchical``) is the cohort-sharded server step
(``sharding.cohort``): each rank reduces its block of the stacked cohort to
the fp32 partial sums ``(num, den)`` of ``cohort_reduce``, the partials of
every leaf go into one flat buffer, one ``all_reduce`` (SUM) crosses the
group, and every rank divides and applies alike. Under sharding the gate
splits in two: ``delta_norms`` on the block, ``validity_verdict`` on the
all-gathered columns, so every rank quarantines the same slots.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.sharding.cohort import CohortSharding, all_reduce_flat

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
                    sanitize: bool = False, mesh=None):
    """Fused Alg. 3 + Alg. 4 server step over a stacked cohort.

    ``weights`` (G,) data sizes; ``participation`` optional (G,) 0/1 flags
    (absent slots drop out of the numerator and the coverage
    denominator); ``sanitize`` zeroes non-finite delta entries inside the
    weighted sums (``0 * NaN`` would poison the sum otherwise), leaving
    finite deltas bit-identical. Weighted sums reduce in fp32.
    ``stacked_coverages`` may be None when ``coverage_norm`` is False.
    It is the buffered step of one group holding the whole cohort
    (``cohort_reduce`` then ``buffer_apply``).

    With a cohort ``mesh`` it is the sharded step: ``weights`` and
    ``participation`` span the whole cohort (K,), ``stacked_deltas`` and
    ``stacked_coverages`` are this rank's block of it
    (``CohortSharding.block``; empty on a rank past the shard count, which
    still joins the collective with zeros), and the partial sums cross the
    group in one ``all_reduce`` (``all_reduce_partials``) before every
    rank divides and applies alike. The numerics match the flat mean to
    ≤1e-5 (the same fp32 partial sums, summed in another order); one shard
    is the flat mean to the bit.
    """
    if mesh is not None:
        lo, hi = CohortSharding(mesh).block(int(weights.shape[0]))
        for d in tree_leaves(stacked_deltas):
            if d.shape[0] != hi - lo:
                raise ValueError(f"rank {mesh.rank}'s block is [{lo}, {hi}) "
                                 f"but its deltas stack {d.shape[0]} slots")
        weights = weights[lo:hi]
        if participation is not None:
            participation = participation[lo:hi]
    num, den = cohort_reduce(
        stacked_deltas, stacked_coverages, weights,
        coverage_norm=coverage_norm, participation=participation,
        sanitize=sanitize)
    return buffer_apply(params, *all_reduce_partials(num, den, mesh),
                        coverage_norm=coverage_norm)


# ---------------------------------------------------------------------------
# buffered (FedBuff-style) aggregation: partial sums a server can hold
# ---------------------------------------------------------------------------
def staleness_scale(staleness: float, decay: float) -> float:
    """FedBuff's staleness discount ``(1 + s)^-decay`` of a delta trained
    against a server version ``s`` versions old; ``decay=0`` disables it
    (async with a full buffer then reproduces sync exactly). A host
    scalar: every slot of a dispatch group trained against one version."""
    return float((1.0 + float(staleness)) ** (-float(decay)))


def _weighted(w, sanitize: bool):
    """Σ_k w_k d_k over the leading client axis, in fp32; ``sanitize``
    zeroes non-finite entries first (``0 * NaN`` is NaN)."""
    def leaf(d):
        d = d.to(torch.float32)
        if sanitize:
            d = torch.where(torch.isfinite(d), d,
                            torch.zeros((), device=d.device))
        return torch.sum(d * w.reshape((-1,) + (1,) * (d.dim() - 1)), 0)
    return leaf


def cohort_reduce(stacked_deltas, stacked_coverages, weights, *,
                  coverage_norm: bool = False, participation=None,
                  scale=1.0, sanitize: bool = False):
    """One completed dispatch group's aggregation partial sums ``(num,
    den)``: ``num`` the fp32 weighted delta sum per leaf, ``den`` the
    coverage-weight sum per leaf (``coverage_norm``; in the coverage's
    shape, which may be a broadcast factor) or the scalar participating
    mass. ``scale`` is the group's staleness discount (a float or a
    0-dim tensor). Groups completing at different times add up in
    ``buffer_add``; ``buffer_apply`` turns the buffer into a server step.
    ``sanitize`` as in ``aggregate_apply``; coverages are never
    sanitised."""
    w = weights.to(torch.float32)
    if participation is not None:
        w = w * participation.to(torch.float32)
    w = w * scale
    num = tree_map(_weighted(w, sanitize), stacked_deltas)
    if coverage_norm:
        den = tree_map(_weighted(w, False), stacked_coverages)
    else:
        den = torch.sum(w)
    return num, den


def buffer_add(acc, update):
    """Fold a group's ``(num, den)`` into the running buffer, leaf by
    leaf (either form of ``den``)."""
    return tree_map(torch.add, acc, update)


def buffer_apply(params, num, den, *, coverage_norm: bool = False,
                 eps: float = EPS):
    """The buffered server step: Δ = num / max(den, eps) (leaf by leaf,
    broadcasting a factor-shaped ``den``, under ``coverage_norm``; the
    scalar mass otherwise), then ω ← ω − Δ. One group holding the whole
    cohort reproduces ``aggregate_apply``."""
    if coverage_norm:
        delta_t = tree_map(lambda n, d: n / torch.clamp(d, min=eps), num,
                           den)
    else:
        mass = torch.clamp(den, min=eps)
        delta_t = tree_map(lambda n: n / mass, num)
    return tree_map(lambda p, d: (p - d).to(p.dtype), params, delta_t)


# ---------------------------------------------------------------------------
# delta validation: the quarantine gate in front of every aggregate
# ---------------------------------------------------------------------------
def delta_norms(stacked_deltas):
    """Per-slot (K,) fp32 squared global L2 norms over the finite entries,
    and (K,) bool all-finite flags, of a stacked (K, ...) delta tree: the
    half of ``delta_validity`` that reads the deltas."""
    sq, finite = None, None
    for d in tree_leaves(stacked_deltas):
        d32 = d.to(torch.float32).reshape(d.shape[0],
                                          math.prod(d.shape[1:]))
        fin = torch.isfinite(d32)
        s = torch.sum(torch.where(fin, d32 * d32,
                                  torch.zeros((), device=d.device)), 1)
        f = torch.all(fin, 1)
        sq = s if sq is None else sq + s
        finite = f if finite is None else finite & f
    return sq, finite


def validity_verdict(sq, finite, participation, clip_factor: float):
    """The half of ``delta_validity`` over the whole cohort's columns
    (``delta_norms``): ``(valid, norms)``."""
    part = participation.to(torch.float32) > 0
    norm = torch.sqrt(sq)
    ref = torch.where(part & finite, norm,
                      torch.full_like(norm, float("nan")))
    median = torch.nanquantile(ref, 0.5)
    limit = clip_factor * torch.maximum(
        median, torch.full_like(median, 1e-12))
    norm_ok = torch.where(torch.isnan(limit), torch.ones_like(finite),
                          norm <= limit)
    ok = finite & ((clip_factor <= 0) | norm_ok)
    return ok.to(torch.float32), norm


def delta_validity(stacked_deltas, participation, clip_factor: float):
    """Per-client validity gate over a stacked (K, ...) delta tree:
    ``(valid, norms)``, (K,) float32 0/1 flags and the (K,) fp32 global L2
    norms. A slot is valid iff every entry of its delta is finite and
    (unless ``clip_factor <= 0``) its norm is at most ``clip_factor`` ×
    the median norm of the finite participating slots. The median is the
    reference's (``jnp.nanmedian``): the mean of the two middle values
    when their count is even (``torch.nanmedian`` would take the lower);
    with no finite participating slot there is no limit."""
    return validity_verdict(*delta_norms(stacked_deltas), participation,
                            clip_factor)


# ---------------------------------------------------------------------------
# hierarchical aggregation: per-rank partial sums and one collective
# ---------------------------------------------------------------------------
def all_reduce_partials(num, den, mesh=None):
    """Sum every rank's ``(num, den)`` (``cohort_reduce`` partials, either
    form of ``den``) over the mesh's group: one flat buffer, one
    ``all_reduce``. Returns the summed ``(num, den)`` on the partials'
    device; without a ``mesh`` (unsharded) the partials themselves."""
    if mesh is None:
        return num, den
    leaves = tree_leaves(num) + tree_leaves(den)
    out = iter(all_reduce_flat(leaves, mesh))
    num = tree_map(lambda _: next(out), num)
    den = tree_map(lambda _: next(out), den)
    return num, den


def aggregate_apply_hierarchical(params, stacked_deltas, stacked_coverages,
                                 weights, *, mesh,
                                 coverage_norm: bool = False,
                                 participation=None,
                                 sanitize: bool = False):
    """The reference's name for the sharded server step:
    :func:`aggregate_apply` over this rank's block with the cohort
    ``mesh`` (None: the flat step)."""
    return aggregate_apply(params, stacked_deltas, stacked_coverages,
                           weights, coverage_norm=coverage_norm,
                           participation=participation, sanitize=sanitize,
                           mesh=mesh)
