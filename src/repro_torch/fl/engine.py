"""Batched parent-space FL round engine, for the CNN and transformer
families.

The port of the reference's ``fl/engine.py``. Every client of a CFL cohort
trains in *parent coordinates* under its own 0/1 masks (``core.elastic``:
``CNNElasticFamily``, ``TransformerElasticFamily``): the reference's
``vmap`` over
clients is a leading client axis G written out on every parameter, mask,
activation and optimizer buffer, and its ``lax.scan`` over local steps is
a Python loop. One cohort call trains every client's local epochs whatever
the mix of submodel specs; there is no loop over clients.

Exactness contract (as the reference's): gradients are masked to each
client's coverage, so momentum and updates on uncovered entries stay 0 and
``Δ = mask * (ω_0 − ω_E)`` equals the zero-padded submodel update. Clients
with fewer local steps than the cohort's longest stream carry step validity
flags (an invalid step leaves the client's parameters and momentum
untouched), partial batches carry sample weights — the same index streams
as the per-client loader.

Each step's batch carries its labels ``y`` to the family's loss, as the
reference's ``_client_train`` does: the CNN's cross-entropy needs them,
the LM families (whose targets are their own tokens) ignore them. Images
stay float32; token rows become int64.

The kernel path (``backend="auto"``) runs the CNN's stage convolutions
(K1 through ``kernels.elastic_conv``), or the MLP (or, on a MoE parent,
the expert dispatch, grouped expert matmul and combine) and attention,
through the hand-written kernels, forward and backward
(``kernels.dispatch``); ``backend=None`` is the dense masked path of plain
tensor ops, the A/B baseline. Per-client prefixes (channels, d_ff,
experts, heads) reach the kernels as (G,) or (G·B,) int32 device tensors
derived from the masks; the engine itself has no family logic.

``SequentialFamilyTrainer`` is the reference's other engine: the
per-client extract → train → pad loop on the plain forward (either
family: ``models.cnn.forward``, or ``models.transformer.forward`` on a
one-client stack with no kernel table), held to the same
``run_fl_round`` contract.

Partial participation (``fl.selection``): with ``participation=`` (a
``Selection``) a round trains its fixed-size padded cohort — the selected
clients gathered out of the fleet's cached data pack on the device
(``index_select``), streams padded to the fleet-wide step count, padding
slots training zero steps with weight 0 — so the cohort's shapes never
depend on which clients were picked.

Not ported yet, and raising NotImplementedError: the double-buffered
prefetch ring (``enable_prefetch`` / ``prefetch_hook``, ROADMAP A14) and
cohort sharding over several cards (``cohort_shards > 1``, A17).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.aggregate import (aggregate, aggregate_apply,
                                       aggregate_coverage,
                                       apply_server_update)
from repro_torch.core.elastic import CohortMasks, family_for
from repro_torch.data.loader import index_batches
from repro_torch.fl.client import sgd_step
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.dispatch import kernel_dispatch
from repro_torch.optim.optimizers import (apply_updates,
                                          clip_by_global_norm, sgd,
                                          tree_leaves, tree_map)


# ---------------------------------------------------------------------------
# host-side packing (numpy, as in the reference)
# ---------------------------------------------------------------------------
def pack_cohort_data(datasets: Sequence[Dict[str, np.ndarray]]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack every client's (round-invariant) data once: (G, N, ...)."""
    G = len(datasets)
    N = max(len(d["y"]) for d in datasets)
    sample_shape = datasets[0]["x"].shape[1:]
    x = np.zeros((G, N) + sample_shape, datasets[0]["x"].dtype)
    y = np.zeros((G, N), np.int32)
    for k, d in enumerate(datasets):
        n = len(d["y"])
        x[k, :n] = d["x"]
        y[k, :n] = d["y"]
    return x, y


def n_stream_steps(n: int, batch_size: int, epochs: int) -> int:
    """Steps ``index_batches(n, batch_size, epochs=epochs)`` will yield
    (drop-remainder semantics; a dataset smaller than one batch still
    yields one partial batch per epoch)."""
    per_epoch = n // batch_size if n >= batch_size else 1
    return per_epoch * epochs


def _pack_streams(lengths: Sequence[int], batch_size: int, *, epochs: int,
                  seeds: Sequence[int], n_steps_pad: Optional[int] = None):
    """The (G, S, B) index / validity arrays of per-client batch streams;
    ``lengths[k] == 0`` marks a padding slot (no valid steps).
    ``n_steps_pad`` pins S to a caller-chosen value. Returns (idx,
    sample_valid, step_valid, n_steps), numpy."""
    streams = [list(index_batches(n, batch_size, seed=s, epochs=epochs))
               if n > 0 else []
               for n, s in zip(lengths, seeds)]
    G = len(streams)
    S = max(len(st) for st in streams) if n_steps_pad is None \
        else int(n_steps_pad)
    idx = np.zeros((G, S, batch_size), np.int32)
    sv = np.zeros((G, S, batch_size), np.float32)
    stv = np.zeros((G, S), bool)
    for k, stream in enumerate(streams):
        assert len(stream) <= S, (k, len(stream), S)
        for t, b_idx in enumerate(stream):
            idx[k, t, :len(b_idx)] = b_idx
            sv[k, t, :len(b_idx)] = 1.0
            stv[k, t] = True
    return idx, sv, stv, np.array([len(st) for st in streams])


@dataclasses.dataclass
class EvalPack:
    x: np.ndarray        # (G, T, ...)
    y: np.ndarray        # (G, T) int32
    valid: np.ndarray    # (G, T) float32


def pack_eval(datasets: Sequence[Dict[str, np.ndarray]]) -> EvalPack:
    G = len(datasets)
    T = max(len(d["y"]) for d in datasets)
    sample_shape = datasets[0]["x"].shape[1:]
    x = np.zeros((G, T) + sample_shape, datasets[0]["x"].dtype)
    y = np.zeros((G, T), np.int32)
    v = np.zeros((G, T), np.float32)
    for k, d in enumerate(datasets):
        n = len(d["y"])
        x[k, :n] = d["x"]
        y[k, :n] = d["y"]
        v[k, :n] = 1.0
    return EvalPack(x, y, v)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CohortResult:
    deltas: Dict            # stacked (G, ...) masked updates ω_0 − ω_E
    trained: Dict           # stacked (G, ...) locally-trained parent params
    masks: CohortMasks
    n_steps: np.ndarray
    accs: Optional[np.ndarray] = None   # local-eval accuracies


def _or_zeros(grad, like):
    return torch.zeros_like(like) if grad is None else grad


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class BatchedRoundEngine:
    """One cohort call trains every client's local epochs, whatever the
    spec mix (see the module docstring).

    ``cfg``: a ``CNNConfig``, a transformer ModelConfig, or their
    family.
    ``backend``: "auto" / "cuda" (the hand-written kernels) or None (the
    dense masked path). ``device``: the card unless the caller asks for
    the CPU (where the kernels' plain versions run); raises without a card.
    """

    def __init__(self, cfg, *, lr: float, momentum: float,
                 grad_clip: float = 5.0, cohort_shards: int = 1,
                 backend="auto", device=None):
        if int(cohort_shards) != 1:
            raise _not_ported("cohort sharding over several cards", "A17")
        self.device = resolve_device(device)
        self.family = family_for(cfg)
        self.cfg = self.family.cfg
        self._kernels = kernel_dispatch(backend).table(self.family.name)
        self._opt = sgd(lr, momentum=momentum)
        self._grad_clip = grad_clip
        # bounded caches; data entries hold a strong ref to the keying
        # datasets object so its id() cannot be recycled while cached
        self._eval_cache: "OrderedDict[int, Tuple[object, Tuple]]" = \
            OrderedDict()
        self._data_cache: "OrderedDict[int, Tuple[object, Tuple]]" = \
            OrderedDict()

    @property
    def kernel_path(self) -> str:
        """'tile-skipping' | 'dense-masked' — which path this engine runs."""
        return "tile-skipping" if self._kernels else "dense-masked"

    def enable_prefetch(self, depth: int = 1) -> None:
        raise _not_ported("the double-buffered prefetch ring", "A14")

    # -- one local step of every client ------------------------------------
    def local_state(self, theta0_stacked):
        """(params, opt_state) of a cohort's local training: trainable
        copies of the client-stacked ``theta0_stacked`` and fresh optimizer
        state (the carry of the reference's ``lax.scan``)."""
        params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          theta0_stacked)
        return params, self._opt.init(params)

    def local_step(self, params, opt_state, masks: CohortMasks, x,
                   sample_weight, valid=None, y=None):
        """One local SGD step of every client at once — the body of the
        reference's ``lax.scan``: the masked loss, gradients masked to each
        client's coverage, the per-client global-norm clip, momentum SGD.

        ``params`` (client-stacked leaves that require grad) and
        ``opt_state`` are updated in place. x (G, B, ...) the batch (token
        rows or images), ``sample_weight`` (G, B); ``valid``: None (every
        client steps) or a (G,) bool tensor — a client with False keeps
        its parameters and momentum; y (G, B) the batch's labels (None for
        the LM families). Returns the per-client losses (G,)."""
        loss = self.family.masked_loss(params, masks.fwd, x, y,
                                       sample_weight, kernels=self._kernels)
        # a leaf the loss never reads (the CNN's RL gates, whose sampled
        # modes are not ported) gets a zero gradient, as jax.grad gives it
        raw = iter(torch.autograd.grad(loss.sum(), tree_leaves(params),
                                       allow_unused=True))
        grads = tree_map(
            lambda p, m: _or_zeros(next(raw), p) * m, params,
            masks.param_mask)
        del raw
        grads, _ = clip_by_global_norm(grads, self._grad_clip)
        mus = tree_leaves(opt_state["mu"]) or None
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(tree_leaves(params),
                                           tree_leaves(grads))):
                mu = None if mus is None else mus[i]
                upd, st = self._opt.update(g, {"step": opt_state["step"],
                                               "mu": mu})
                new_p = apply_updates(p, upd)
                if valid is not None:
                    keep = valid.reshape((-1,) + (1,) * (p.dim() - 1))
                    new_p = torch.where(keep, new_p, p)
                    if mu is not None:
                        st["mu"] = torch.where(keep, st["mu"], mu)
                p.copy_(new_p)
                if mu is not None:
                    mu.copy_(st["mu"])
        opt_state["step"] += 1
        return loss.detach()

    # -- cohort API --------------------------------------------------------
    def broadcast_params(self, params, n_clients: int):
        """Client-stacked views of one parent (no copy)."""
        return tree_map(lambda a: a.expand((n_clients,) + a.shape), params)

    def train_cohort(self, theta0_stacked, specs: Sequence,
                     datasets: Sequence[Dict], *, batch_size: int,
                     epochs: int, seeds: Sequence[int],
                     eval_datasets: Optional[Sequence[Dict]] = None,
                     participation=None, prefetch_hook=None
                     ) -> CohortResult:
        """Every client's local epochs (and, with ``eval_datasets``, its
        local test pass) in one cohort call.

        With ``participation`` (an ``fl.selection.Selection``) the cohort
        is the padded subset it names: ``specs`` and ``seeds`` are per
        slot (M = ``len(participation.idx)``), ``datasets`` /
        ``eval_datasets`` stay the whole fleet's (their packs are cached;
        the subset is gathered on the device), streams are padded to the
        fleet-wide step count and a padding slot (``valid`` 0) trains zero
        steps and scores no eval sample; it still rides every launch of a
        step. The results are per slot."""
        if prefetch_hook is not None:
            raise _not_ported("the double-buffered prefetch ring", "A14")
        dev = self.device
        masks = self.family.cohort_masks(specs, self.device)
        x, y = self._cohort_data(datasets)
        lengths = [len(d["y"]) for d in datasets]
        steps_pad, gidx = None, None
        if participation is not None:
            part = participation
            if not (len(specs) == len(seeds) == len(part.idx)):
                raise ValueError(
                    f"per-slot specs/seeds must match the padded cohort "
                    f"size {len(part.idx)}, got {len(specs)}/{len(seeds)}")
            # S is the fleet-wide maximum: it never depends on the subset
            steps_pad = max(n_stream_steps(n, batch_size, epochs)
                            for n in lengths)
            lengths = [lengths[i] if v > 0 else 0
                       for i, v in zip(part.idx, part.valid)]
            gidx = torch.as_tensor(np.asarray(part.idx, np.int64),
                                   device=dev)
            x, y = x.index_select(0, gidx), y.index_select(0, gidx)
        idx, sv, stv, n_steps = _pack_streams(
            lengths, batch_size, epochs=epochs, seeds=seeds,
            n_steps_pad=steps_pad)
        idx = torch.as_tensor(idx, device=dev).long()
        sv = torch.as_tensor(sv, device=dev)
        rows = torch.arange(len(specs), device=dev)[:, None]
        params, opt_state = self.local_state(theta0_stacked)
        for t in range(stv.shape[1]):
            if not stv[:, t].any():          # every client padded: no-op
                continue
            valid = None if stv[:, t].all() else torch.as_tensor(
                stv[:, t], device=dev)
            self.local_step(params, opt_state, masks, x[rows, idx[:, t]],
                            sv[:, t], valid, y[rows, idx[:, t]])
        del opt_state
        trained = tree_map(lambda t: t.detach(), params)
        deltas = tree_map(lambda a, b, m: (a - b) * m, theta0_stacked,
                          trained, masks.param_mask)
        accs = None
        if eval_datasets is not None:
            ex, ey, ev = self._eval_pack(eval_datasets)
            if gidx is not None:
                ex, ey = ex.index_select(0, gidx), ey.index_select(0, gidx)
                ev = ev.index_select(0, gidx) * torch.as_tensor(
                    participation.valid, device=dev)[:, None]
            accs = self._metric(trained, masks, ex, ey, ev)
        return CohortResult(deltas, trained, masks, n_steps, accs)

    def run_fl_round(self, params, specs: Sequence,
                     datasets: Sequence[Dict], test_datasets: Sequence[Dict],
                     sizes: Sequence[float], *, batch_size: int, epochs: int,
                     seeds: Sequence[int], coverage_norm: bool = False,
                     participation=None, prefetch_hook=None):
        """One FL round: the cohort's local train + eval, then the fused
        aggregate + apply. Returns (new_params, accs, n_steps). With
        ``participation`` the round trains its padded cohort (see
        ``train_cohort``), ``sizes`` gives way to the selection's weights,
        padding slots drop out of the aggregate, and accs / n_steps are
        per slot (filter by ``participation.valid``)."""
        theta0 = self.broadcast_params(params, len(specs))
        res = self.train_cohort(theta0, specs, datasets,
                                batch_size=batch_size, epochs=epochs,
                                seeds=seeds, eval_datasets=test_datasets,
                                participation=participation,
                                prefetch_hook=prefetch_hook)
        covs = res.masks.param_mask if coverage_norm else None
        part = None
        if participation is not None:
            sizes = participation.weights
            part = torch.as_tensor(participation.valid, device=self.device)
        weights = torch.as_tensor(np.asarray(sizes, np.float32),
                                  device=self.device)
        with torch.no_grad():
            new_params = aggregate_apply(params, res.deltas, covs, weights,
                                         coverage_norm=coverage_norm,
                                         participation=part)
        return new_params, [float(a) for a in res.accs], res.n_steps

    def eval_cohort(self, params_stacked, specs: Sequence,
                    datasets: Sequence[Dict],
                    masks: Optional[CohortMasks] = None) -> np.ndarray:
        """Per-client accuracy of each client's masked submodel on its own
        eval set."""
        if masks is None:
            masks = self.family.cohort_masks(specs, self.device)
        return self._metric(params_stacked, masks,
                            *self._eval_pack(datasets))

    def _metric(self, params_stacked, masks: CohortMasks, x, y, valid):
        with torch.no_grad():
            accs = self.family.masked_metric(params_stacked, masks.fwd, x, y,
                                             valid, kernels=self._kernels)
        return accs.cpu().numpy()

    def _eval_pack(self, datasets: Sequence[Dict]):
        def build(d):
            p = pack_eval(d)
            return (self._samples(p.x),
                    torch.as_tensor(p.y, device=self.device).long(),
                    torch.as_tensor(p.valid, device=self.device))
        return self._cached(self._eval_cache, datasets, build)

    def _cohort_data(self, datasets: Sequence[Dict]):
        def build(d):
            x, y = pack_cohort_data(d)
            return (self._samples(x),
                    torch.as_tensor(y, device=self.device).long())
        return self._cached(self._data_cache, datasets, build)

    def _samples(self, x: np.ndarray):
        """Packed samples on the device: token rows as int64 (embedding
        and gather indices), images as they are (float32)."""
        t = torch.as_tensor(x, device=self.device)
        return t.long() if np.issubdtype(x.dtype, np.integer) else t

    @staticmethod
    def _cached(cache: OrderedDict, datasets, build, bound: int = 4):
        key = id(datasets)
        hit = cache.get(key)
        if hit is not None and hit[0] is datasets:
            return hit[1]
        val = build(datasets)
        cache[key] = (datasets, val)
        while len(cache) > bound:
            cache.popitem(last=False)
        return val


# ---------------------------------------------------------------------------
# the sequential reference: extract -> train -> pad, one client at a time
# ---------------------------------------------------------------------------
class SequentialFamilyTrainer:
    """The per-client loop over an elastic family — the A/B reference the
    batched engine is held to, and the sequential engine of
    ``CFLConfig(batched_rounds=False)``: each client trains its extracted
    submodel (``family.extract`` / ``sub_loss``, the plain forward) one
    step at a time (``fl.client.sgd_step``), and its update
    is padded back to parent coordinates (``pad_delta``). It runs on the
    device of the parameters it is given."""

    def __init__(self, cfg, *, lr: float, momentum: float,
                 grad_clip: float = 5.0):
        self.family = family_for(cfg)
        self._opt = sgd(lr, momentum=momentum)
        self._grad_clip = grad_clip

    def client_update(self, params, spec, data, *, batch_size: int,
                      epochs: int, seed: int):
        """E local epochs on the extracted submodel; returns (delta,
        trained_sub, sub_ctx, n_steps) with delta = ω_0 − ω_E in the
        submodel's coordinates."""
        sub0, ctx = self.family.extract(params, spec)
        dev = tree_leaves(params)[0].device
        p, state = sub0, self._opt.init(sub0)
        n_steps = 0
        for b_idx in index_batches(len(data["y"]), batch_size, seed=seed,
                                   epochs=epochs):
            x = torch.as_tensor(data["x"][b_idx], device=dev)
            yb = torch.as_tensor(data["y"][b_idx], device=dev)
            sw = torch.ones((len(b_idx),), device=dev)
            p, state = sgd_step(
                p, self._opt, state,
                lambda q: self.family.sub_loss(q, ctx, x, yb, sw),
                self._grad_clip)
            n_steps += 1
        delta = tree_map(lambda a, b: a - b, sub0, p)
        return delta, p, ctx, n_steps

    def run_fl_round(self, params, specs: Sequence,
                     datasets: Sequence[Dict], test_datasets: Sequence[Dict],
                     sizes: Sequence[float], *, batch_size: int, epochs: int,
                     seeds: Sequence[int], coverage_norm: bool = False):
        """The contract of ``BatchedRoundEngine.run_fl_round``: each
        client's local epochs and local test pass, then ``aggregate`` (or
        ``aggregate_coverage``) of the padded updates and
        ``apply_server_update``. Returns (new_params, accs, n_steps)."""
        dev = resolve_device(tree_leaves(params)[0].device)
        deltas, covs, accs, n_steps_all = [], [], [], []
        for spec, data, tdata, seed in zip(specs, datasets, test_datasets,
                                           seeds):
            delta, trained, ctx, n = self.client_update(
                params, spec, data, batch_size=batch_size, epochs=epochs,
                seed=seed)
            n_test = len(tdata["y"])
            with torch.no_grad():
                acc = float(self.family.sub_metric(
                    trained, ctx, torch.as_tensor(tdata["x"], device=dev),
                    torch.as_tensor(tdata["y"], device=dev),
                    torch.ones((n_test,), device=dev)))
            deltas.append(self.family.pad_delta(delta, params, spec))
            if coverage_norm:
                covs.append(tree_map(
                    lambda m: torch.as_tensor(m, device=dev),
                    self.family.spec_masks(spec).param_mask))
            accs.append(acc)
            n_steps_all.append(n)
        with torch.no_grad():
            if coverage_norm:
                delta_t = aggregate_coverage(deltas, covs, list(sizes))
            else:
                delta_t = aggregate(deltas, list(sizes))
            params = apply_server_update(params, delta_t)
        return params, accs, np.array(n_steps_all)
