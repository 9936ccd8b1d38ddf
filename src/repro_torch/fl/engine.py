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

Double-buffered prefetch (``enable_prefetch``): while round r's local
steps run on the card, the host can already pack round r+1's batch
streams and stage its gathers and host-to-device copies —
``stage_cohort`` builds exactly the tensors the next ``train_cohort`` call
would (the same ``_pack_inputs``, so a hit is bit-identical by
construction) into a bounded ring of :class:`StagedCohort` entries. On the
card it packs into pinned host buffers and copies them with
``non_blocking=True`` on a side ``torch.cuda.Stream``, then records an
event there; a hit makes the consuming stream wait on that event and
``record_stream``s every staged tensor. This is the port's form of the
overlap JAX's async dispatch gives the reference; on the CPU the copies
are plain. A staged entry is consumed only when the eventual call's
selection triple, seeds, batch / epoch geometry and resident-data identity
all match (by value); a mismatch counts a miss, flushes the ring and packs
eagerly, so the ring can cost a re-pack, never a bit. Callers flush on
policy / fleet / mode changes, drain, deadline misses, retries and
checkpoint restore.

Not ported yet, and raising NotImplementedError: cohort sharding over
several cards (``cohort_shards > 1``, ROADMAP A17).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

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
class CohortInputs:
    """What a cohort call feeds its local steps and its eval pass beyond
    parameters and masks (``BatchedRoundEngine._pack_inputs``)."""
    x: torch.Tensor                  # (G, N, ...) each slot's data
    y: torch.Tensor                  # (G, N) int64 labels
    idx: torch.Tensor                # (G, S, B) int64 gather indices
    sample_valid: torch.Tensor       # (G, S, B) float32
    step_valid: np.ndarray           # (G, S) bool, host (the step loop)
    valid: List[Optional[torch.Tensor]]   # per step: None (every slot
                                     # steps) or (G,) bool
    n_steps: np.ndarray              # (G,) host ints (timing model)
    ex: Optional[torch.Tensor] = None     # eval pack, gathered per slot
    ey: Optional[torch.Tensor] = None
    ev: Optional[torch.Tensor] = None
    owned: Tuple[torch.Tensor, ...] = ()  # tensors this packing made


@dataclasses.dataclass
class StagedCohort:
    """One prefetched cohort: the inputs of a round that has not started
    yet, keyed by what they are a pure function of (selection triple,
    seeds, geometry, resident-pack identity). ``event`` (on the card)
    marks the end of the side stream's copies."""
    round_idx: int                   # staged-for round (checkpoints)
    batch_size: int
    epochs: int
    seeds: Tuple[int, ...]
    data_ref: object                 # strong ref: id identity can't recycle
    eval_ref: object
    has_eval: bool
    inputs: CohortInputs
    sel_idx: Optional[np.ndarray] = None      # None = full-cohort entry
    sel_valid: Optional[np.ndarray] = None
    sel_weights: Optional[np.ndarray] = None
    event: Optional[object] = None


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
        # the prefetch ring (enable_prefetch); depth 0 = disabled
        self._prefetch_depth = 0
        self._prefetch_ring: List[StagedCohort] = []
        self._prefetch_stats = {"staged": 0, "hits": 0, "misses": 0,
                                "flushes": 0}
        self._side = None               # the staging stream (on the card)
        self._packs_ready = None        # event after the last pack build

    @property
    def kernel_path(self) -> str:
        """'tile-skipping' | 'dense-masked' — which path this engine runs."""
        return "tile-skipping" if self._kernels else "dense-masked"

    # -- the double-buffered prefetch ring ----------------------------------
    @property
    def prefetch_enabled(self) -> bool:
        return self._prefetch_depth > 0

    def enable_prefetch(self, depth: int = 1) -> None:
        """Let up to ``depth`` future cohorts be staged at once;
        ``depth <= 0`` disables the ring and flushes it."""
        depth = int(depth)
        if depth <= 0:
            self.flush_prefetch("disabled")
            self._prefetch_depth = 0
            return
        self._prefetch_depth = depth
        while len(self._prefetch_ring) > depth:
            self._prefetch_ring.pop(0)

    def flush_prefetch(self, reason: str = "") -> None:
        """Drop every staged cohort; the next round packs eagerly. A flush
        can forfeit overlap, never change a bit."""
        del reason      # for the reader of a call site; not counted apart
        if self._prefetch_ring:
            self._prefetch_stats["flushes"] += 1
            self._prefetch_ring.clear()

    def prefetch_stats(self) -> Dict[str, int]:
        """Copy of the ring's counters: staged / hits / misses / flushes."""
        return dict(self._prefetch_stats)

    def stage_cohort(self, round_idx: int, datasets: Sequence[Dict], *,
                     batch_size: int, epochs: int, seeds: Sequence[int],
                     eval_datasets: Optional[Sequence[Dict]] = None,
                     participation=None) -> None:
        """Pack and stage a *future* round's cohort while the current
        round still runs on the card: the tensors the matching
        ``train_cohort`` call would build (``_pack_inputs``), appended to
        the ring. On the card the copies run from pinned buffers on a side
        stream. A no-op unless ``enable_prefetch`` was called."""
        if not self.prefetch_enabled:
            return
        seeds = tuple(int(s) for s in seeds)
        # the resident packs are built once, on the current stream
        self._cohort_data(datasets)
        if eval_datasets is not None:
            self._eval_pack(eval_datasets)
        event = None
        if self.device.type == "cuda":
            if self._side is None:
                self._side = torch.cuda.Stream(device=self.device)
            # wait for the packs' build only, never for the round that is
            # running on the current stream
            if self._packs_ready is not None:
                self._side.wait_event(self._packs_ready)
            with torch.cuda.stream(self._side):
                inputs = self._pack_inputs(
                    datasets, participation, batch_size, epochs, seeds,
                    eval_datasets, pinned=True)
                event = torch.cuda.Event()
                event.record(self._side)
        else:
            inputs = self._pack_inputs(datasets, participation, batch_size,
                                       epochs, seeds, eval_datasets)
        part = participation
        self._prefetch_ring.append(StagedCohort(
            round_idx=int(round_idx), batch_size=int(batch_size),
            epochs=int(epochs), seeds=seeds, data_ref=datasets,
            eval_ref=eval_datasets, has_eval=eval_datasets is not None,
            inputs=inputs, event=event,
            sel_idx=None if part is None else np.array(part.idx, copy=True),
            sel_valid=None if part is None
            else np.array(part.valid, copy=True),
            sel_weights=None if part is None
            else np.array(part.weights, copy=True)))
        self._prefetch_stats["staged"] += 1
        while len(self._prefetch_ring) > self._prefetch_depth:
            self._prefetch_ring.pop(0)

    def _take_staged(self, datasets, eval_datasets, participation,
                     batch_size: int, epochs: int,
                     seeds) -> Optional[CohortInputs]:
        """Pop the staged entry matching this exact call, if any, by value
        (selection triple, seeds, geometry, resident-pack identity). A hit
        drops it and everything staged before it from the ring; a miss
        flushes the whole ring (the prediction went wrong)."""
        if not self.prefetch_enabled or not self._prefetch_ring:
            return None
        seeds = tuple(int(s) for s in seeds)
        for pos, e in enumerate(self._prefetch_ring):
            if (e.batch_size == int(batch_size)
                    and e.epochs == int(epochs) and e.seeds == seeds
                    and e.data_ref is datasets
                    and e.has_eval == (eval_datasets is not None)
                    and (not e.has_eval or e.eval_ref is eval_datasets)
                    and self._sel_match(e, participation)):
                del self._prefetch_ring[:pos + 1]
                self._prefetch_stats["hits"] += 1
                if e.event is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(e.event)
                    for t in e.inputs.owned:
                        t.record_stream(cur)
                return e.inputs
        self._prefetch_stats["misses"] += 1
        self.flush_prefetch("stale")
        return None

    @staticmethod
    def _sel_match(e: StagedCohort, part) -> bool:
        if (e.sel_idx is None) != (part is None):
            return False
        if part is None:
            return True
        return (np.array_equal(e.sel_idx, np.asarray(part.idx))
                and np.array_equal(e.sel_valid, np.asarray(part.valid))
                and np.array_equal(e.sel_weights,
                                   np.asarray(part.weights)))

    def prefetch_snapshot(self) -> Dict:
        """The ring for ``checkpoint.fleet``: each entry's *derivation*
        (round, selection triple, seeds, geometry), never its tensors —
        staging is a pure function of the resident packs, so a restore
        re-stages it bit for bit."""
        entries = [{
            "round_idx": int(e.round_idx),
            "batch_size": int(e.batch_size),
            "epochs": int(e.epochs),
            "seeds": [int(s) for s in e.seeds],
            "has_eval": bool(e.has_eval),
            "sel": None if e.sel_idx is None else (
                np.asarray(e.sel_idx), np.asarray(e.sel_valid),
                np.asarray(e.sel_weights)),
        } for e in self._prefetch_ring]
        return {"depth": int(self._prefetch_depth), "entries": entries,
                "stats": dict(self._prefetch_stats)}

    def prefetch_restore(self, snap: Dict, datasets,
                         eval_datasets=None) -> None:
        """Rebuild the ring from :meth:`prefetch_snapshot` against the
        (restored) resident packs."""
        from repro_torch.fl.selection import Selection
        self.flush_prefetch("restore")
        self._prefetch_depth = int(snap.get("depth", self._prefetch_depth))
        for es in snap.get("entries", []):
            sel = es.get("sel")
            part = None if sel is None else Selection(
                np.asarray(sel[0]), np.asarray(sel[1]), np.asarray(sel[2]))
            self.stage_cohort(
                es["round_idx"], datasets, batch_size=es["batch_size"],
                epochs=es["epochs"], seeds=es["seeds"],
                eval_datasets=eval_datasets if es.get("has_eval") else None,
                participation=part)
        if snap.get("stats"):
            self._prefetch_stats = {k: int(v)
                                    for k, v in snap["stats"].items()}

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
        step. The results are per slot.

        ``prefetch_hook`` (a no-arg callable) runs once every local step
        and the eval pass have been issued, before the first host read of
        the round — the seam where it stages the next cohort
        (``stage_cohort``) while this one still runs on the card. A
        matching staged entry in the ring is consumed instead of packing
        afresh."""
        if participation is not None and not (
                len(specs) == len(seeds) == len(participation.idx)):
            raise ValueError(
                f"per-slot specs/seeds must match the padded cohort size "
                f"{len(participation.idx)}, got {len(specs)}/{len(seeds)}")
        masks = self.family.cohort_masks(specs, self.device)
        inp = self._take_staged(datasets, eval_datasets, participation,
                                batch_size, epochs, seeds)
        if inp is None:
            inp = self._pack_inputs(datasets, participation, batch_size,
                                    epochs, seeds, eval_datasets)
        x, y, idx, sv = inp.x, inp.y, inp.idx, inp.sample_valid
        rows = torch.arange(len(specs), device=self.device)[:, None]
        params, opt_state = self.local_state(theta0_stacked)
        for t in range(inp.step_valid.shape[1]):
            if not inp.step_valid[:, t].any():   # every client padded
                continue
            self.local_step(params, opt_state, masks, x[rows, idx[:, t]],
                            sv[:, t], inp.valid[t], y[rows, idx[:, t]])
        del opt_state
        trained = tree_map(lambda t: t.detach(), params)
        deltas = tree_map(lambda a, b, m: (a - b) * m, theta0_stacked,
                          trained, masks.param_mask)
        accs = None
        if eval_datasets is not None:
            accs = self._metric_device(trained, masks, inp.ex, inp.ey,
                                       inp.ev)
        if prefetch_hook is not None:
            prefetch_hook()
        if accs is not None:
            accs = accs.cpu().numpy()
        return CohortResult(deltas, trained, masks, inp.n_steps, accs)

    def _pack_inputs(self, datasets, participation, batch_size: int,
                     epochs: int, seeds, eval_datasets,
                     pinned: bool = False) -> CohortInputs:
        """Everything ``train_cohort`` feeds the cohort beyond parameters
        and masks: the stream pack (host numpy, ``_pack_streams``), a
        subset's ``index_select`` from the resident packs, the copies of
        its indices, sample weights and per-step validity columns to the
        device, and the eval pack's gather. The eager path and
        ``stage_cohort`` both call it, so a staged hit is bit-identical.
        ``pinned``: copy from pinned host buffers with
        ``non_blocking=True`` (the staging side stream's copies)."""
        dev = self.device
        owned = []

        def put(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a))
            t = t.pin_memory().to(dev, non_blocking=True) if pinned \
                else t.to(dev)
            owned.append(t)
            return t

        x, y = self._cohort_data(datasets)
        lengths = [len(d["y"]) for d in datasets]
        steps_pad = gidx = None
        part = participation
        if part is not None:
            # S is the fleet-wide maximum: it never depends on the subset
            steps_pad = max(n_stream_steps(n, batch_size, epochs)
                            for n in lengths)
            lengths = [lengths[i] if v > 0 else 0
                       for i, v in zip(part.idx, part.valid)]
            gidx = put(np.asarray(part.idx, np.int64))
            x, y = x.index_select(0, gidx), y.index_select(0, gidx)
            owned += [x, y]
        idx, sv, stv, n_steps = _pack_streams(
            lengths, batch_size, epochs=epochs, seeds=seeds,
            n_steps_pad=steps_pad)
        cols = put(stv.T)                       # (S, G) step validity
        inp = CohortInputs(
            x, y, put(idx.astype(np.int64)), put(sv), stv,
            [None if stv[:, t].all() else cols[t]
             for t in range(stv.shape[1])], n_steps)
        if eval_datasets is not None:
            inp.ex, inp.ey, inp.ev = self._eval_pack(eval_datasets)
            if gidx is not None:
                inp.ex = inp.ex.index_select(0, gidx)
                inp.ey = inp.ey.index_select(0, gidx)
                inp.ev = inp.ev.index_select(0, gidx) * put(
                    np.asarray(part.valid))[:, None]
                owned += [inp.ex, inp.ey, inp.ev]
        inp.owned = tuple(owned)
        return inp

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
        return self._metric_device(params_stacked, masks, x, y,
                                   valid).cpu().numpy()

    def _metric_device(self, params_stacked, masks: CohortMasks, x, y,
                       valid) -> torch.Tensor:
        with torch.no_grad():
            return self.family.masked_metric(params_stacked, masks.fwd, x,
                                             y, valid, kernels=self._kernels)

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

    def _cached(self, cache: OrderedDict, datasets, build, bound: int = 4):
        key = id(datasets)
        hit = cache.get(key)
        if hit is not None and hit[0] is datasets:
            return hit[1]
        val = build(datasets)
        if self.device.type == "cuda":    # what the staging stream waits on
            self._packs_ready = torch.cuda.Event()
            self._packs_ready.record()
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
