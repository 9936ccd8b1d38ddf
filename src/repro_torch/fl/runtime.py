"""Event-driven fleet runtime: the async control plane of CFL and FedAvg —
the port of the reference's ``fl/runtime.py``.

The paper's server (Alg. 4) is lock-step: select, train a cohort, wait
for the barrier, aggregate. This module replaces the barrier with a tick
machine over five event kinds on the simulated two-term latency clock
(``core.latency``):

``dispatch``   select a cohort among the clients with no delta in flight,
               train it on the batched engine (the compute runs at once;
               the simulation spreads the results over the clock),
               schedule one ``complete`` per participant at its simulated
               finish time, and flag the cohort pending;
``complete``   a client's delta arrives (host bookkeeping: the slot is
               done, its accuracy folds into the tracker); once the
               arrived-but-unapplied deltas reach the buffer size B, an
               ``aggregate`` is scheduled;
``aggregate``  the FedBuff-style buffered server step: each in-flight
               group's arrived deltas reduce to partial sums
               (``cohort_reduce``, discounted by ``(1+s)^-a`` for the
               group's staleness s), the buffer applies once
               (``buffer_apply``), the server version advances and the
               next ``dispatch`` is scheduled;
``deadline``   the dispatch's time budget expires: slots not yet arrived
               fail, each credited a fairness miss and re-enqueued with
               exponential backoff (bounded retries); a late arrival is
               discarded;
``retry``      a failed client's backoff expires: it is selectable again,
               with a fresh fault draw.

Faults (``fl.faults.FaultPlan``) are drawn per engagement: drop (no
``complete`` fires), straggle (the simulated time inflates past the
deadline), corrupt (NaN / Inf / norm-outlier deltas injected into the
stacked deltas). The quarantine gate (``core.aggregate.delta_validity``)
takes bad deltas out of the numerator and the coverage denominator
(``sanitize=True``), and an all-quarantined buffer is a no-op step.

Numerics: with B the cohort size and no staleness, the aggregate fires at
the barrier with one complete group whose discount is 1, and the
buffered step of one group is the sync path's ``aggregate_apply``
(``buffer_apply(cohort_reduce(...))``) over the same padded cohort:
async at the sync operating point is the sync round, bit for bit.

Servers stay thin policies over the runtime: they give the cohort specs
(``cohort_specs``), the seeds (``_client_seed``), the simulated times
(``_simulated_times``) and the ``post_aggregate`` hook.

The whole machine is checkpointable: ``state_snapshot()`` /
``load_state()`` round-trip the event heap, the in-flight groups (deltas
included, as host numpy) and the retry ladder; ``checkpoint.fleet``
builds the bit-exact kill-and-resume on them. With the engine's prefetch
ring on, a dispatch stages the next one (``_stage_next_dispatch``); a
drain, a deadline miss and a retry flush the ring.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.io import _to_device, _to_host
from repro_torch.core.aggregate import (buffer_add, buffer_apply,
                                        cohort_reduce, delta_validity,
                                        staleness_scale)
from repro_torch.core.fairness import accuracy_fairness, round_time_fairness
from repro_torch.fl.faults import STREAM_ASYNC, inject_deltas, resolve_fault_plan
from repro_torch.fl.selection import FleetState, Selection, _pad_selection

DISPATCH, COMPLETE, AGGREGATE = "dispatch", "complete", "aggregate"
DEADLINE, RETRY = "deadline", "retry"

# with faults on and no explicit deadline, a dropped client must still
# fail in bounded simulated time: 4× the cohort's median predicted time
DEFAULT_DEADLINE_FACTOR = 4.0


@dataclasses.dataclass
class InFlightCohort:
    """One dispatched cohort's state while its deltas stream in: the
    engine's stacked (M, ...) deltas stay on the device until every valid
    slot is consumed by an aggregate or has ``failed`` its deadline."""
    version: int              # server version at dispatch (staleness base)
    dispatch_t: float
    sel: Selection
    specs: List               # per-slot specs (padding repeats slot 0)
    deltas: object            # stacked (M, ...) tree
    covs: Optional[object]    # stacked masks (coverage_norm) or None
    weights: torch.Tensor     # (M,) aggregation weights
    accs: np.ndarray          # (M,) local-eval accuracies
    n_steps: np.ndarray       # (M,) local steps (timing model)
    times: np.ndarray         # (M,) simulated per-slot latency
    completed: np.ndarray     # (M,) bool — delta arrived
    consumed: np.ndarray      # (M,) bool — delta aggregated
    complete_t: np.ndarray    # (M,) arrival clock (aggregate-lag metric)
    failed: np.ndarray = None          # (M,) bool — missed its deadline
    deadline_t: float = float("inf")   # this dispatch's time budget

    def __post_init__(self):
        if self.failed is None:
            self.failed = np.zeros_like(self.completed)

    def pending_slots(self) -> np.ndarray:
        """Valid slots whose delta has arrived but not been applied."""
        return np.flatnonzero(self.completed & ~self.consumed
                              & (self.sel.valid > 0))

    def expected_slots(self) -> int:
        """Valid slots still in flight (not arrived, not failed)."""
        return int(np.sum(~self.completed & ~self.failed
                          & (self.sel.valid > 0)))

    def all_settled(self) -> bool:
        """Every valid slot aggregated or failed."""
        return bool(np.all((self.consumed | self.failed)
                           [self.sel.valid > 0]))


class FleetRuntime:
    """The buffered-async tick machine shared by CFL and FedAvg.

    ``buffer_size`` B: apply the server step whenever B deltas have
    arrived (None: ``ceil(quorum_frac × cohort size)``; quorum_frac 1 is
    the sync barrier). ``staleness_decay`` a: a delta dispatched s
    versions ago counts ``(1+s)^-a`` (0 disables; 0.5 is FedBuff's
    ``1/sqrt(1+s)``). The fault knobs come from the server's config:
    ``faults``, ``deadline_factor`` (default 4 with faults, else none),
    ``max_retries`` / ``retry_backoff``, ``norm_clip_factor``.

    Drive it with ``tick()`` (one event; the history record when it was
    an aggregate) or ``run_until_aggregate()`` (one server version). Each
    record carries the reference's columns plus ``n_steps`` and
    ``host_seconds`` (search and predictor since the last aggregate)."""

    def __init__(self, server, *, buffer_size: Optional[int] = None,
                 staleness_decay: float = 0.5):
        if getattr(server, "engine", None) is None:
            raise ValueError(
                "FleetRuntime requires the batched engine "
                "(batched_rounds=True); the sequential loop stays the "
                "sync A/B reference")
        self.server = server
        self.engine = server.engine
        self.tracker = server.tracker
        self.buffer_size = buffer_size
        self.staleness_decay = float(staleness_decay)
        fl = server.fl
        self.faults = resolve_fault_plan(fl.faults)
        self.quorum_frac = float(fl.quorum_frac)
        if not (0.0 < self.quorum_frac <= 1.0):
            raise ValueError(f"quorum_frac must be in (0, 1], got "
                             f"{self.quorum_frac}")
        self.max_retries = int(fl.max_retries)
        self.retry_backoff = float(fl.retry_backoff)
        self.norm_clip_factor = float(fl.norm_clip_factor)
        df = fl.deadline_factor
        if df is None and self.faults is not None:
            df = DEFAULT_DEADLINE_FACTOR
        self.deadline_factor = None if df is None else float(df)
        # the gate runs with faults on or when asked for; off, the
        # fault-free numerics stay those of the sync path
        self._validate = self.faults is not None or bool(fl.validate_deltas)
        self.clock = 0.0
        # in-flight cohorts by a monotonically increasing group id (the
        # COMPLETE events carry it)
        self.groups: Dict[int, InFlightCohort] = {}
        self._next_gid = 0
        self._events: List[Tuple[float, int, str, tuple]] = []
        self._seq = 0
        self._agg_scheduled = False
        self._draining = False
        self._cohort_slots = None       # last dispatch's participant count
        self._retry_attempts: Dict[int, int] = {}   # consecutive failures
        self._in_backoff: Set[int] = set()
        self._dropped_since_agg = 0     # failed engagements (deadline)
        self._retried_since_agg = 0     # backoffs expired → re-selectable
        self._host = {"search": 0.0, "predictor": 0.0}
        self._push(0.0, DISPATCH, ())

    # -- event plumbing ----------------------------------------------------
    def _push(self, t: float, kind: str, payload: tuple):
        heapq.heappush(self._events, (float(t), self._seq, kind, payload))
        self._seq += 1

    def _buffered(self) -> int:
        return int(sum(len(g.pending_slots())
                       for g in self.groups.values()))

    def _expected(self) -> int:
        """Valid slots still in flight across every group."""
        return int(sum(g.expected_slots() for g in self.groups.values()))

    def _effective_buffer(self) -> int:
        if self.buffer_size is not None:
            return max(1, int(self.buffer_size))
        slots = int(self._cohort_slots or 1)
        return max(1, int(np.ceil(self.quorum_frac * slots)))

    def tick(self) -> Optional[Dict]:
        """Process one event; returns the aggregate's history record when
        one fired. A drained queue with arrived deltas flushes an
        aggregate; a fully idle fleet re-dispatches."""
        if not self._events:
            if self._buffered() > 0:
                self._push(self.clock, AGGREGATE, ())
            elif not self.tracker.pending_mask().any():
                self._push(self.clock, DISPATCH, ())
            else:                        # pragma: no cover - defensive
                raise RuntimeError("runtime stalled: pending deltas with "
                                   "no scheduled events")
        t, _, kind, payload = heapq.heappop(self._events)
        self.clock = max(self.clock, t)
        if kind == DISPATCH:
            self._on_dispatch(t)
            return None
        if kind == COMPLETE:
            self._on_complete(t, *payload)
            return None
        if kind == DEADLINE:
            self._on_deadline(t, *payload)
            return None
        if kind == RETRY:
            self._on_retry(t, *payload)
            return None
        return self._on_aggregate(t)

    def run_until_aggregate(self, max_ticks: int = 100_000) -> Dict:
        """Advance the clock until one server step applies — the async
        analogue of one sync ``run_round``."""
        for _ in range(max_ticks):
            rec = self.tick()
            if rec is not None:
                return rec
        raise RuntimeError(f"no aggregate within {max_ticks} ticks")

    def drain(self, max_ticks: int = 100_000) -> List[Dict]:
        """Flush every in-flight cohort without dispatching new work: the
        remaining completions are applied through buffered aggregates
        (each a recorded server step); clients waiting out a backoff are
        given up at once."""
        recs: List[Dict] = []
        self._draining = True
        try:
            # a drain dispatches nothing more: staged cohorts are dead
            self.engine.flush_prefetch("drain")
            self._flush_backoff()
            for _ in range(max_ticks):
                if not self.groups:
                    return recs
                rec = self.tick()
                if rec is not None:
                    recs.append(rec)
        finally:
            self._draining = False
        raise RuntimeError(f"drain incomplete after {max_ticks} ticks")

    def _flush_backoff(self) -> None:
        """Give up on every client in backoff: clear its pending flag and
        retry ladder (its RETRY event becomes a no-op)."""
        for cid in sorted(self._in_backoff):
            self.tracker.clear_pending([cid])
            self._retry_attempts.pop(cid, None)
        self._in_backoff.clear()

    # -- checkpoint surface (checkpoint.fleet) -----------------------------
    def state_snapshot(self) -> Dict:
        """Everything that rebuilds this machine bit for bit in a fresh
        process: the clock, the event heap, every in-flight group (its
        deltas pulled to host numpy) and the retry ladder. Host data only:
        picklable by ``checkpoint.io.save_state``."""
        groups = {}
        for gid, g in self.groups.items():
            groups[int(gid)] = {
                "version": int(g.version),
                "dispatch_t": float(g.dispatch_t),
                "sel": (np.asarray(g.sel.idx), np.asarray(g.sel.valid),
                        np.asarray(g.sel.weights)),
                "specs": list(g.specs),
                "deltas": _to_host(g.deltas),
                "covs": _to_host(g.covs),
                "weights": _to_host(g.weights),
                "accs": np.asarray(g.accs),
                "n_steps": np.asarray(g.n_steps),
                "times": np.asarray(g.times),
                "completed": np.array(g.completed),
                "consumed": np.array(g.consumed),
                "complete_t": np.array(g.complete_t),
                "failed": np.array(g.failed),
                "deadline_t": float(g.deadline_t),
            }
        return {
            "groups": groups,
            "clock": float(self.clock),
            "next_gid": int(self._next_gid),
            "seq": int(self._seq),
            "agg_scheduled": bool(self._agg_scheduled),
            "cohort_slots": self._cohort_slots,
            "events": [(float(t), int(s), k, tuple(p))
                       for t, s, k, p in self._events],
            "retry_attempts": dict(self._retry_attempts),
            "in_backoff": sorted(self._in_backoff),
            "dropped_since_agg": int(self._dropped_since_agg),
            "retried_since_agg": int(self._retried_since_agg),
        }

    def load_state(self, snap: Dict) -> None:
        """Inverse of :meth:`state_snapshot`: the groups' deltas, masks
        and weights go back to the engine's device."""
        dev = self.engine.device
        self.clock = float(snap["clock"])
        self._next_gid = int(snap["next_gid"])
        self._seq = int(snap["seq"])
        self._agg_scheduled = bool(snap["agg_scheduled"])
        self._cohort_slots = snap["cohort_slots"]
        self._events = [(float(t), int(s), k, tuple(p))
                        for t, s, k, p in snap["events"]]
        heapq.heapify(self._events)
        self._retry_attempts = {int(k): int(v)
                                for k, v in snap["retry_attempts"].items()}
        self._in_backoff = set(int(c) for c in snap["in_backoff"])
        self._dropped_since_agg = int(snap["dropped_since_agg"])
        self._retried_since_agg = int(snap["retried_since_agg"])
        self.groups = {}
        for gid, gs in snap.get("groups", {}).items():
            idx, valid, weights = gs["sel"]
            self.groups[int(gid)] = InFlightCohort(
                version=int(gs["version"]),
                dispatch_t=float(gs["dispatch_t"]),
                sel=Selection(np.asarray(idx), np.asarray(valid),
                              np.asarray(weights)),
                specs=list(gs["specs"]),
                deltas=_to_device(gs["deltas"], dev),
                covs=_to_device(gs["covs"], dev),
                weights=_to_device(gs["weights"], dev),
                accs=np.asarray(gs["accs"]),
                n_steps=np.asarray(gs["n_steps"]),
                times=np.asarray(gs["times"]),
                completed=np.array(gs["completed"]),
                consumed=np.array(gs["consumed"]),
                complete_t=np.array(gs["complete_t"]),
                failed=np.array(gs["failed"]),
                deadline_t=float(gs["deadline_t"]))

    # -- dispatch ----------------------------------------------------------
    def _select_available(self, round_idx: int,
                          avail: np.ndarray) -> Selection:
        """The policy over the non-pending sub-fleet, re-padded to the
        fleet-fixed slot count: in-flight clients are never re-dispatched
        and the engine's shapes never churn with availability."""
        tracker, server = self.tracker, self.server
        avail_ids = np.flatnonzero(avail)
        m_fleet = tracker.policy.cohort_size(len(server.clients))
        full = tracker.state(round_idx)
        times = None if full.predicted_times is None else \
            np.asarray(full.predicted_times)[avail_ids]
        sub = FleetState([server.clients[int(i)] for i in avail_ids],
                         round_idx, full.last_accs[avail_ids],
                         full.participation_counts[avail_ids], times,
                         misses=None if full.misses is None
                         else full.misses[avail_ids])
        sub_sel = tracker.policy.select(sub, tracker._round_rng(round_idx))
        local = sub_sel.participants
        weights = [float(w) for w, v in zip(sub_sel.weights, sub_sel.valid)
                   if v > 0]
        return _pad_selection([int(avail_ids[i]) for i in local], weights,
                              m_fleet)

    def _stage_next_dispatch(self) -> None:
        """The prefetch hook of a dispatch: while this dispatch still runs
        on the card, stage the next one, predicted in the steady state
        (this cohort consumed by the next aggregate, so round r+1
        dispatches at full availability with the policy's derivational
        draw). Under churn — partial availability, deadline misses,
        retries — the prediction is wrong, the staged entry fails its
        check by value and the dispatch packs eagerly."""
        engine = self.engine
        if not engine.prefetch_enabled or self._draining or \
                self.tracker.policy.state_dependent:
            return
        server = self.server
        r = server.round_idx + 1
        sel = self.tracker.select(r)
        engine.stage_cohort(
            r, server.client_data, batch_size=server.fl.batch_size,
            epochs=server.fl.local_epochs,
            seeds=[server._client_seed(int(i), r) for i in sel.idx],
            eval_datasets=server.test_data, participation=sel)

    def _on_dispatch(self, t: float) -> None:
        if self._draining:
            return              # the post-drain idle guard re-dispatches
        server, fl = self.server, self.server.fl
        dev = self.engine.device
        avail = ~self.tracker.pending_mask()
        if not avail.any():
            return                      # the next aggregate re-dispatches
        r = server.round_idx
        sel = self.tracker.select(r) if avail.all() else \
            self._select_available(r, avail)
        participants = [int(i) for i in sel.participants]
        t0 = time.perf_counter()
        specs_real = server.cohort_specs(participants)
        self._host["search"] += time.perf_counter() - t0
        m = len(sel.idx)
        # padding slots repeat slot 0's spec (weight 0, no steps)
        specs_slots = list(specs_real) + \
            [specs_real[0]] * (m - len(specs_real))
        theta0 = self.engine.broadcast_params(server.params, m)
        res = self.engine.train_cohort(
            theta0, specs_slots, server.client_data,
            batch_size=fl.batch_size, epochs=fl.local_epochs,
            seeds=[server._client_seed(int(i)) for i in sel.idx],
            eval_datasets=server.test_data, participation=sel,
            prefetch_hook=self._stage_next_dispatch)
        covs = res.masks.param_mask if fl.coverage_norm else None
        deltas = res.deltas
        weights = torch.as_tensor(sel.weights, device=dev)

        n_steps_valid = [int(n) for n in sel.take_valid(res.n_steps)]
        times_valid = server._simulated_times(specs_real, n_steps_valid,
                                              participants)
        times = np.zeros((m,), np.float64)
        valid_slots = np.flatnonzero(sel.valid > 0)
        times[valid_slots] = times_valid

        # an engagement-keyed draw: this gid, these slots, once — a retried
        # client rides a later gid and draws afresh
        gid = self._next_gid
        self._next_gid += 1
        gf = None
        if self.faults is not None and self.faults.any_rates():
            gf = self.faults.draw(STREAM_ASYNC, gid, m, 1)
            if gf.corrupt.any():
                codes, scales = gf.codes_scales(self.faults.outlier_scale,
                                                dev)
                deltas = inject_deltas(deltas, codes, scales)
            straggle = gf.straggle & (sel.valid > 0)
            times[straggle] *= self.faults.straggle_factor

        deadline_t = float("inf")
        if self.deadline_factor is not None and len(valid_slots):
            # the budget from the clean predicted times: a straggler gets
            # no extra rope
            base = float(np.median(np.asarray(times_valid)))
            deadline_t = t + self.deadline_factor * max(base, 1e-9)

        group = InFlightCohort(
            version=r, dispatch_t=t, sel=sel, specs=specs_slots,
            deltas=deltas, covs=covs, weights=weights,
            accs=np.asarray(res.accs), n_steps=np.asarray(res.n_steps),
            times=times, completed=np.zeros((m,), bool),
            consumed=np.zeros((m,), bool),
            complete_t=np.zeros((m,), np.float64),
            failed=np.zeros((m,), bool),
            deadline_t=deadline_t)
        self.groups[gid] = group
        self._cohort_slots = len(participants)
        self.tracker.mark_pending(participants)
        dropped = gf.drop if gf is not None else np.zeros((m,), bool)
        for slot in valid_slots:
            if dropped[slot]:
                continue        # no delta will arrive: the deadline fails it
            self._push(t + times[slot], COMPLETE, (gid, int(slot)))
        if np.isfinite(deadline_t):
            self._push(deadline_t, DEADLINE, (gid,))

    # -- complete ----------------------------------------------------------
    def _on_complete(self, t: float, gid: int, slot: int) -> None:
        g = self.groups.get(gid)
        if g is None:
            return              # the group was settled and freed already
        if g.failed[slot]:
            return              # a late arrival past its deadline
        g.completed[slot] = True
        g.complete_t[slot] = t
        cid = int(g.sel.idx[slot])
        self._retry_attempts.pop(cid, None)     # success resets the ladder
        self.tracker.record([cid], [float(g.accs[slot])])
        if not self._agg_scheduled and \
                self._buffered() >= self._effective_buffer():
            self._agg_scheduled = True
            self._push(t, AGGREGATE, ())

    # -- deadline / retry --------------------------------------------------
    def _on_deadline(self, t: float, gid: int) -> None:
        g = self.groups.get(gid)
        if g is None:
            return
        miss = np.flatnonzero((g.sel.valid > 0) & ~g.completed & ~g.failed)
        if len(miss) == 0:
            return
        g.failed[miss] = True
        # misses change availability and fairness debt: a staged cohort
        # drawn under the old fleet state is stale
        self.engine.flush_prefetch("deadline")
        for slot in miss:
            self._fail_engagement(int(g.sel.idx[slot]), t)
        self._dropped_since_agg += len(miss)
        if g.all_settled() and len(g.pending_slots()) == 0:
            del self.groups[gid]    # nothing arrived worth keeping
        # the failures may have made the quorum unreachable: flush what
        # arrived rather than wait for a B that can no longer fill
        if not self._agg_scheduled and self._buffered() > 0 and (
                self._buffered() >= self._effective_buffer()
                or self._expected() == 0):
            self._agg_scheduled = True
            self._push(t, AGGREGATE, ())

    def _fail_engagement(self, cid: int, t: float) -> None:
        """A client missed its deadline: credit the miss, then re-enqueue
        it with exponential backoff — or give up (clear pending) after
        ``max_retries`` consecutive failures, or at once when draining."""
        self.tracker.record_miss([cid])
        attempt = self._retry_attempts.get(cid, 0)
        if self._draining or attempt >= self.max_retries:
            self._retry_attempts.pop(cid, None)
            self.tracker.clear_pending([cid])
            return
        self._retry_attempts[cid] = attempt + 1
        self._in_backoff.add(cid)
        self._push(t + self.retry_backoff * (2.0 ** attempt), RETRY,
                   (cid,))

    def _on_retry(self, t: float, cid: int) -> None:
        if cid not in self._in_backoff:
            return              # given up by a drain: a stale event
        self._in_backoff.discard(cid)
        self.tracker.clear_pending([cid])
        self._retried_since_agg += 1
        # a retry restores availability: the staged availability is stale
        self.engine.flush_prefetch("retry")

    # -- aggregate ---------------------------------------------------------
    def _gate(self, g: InFlightCohort, mask: np.ndarray):
        """The quarantine gate over one group's contributing slots: the
        gated participation (a tensor) and the quarantined slots."""
        dev = self.engine.device
        gatev, _ = delta_validity(g.deltas, torch.as_tensor(mask,
                                                            device=dev),
                                  self.norm_clip_factor)
        gv = gatev.cpu().numpy()
        quarantined = np.flatnonzero((mask > 0) & (gv == 0))
        return torch.as_tensor(mask * gv.astype(np.float32),
                               device=dev), quarantined

    def _apply_buffered(self, contribs, quarantined) -> None:
        """The FedBuff step: per-group masked partial sums, each scaled by
        its group's staleness discount, added, applied once. Quarantined
        slots leave the group's participation; an all-quarantined buffer
        reduces to (0, 0), which ``buffer_apply``'s floor makes a no-op.
        One fresh, complete group is the sync round's ``aggregate_apply``
        to the bit: its discount is 1 and its mask is ``sel.valid``."""
        server, fl = self.server, self.server.fl
        r = server.round_idx
        total = None
        for g, slots in contribs:
            mask = np.zeros((len(g.sel.idx),), np.float32)
            mask[slots] = 1.0
            if self._validate:
                part, quar = self._gate(g, mask)
                quarantined.extend((g, int(s)) for s in quar)
            else:
                part = torch.as_tensor(mask, device=self.engine.device)
            scale = staleness_scale(r - g.version, self.staleness_decay)
            nd = cohort_reduce(g.deltas, g.covs, g.weights,
                               coverage_norm=fl.coverage_norm,
                               participation=part,
                               scale=float(np.float32(scale)),
                               sanitize=self._validate)
            total = nd if total is None else buffer_add(total, nd)
        server.params = buffer_apply(server.params, *total,
                                     coverage_norm=fl.coverage_norm)

    def _on_aggregate(self, t: float) -> Optional[Dict]:
        self._agg_scheduled = False
        server = self.server
        contribs = [(g, g.pending_slots()) for g in self.groups.values()
                    if len(g.pending_slots())]
        if not contribs:
            return None
        r = server.round_idx
        quarantined: List[tuple] = []   # (group, slot) pairs
        with torch.no_grad():
            self._apply_buffered(contribs, quarantined)

        # a quarantined slot was consumed with zero weight: its update
        # never reached the model, so it is a miss
        for g, s in quarantined:
            self.tracker.record_miss([int(g.sel.idx[s])])

        participants, accs, times, specs, lags, stale = [], [], [], [], [], []
        n_steps, waited = [], []
        for g, slots in contribs:
            g.consumed[slots] = True
            ids = [int(g.sel.idx[s]) for s in slots]
            participants.extend(ids)
            accs.extend(float(g.accs[s]) for s in slots)
            times.extend(float(g.times[s]) for s in slots)
            specs.extend(g.specs[s] for s in slots)
            n_steps.extend(int(g.n_steps[s]) for s in slots)
            lags.extend(t - float(g.complete_t[s]) for s in slots)
            stale.extend([r - g.version] * len(slots))
            waited.append(t - g.dispatch_t)
            self.tracker.clear_pending(ids)
        self.groups = {gid: g for gid, g in self.groups.items()
                       if not g.all_settled()}

        server.round_idx += 1
        self.tracker.bump_staleness()
        rec = {
            "round": r,
            "participants": participants,
            "selection": self.tracker.policy.name,
            "accs": accs,
            "fairness": accuracy_fairness(accs),
            "timing": round_time_fairness(times),
            "n_steps": n_steps,
            "staleness": float(np.mean(stale)),
            "aggregate_lag": float(np.mean(lags)),
            "sim_clock": float(t),
            "buffered": len(participants),
            "mode": "async",
            "dropped": self._dropped_since_agg,
            "retried": self._retried_since_agg,
            "quarantined": len(quarantined),
            "quorum_waited_ms": float(np.mean(waited)) * 1e3,
        }
        self._dropped_since_agg = 0
        self._retried_since_agg = 0
        t0 = time.perf_counter()
        rec.update(server.post_aggregate(specs, participants, accs))
        self._host["predictor"] += time.perf_counter() - t0
        rec["host_seconds"] = {k: self._host[k] for k in server.HOST_PHASES}
        self._host = {"search": 0.0, "predictor": 0.0}
        server.history.append(rec)
        self._push(t, DISPATCH, ())
        return rec
