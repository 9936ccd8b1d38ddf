"""CFL server (Alg. 4) — the port of the reference's ``fl/server.py``:
client selection -> submodel sampling -> local training -> alignment +
aggregation -> search-helper update, with per-round latency / fairness
accounting from the device profiles.

Each sync round:

* the tracker's policy picks the cohort (``fl.selection``: every client
  under "full", a fixed-size padded subset under "uniform", "fairness"
  or "latency");
* round 0 draws, per client, 32 random specs and keeps the first that is
  feasible under its latency bound in the LUT (the predictor is still
  untrained); later rounds run the genetic search (``core.search``),
  scored by the accuracy predictor;
* ``BatchedRoundEngine.run_fl_round`` trains and evaluates the cohort in
  parent coordinates and applies the aggregate (``batched_rounds=True``,
  the default), or ``SequentialFamilyTrainer`` does it one extracted
  submodel at a time on the participants' sub-lists
  (``batched_rounds=False``);
* ``post_aggregate`` feeds the participants' accuracies to the predictor
  (Alg. 2) and the round is recorded with its fairness, its simulated
  timing and scheduling columns, and the host seconds of the search and
  of the round.

With ``faults`` a sync round sheds, quarantines and applies a sanitised
step (``fl.faults.faulty_sync_round``); ``mode="async"`` drives buffered
rounds through the event-driven runtime (``fl.runtime.FleetRuntime``).
Both need the batched engine, as in the reference.

``overlap`` turns on the batched engine's prefetch ring: while round r
runs on the card, ``_stage_next_round`` stages round r+1's cohort, drawn
from the derivational selection RNG, for the state-independent policies
("full", "uniform", "latency"); a policy, fleet or mode change flushes
it. ``checkpoint_every`` is ``CFLSession``'s autosave
(``checkpoint.fleet``).

``CFLConfig`` keeps every field of the reference's. What is not ported
yet raises, naming its ROADMAP item: ``cohort_shards > 1`` (A17).
``elastic_kernels`` keeps its meaning: False is the dense masked path;
True / "auto" / "cuda" the hand kernels (the batched engine's; the
sequential trainer runs the plain forward).

``SyncServer`` holds what this server and the FedAvg baseline
(``fl.baselines``) share.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.elastic import family_for
from repro_torch.core.fairness import accuracy_fairness, round_time_fairness
from repro_torch.core.latency import LatencyTable
from repro_torch.core.predictor import AccuracyPredictor
from repro_torch.core.search import SearchConfig, search_all_workers
from repro_torch.fl.client import ClientInfo
from repro_torch.fl.engine import (BatchedRoundEngine,
                                   SequentialFamilyTrainer, _not_ported)
from repro_torch.fl.selection import (FleetTracker, SelectionPolicy,
                                      predict_full_round_times)
from repro_torch.kernels.backend import resolve_backend, resolve_device


@dataclasses.dataclass
class CFLConfig:
    n_workers: int = 8
    local_epochs: int = 1
    batch_size: int = 32
    lr: float = 0.05
    momentum: float = 0.9
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    coverage_norm: bool = False     # beyond-paper aggregation variant
    # l_k = frac * min(own, fleet-median) full-model step latency; >1 lets
    # devices at/below the median train the full parent model.
    latency_bound_frac: float = 1.05
    batched_rounds: bool = True     # parent-space cohort engine vs seq loop
    cohort_shards: int = 1
    # the batched engine's masked compute: False = the dense masked path;
    # True / "auto" / "cuda" = the hand-written kernels (kernels.dispatch)
    elastic_kernels: Union[bool, str] = False
    selection: Union[None, str, SelectionPolicy] = "full"
    mode: str = "sync"
    overlap: bool = False
    prefetch_depth: int = 1
    async_buffer: Optional[int] = None
    staleness_decay: float = 0.5
    # cohort RNG derivation: 'seedseq' | 'legacy' (fl.selection)
    selection_rng: str = "seedseq"
    faults: object = None
    quorum_frac: float = 1.0
    deadline_factor: Optional[float] = None
    max_retries: int = 2
    retry_backoff: float = 0.5
    norm_clip_factor: float = 6.0
    validate_deltas: bool = False
    checkpoint_every: Optional[int] = None
    checkpoint_dir: str = "checkpoints/fleet"
    seed: int = 0


def engine_backend(elastic_kernels) -> str:
    """``CFLConfig.elastic_kernels`` -> the engine's backend: False ->
    "dense" (the dense masked path), True -> "auto" (the hand kernels),
    a name as ``kernels.backend.resolve_backend`` takes it; the
    reference's "tpu" and "interpret" raise its ValueError, which names
    the port's backends."""
    if isinstance(elastic_kernels, bool):
        return "auto" if elastic_kernels else "dense"
    return resolve_backend(elastic_kernels)


def check_supported(fl: CFLConfig) -> None:
    """Raise for the ``CFLConfig`` settings the port does not run yet."""
    if fl.mode not in ("sync", "async"):
        raise ValueError(f"mode must be 'sync' or 'async', "
                         f"got {fl.mode!r}")
    if int(fl.cohort_shards) != 1:
        raise _not_ported("cohort sharding over several cards", "A17")
    engine_backend(fl.elastic_kernels)


def round_engines(family, fl: CFLConfig, device):
    """(engine, seq): the batched engine and None, or None and the
    sequential trainer, as ``fl.batched_rounds`` says."""
    if fl.batched_rounds:
        return BatchedRoundEngine(
            family, lr=fl.lr, momentum=fl.momentum,
            backend=engine_backend(fl.elastic_kernels), device=device), None
    return None, SequentialFamilyTrainer(family, lr=fl.lr,
                                         momentum=fl.momentum)


class SyncServer:
    """What the CFL server and the FedAvg baseline (``fl.baselines``)
    share: the fleet, the latency LUT, the selection tracker, the round
    engine (batched or sequential, ``round_engines``), and the sync round
    itself — the cohort's specs (``cohort_specs``), local training and
    aggregation, the simulated timing, the server's update
    (``post_aggregate``) and the record. ``params``: the parent's
    parameters on ``device`` (the card unless the caller asks for the
    CPU). ``HOST_PHASES`` names the host seconds a round records beside
    the whole round's."""

    HOST_PHASES: Tuple[str, ...] = ()

    def __init__(self, cfg, params, clients: List[ClientInfo],
                 client_data: List[Dict], test_data: List[Dict],
                 fl_cfg: CFLConfig, device=None):
        check_supported(fl_cfg)
        self.device = resolve_device(device)
        self.family = family_for(cfg)
        self.cfg = self.family.cfg
        self.params = params
        self.clients = clients
        self.client_data = client_data
        self.test_data = test_data
        self.fl = fl_cfg
        t0 = time.perf_counter()
        self.latency = LatencyTable(self.family,
                                    batch_size=fl_cfg.batch_size)
        self.lut_seconds = time.perf_counter() - t0   # host, at build
        self.tracker = FleetTracker(
            clients, fl_cfg.selection, seed=fl_cfg.seed,
            predicted_times_fn=self._predict_round_times,
            rng_mode=fl_cfg.selection_rng, device=self.device)
        self.round_idx = 0
        self.history: List[Dict] = []
        self._sim_clock = 0.0
        self._runtime = None            # built on the first async round
        self.engine, self._seq = round_engines(self.family, fl_cfg,
                                               self.device)
        if self.engine is not None:
            # a cohort staged under an old policy or fleet must never be
            # consumed: any tracker invalidation flushes the ring
            self.tracker.add_invalidate_hook(
                lambda: self.engine.flush_prefetch("fleet-invalidate"))
            if fl_cfg.overlap:
                self.engine.enable_prefetch(fl_cfg.prefetch_depth)

    # ------------------------------------------------------------------
    def set_selection(self, selection) -> None:
        """Swap the client-selection policy ('full' | 'uniform' |
        'fairness' | 'latency' or a SelectionPolicy) for the rounds that
        follow; the tracker's invalidate hook flushes the prefetch
        ring."""
        self.tracker.set_policy(selection)

    def set_mode(self, mode: str) -> None:
        """Switch round scheduling for the rounds that follow: 'sync'
        (barrier rounds) | 'async' (buffered rounds, ``fl.runtime``).
        Switching to sync with deltas in flight drains the runtime first:
        the remaining completions are aggregated (each a server step,
        recorded in ``history``). The prefetch ring is flushed either way:
        the two modes predict different next cohorts."""
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', "
                             f"got {mode!r}")
        if mode == "sync" and self._runtime is not None:
            self._runtime.drain()
        if self.engine is not None:
            self.engine.flush_prefetch("set_mode")
        self.fl.mode = mode

    def set_overlap(self, overlap: bool) -> None:
        """Turn the prefetch ring on (``CFLConfig.prefetch_depth`` deep)
        or off for the rounds that follow; off flushes it. The results
        are the same either way."""
        if self.engine is None:
            if overlap:
                raise ValueError("overlap requires the batched engine "
                                 "(batched_rounds=True)")
            return
        self.fl.overlap = bool(overlap)
        self.engine.enable_prefetch(self.fl.prefetch_depth if overlap
                                    else 0)

    @property
    def runtime(self):
        """The event-driven runtime (``fl.runtime.FleetRuntime``), built
        on first use; async rounds are driven through it."""
        if self._runtime is None:
            from repro_torch.fl.runtime import FleetRuntime
            self._runtime = FleetRuntime(
                self, buffer_size=self.fl.async_buffer,
                staleness_decay=self.fl.staleness_decay)
        return self._runtime

    def _predict_round_times(self) -> List[float]:
        return predict_full_round_times(
            self.family, self.clients, self.latency,
            batch_size=self.fl.batch_size, epochs=self.fl.local_epochs)

    def _client_seed(self, k: int, round_idx: Optional[int] = None) -> int:
        r = self.round_idx if round_idx is None else int(round_idx)
        return self.fl.seed * 7 + r * 131 + k

    def _stage_next_round(self) -> None:
        """The prefetch hook of a sync round: draw round r+1's cohort from
        the derivational selection RNG (side-effect free for any round)
        and stage it while round r still runs on the card — the very
        ``train_cohort`` call ``_train_round`` (or the faulty round) will
        make. Only for policies that are not ``state_dependent``; the
        entry is checked by value when consumed either way."""
        engine = self.engine
        if engine is None or not engine.prefetch_enabled or \
                self.tracker.policy.state_dependent:
            return
        r = self.round_idx + 1
        sel = self.tracker.select(r)
        engine.stage_cohort(
            r, self.client_data, batch_size=self.fl.batch_size,
            epochs=self.fl.local_epochs,
            seeds=[self._client_seed(int(i), r) for i in sel.idx],
            eval_datasets=self.test_data, participation=sel)

    def _simulated_times(self, specs, n_steps,
                         client_ids: Sequence[int]) -> List[float]:
        """Simulated wall clock per client of a cohort (``client_ids``
        its fleet indices): compute + update exchange."""
        times = []
        for i, spec, n in zip(client_ids, specs, n_steps):
            client = self.clients[int(i)]
            prof = self.latency.fleet[client.device]
            t = n * self.latency.lookup(spec, client.device) + \
                prof.comm_latency(2 * self.family.param_bytes(spec))
            times.append(float(t))
        return times

    def cohort_specs(self, participants: Sequence[int]) -> List:
        """The specs of a cohort (``participants`` its fleet indices)."""
        raise NotImplementedError

    def post_aggregate(self, specs, participants: Sequence[int],
                       accs: Sequence[float]) -> Dict:
        return {}

    def run_round(self) -> Dict:
        """One sync round, or in ``mode="async"`` one server step of the
        runtime; returns its history record."""
        t_round = time.perf_counter()
        if self.fl.mode == "async":
            rec = self.runtime.run_until_aggregate()
            rec["host_seconds"]["round"] = time.perf_counter() - t_round
            return rec
        sel = self.tracker.select(self.round_idx)
        participants = [int(i) for i in sel.participants]
        t0 = time.perf_counter()
        specs = self.cohort_specs(participants)
        search_s = time.perf_counter() - t0
        stats = None
        if self.fl.faults is not None:
            from repro_torch.fl.faults import faulty_sync_round
            accs, times, participants, specs_kept, stats, n_steps = \
                faulty_sync_round(self, specs, sel)
            t0 = time.perf_counter()
            extras = self.post_aggregate(specs_kept, participants, accs) \
                if participants else {}
        else:
            accs, n_steps, times = self._train_round(specs, sel)
            t0 = time.perf_counter()
            extras = self.post_aggregate(specs, participants, accs)
            self.tracker.record(participants, accs)
        host = {"search": search_s, "predictor": time.perf_counter() - t0}
        rec = {
            "round": self.round_idx,
            "participants": participants,
            "selection": self.tracker.policy.name,
            "accs": accs,
            "fairness": accuracy_fairness(accs if accs
                                          else [float("nan")]),
            "timing": round_time_fairness(times if times else [0.0]),
            "n_steps": [int(n) for n in n_steps],
        }
        rec.update(extras)
        rec.update(self._sync_clock_columns(times))
        if stats is not None:
            rec.update(stats)
        rec["host_seconds"] = {k: host[k] for k in self.HOST_PHASES}
        rec["host_seconds"]["round"] = time.perf_counter() - t_round
        self.history.append(rec)
        self.round_idx += 1
        return rec

    def _train_round(self, specs, sel):
        """The cohort's local train + eval, then the aggregate and the
        server step, on the batched engine (the selection's padded slots
        in parent coordinates; full participation is the identity
        cohort) or on the sequential trainer (one extracted submodel at a
        time, on the participants' sub-lists with the selection's
        weights, the reference's ``_train_round_sequential``). Returns
        the participants' accuracies, local steps and simulated times."""
        kw = dict(batch_size=self.fl.batch_size,
                  epochs=self.fl.local_epochs,
                  coverage_norm=self.fl.coverage_norm)
        participants = [int(i) for i in sel.participants]
        if self.engine is not None:
            # padding slots repeat slot 0's spec (weight 0, no steps)
            m = len(sel.idx)
            specs_pad = list(specs) + [specs[0]] * (m - len(specs))
            self.params, accs_pad, n_steps_pad = self.engine.run_fl_round(
                self.params, specs_pad, self.client_data, self.test_data,
                None, seeds=[self._client_seed(int(i)) for i in sel.idx],
                participation=sel, prefetch_hook=self._stage_next_round,
                **kw)
            accs = sel.take_valid(accs_pad)
            n_steps = [int(n) for n in sel.take_valid(n_steps_pad)]
        else:
            sizes = [float(w) for w, v in zip(sel.weights, sel.valid)
                     if v > 0]
            self.params, accs, n_steps = self._seq.run_fl_round(
                self.params, specs,
                [self.client_data[i] for i in participants],
                [self.test_data[i] for i in participants], sizes,
                seeds=[self._client_seed(i) for i in participants], **kw)
        return accs, n_steps, self._simulated_times(specs, n_steps,
                                                    participants)

    def _sync_clock_columns(self, times: Sequence[float]) -> Dict:
        """The scheduling columns of a sync round: staleness 0, the
        barrier wait per delta, the simulated clock (failure counts 0;
        the fault path overrides them)."""
        barrier = max(times) if times else 0.0
        self._sim_clock += barrier
        return {"staleness": 0.0,
                "aggregate_lag": float(np.mean([barrier - t
                                                for t in times]))
                if times else 0.0,
                "sim_clock": self._sim_clock,
                "mode": "sync",
                "dropped": 0, "retried": 0, "quarantined": 0,
                "quorum_waited_ms": barrier * 1e3}

    def global_accuracy(self, data: Dict) -> float:
        return self.family.evaluate(self.params, data)


class CFLServer(SyncServer):
    """The CFL control plane for either family (the paper's CNN or the
    transformer zoo — any family with the spec-space surface): each
    round's specs from the search (Alg. 1), the accuracy predictor's
    update after it (Alg. 2)."""

    HOST_PHASES = ("search", "predictor")

    def __init__(self, cfg, params, clients: List[ClientInfo],
                 client_data: List[Dict], test_data: List[Dict],
                 fl_cfg: CFLConfig, device=None):
        super().__init__(cfg, params, clients, client_data, test_data,
                         fl_cfg, device)
        self.predictor = AccuracyPredictor(self.family, seed=fl_cfg.seed,
                                           device=self.device)

    def cohort_specs(self, participants: Sequence[int]) -> List:
        """CFL's specs: the Alg. 1 search (``sample_submodels``)."""
        return self.sample_submodels(participants)

    def sample_submodels(self, client_ids: Optional[Sequence[int]] = None
                         ) -> List:
        """Alg. 1 + helper filtering; round 0 takes random feasible specs
        (the predictor is untrained). Per-client randomness is keyed by
        fleet id, as in the reference."""
        ids = list(range(len(self.clients))) if client_ids is None \
            else [int(i) for i in client_ids]
        cohort = [self.clients[i] for i in ids]
        if self.round_idx == 0:
            fallback = self.family.minimal_spec()
            specs = []
            for i, c in zip(ids, cohort):
                rng = random.Random(self.fl.seed * 131 + i)
                cand = [self.family.random_spec(rng) for _ in range(32)]
                feas = [s for s in cand
                        if self.latency.lookup(s, c.device) < c.latency_bound]
                # the minimal spec is the cheapest expressible submodel: if
                # it is infeasible nothing else is, and the timing model
                # shows the violation
                specs.append(feas[0] if feas else fallback)
            return specs
        return search_all_workers(
            self.family, self.predictor, self.latency,
            devices=[c.device for c in cohort],
            qualities=[c.quality for c in cohort],
            latency_bounds=[c.latency_bound for c in cohort],
            search_cfg=self.fl.search,
            seed=self.fl.seed + self.round_idx)

    def post_aggregate(self, specs, participants: Sequence[int],
                       accs: Sequence[float]) -> Dict:
        """The search-helper update (Alg. 2) over the deltas just
        aggregated — participants only: absentees reported nothing."""
        self.predictor.add_profiles(
            [(spec, self.clients[i].quality, acc)
             for spec, i, acc in zip(specs, participants, accs)])
        mae = self.predictor.train_round(epochs=4)
        return {"specs": [self.family.genes(s) for s in specs],
                "predictor_mae": mae}
