"""CFL server (Alg. 4) — the port of the reference's ``fl/server.py`` for
sync, full-participation rounds: submodel sampling -> local training ->
alignment + aggregation -> search-helper update, with per-round latency /
fairness accounting from the device profiles.

Each round:

* round 0 draws, per client, 32 random specs and keeps the first that is
  feasible under its latency bound in the LUT (the predictor is still
  untrained); later rounds run the genetic search (``core.search``),
  scored by the accuracy predictor;
* ``BatchedRoundEngine.run_fl_round`` trains and evaluates every client
  in parent coordinates and applies the aggregate
  (``batched_rounds=True``, the default), or ``SequentialFamilyTrainer``
  does it one extracted submodel at a time (``batched_rounds=False``);
* ``post_aggregate`` feeds the clients' accuracies to the predictor
  (Alg. 2) and the round is recorded with its fairness and simulated
  timing, and the host seconds of the search and of the round.

``CFLConfig`` keeps every field of the reference's. What is not ported
yet raises, naming its ROADMAP item: ``mode="async"``, ``faults`` (A13),
``overlap``, ``checkpoint_every`` (A14), ``cohort_shards > 1`` (A17) and
every selection policy but "full" (A12). ``elastic_kernels`` keeps its
meaning: False is the dense masked path; True / "auto" / "cuda" the hand
kernels (the batched engine's; the sequential trainer runs the plain
forward).

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
    if fl.mode != "sync":
        raise _not_ported(f"mode={fl.mode!r} (async rounds)", "A13")
    if fl.faults is not None:
        raise _not_ported("fault injection (faults=)", "A13")
    if fl.overlap:
        raise _not_ported("the double-buffered prefetch ring (overlap=)",
                          "A14")
    if fl.checkpoint_every:
        raise _not_ported("fleet checkpoints (checkpoint_every=)", "A14")
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
            rng_mode=fl_cfg.selection_rng)
        self.round_idx = 0
        self.history: List[Dict] = []
        self._sim_clock = 0.0
        self.engine, self._seq = round_engines(self.family, fl_cfg,
                                               self.device)

    # ------------------------------------------------------------------
    def set_selection(self, selection) -> None:
        """Swap the client-selection policy ('full' only, for now)."""
        self.tracker.set_policy(selection)

    def set_mode(self, mode: str) -> None:
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', "
                             f"got {mode!r}")
        if mode != "sync":
            raise _not_ported("async rounds", "A13")

    def set_overlap(self, overlap: bool) -> None:
        if overlap:
            raise _not_ported("the double-buffered prefetch ring", "A14")

    @property
    def runtime(self):
        """The reference's event-driven runtime of async rounds."""
        raise _not_ported("the event-driven runtime (async rounds)", "A13")

    def _predict_round_times(self) -> List[float]:
        return predict_full_round_times(
            self.family, self.clients, self.latency,
            batch_size=self.fl.batch_size, epochs=self.fl.local_epochs)

    def _client_seed(self, k: int) -> int:
        return self.fl.seed * 7 + self.round_idx * 131 + k

    def _simulated_times(self, specs, n_steps) -> List[float]:
        """Simulated wall clock per client: compute + update exchange."""
        times = []
        for client, spec, n in zip(self.clients, specs, n_steps):
            prof = self.latency.fleet[client.device]
            t = n * self.latency.lookup(spec, client.device) + \
                prof.comm_latency(2 * self.family.param_bytes(spec))
            times.append(float(t))
        return times

    def cohort_specs(self) -> List:
        raise NotImplementedError

    def post_aggregate(self, specs, participants: Sequence[int],
                       accs: Sequence[float]) -> Dict:
        return {}

    def run_round(self) -> Dict:
        t_round = time.perf_counter()
        if not self.tracker.is_full:
            raise _not_ported(f"partial participation (selection "
                              f"{self.tracker.policy.name!r})", "A12")
        sel = self.tracker.select(self.round_idx)
        participants = [int(i) for i in sel.participants]
        t0 = time.perf_counter()
        specs = self.cohort_specs()
        search_s = time.perf_counter() - t0
        accs, n_steps = self._train_round(specs)
        times = self._simulated_times(specs, n_steps)
        t0 = time.perf_counter()
        extras = self.post_aggregate(specs, participants, accs)
        host = {"search": search_s, "predictor": time.perf_counter() - t0}
        self.tracker.record(participants, accs)
        rec = {
            "round": self.round_idx,
            "participants": participants,
            "selection": self.tracker.policy.name,
            "accs": accs,
            "fairness": accuracy_fairness(accs),
            "timing": round_time_fairness(times),
            "n_steps": [int(n) for n in n_steps],
        }
        rec.update(extras)
        rec.update(self._sync_clock_columns(times))
        rec["host_seconds"] = {k: host[k] for k in self.HOST_PHASES}
        rec["host_seconds"]["round"] = time.perf_counter() - t_round
        self.history.append(rec)
        self.round_idx += 1
        return rec

    def _train_round(self, specs):
        """Every client's local train + eval, then the aggregate and the
        server step: on the batched engine (the whole cohort in parent
        coordinates) or on the sequential trainer (one extracted submodel
        at a time, the reference's ``_train_round_sequential``); both keep
        ``run_fl_round``'s contract and take the same seeds."""
        runner = self.engine if self.engine is not None else self._seq
        self.params, accs, n_steps = runner.run_fl_round(
            self.params, specs, self.client_data, self.test_data,
            [c.n_samples for c in self.clients],
            batch_size=self.fl.batch_size, epochs=self.fl.local_epochs,
            seeds=[self._client_seed(k) for k in range(len(self.clients))],
            coverage_norm=self.fl.coverage_norm)
        return accs, n_steps

    def _sync_clock_columns(self, times: Sequence[float]) -> Dict:
        """The scheduling columns of a sync round: staleness 0, the
        barrier wait per delta, the simulated clock."""
        barrier = max(times)
        self._sim_clock += barrier
        return {"staleness": 0.0,
                "aggregate_lag": float(np.mean([barrier - t
                                                for t in times])),
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

    def cohort_specs(self) -> List:
        return self.sample_submodels()

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
        """The search-helper update (Alg. 2) over the round's profiles."""
        self.predictor.add_profiles(
            [(spec, self.clients[i].quality, acc)
             for spec, i, acc in zip(specs, participants, accs)])
        mae = self.predictor.train_round(epochs=4)
        return {"specs": [self.family.genes(s) for s in specs],
                "predictor_mae": mae}
