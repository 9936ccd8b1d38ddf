"""CFLSession — the CFL control plane's single entry point, the port of
the reference's ``fl/session.py`` for ``algorithm="cfl"``.

One API runs the paper's system (Alg. 1–4): the genetic submodel search
bounded by the per-device latency LUT (Alg. 1), the online accuracy
predictor (Alg. 2), and coverage-aware alignment / aggregation
(Alg. 3–4) — family + fleet + data in, per-round history with fairness
and latency accounting out:

    sess = CFLSession.from_synthetic(PAPER_CNN, kind="synthcifar",
                                     n_workers=8, heterogeneity="quality",
                                     fl_cfg=CFLConfig(elastic_kernels=True))
    sess.run(rounds=3)
    sess.fairness()                  # last-round accuracy fairness

``algorithm`` selects CFL (the default) or the paper's comparison
baselines, ``"fedavg"`` and ``"il"`` (``fl.baselines``), under the same
budget and fleet, so every Table II experiment is the same three lines.
IL is single-shot: one ``run(rounds)`` trains every client's local budget
and records one history entry.

Fault tolerance: ``save_checkpoint`` / ``restore_checkpoint`` (and
``CFLConfig.checkpoint_every``'s autosave into ``checkpoint_dir``) write
and load a fleet checkpoint (``checkpoint.fleet``) from which a fresh,
same-config session resumes bit for bit. ``run(overlap=True)`` turns the
engine's prefetch ring on. ``serving()`` hands the trained parent to the
elastic serving subsystem (``serving.EdgeServer``).

It runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from repro_torch.core.elastic import family_for
from repro_torch.core.fairness import accuracy_fairness
from repro_torch.fl.baselines import FedAvgServer, independent_learning
from repro_torch.fl.client import ClientInfo
from repro_torch.fl.selection import FullParticipation, resolve_policy
from repro_torch.fl.server import CFLConfig, CFLServer

ALGORITHMS = ("cfl", "fedavg", "il")


def _reject_il_selection(selection) -> None:
    """IL has no rounds or aggregation to subsample."""
    if not isinstance(resolve_policy(selection), FullParticipation):
        raise ValueError(
            "IL has no rounds/aggregation to subsample — selection only "
            "applies to cfl/fedavg (use selection='full' for IL)")


class CFLSession:
    """Family + fleet + data in; history / fairness out.

    ``cfg``: a ``CNNConfig``, a zoo ``ModelConfig`` or their family;
    per-client ``ClientInfo`` with matching train / test data dicts
    (numpy ``x``, ``y``); optionally a
    ``CFLConfig``, initial parent ``params`` (tensors on ``device``) and
    the ``algorithm``. ``run(rounds)`` returns the per-round ``history``;
    ``fairness()`` summarises the last round; ``params`` is the
    aggregated parent (cfl / fedavg; IL keeps per-client models and
    records ``il_accs``)."""

    def __init__(self, cfg, clients: List[ClientInfo],
                 client_data: List[Dict], test_data: List[Dict],
                 fl_cfg: Optional[CFLConfig] = None, *,
                 params=None, algorithm: str = "cfl", device=None):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}, "
                             f"got {algorithm!r}")
        self.family = family_for(cfg)
        self.fl = fl_cfg if fl_cfg is not None else \
            CFLConfig(n_workers=len(clients))
        if algorithm == "il":
            _reject_il_selection(self.fl.selection)
        self.algorithm = algorithm
        self.clients = clients
        self.client_data = client_data
        self.test_data = test_data
        self.device = device
        if params is None:
            params = self.family.init_params(seed=self.fl.seed,
                                             device=device)
        self._init_params = params
        self._il_history: List[Dict] = []
        self.il_accs: Optional[List[float]] = None
        if algorithm == "il":           # no server, no aggregation
            self.server = None
        else:
            server = CFLServer if algorithm == "cfl" else FedAvgServer
            self.server = server(self.family, params, clients, client_data,
                                 test_data, self.fl, device=device)

    @classmethod
    def from_synthetic(cls, cfg, *, kind: Optional[str] = None,
                       n_workers: int = 8, n_samples: int = 4000,
                       heterogeneity: str = "quality",
                       fl_cfg: Optional[CFLConfig] = None,
                       algorithm: str = "cfl", seed: int = 0,
                       cohort_shards: int = 1, selection=None,
                       device=None) -> "CFLSession":
        """Build the paper's synthetic heterogeneous population (devices ×
        quality × distribution) and wrap it in a session; the parent's
        initial parameters are keyed by the population ``seed``.
        ``cohort_shards`` splits the batched engine's cohort over that many
        ranks of the process group (``sharding.cohort``: run the same
        session on every rank, e.g. under ``torchrun`` after
        ``init_cohort_group()``)."""
        from repro_torch.fl.rounds import build_population
        if fl_cfg is None:
            fl_cfg = CFLConfig(n_workers=n_workers, seed=seed,
                               cohort_shards=cohort_shards)
        elif cohort_shards != 1:
            fl_cfg = dataclasses.replace(fl_cfg,
                                         cohort_shards=cohort_shards)
        if selection is not None:
            fl_cfg = dataclasses.replace(fl_cfg, selection=selection)
        family = family_for(cfg)
        clients, cdata, tdata = build_population(
            family, kind=kind, n_workers=n_workers, n_samples=n_samples,
            heterogeneity=heterogeneity, seed=seed,
            latency_bound_frac=fl_cfg.latency_bound_frac)
        params = family.init_params(seed=seed, device=device)
        return cls(family, clients, cdata, tdata, fl_cfg, params=params,
                   algorithm=algorithm, device=device)

    def run(self, rounds: int, selection=None, mode: Optional[str] = None,
            overlap: Optional[bool] = None) -> List[Dict]:
        """Run ``rounds`` rounds (async: server steps) and return the
        history; each entry carries ``accs`` / ``fairness`` / ``timing`` /
        ``participants`` / ``selection`` / ``n_steps``, the scheduling
        columns (``staleness``, ``aggregate_lag``, ``sim_clock``,
        ``mode``, ``dropped``, ``retried``, ``quarantined``,
        ``quorum_waited_ms``; async also ``buffered``) and
        ``host_seconds`` (cfl also ``specs`` and ``predictor_mae``).
        ``selection`` ('full' | 'uniform' | 'fairness' | 'latency' or a
        ``fl.selection.SelectionPolicy``) and ``mode`` ('sync' | 'async')
        set the policy and the scheduling for these and later rounds;
        ``overlap`` turns the engine's prefetch ring on or off (a host
        pipelining knob: the results are the same either way). With
        ``CFLConfig.checkpoint_every`` N, every N-th applied server step
        writes ``checkpoint_dir/round_NNNNNN.ckpt``.

        IL runs the same local budget with no aggregation, recorded as one
        history entry (``round``, ``accs``, ``fairness``); it rejects a
        non-full selection, a non-sync mode, overlap, checkpoints and a
        second ``run``."""
        if self.algorithm == "il":
            return self._run_il(rounds, selection, mode, overlap)
        if mode is not None:
            self.server.set_mode(mode)
        if selection is not None:
            self.server.set_selection(selection)
        if overlap is not None:
            self.server.set_overlap(overlap)
        every = self.fl.checkpoint_every
        for _ in range(rounds):
            self.server.run_round()
            if every and self.server.round_idx % every == 0:
                self.save_checkpoint(self._checkpoint_path())
        return self.history

    def _run_il(self, rounds: int, selection, mode, overlap) -> List[Dict]:
        if mode is not None and mode != "sync":
            raise ValueError("IL has no rounds to schedule — mode only "
                             "applies to cfl/fedavg")
        if selection is not None:
            _reject_il_selection(selection)
        if overlap is not None:
            raise ValueError("IL has no round pipeline to overlap — overlap "
                             "only applies to cfl/fedavg")
        if self.fl.checkpoint_every:
            raise ValueError("IL is single-shot — there is no round "
                             "boundary to checkpoint at")
        if self._il_history:
            # IL trains each client from the initial parent for the whole
            # budget in one shot: a second run would restart from scratch
            raise RuntimeError(
                "an IL session is single-shot: run(rounds) consumes the "
                "whole local budget; build a new session (or use "
                "algorithm='cfl'/'fedavg') to train further")
        accs = independent_learning(
            self.family, self._init_params, self.clients, self.client_data,
            self.test_data, rounds=rounds, fl_cfg=self.fl,
            device=self.device)
        self.il_accs = accs
        self._il_history.append({"round": 0, "accs": accs,
                                 "fairness": accuracy_fairness(accs)})
        return self.history

    # -- fault tolerance: round-granular checkpoint / resume --------------
    def _checkpoint_path(self) -> str:
        return os.path.join(self.fl.checkpoint_dir,
                            f"round_{self.server.round_idx:06d}.ckpt")

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """Snapshot the fleet's whole state (parameters, round counter,
        history, fleet columns, predictor, the async runtime's event heap,
        in-flight groups and retry ladder, the prefetch ring's derivation)
        so that a killed process resumes bit for bit. Returns the path
        written (default ``checkpoint_dir/round_NNNNNN.ckpt``)."""
        if self.server is None:
            raise RuntimeError("IL keeps no resumable fleet state")
        from repro_torch.checkpoint.fleet import save_fleet_checkpoint
        path = path if path is not None else self._checkpoint_path()
        save_fleet_checkpoint(path, self.server,
                              metadata={"algorithm": self.algorithm})
        return path

    def restore_checkpoint(self, path: str) -> Dict:
        """Load a checkpoint of :meth:`save_checkpoint` into this freshly
        built, same-config session and continue from its round. Returns
        the restore's info dict: ``resharded`` True flags the degraded
        reshard-and-rewind path (in-flight work dropped)."""
        if self.server is None:
            raise RuntimeError("IL keeps no resumable fleet state")
        from repro_torch.checkpoint.fleet import restore_fleet_checkpoint
        return restore_fleet_checkpoint(path, self.server)

    @property
    def history(self) -> List[Dict]:
        return self._il_history if self.server is None \
            else self.server.history

    @property
    def params(self):
        """The aggregated parent parameters (cfl / fedavg). IL keeps
        per-client models and aggregates nothing."""
        if self.server is None:
            raise RuntimeError(
                "IL trains per-client models only — there is no "
                "aggregated parent; use il_accs / history for its results")
        return self.server.params

    def fairness(self) -> Dict[str, float]:
        """Last-round accuracy-fairness summary (mean/std/min/Jain)."""
        if not self.history:
            raise RuntimeError("no rounds run yet")
        return self.history[-1]["fairness"]

    def global_accuracy(self, data: Dict) -> float:
        return self.family.evaluate(self.params, data)

    def serving(self, **kwargs):
        """Hand the trained parent to the elastic serving subsystem: a
        ``serving.EdgeServer`` over this session's family and aggregated
        parameters, on the session's device unless ``device=`` says
        otherwise (the other keywords — ``slots``, ``prompt_len``,
        ``max_new_tokens``, ``backend``, ... — go to it as they are).
        Token-decode families only."""
        from repro_torch.serving.server import EdgeServer
        kwargs.setdefault("device", self.device)
        return EdgeServer(self.family, self.params, **kwargs)
