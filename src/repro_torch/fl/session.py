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

It runs on the card unless the caller passes ``device="cpu"``. The
comparison baselines ``"fedavg"`` and ``"il"`` are not ported yet
(ROADMAP A20) and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.elastic import family_for
from repro_torch.fl.client import ClientInfo
from repro_torch.fl.server import CFLConfig, CFLServer

ALGORITHMS = ("cfl", "fedavg", "il")


class CFLSession:
    """Family + fleet + data in; history / fairness out.

    ``cfg``: a ``CNNConfig`` or its family; per-client ``ClientInfo`` with
    matching train / test data dicts (numpy ``x``, ``y``); optionally a
    ``CFLConfig``, initial parent ``params`` (tensors on ``device``) and
    the ``algorithm``. ``run(rounds)`` returns the per-round ``history``;
    ``fairness()`` summarises the last round; ``params`` is the
    aggregated parent."""

    def __init__(self, cfg, clients: List[ClientInfo],
                 client_data: List[Dict], test_data: List[Dict],
                 fl_cfg: Optional[CFLConfig] = None, *,
                 params=None, algorithm: str = "cfl", device=None):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"algorithm must be one of {ALGORITHMS}, "
                             f"got {algorithm!r}")
        if algorithm != "cfl":
            raise NotImplementedError(
                f"algorithm={algorithm!r} (the paper's comparison "
                "baselines, fl/baselines.py) is not ported yet (ROADMAP "
                "A20)")
        self.family = family_for(cfg)
        self.fl = fl_cfg if fl_cfg is not None else \
            CFLConfig(n_workers=len(clients))
        self.algorithm = algorithm
        self.clients = clients
        self.client_data = client_data
        self.test_data = test_data
        if params is None:
            params = self.family.init_params(seed=self.fl.seed,
                                             device=device)
        self.server = CFLServer(self.family, params, clients, client_data,
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
        initial parameters are keyed by the population ``seed``."""
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
        """Run ``rounds`` sync CFL rounds and return the history; each
        entry carries ``accs`` / ``fairness`` / ``timing`` /
        ``participants`` / ``specs`` / ``predictor_mae``, the scheduling
        columns and ``host_seconds``. ``selection`` / ``mode`` /
        ``overlap`` set the policy, the scheduling and the prefetch ring
        for these and later rounds ('full', 'sync' and off are what the
        port runs)."""
        if mode is not None:
            self.server.set_mode(mode)
        if selection is not None:
            self.server.set_selection(selection)
        if overlap is not None:
            self.server.set_overlap(overlap)
        for _ in range(rounds):
            self.server.run_round()
        return self.history

    @property
    def history(self) -> List[Dict]:
        return self.server.history

    @property
    def params(self):
        """The aggregated parent parameters."""
        return self.server.params

    def fairness(self) -> Dict[str, float]:
        """Last-round accuracy-fairness summary (mean/std/min/Jain)."""
        if not self.history:
            raise RuntimeError("no rounds run yet")
        return self.history[-1]["fairness"]

    def global_accuracy(self, data: Dict) -> float:
        return self.family.evaluate(self.params, data)
