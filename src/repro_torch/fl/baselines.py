"""The baselines the paper compares against (Table II) — the port of the
reference's ``fl/baselines.py``: standard FedAvg (one global model that
every client trains whole) and Independent Learning (IL: the same local
budget, no aggregation).

Both ride the CFL server's engines: the batched parent-space engine when
``fl_cfg.batched_rounds`` (every client's masks are the full spec's, so on
the kernel path K1 runs at full prefixes), the sequential trainer
otherwise. FedAvg runs what the port's ``CFLServer`` runs (it shares
its ``SyncServer``): every selection policy, partial participation, async
buffered rounds (``fl.runtime``), fault injection (``fl.faults``), the
prefetch ring (``SyncServer._stage_next_round`` stages FedAvg's next
cohort as it does CFL's), fleet checkpoints (``checkpoint.fleet``) and
cohort sharding (``cohort_shards``). IL has no rounds to subsample,
schedule, overlap or checkpoint: ``CFLSession`` rejects a non-full
selection, async, overlap and checkpoints for it; sharded, each rank keeps
its block of the clients' trained parameters across the rounds and only
the accuracies are gathered.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.elastic import family_for
from repro_torch.fl.client import ClientInfo
from repro_torch.fl.server import SyncServer, check_supported, round_engines
from repro_torch.kernels.backend import resolve_device


class FedAvgServer(SyncServer):
    """Standard FL [40]: every client trains the full parent model; the
    record is the CFL server's without the search's columns (``specs``,
    ``predictor_mae``), and its host seconds are the round's."""

    def cohort_specs(self, participants) -> List:
        return [self.family.full_spec()] * len(participants)


def independent_learning(cfg, init_params, clients: List[ClientInfo],
                         client_data: List[Dict], test_data: List[Dict], *,
                         rounds: int, fl_cfg, device=None) -> List[float]:
    """IL (Table II): every client trains the full model from
    ``init_params`` for ``rounds`` rounds of its local epochs, with no
    aggregation, then is evaluated on its own test set. Returns the
    accuracies.

    ``apply_server_update(p, ω_0 − ω_E) == ω_E``, so a round is 'keep
    training from where you left off': the batched path carries the
    client-stacked trained parameters from round to round (sharded: this
    rank's block of them; ``eval_cohort`` all-gathers the accuracies)."""
    check_supported(fl_cfg)
    family = family_for(cfg)
    spec = family.full_spec()
    engine, seq = round_engines(family, fl_cfg, resolve_device(device))
    if engine is not None:
        specs = [spec] * len(clients)
        thetas = engine.broadcast_params(init_params, len(clients))
        for r in range(rounds):
            seeds = [fl_cfg.seed + r * 31 + k for k in range(len(clients))]
            thetas = engine.train_cohort(
                thetas, specs, client_data, batch_size=fl_cfg.batch_size,
                epochs=fl_cfg.local_epochs, seeds=seeds).trained
        return [float(a) for a in engine.eval_cohort(thetas, specs,
                                                     test_data)]

    accs = []
    for k in range(len(clients)):
        p = init_params
        for r in range(rounds):
            # the full spec: extract is the identity, the trained
            # submodel is the parent
            _, p, _, _ = seq.client_update(
                p, spec, client_data[k], batch_size=fl_cfg.batch_size,
                epochs=fl_cfg.local_epochs, seed=fl_cfg.seed + r * 31 + k)
        accs.append(family.evaluate(p, test_data[k]))
    return accs
