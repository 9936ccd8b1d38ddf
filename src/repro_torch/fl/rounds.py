"""Experiment set-up: the heterogeneous FL population (devices × quality ×
distribution) — the port of the reference's
``fl/rounds.py::build_population`` for the image scenario (the paper's
CIFAR / MNIST stand-ins: quality = blur / sharpen levels, distribution =
non-IID labels).

The synthetic Markov-LM population of the transformer zoo comes with that
family's search surface (ROADMAP A6); the ``run_cfl`` / ``run_fedavg`` /
``run_il`` drivers with the baselines (ROADMAP A20).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.elastic import family_for
from repro_torch.core.latency import fleet_for_workers, train_step_latency
from repro_torch.data.partition import (iid_partition, noniid_partition,
                                        subset)
from repro_torch.data.quality import apply_quality
from repro_torch.data.synth import make_dataset, train_test_split
from repro_torch.fl.client import ClientInfo


def _image_population(kind: str, n_workers: int, n_samples: int,
                      heterogeneity: str, seed: int):
    raw = make_dataset(kind, n_samples, seed=seed)
    train, test = train_test_split(raw, 0.25, seed)
    rng = np.random.RandomState(seed)

    if heterogeneity in ("distribution", "both"):
        parts = noniid_partition(train["y"], n_workers, 0.8, seed)
        test_parts = noniid_partition(test["y"], n_workers, 0.8, seed + 1)
    else:
        parts = iid_partition(len(train["y"]), n_workers, seed)
        test_parts = iid_partition(len(test["y"]), n_workers, seed + 1)

    cdata, tdata, quals = [], [], []
    for k in range(n_workers):
        ctr = subset(train, parts[k])
        cte = subset(test, test_parts[k])
        q = 0
        if heterogeneity in ("quality", "both"):
            q = int(rng.randint(0, 5))
            ctr = dict(ctr, x=apply_quality(ctr["x"], q))
            cte = dict(cte, x=apply_quality(cte["x"], q))
        cdata.append(ctr)
        tdata.append(cte)
        quals.append(q)
    return cdata, tdata, quals


def build_population(cfg, *, kind: Optional[str] = None, n_workers: int,
                     n_samples: int, heterogeneity: str, seed: int = 0,
                     latency_bound_frac: float = 1.05
                     ) -> Tuple[List[ClientInfo], List[Dict], List[Dict]]:
    """heterogeneity: 'quality' | 'distribution' | 'both' | 'none'.

    ``kind``: 'synthmnist' (the default) or 'synthcifar'. Each client's
    latency budget is ``l_k = frac * min(own, fleet-median)`` full-model
    step latency: weak devices get tight bounds, and frac > 1 lets devices
    at or below the median train the full model."""
    family = family_for(cfg)
    if family.name != "cnn" or kind == "synthlm":
        raise NotImplementedError(
            "the Markov-LM population of the transformer zoo is not ported "
            "yet (ROADMAP A6: the transformer family's search surface)")
    cdata, tdata, quals = _image_population(
        kind or "synthmnist", n_workers, n_samples, heterogeneity, seed)

    fleet = fleet_for_workers(n_workers)
    full = family.full_spec()
    full_lats = {p.name: train_step_latency(family, full, p)
                 for p in set(fleet)}
    med = float(np.median([full_lats[p.name] for p in fleet]))
    clients = []
    for k in range(n_workers):
        prof = fleet[k]
        bound = float(min(full_lats[prof.name], med) * latency_bound_frac)
        clients.append(ClientInfo(cid=k, device=prof.name, quality=quals[k],
                                  n_samples=len(cdata[k]["y"]),
                                  latency_bound=bound))
    return clients, cdata, tdata
