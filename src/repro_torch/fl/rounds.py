"""Experiment set-up: the heterogeneous FL population (devices × quality ×
distribution) and the experiment drivers — the port of the reference's
``fl/rounds.py``: ``build_population`` for the image scenario (the
paper's CIFAR / MNIST stand-ins: quality = blur / sharpen levels,
distribution = non-IID labels) and the zoo's synthetic Markov-LM scenario
(quality = token-corruption levels, distribution = one Markov chain per
client), and ``run_cfl`` / ``run_fedavg`` / ``run_il``, thin shims over
``CFLSession``. The population's data is numpy, bit-equal to the
reference's on the same seeds.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.elastic import family_for
from repro_torch.core.latency import fleet_for_workers, train_step_latency
from repro_torch.data.partition import (iid_partition, noniid_partition,
                                        subset)
from repro_torch.data.quality import apply_quality, apply_token_quality
from repro_torch.data.synth import (make_dataset, make_lm_dataset,
                                    train_test_split)
from repro_torch.fl.client import ClientInfo
from repro_torch.fl.server import CFLConfig


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


def _lm_population(family, n_workers: int, n_samples: int,
                   heterogeneity: str, seed: int):
    """Markov-LM heterogeneous population: distribution heterogeneity =
    one Markov chain per client (vs a shared chain), quality = token
    corruption levels (``data.quality.apply_token_quality``); sequences
    of ``family.seq_len`` tokens."""
    cfg = family.cfg
    seq_len = getattr(family, "seq_len", 32)
    vocab = cfg.vocab_size
    rng = np.random.RandomState(seed)
    n_tr = max(8, n_samples // n_workers)
    n_te = max(8, n_tr // 4)
    cdata, tdata, quals = [], [], []
    for k in range(n_workers):
        chain = seed * 31 + (k if heterogeneity in ("distribution", "both")
                             else 0)
        ctr = make_lm_dataset(n_tr, seq_len, vocab, seed=seed * 7 + 2 * k,
                              chain_seed=chain)
        cte = make_lm_dataset(n_te, seq_len, vocab,
                              seed=seed * 7 + 2 * k + 1, chain_seed=chain)
        q = 0
        if heterogeneity in ("quality", "both"):
            q = int(rng.randint(0, 5))
            ctr = dict(ctr, x=apply_token_quality(ctr["x"], q, vocab,
                                                  seed=seed + k))
            cte = dict(cte, x=apply_token_quality(cte["x"], q, vocab,
                                                  seed=seed + 100 + k))
        cdata.append(ctr)
        tdata.append(cte)
        quals.append(q)
    return cdata, tdata, quals


def build_population(cfg, *, kind: Optional[str] = None, n_workers: int,
                     n_samples: int, heterogeneity: str, seed: int = 0,
                     latency_bound_frac: float = 1.05
                     ) -> Tuple[List[ClientInfo], List[Dict], List[Dict]]:
    """heterogeneity: 'quality' | 'distribution' | 'both' | 'none'.

    ``cfg``: any family config or a family. ``kind``: an image kind
    ('synthmnist', 'synthcifar'), 'synthlm', or None for the family's
    default ('synthlm' for the transformer family, 'synthmnist' for the
    CNN). Each client's latency budget is ``l_k = frac * min(own,
    fleet-median)`` full-model step latency: weak devices get tight
    bounds, and frac > 1 lets devices at or below the median train the
    full model."""
    family = family_for(cfg)
    if kind is None:
        kind = "synthlm" if family.name == "transformer" else "synthmnist"
    if kind == "synthlm":
        cdata, tdata, quals = _lm_population(
            family, n_workers, n_samples, heterogeneity, seed)
    else:
        cdata, tdata, quals = _image_population(
            kind, n_workers, n_samples, heterogeneity, seed)

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


# ---------------------------------------------------------------------------
# experiment drivers (thin shims over CFLSession)
# ---------------------------------------------------------------------------
def _session(cfg, algorithm, *, kind, n_workers, n_samples, heterogeneity,
             fl_cfg, seed, cohort_shards, device):
    from repro_torch.fl.session import CFLSession
    return CFLSession.from_synthetic(
        cfg, kind=kind, n_workers=n_workers, n_samples=n_samples,
        heterogeneity=heterogeneity, fl_cfg=fl_cfg, algorithm=algorithm,
        seed=seed, cohort_shards=cohort_shards, device=device)


def run_cfl(cfg, *, kind=None, n_workers=8, n_samples=4000,
            heterogeneity="quality", rounds=5,
            fl_cfg: Optional[CFLConfig] = None, seed=0,
            cohort_shards: int = 1, device=None):
    """``rounds`` CFL rounds on the synthetic population; returns the
    server (``history``, ``params``)."""
    sess = _session(cfg, "cfl", kind=kind, n_workers=n_workers,
                    n_samples=n_samples, heterogeneity=heterogeneity,
                    fl_cfg=fl_cfg, seed=seed, cohort_shards=cohort_shards,
                    device=device)
    sess.run(rounds)
    return sess.server


def run_fedavg(cfg, *, kind=None, n_workers=8, n_samples=4000,
               heterogeneity="quality", rounds=5,
               fl_cfg: Optional[CFLConfig] = None, seed=0,
               cohort_shards: int = 1, device=None):
    """``rounds`` FedAvg rounds on the synthetic population; returns the
    server."""
    sess = _session(cfg, "fedavg", kind=kind, n_workers=n_workers,
                    n_samples=n_samples, heterogeneity=heterogeneity,
                    fl_cfg=fl_cfg, seed=seed, cohort_shards=cohort_shards,
                    device=device)
    sess.run(rounds)
    return sess.server


def run_il(cfg, *, kind=None, n_workers=8, n_samples=4000,
           heterogeneity="quality", rounds=5,
           fl_cfg: Optional[CFLConfig] = None, seed=0,
           cohort_shards: int = 1, device=None) -> List[float]:
    """IL with ``rounds`` rounds' local budget on the synthetic
    population; returns the clients' accuracies."""
    sess = _session(cfg, "il", kind=kind, n_workers=n_workers,
                    n_samples=n_samples, heterogeneity=heterogeneity,
                    fl_cfg=fl_cfg, seed=seed, cohort_shards=cohort_shards,
                    device=device)
    sess.run(rounds)
    return sess.il_accs
