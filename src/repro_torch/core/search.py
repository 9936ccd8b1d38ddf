"""Alg. 1 — genetic submodel search, latency-bounded, predictor-filtered
— the port of the reference's ``core/search.py`` (Python ``random``, the
same draws in the same order).

Submodels are generated by a genetic algorithm in the family's spec space
(the paper CNN's depth × width grid, the zoo's layer subsets and
widths), then filtered through the search helper = the online accuracy
predictor (Alg. 2) + the offline latency LUT. Per worker k it keeps the
submodel maximising the predicted accuracy subject to
``g(ω, p_k) < l_k``. Mutation, crossover and random sampling are the
family's spec-space surface.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Sequence

import numpy as np

from repro_torch.core.elastic import family_for
from repro_torch.core.latency import LatencyTable
from repro_torch.core.predictor import AccuracyPredictor


@dataclasses.dataclass
class SearchConfig:
    population: int = 24
    generations: int = 8         # the paper's S search iterations
    mutate_prob: float = 0.3
    crossover_prob: float = 0.5
    elite: int = 4


def search_submodel(cfg, predictor: AccuracyPredictor,
                    latency: LatencyTable, *, device: str, quality: int,
                    latency_bound: float,
                    search_cfg: SearchConfig = SearchConfig(),
                    seed: int = 0):
    """GA for one worker (Alg. 1 inner loop); ``cfg`` may be any family
    config or a family. Each generation's feasible candidates are scored
    by one ``predictor.predict_batch`` call and ranked by
    ``np.argsort(-accs)``, as in the reference."""
    fam = family_for(cfg)
    rng = random.Random(seed)
    pop = [fam.random_spec(rng) for _ in range(search_cfg.population)]
    best = None
    best_acc = -1.0

    for _ in range(search_cfg.generations):
        feasible = [s for s in pop
                    if latency.lookup(s, device) < latency_bound]
        if feasible:
            accs = predictor.predict_batch(feasible, quality)
            order = np.argsort(-accs)
            if accs[order[0]] > best_acc:
                best_acc = float(accs[order[0]])
                best = feasible[order[0]]
            elites = [feasible[i] for i in order[:search_cfg.elite]]
        else:
            elites = []
        nxt = list(elites)
        while len(nxt) < search_cfg.population:
            if elites and rng.random() < search_cfg.crossover_prob:
                child = fam.crossover(rng.choice(elites), rng.choice(pop),
                                      rng)
            else:
                child = fam.random_spec(rng)
            nxt.append(fam.mutate(child, rng, search_cfg.mutate_prob))
        pop = nxt

    if best is None:
        # nothing feasible: fall back to the smallest submodel
        best = fam.minimal_spec()
    return best


def search_all_workers(cfg, predictor: AccuracyPredictor,
                       latency: LatencyTable, *, devices: Sequence[str],
                       qualities: Sequence[int],
                       latency_bounds: Sequence[float],
                       search_cfg: SearchConfig = SearchConfig(),
                       seed: int = 0) -> List:
    """Alg. 1 outer loop: one submodel per worker."""
    fam = family_for(cfg)
    return [search_submodel(fam, predictor, latency, device=d, quality=q,
                            latency_bound=lb, search_cfg=search_cfg,
                            seed=seed * 977 + k)
            for k, (d, q, lb) in enumerate(zip(devices, qualities,
                                               latency_bounds))]
