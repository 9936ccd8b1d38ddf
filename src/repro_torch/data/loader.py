"""Epoch-shuffled batch iterators (host-side, numpy) — the port of the
reference's ``data/loader.py`` (``index_batches``, ``batches``,
``eval_batches``), unchanged: the same seeds give the same streams."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def index_batches(n: int, batch_size: int, *, seed: int = 0,
                  epochs: int = None,
                  drop_remainder: bool = True) -> Iterator[np.ndarray]:
    """Epoch-shuffled batch *indices*: the batched round engine keeps one
    resident copy of each client's data and gathers every step's batch
    with them."""
    rng = np.random.RandomState(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        perm = rng.permutation(n)
        end = n - (n % batch_size) if drop_remainder else n
        if end == 0:
            end = n
        for i in range(0, end, batch_size):
            yield perm[i:i + batch_size]
        epoch += 1


def batches(data: Dict[str, np.ndarray], batch_size: int, *,
            seed: int = 0, epochs: int = None,
            drop_remainder: bool = True) -> Iterator[Dict]:
    for idx in index_batches(len(data["y"]), batch_size, seed=seed,
                             epochs=epochs, drop_remainder=drop_remainder):
        yield {k: v[idx] for k, v in data.items()}


def eval_batches(data: Dict[str, np.ndarray],
                 batch_size: int) -> Iterator[Dict]:
    n = len(data["y"])
    for i in range(0, n, batch_size):
        yield {k: v[i:i + batch_size] for k, v in data.items()}
