"""FL fairness metrics — the port of the reference's ``core/fairness.py``
(numpy, unchanged): accuracy spread across clients and the round-time gap
between the fastest and the slowest worker (the paper's fairness
claims)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def accuracy_fairness(accs: Sequence[float]) -> Dict[str, float]:
    a = np.asarray(accs, np.float64)
    jain = float((a.sum() ** 2) / (len(a) * (a ** 2).sum() + 1e-12))
    k = max(1, len(a) // 10)
    return {
        "mean": float(a.mean()),
        "std": float(a.std()),
        "var": float(a.var()),
        "min": float(a.min()),
        "worst10pct": float(np.sort(a)[:k].mean()),
        "jain_index": jain,
    }


def round_time_fairness(times: Sequence[float]) -> Dict[str, float]:
    t = np.asarray(times, np.float64)
    return {
        "round_time": float(t.max()),         # barrier = slowest client
        "mean_time": float(t.mean()),
        "std_time": float(t.std()),
        "straggler_gap": float(t.max() - t.min()),
        "utilisation": float(t.mean() / (t.max() + 1e-12)),
    }
