"""Data-quality heterogeneity transforms (paper §IV-A) — the port of the
reference's ``data/quality.py`` (numpy, unchanged: the same inputs give
the same bits).

Five quality levels: level 0 = unprocessed, levels 1-3 = Gaussian blur
with increasing variance, level 4 = sharpened (unsharp mask). Applied
per subset to emulate mixed-quality edge data. Token data (the zoo's LM
scenario) has its own levels: a growing fraction of tokens replaced by
uniform vocab draws (``apply_token_quality``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

N_LEVELS = 5
BLUR_SIGMAS = {1: 0.6, 2: 1.2, 3: 2.0}
SHARPEN_AMOUNT = 1.5


def _gauss_kernel(sigma: float, radius: int = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(3 * sigma))
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: np.ndarray, sigma: float) -> np.ndarray:
    """x: (N,H,W,C) in [0,1]; separable blur, reflect padding."""
    k = _gauss_kernel(sigma)
    r = len(k) // 2
    # height axis
    xp = np.pad(x, ((0, 0), (r, r), (0, 0), (0, 0)), mode="reflect")
    out = np.zeros_like(x)
    for i, kv in enumerate(k):
        out += kv * xp[:, i:i + x.shape[1], :, :]
    # width axis
    xp = np.pad(out, ((0, 0), (0, 0), (r, r), (0, 0)), mode="reflect")
    out2 = np.zeros_like(x)
    for i, kv in enumerate(k):
        out2 += kv * xp[:, :, i:i + x.shape[2], :]
    return out2


def sharpen(x: np.ndarray, amount: float = SHARPEN_AMOUNT) -> np.ndarray:
    """Unsharp mask: x + amount * (x - blur(x))."""
    return np.clip(x + amount * (x - gaussian_blur(x, 1.0)), 0.0, 1.0)


def apply_quality(x: np.ndarray, level: int) -> np.ndarray:
    if level == 0:
        return x
    if level in BLUR_SIGMAS:
        return gaussian_blur(x, BLUR_SIGMAS[level])
    if level == 4:
        return sharpen(x)
    raise ValueError(f"quality level {level}")


TOKEN_NOISE_FRACS = {0: 0.0, 1: 0.05, 2: 0.10, 3: 0.15, 4: 0.20}


def apply_token_quality(tokens: np.ndarray, level: int, vocab: int,
                        seed: int = 0) -> np.ndarray:
    """LM analogue of ``apply_quality``: level-l data has a fraction of its
    tokens replaced with uniform-random vocab draws (corrupted edge text).
    Level 0 = clean; deterministic given ``seed``."""
    frac = TOKEN_NOISE_FRACS[int(level)]
    if frac == 0.0:
        return tokens
    rng = np.random.RandomState(seed)
    out = tokens.copy()
    mask = rng.random_sample(tokens.shape) < frac
    out[mask] = rng.randint(0, vocab, size=int(mask.sum()))
    return out


def mixed_quality_dataset(data: Dict[str, np.ndarray],
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """IID-split into 5 groups, one quality level each, re-mixed
    (paper §IV-A 'mixed-quality datasets'). Adds a per-sample 'q' field."""
    n = len(data["y"])
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    x = data["x"].copy()
    q = np.zeros(n, np.int32)
    for lvl, idx in enumerate(np.array_split(perm, N_LEVELS)):
        x[idx] = apply_quality(data["x"][idx], lvl)
        q[idx] = lvl
    return {"x": x, "y": data["y"].copy(), "q": q}
