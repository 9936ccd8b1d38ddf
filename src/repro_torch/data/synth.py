"""Synthetic data for the CFL engine — the port of the reference's
``data/synth.py``.

``make_lm_dataset`` and ``train_test_split`` are unchanged: numpy draws,
so the same seeds give the same data. ``make_dataset`` (the CIFAR-10 /
MNIST stand-ins: class-structured images) draws with a seeded
``torch.Generator`` where the reference draws with ``jax.random``: the same
shapes, value range and class structure, other pixels (tests that compare
the two frameworks bridge the reference's arrays).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGE_KINDS = {"synthcifar": (32, 3), "synthmnist": (28, 1)}


def _smooth_fields(gen, n, h, w, c, cutoff=4):
    """n low-frequency random images (n, h, w, c) in [0, 1]: a coarse
    normal field upsampled bicubically, min-max normalised per image."""
    coarse = torch.randn((n, c, cutoff, cutoff), generator=gen)
    img = F.interpolate(coarse, size=(h, w), mode="bicubic",
                        align_corners=False).permute(0, 2, 3, 1)
    lo = img.amin((1, 2, 3), keepdim=True)
    hi = img.amax((1, 2, 3), keepdim=True)
    return (img - lo) / (hi - lo + 1e-8)


def make_dataset(kind: str, n: int, seed: int = 0,
                 n_classes: int = 10) -> Dict[str, np.ndarray]:
    """kind: 'synthcifar' (32x32x3) | 'synthmnist' (28x28x1). Each class is
    a smooth random template; a sample is 0.75 · its class template +
    0.25 · a smooth per-sample deformation + N(0, 0.08²) pixel noise,
    clipped to [0, 1]. ``x`` (n, h, w, c) float32, ``y`` (n,) int32."""
    if kind not in IMAGE_KINDS:
        raise ValueError(kind)
    h, c = IMAGE_KINDS[kind]
    gen = torch.Generator().manual_seed(int(seed))
    templates = _smooth_fields(gen, n_classes, h, h, c)
    y = torch.randint(0, n_classes, (n,), generator=gen)
    deform = _smooth_fields(gen, n, h, h, c, cutoff=3)
    noise = 0.08 * torch.randn((n, h, h, c), generator=gen)
    x = torch.clamp(0.75 * templates[y] + 0.25 * deform + noise, 0.0, 1.0)
    return {"x": x.numpy().astype(np.float32),
            "y": y.numpy().astype(np.int32)}


def train_test_split(data: Dict[str, np.ndarray], test_frac: float = 0.2,
                     seed: int = 0) -> Tuple[Dict, Dict]:
    n = len(data["y"])
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    k = int(n * (1 - test_frac))
    tr, te = perm[:k], perm[k:]
    return ({"x": data["x"][tr], "y": data["y"][tr]},
            {"x": data["x"][te], "y": data["y"][te]})


def make_lm_dataset(n: int, seq_len: int, vocab: int, seed: int = 0,
                    chain_seed: int = None) -> Dict[str, np.ndarray]:
    """A sparse Markov chain over the vocab (each token has 4 learnable
    successors), so next-token prediction is learnable by a small LM while
    staying offline. ``x`` (N, S) int32 token rows; ``y`` (N,) is a dummy
    label column (causal-LM targets come from the tokens themselves).

    ``chain_seed`` decouples the chain (the *distribution*) from the
    sampling seed, so an FL population can share one chain across clients
    (IID) or draw one chain per client (distribution heterogeneity).
    """
    rng = np.random.RandomState(seed)
    crng = rng if chain_seed is None else np.random.RandomState(chain_seed)
    nexts = crng.randint(0, vocab, size=(vocab, 4))
    toks = np.zeros((n, seq_len), np.int32)
    state = rng.randint(0, vocab, size=n)
    for t in range(seq_len):
        toks[:, t] = state
        state = nexts[state, rng.randint(0, 4, size=n)]
    return {"x": toks, "y": np.zeros((n,), np.int32)}
