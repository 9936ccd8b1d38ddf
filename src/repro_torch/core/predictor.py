"""Alg. 2 — the online-trained accuracy predictor — the port of the
reference's ``core/predictor.py``.

A four-layer MLP (as the paper states) mapping (submodel structure, data
quality) -> predicted test accuracy, trained online on the
(x_k = (q_k, ω_k^t), y_k = acc_k^t) profiles the clients upload each
round; training stops once the predictor converges (paper: "one or two
CFL rounds of samples suffice"). Structure features come from the
family's ``featurize``; the predictor appends the data-quality one-hot.

The network lives on the session's device (the card unless the caller
asks for the CPU), so each ``predict_batch`` — the search scores one
generation of candidates per call — costs one device round trip. Its
initial weights are torch-seeded (the reference draws them with
``jax.random``); ``load_numpy`` takes the reference's.
``state_snapshot`` / ``load_state`` carry its whole state through a fleet
checkpoint (``checkpoint.fleet``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.io import _to_device, _to_host
from repro_torch.core.elastic import family_for
from repro_torch.kernels.backend import resolve_device
from repro_torch.optim.optimizers import adamw, apply_updates

N_QUALITY_LEVELS = 5


def featurize(cfg, spec, quality: int) -> np.ndarray:
    """Structure + quality features; bounded [0,1]-ish. ``cfg`` may be any
    family config or a family."""
    fam = family_for(cfg)
    q = np.zeros(N_QUALITY_LEVELS, np.float32)
    q[int(quality)] = 1.0
    return np.concatenate([fam.featurize(spec), q]).astype(np.float32)


def feature_dim(cfg) -> int:
    return family_for(cfg).feature_dim + N_QUALITY_LEVELS


def _net(params, x):
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return torch.sigmoid(h[..., 0])


class AccuracyPredictor:
    """4-layer MLP, sigmoid head (accuracy in [0,1])."""

    def __init__(self, cfg, hidden: int = 64, lr: float = 3e-3,
                 seed: int = 0, converge_mae: float = 0.03, device=None):
        self.family = family_for(cfg)
        self.cfg = self.family.cfg
        self.device = resolve_device(device)
        dims = [feature_dim(self.family), hidden, hidden, hidden, 1]
        gen = torch.Generator().manual_seed(int(seed))
        self.opt = adamw(lr)
        self.load_numpy([
            {"w": (torch.randn((dims[i], dims[i + 1]), generator=gen)
                   / np.sqrt(dims[i])).numpy(),
             "b": np.zeros((dims[i + 1],), np.float32)}
            for i in range(4)])
        self.buffer_x: List[np.ndarray] = []
        self.buffer_y: List[float] = []
        self.converged = False
        self.converge_mae = converge_mae
        self.last_mae = float("inf")

    def load_numpy(self, params: Sequence[dict]) -> None:
        """Set the network's weights from a list of ``{"w", "b"}`` numpy
        arrays (the reference predictor's ``params``, bridged); the
        optimizer state starts afresh."""
        self.params = [{k: torch.tensor(np.asarray(v, np.float32),
                                        device=self.device)
                        for k, v in layer.items()} for layer in params]
        self.opt_state = self.opt.init(self.params)

    # -- fleet checkpoints (checkpoint.fleet) ------------------------------
    def state_snapshot(self) -> Dict:
        """The predictor's state as host data: the network and optimizer
        state (numpy, bit for bit), the profile buffer, the convergence
        latch."""
        return {"params": _to_host(self.params),
                "opt_state": _to_host(self.opt_state),
                "buffer_x": [np.array(x) for x in self.buffer_x],
                "buffer_y": list(self.buffer_y),
                "converged": bool(self.converged),
                "last_mae": float(self.last_mae)}

    def load_state(self, snap: Dict) -> None:
        """Inverse of :meth:`state_snapshot`; the tensors go back to the
        predictor's device."""
        self.params = _to_device(snap["params"], self.device)
        self.opt_state = _to_device(snap["opt_state"], self.device)
        self.buffer_x = [np.array(x) for x in snap["buffer_x"]]
        self.buffer_y = list(snap["buffer_y"])
        self.converged = bool(snap["converged"])
        self.last_mae = float(snap["last_mae"])

    # -- Alg. 2 ------------------------------------------------------------
    def add_profiles(self, samples: Sequence[Tuple]):
        """samples: (spec, quality_level, observed_accuracy)."""
        for spec, q, acc in samples:
            self.buffer_x.append(featurize(self.family, spec, q))
            self.buffer_y.append(float(acc))

    def train_round(self, epochs: int = 1):
        """``epochs`` full-batch steps over all collected profiles per FL
        round (Alg. 2); freezes itself once the MAE converges (paper
        §III-B1). Returns the MAE after the steps."""
        if self.converged or not self.buffer_x:
            return self.last_mae
        x = torch.as_tensor(np.stack(self.buffer_x), device=self.device)
        y = torch.as_tensor(np.asarray(self.buffer_y, np.float32),
                            device=self.device)
        for _ in range(epochs):
            params = [{k: v.detach().requires_grad_(True)
                       for k, v in layer.items()} for layer in self.params]
            loss = torch.mean(torch.square(_net(params, x) - y))
            flat = [t for layer in params for t in layer.values()]
            raw = iter(torch.autograd.grad(loss, flat))
            grads = [{k: next(raw) for k in layer} for layer in params]
            with torch.no_grad():
                upd, self.opt_state = self.opt.update(grads, self.opt_state,
                                                      self.params)
                self.params = apply_updates(self.params, upd)
        with torch.no_grad():
            pred = _net(self.params, x)
            self.last_mae = float(torch.mean(torch.abs(pred - y)))
        if self.last_mae < self.converge_mae and len(self.buffer_y) >= 16:
            self.converged = True
        return self.last_mae

    # -- Alg. 1's `f_t` ------------------------------------------------------
    def predict(self, spec, quality: int) -> float:
        return float(self.predict_batch([spec], quality)[0])

    def predict_batch(self, specs: Sequence, quality: int) -> np.ndarray:
        """Predicted accuracies (float32 numpy) of ``specs`` at
        ``quality``."""
        x = torch.as_tensor(np.stack([featurize(self.family, s, quality)
                                      for s in specs]), device=self.device)
        with torch.no_grad():
            return _net(self.params, x).cpu().numpy()
