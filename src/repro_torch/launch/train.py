"""LM training driver (reduced configs end to end), the port of the
reference's ``launch/train.py``. Runs on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --steps 200 --batch 8 --seq 256

It trains the dense path in bf16 activations, as the reference does
(``launch.steps.make_train_step`` takes a kernel table, in fp32).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import tree_leaves


def synthetic_lm_batches(cfg, batch: int, seq: int, seed: int = 0,
                         device=None) -> Iterator[Dict]:
    """Deterministic synthetic language: a noisy order-2 Markov chain over
    the vocab (loss should drop well below uniform log V), drawn from a
    numpy ``RandomState`` exactly as the reference draws it; tensors on
    ``device`` (the card unless the caller asks for the CPU). A vision
    frontend's batches carry zero ``image_embeds``; an audio frontend's
    are random ``frames`` with the tokens as ``labels``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    V = cfg.vocab_size
    # a sparse transition table: each (a, b) context has 4 likely nexts
    ctx_next = rng.randint(0, V, size=(257, 4))
    while True:
        toks = np.zeros((batch, seq), np.int32)
        toks[:, :2] = rng.randint(0, V, size=(batch, 2))
        for t in range(2, seq):
            ctx = (toks[:, t - 1] * 31 + toks[:, t - 2]) % 257
            choice = rng.randint(0, 4, size=batch)
            nxt = ctx_next[ctx, choice]
            noise = rng.randint(0, V, size=batch)
            use_noise = rng.rand(batch) < 0.1
            toks[:, t] = np.where(use_noise, noise, nxt)
        out = {"tokens": torch.from_numpy(toks).to(dev)}
        if cfg.frontend == "vision":
            out["image_embeds"] = torch.zeros(
                (batch, cfg.frontend_tokens, cfg.d_model), device=dev)
        if cfg.frontend == "audio":
            out = {"frames": torch.from_numpy(rng.randn(
                       batch, seq, cfg.d_model).astype(np.float32)).to(dev),
                   "labels": torch.from_numpy(toks % cfg.vocab_size).to(dev)}
        yield out


def train(arch: str, *, steps: int = 100, batch: int = 8, seq: int = 256,
          lr: float = 3e-4, use_reduced: bool = True, n_layers: int = 4,
          d_model: int = 256, seed: int = 0, log_every: int = 10,
          checkpoint_path: str = None, device=None):
    """Train ``arch`` (reduced to ``n_layers`` × ``d_model`` unless
    ``use_reduced`` is False) on ``synthetic_lm_batches`` for ``steps``
    steps of ``make_train_step`` (no remat, bf16 activations, the dense
    path), on ``device`` (the card unless the caller asks for the CPU).
    Returns (params, history of {"step", "loss"})."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg, n_layers=n_layers, d_model=d_model)
    params = T.init_params(cfg, seed=seed, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"vocab={cfg.vocab_size} seq={seq} batch={batch}")
    step_fn, opt = make_train_step(cfg, lr=lr, remat=False)
    opt_state = opt.init(params)
    data = synthetic_lm_batches(cfg, batch, seq, seed, device=dev)

    history = []
    t0 = time.time()
    for i in range(steps):
        b = next(data)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        if i % log_every == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            history.append({"step": i, "loss": loss})
            print(f"step {i:5d}  loss {loss:8.4f}  "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    if checkpoint_path:
        save_checkpoint(checkpoint_path, params,
                        metadata={"arch": cfg.name, "steps": steps})
        print("checkpoint ->", checkpoint_path)
    return params, history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="full config (default is reduced)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
          lr=args.lr, use_reduced=not args.full, n_layers=args.layers,
          d_model=args.d_model, seed=args.seed,
          checkpoint_path=args.checkpoint, device=args.device)


if __name__ == "__main__":
    main()
