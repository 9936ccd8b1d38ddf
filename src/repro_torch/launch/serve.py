"""Serving CLI — a thin command line over ``repro_torch.serving``.

Batches requests through the multi-tenant :class:`EdgeServer` (fused
one-shot prefill + masked parent-space decode). ``--elastic`` gives each
request a random submodel spec; ``--full`` serves the architecture at its
published width and depth; ``--check-prefill`` asserts that the fused
prefill matches the token-by-token decode path within 1e-5. Runs on the
card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
      --batch 4 --prompt-len 32 --gen 8 --full --elastic --backend auto

``--arch granite-moe-1b-a400m`` serves the MoE parent the same way (each
request's random spec then also cuts the routed experts), ``--arch
mamba2-2.7b`` the SSM parent (the spec cuts the SSD heads; prompts split
into chunks of 256 tokens, or of 16 in a reduced config, so use a
multiple of the chunk when longer). ``--arch deepseek-v2-lite-16b`` (MLA,
MoE with shared experts), ``gemma2-9b`` (local / global attention pairs)
and ``zamba2-1.2b`` (Mamba2 with the shared attention block, the SSM
parent's prompt rule) serve the same way.
"""
from __future__ import annotations

import argparse
import random
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.core.elastic import family_for
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.serving.batcher import Request
from repro_torch.serving.server import EdgeServer


def check_prefill_parity(params, cfg, tokens, max_len: int,
                         tol: float = 1e-5) -> float:
    """Assert that the fused one-shot prefill of ``tokens`` (B, S) leaves
    the same decode caches (and last-position logits) as stepping the
    prompt token by token through ``decode_step``, within ``tol``; returns
    the largest difference. The dense path, on the parameters' device,
    with fp32 caches (fp64 for an fp64 parent)."""
    cache_dtype = torch.promote_types(params["embed"]["table"].dtype,
                                      torch.float32)
    with torch.no_grad():
        logits_f, caches_f = T.prefill(params, cfg, tokens, max_len,
                                       cache_dtype=cache_dtype)
        caches_s = T.init_decode_caches(cfg, tokens.shape[0], max_len,
                                        cache_dtype, tokens.device)
        logits_s = None
        for i in range(tokens.shape[1]):
            pos = torch.full((tokens.shape[0],), i, dtype=torch.long,
                             device=tokens.device)
            logits_s, caches_s = T.decode_step(params, cfg, caches_s,
                                               tokens[:, i:i + 1], pos)
        diffs = [float((a.float() - b.float()).abs().max())
                 for a, b in zip(tree_leaves(caches_f),
                                 tree_leaves(caches_s))]
        diffs.append(float((logits_f - logits_s).abs().max()))
    worst = max(diffs)
    if worst > tol:
        raise AssertionError(
            f"fused prefill diverges from stepwise decode: {worst:.2e}")
    return worst


def serve(arch: str, *, batch: int = 4, prompt_len: int = 64, gen: int = 32,
          use_reduced: bool = True, n_layers: int = 4, d_model: int = 256,
          seed: int = 0, temperature: float = 0.0, elastic: bool = False,
          check_prefill: bool = False, backend: str = None, device=None):
    dev = resolve_device(device)
    cfg = get_config(arch)
    if cfg.encoder_only:
        raise SystemExit(f"{arch} is encoder-only; no decode path")
    if use_reduced:
        cfg = reduced(cfg, n_layers=n_layers, d_model=d_model)
    family = family_for(cfg)
    # independent streams: params / prompts / specs / sampling
    params = family.init_params(seed=seed, device=dev)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt_len))
    if check_prefill:
        worst = check_prefill_parity(
            params, cfg, torch.as_tensor(prompts, device=dev),
            prompt_len + gen)
        print(f"fused-prefill parity: max|Δ| = {worst:.2e} (≤ 1e-5)")
    rng = random.Random(seed)
    specs = [family.random_spec(rng) if elastic else None
             for _ in range(batch)]
    server = EdgeServer(family, params, slots=min(batch, 8),
                        prompt_len=prompt_len, max_new_tokens=gen,
                        temperature=temperature, seed=seed + 1,
                        backend=backend, device=dev)
    reqs = [Request(uid=b, spec=specs[b], prompt=prompts[b],
                    max_new_tokens=gen) for b in range(batch)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    completions = server.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_total = time.perf_counter() - t0

    stats = {"serve_s": t_total,
             "requests_per_s": batch / max(t_total, 1e-9),
             "tokens_per_s": batch * gen / max(t_total, 1e-9)}
    mode = "elastic multi-tenant" if elastic else "full-parent"
    print(f"arch={cfg.name} batch={batch} prompt={prompt_len} gen={gen} "
          f"device={dev} backend={backend} [{mode}]")
    print(f"serve: {t_total:.3f}s ({stats['tokens_per_s']:.2f} tok/s, "
          f"{stats['requests_per_s']:.3f} req/s aggregate)")
    print("sample generations (token ids):")
    for c in completions[:2]:
        print(f"  req{c.uid}: {c.tokens[:16]} ...")
    return completions, stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="published width and depth (no reduction)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--elastic", action="store_true",
                    help="serve a random submodel spec per request")
    ap.add_argument("--check-prefill", action="store_true",
                    help="assert fused prefill == stepwise decode (≤1e-5)")
    ap.add_argument("--backend", default=None,
                    help="'auto'/'cuda' for the hand-written kernels; "
                         "omit for the dense masked path")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
          gen=args.gen, use_reduced=not args.full, n_layers=args.layers,
          d_model=args.d_model, temperature=args.temperature,
          elastic=args.elastic, check_prefill=args.check_prefill,
          backend=args.backend, device=args.device)


if __name__ == "__main__":
    main()
