#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout. It imports the port (``src/repro_torch``)
and nothing of JAX or of the JAX package, and fails (non-zero exit, no
result line) without a CUDA device or without the checkout. Phases, each
printing its own lines; any failed phase exits non-zero:

1. device — the card's name and power limit (``nvidia-smi``); sm_90 check.
2. build — compiles every kernel of ``src/repro_torch/csrc`` (one ``nvcc``
   per source, in parallel) and prints the build seconds and the
   compiler's register / shared-memory report.
3. kernels — each kernel against its plain PyTorch version on the card,
   at the serving path's shapes and at the edges (prefix 0, full, ragged,
   per-group prefixes that differ, shapes that are not tile multiples,
   window and softcap), each held to a stated fp32 tolerance.
4. times — per kernel and shape: kernel ms, plain ms, the library call's
   ms (``torch.matmul``; ``F.scaled_dot_product_attention`` with KV
   repeated — timed here only, never called by the port) and the bound
   ``max(bytes / 3.35 TB/s, operations / 67 TFLOP/s fp32)``.
5. slice — granite-3-8b at its published width and depth (40 layers,
   d_model 4096, fp32, torch-seeded weights) served by ``EdgeServer``
   through the kernels: 4 elastic requests on 2 slots. Every request must
   finish with finite logits, both kernels must have launched in that run,
   and the same requests through the dense masked path (no kernels) must
   give identical greedy tokens and logits within a stated tolerance.

The last lines are a ``kernels:`` line, the card line, one JSON object
with every kernel's launches and times, and the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
K1_TOL = 1e-4                  # K up to 12800 fp32 products, outputs O(1)
K2_TOL = 2e-5                  # D-length dots and one softmax, outputs O(1)
SLICE_LOGIT_RTOL = 1e-3        # 40 fp32 layers summed in another order
SLICE = dict(arch="granite-3-8b", slots=2, n_requests=4, prompt_len=32,
             gen=8, seed=0)


class PhaseError(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, device, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def _i32(vals, device):
    import torch
    return torch.tensor(vals, dtype=torch.int32, device=device)


def k1_cases(d_model, d_ff, slots, prompt_len):
    """(label, G, M, K, N, prefixes, act, bias) for elastic_dense: the
    serving shapes first, then the edges."""
    full = None
    return [
        ("decode up", slots, 1, d_model, d_ff, full, None, False),
        ("decode up ragged", slots, 1, d_model, d_ff,
         dict(n=[d_ff // 4 + 3] + [d_ff] * (slots - 1)), "silu", False),
        ("decode down", slots, 1, d_ff, d_model, full, None, False),
        ("decode down ragged", slots, 1, d_ff, d_model,
         dict(k=[d_ff // 2 + 5] + [d_ff // 4] * (slots - 1)), None, False),
        ("prefill up", 1, prompt_len, d_model, d_ff, full, "silu", False),
        ("prefill down ragged", 1, prompt_len, d_ff, d_model,
         dict(k=[3 * d_ff // 4]), None, False),
        ("prefix 0", 3, 1, 300, 200, dict(k=[0, 0, 0], n=[0, 5, 200]),
         "gelu", True),
        ("per-group prefixes", 5, 1, 257, 130,
         dict(k=[257, 0, 100, 31, 256], n=[130, 64, 1, 129, 33],
              m=[1, 1, 0, 1, 1]), "relu", True),
        ("tiles ragged", 3, 37, 1000, 777,
         dict(k=[1000, 13, 999], n=[777, 700, 65], m=[37, 20, 0]), "gelu",
         True),
        ("rows ragged", 2, 3, 129, 1000, dict(m=[3, 1]), "silu", True),
        ("rows no split", 2, 1, 64, 100, dict(n=[100, 37]), "gelu", True),
        ("tiles no split", 1, 20, 50, 70, dict(k=[33]), "silu", True),
    ]


def k2_cases(n_heads, n_kv, head_dim, prompt_len):
    """(label, B, S, H, KV, D, h_active, causal, window, cap)."""
    return [
        ("prefill causal", 1, prompt_len, n_heads, n_kv, head_dim, None,
         True, None, None),
        ("prefill heads ragged", 1, prompt_len, n_heads, n_kv, head_dim,
         [n_heads // 2], True, None, None),
        ("heads 0 / per-batch", 3, 37, 8, 2, 64, [0, 8, 4], True, None,
         None),
        ("window + softcap", 2, 70, 4, 2, 128, [4, 2], True, 9, 50.0),
        ("non-causal ragged S", 1, 45, 4, 1, 32, None, False, None, None),
        ("window non-causal", 1, 33, 2, 2, 64, [2], False, 5, 20.0),
    ]


def _k1_inputs(G, M, K, N, prefixes, bias, device, gen):
    import torch
    x = torch.randn((G, M, K), generator=gen, device=device)
    w = torch.randn((K, N), generator=gen, device=device) / math.sqrt(K)
    b = torch.randn((N,), generator=gen, device=device) if bias else None
    pre = {f"{a}_active": (_i32(prefixes[a], device)
                           if prefixes and a in prefixes else None)
           for a in ("k", "n", "m")}
    return x, w, b, pre


def _k2_inputs(B, S, H, KV, D, ha, device, gen):
    import torch
    q = torch.randn((B, S, H, D), generator=gen, device=device)
    k = torch.randn((B, S, KV, D), generator=gen, device=device)
    v = torch.randn((B, S, KV, D), generator=gen, device=device)
    return q, k, v, (_i32(ha, device) if ha is not None else None)


def phase_kernels(device, d_model, d_ff, n_heads, n_kv, head_dim, slots,
                  prompt_len):
    """Each kernel against its plain version; returns the worst error of
    each kernel. Raises PhaseError past a tolerance."""
    import torch
    from repro_torch.kernels.elastic_matmul import (elastic_dense,
                                                    elastic_dense_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_fwd_plain)
    gen = torch.Generator(device=device).manual_seed(1)
    worst = {"elastic_dense": 0.0, "flash_attention": 0.0}
    failed = []
    for label, G, M, K, N, pre, act, bias in k1_cases(d_model, d_ff, slots,
                                                      prompt_len):
        x, w, b, p = _k1_inputs(G, M, K, N, pre, bias, device, gen)
        got = elastic_dense(x, w, b, act=act, **p)
        want = elastic_dense_plain(x, w, b, act=act, **p)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        err = float((got - want).abs().max())
        worst["elastic_dense"] = max(worst["elastic_dense"], err)
        ok = err <= K1_TOL and bool(torch.isfinite(got).all())
        print(f"  elastic_dense {label:22s} G={G} M={M} K={K} N={N} "
              f"act={act} max|err|={err:.3e} tol={K1_TOL:g} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"elastic_dense {label}")
    for label, B, S, H, KV, D, ha, causal, window, cap in k2_cases(
            n_heads, n_kv, head_dim, prompt_len):
        q, k, v, hat = _k2_inputs(B, S, H, KV, D, ha, device, gen)
        o, lse = flash_attention(q, k, v, hat, causal=causal, window=window,
                                 cap=cap)
        o_p, lse_p = flash_attention_fwd_plain(q, k, v, hat, causal=causal,
                                               window=window, cap=cap)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        err = max(float((o - o_p).abs().max()),
                  float((lse - lse_p).abs().max()))
        worst["flash_attention"] = max(worst["flash_attention"], err)
        ok = err <= K2_TOL and bool(torch.isfinite(o).all())
        print(f"  flash_attention {label:20s} B={B} S={S} H={H} KV={KV} "
              f"D={D} h_active={ha} causal={causal} window={window} "
              f"cap={cap} max|err|={err:.3e} tol={K2_TOL:g} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"flash_attention {label}")
    if failed:
        raise PhaseError(f"kernels disagree with their plain versions: "
                         f"{failed}")
    return worst


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------
def phase_times(device, d_model, d_ff, n_heads, n_kv, head_dim, slots,
                prompt_len, iters=20):
    """Kernel / plain / library ms and the bound at the serving shapes.
    Returns {kernel: [row, ...]} (the first row is the kernel's headline
    shape)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.elastic_matmul import (elastic_dense,
                                                    elastic_dense_plain)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_fwd_plain)
    gen = torch.Generator(device=device).manual_seed(2)
    rows = {"elastic_dense": [], "flash_attention": []}
    for label, G, M, K, N, act in (
            ("decode up/gate", slots, 1, d_model, d_ff, "silu"),
            ("decode down", slots, 1, d_ff, d_model, None),
            ("prefill up/gate", 1, prompt_len, d_model, d_ff, "silu"),
            ("prefill down", 1, prompt_len, d_ff, d_model, None)):
        x, w, _, _ = _k1_inputs(G, M, K, N, None, False, device, gen)
        x2 = x.reshape(G * M, K)
        row = dict(shape=f"{label} ({G},{M},{K})@({K},{N})",
                   ms=cuda_ms(lambda: elastic_dense(x, w, act=act), device,
                              iters),
                   plain_ms=cuda_ms(lambda: elastic_dense_plain(
                       x, w, act=act), device, iters),
                   library_ms=cuda_ms(lambda: torch.matmul(x2, w), device,
                                      iters))
        row["bound_ms"], row["bound_by"] = bound(
            4.0 * (G * M * K + K * N + G * M * N), 2.0 * G * M * K * N)
        rows["elastic_dense"].append(row)
    for label, B, S, H, KV, D in (
            ("prefill causal", 1, prompt_len, n_heads, n_kv, head_dim),):
        q, k, v, _ = _k2_inputs(B, S, H, KV, D, None, device, gen)
        G = H // KV
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        row = dict(shape=f"{label} q({B},{S},{H},{D}) kv({B},{S},{KV},{D})",
                   ms=cuda_ms(lambda: flash_attention(q, k, v), device,
                              iters),
                   plain_ms=cuda_ms(lambda: flash_attention_fwd_plain(
                       q, k, v), device, iters),
                   library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True), device, iters))
        pairs = B * H * S * (S + 1) / 2          # valid (query, key) pairs
        row["bound_ms"], row["bound_by"] = bound(
            4.0 * (2 * B * S * H * D + 2 * B * S * KV * D + B * H * S),
            4.0 * D * pairs)
        rows["flash_attention"].append(row)
    for name, rs in rows.items():
        for r in rs:
            print(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
                  f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    # host cost of one call at a size whose device time is negligible: the
    # serving path makes 120 elastic_dense calls per decode step
    x, w, _, _ = _k1_inputs(2, 1, 64, 64, None, False, device, gen)
    na = _i32([64, 32], device)
    q, k, v, _ = _k2_inputs(1, 16, 2, 1, 32, None, device, gen)
    host = {"elastic_dense": host_us(
                lambda: elastic_dense(x, w, n_active=na, act="silu"), device),
            "torch.matmul": host_us(lambda: torch.matmul(x, w), device),
            "flash_attention": host_us(
                lambda: flash_attention(q, k, v), device)}
    print("  host us per call: " + ", ".join(f"{n} {t:.1f}"
                                             for n, t in host.items()))
    rows["elastic_dense"][0]["host_us"] = host["elastic_dense"]
    rows["elastic_dense"][0]["library_host_us"] = host["torch.matmul"]
    rows["flash_attention"][0]["host_us"] = host["flash_attention"]
    return rows


def host_us(fn, device, iters=200) -> float:
    """Host-clock microseconds per call of ``fn`` (enqueue cost; the
    device work of the calls is far shorter at the sizes used)."""
    import torch
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return t * 1e6 / iters


# ---------------------------------------------------------------------------
# phase 5: the serving slice
# ---------------------------------------------------------------------------
def phase_slice(device, cfg, *, slots, n_requests, prompt_len, gen, seed):
    """Serve elastic requests through the kernels, then through the dense
    masked path; returns (launch counts of the kernel run, stats)."""
    import numpy as np
    import torch
    from repro_torch.core.elastic import family_for
    from repro_torch.kernels.elastic_matmul import elastic_dense
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serving import EdgeServer, Request

    fam = family_for(cfg)
    t0 = time.perf_counter()
    params = fam.init_params(seed=seed, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params fp32 on {device} "
          f"(init {time.perf_counter() - t0:.1f} s)")
    rng = random.Random(seed)
    specs = [fam.random_spec(rng) for _ in range(n_requests - 1)] + \
        [fam.full_spec()]
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n_requests, prompt_len))
    reqs = [Request(uid=i, spec=specs[i], prompt=prompts[i],
                    max_new_tokens=gen) for i in range(n_requests)]

    def serve(backend):
        server = EdgeServer(fam, params, slots=slots, prompt_len=prompt_len,
                            max_new_tokens=gen, backend=backend,
                            trace_logits=True, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = server.run(reqs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t

    elastic_dense.launches = 0
    flash_attention.launches = 0
    comps, secs = serve("auto")
    launches = {"elastic_dense": elastic_dense.launches,
                "flash_attention": flash_attention.launches}
    print(f"  kernel path: {n_requests} requests, {n_requests * gen} "
          f"tokens in {secs:.3f} s -> {n_requests / secs:.3f} req/s, "
          f"{n_requests * gen / secs:.2f} tok/s; launches {launches}")
    problems = []
    if len(comps) != n_requests:
        problems.append(f"{len(comps)} of {n_requests} requests completed")
    for c in comps:
        if len(c.tokens) != gen or not all(np.isfinite(l).all()
                                           for l in c.logits):
            problems.append(f"request {c.uid}: {len(c.tokens)} tokens, "
                            "non-finite logits or short")
    for name, n in launches.items():
        if n <= 0:
            problems.append(f"{name} never launched on the serving path")
    ref, ref_secs = serve(None)
    print(f"  dense path: {n_requests * gen / ref_secs:.2f} tok/s")
    worst = 0.0
    for c, r in zip(comps, ref):
        if c.tokens != r.tokens:
            problems.append(f"request {c.uid}: kernel tokens {c.tokens} != "
                            f"dense tokens {r.tokens}")
        for a, b in zip(c.logits, r.logits):
            worst = max(worst, float(np.max(np.abs(a - b)) /
                                     max(1.0, float(np.max(np.abs(b))))))
    same = not any("tokens" in p for p in problems)
    print(f"  kernel vs dense path: greedy tokens "
          f"{'identical' if same else 'DIFFER'}, "
          f"max relative logit err {worst:.3e} (tol {SLICE_LOGIT_RTOL:g})")
    if worst > SLICE_LOGIT_RTOL:
        problems.append(f"logits differ by {worst:.3e}")
    for c in comps:
        print(f"  req{c.uid} ff={c.spec.ff_frac} heads={c.spec.attn_head_frac}"
              f" layers={len(c.spec.layers[0])}: {c.tokens}")
    if problems:
        raise PhaseError("; ".join(problems))
    stats = {"seconds": secs, "requests_per_s": n_requests / secs,
             "tokens_per_s": n_requests * gen / secs,
             "dense_tokens_per_s": n_requests * gen / ref_secs,
             "max_rel_logit_err": worst}
    if device.type == "cuda":
        fns = {name: decode_step_fn(device, fam, params, specs[:slots], b)
               for name, b in (("kernel", "auto"), ("dense", None))}
        walls = {name: step_wall_ms(fn, device) for name, fn in fns.items()}
        for name, fn in fns.items():
            busy, top = step_device_ms(fn, device)
            prof = {"wall_ms": walls[name], "device_busy_ms": busy,
                    "device_idle_share": None if busy is None
                    else max(0.0, 1.0 - busy / walls[name]),
                    "top_kernels_ms": top}
            stats[f"{name}_decode_step"] = prof
            print(f"  {name} path decode step ({slots} slots): "
                  f"{json.dumps(prof)}")
    return launches, stats


def decode_step_fn(device, fam, params, specs, backend):
    """A closure running one batched masked decode step (a slot per spec)
    through ``backend``'s kernel table."""
    import numpy as np
    import torch
    from repro_torch.kernels.dispatch import kernel_dispatch
    from repro_torch.models import transformer as T
    cfg = fam.cfg
    kernels = kernel_dispatch(backend).table()
    caches = T.init_decode_caches(cfg, len(specs), 64, torch.float32, device)
    hosts = [fam.decode_masks(s) for s in specs]
    masks = {k: (tuple(torch.as_tensor(np.stack([h[k][i] for h in hosts]),
                                       device=device)
                       for i in range(len(hosts[0][k])))
                 if isinstance(hosts[0][k], tuple)
                 else torch.as_tensor(np.stack([h[k] for h in hosts]),
                                      device=device)) for k in hosts[0]}
    toks = torch.ones((len(specs), 1), dtype=torch.int64, device=device)
    pos = torch.arange(len(specs), device=device) + 30

    def step():
        T.decode_step(params, cfg, caches, toks, pos, masks=masks,
                      kernels=kernels)
    return step


def step_wall_ms(step, device, steps=3) -> float:
    """Host-clock ms per call of ``step``, ending in a synchronize (run
    before any profiler session: a finished session still slows
    launches)."""
    import torch
    step()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3 / steps


def step_device_ms(step, device, steps=3):
    """(device-busy ms per call of ``step``, its five costliest kernels)
    from ``torch.profiler``; (None, {}) where it reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize(device)
    # device rows only: an operator's row repeats its kernels' time
    kernels_us = {e.key: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0)) or 0
                  for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")}
    busy = sum(kernels_us.values()) / 1e3 / steps if kernels_us else None
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:5]
    return busy, {k[:60]: v / 1e3 / steps for k, v in top}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


# ---------------------------------------------------------------------------
def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)   # progress survives a kill
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found: run from the root "
              "of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.backend import resolve_device

    device = resolve_device("cuda")
    card = card_line()
    print("== 1. device")
    print(f"  {card}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} sm_"
          f"{''.join(map(str, torch.cuda.get_device_capability(0)))}")
    if torch.cuda.get_device_capability(0) != (9, 0):
        print("chip_smoke: the kernels are built for sm_90a", file=sys.stderr)
        return 1

    print("== 2. build")
    t0 = time.perf_counter()
    build.build_all()
    print(f"  built in {time.perf_counter() - t0:.1f} s "
          f"(per source: {build.build_seconds})")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    cfg = get_config(SLICE["arch"])
    dims = dict(d_model=cfg.d_model, d_ff=cfg.d_ff, n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                slots=SLICE["slots"], prompt_len=SLICE["prompt_len"])
    try:
        print("== 3. kernels against their plain versions")
        worst = phase_kernels(device, **dims)
        print("== 4. times")
        times = phase_times(device, **dims)
        print("== 5. slice: granite-3-8b, full width and depth, fp32")
        launches, stats = phase_slice(
            device, cfg, slots=SLICE["slots"],
            n_requests=SLICE["n_requests"], prompt_len=SLICE["prompt_len"],
            gen=SLICE["gen"], seed=SLICE["seed"])
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    meta = {
        "elastic_dense": dict(
            source="src/repro_torch/csrc/elastic_dense.cu",
            replaces="src/repro/kernels/elastic_matmul.py:103"),
        "flash_attention": dict(
            source="src/repro_torch/csrc/flash_attention_fwd.cu",
            replaces="src/repro/kernels/flash_attention.py:107"),
    }
    entries = []
    for name, rows in times.items():
        head = rows[0]
        entries.append(dict(
            name=name, route="cuda", source=meta[name]["source"],
            replaces=meta[name]["replaces"], launches=launches[name],
            max_abs_err=worst[name], ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            shape=head["shape"], host_us=head.get("host_us"),
            library_host_us=head.get("library_host_us"),
            other_shapes=rows[1:]))
    print("kernels: " + " ".join(f"{n}={c}" for n, c in launches.items()))
    print(f"slice: {json.dumps(stats)}")
    print(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
