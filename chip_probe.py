#!/usr/bin/env python3
"""Measurements on one H100 beside ``chip_smoke.py``, for choices it does
not time itself. Run from the root of a checkout (the card's build reuses
``build/kernels/``):

    python3 chip_probe.py shapes
        K6 / K7's launch shapes at the MoE training combine (granite-moe,
        4 clients × 2048 tokens, top-8, d 1024): the gather-dot at 1, 2 and
        4 warps a token, K7 and K6 at 8, 4 and 2 warps a block, each beside
        its first design, timed in turns (7 rounds, medians, min–max).
    python3 chip_probe.py moe-step ROOT LABEL
        phase 9's MoE local step (12 layers, 4 clients) of the source tree
        at ROOT: 5 × 10 steps of host-clock ms and the device-busy ms
        (``torch.profiler``), with the gathers' device ms. Run it on two
        trees in turns in one call (parent, change, change, parent) to
        compare them on one card.
    python3 chip_probe.py cnn-round ROOT LABEL
        phase 14's sync rounds of the tree at ROOT: a CFL and a FedAvg
        session of ``PAPER_CNN`` on the kernel path (8 clients of the
        synthetic CIFAR stand-in), each after an untimed warm-up round of
        its own session, 4 timed rounds (seconds and the host's search /
        predictor seconds) and one more round's device-busy ms
        (``torch.profiler``). Run it on two trees in turns in one call.

Each prints one ``PROBE {json}`` line.
"""
import json
import os
import statistics
import sys


def _moe_setup(cs, device):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import capacity
    cfg = get_config(cs.MOE_SLICE["arch"])
    pre = cs.train_prefixes(cs.train_family(cfg, cs.MOE_TRAIN["n_layers"]))
    E, k, d = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    tokens = cs.MOE_TRAIN["batch"] * cs.MOE_TRAIN["seq_len"]
    cap = capacity(tokens, MoEConfig(E, k, cfg.moe.d_ff_expert))
    gen = torch.Generator(device=device).manual_seed(5)
    G = cs.MOE_TRAIN["clients"]
    return cs.moe_tables(device, G, tokens, E, k, cap, pre["experts"], d,
                         gen), G * tokens, k, d, gen


def shapes(cs, device):
    """K6 / K7 / the gather-dot at launch shapes the plans do not pick."""
    import torch
    from repro_torch.kernels import moe_dispatch as md
    t, T_all, k, d, gen = _moe_setup(cs, device)
    live = (t["gate_eff"].reshape(-1) != 0).to(torch.int32)
    z = torch.randn((T_all, d), generator=gen, device=device)
    dest = t["dest"].reshape(T_all, k)
    plans = {"dot_plan": md.dot_plan, "reduce_plan": md.reduce_plan,
             "gather_plan": md.gather_plan}

    def at(name, plan, fn):
        def run():
            setattr(md, name, plan)
            try:
                return fn()
            finally:
                setattr(md, name, plans[name])
        return run
    out = {}
    want = md.gather_dot_plain(t["y"], t["dest"], live, z, k)
    fns = {}
    for s in md.DOT_SPLITS:
        fn = at("dot_plan", lambda *a, s=s: md.DotPlan(s),
                lambda: md.gather_dot(t["y"], t["dest"], live, z, k))
        err = float((fn() - want).abs().max())
        fns[f"gather_dot split {s} (max|err| {err:.2e})"] = fn
    out["gather_dot"] = cs.turns_ms(device, fns, 5)
    fns = {f"gather_reduce warps {w}": at(
        "reduce_plan", lambda *a, w=w: md.GatherPlan(w),
        lambda: md.gather_reduce(t["y"], dest, t["gate_eff"]))
        for w in (8, 4, 2)}
    fns["gather_reduce first"] = lambda: md.gather_reduce(
        t["y"], dest, t["gate_eff"], variant="first")
    out["gather_reduce"] = cs.turns_ms(device, fns, 5)
    fns = {f"gather_rows warps {w}": at(
        "gather_plan", lambda *a, w=w: md.GatherPlan(w),
        lambda: md.gather_rows(t["xt"], t["src"], t["valid"]))
        for w in (8, 4, 2)}
    fns["gather_rows first"] = lambda: md.gather_rows(
        t["xt"], t["src"], t["valid"], variant="first")
    out["gather_rows"] = cs.turns_ms(device, fns, 5)
    return out


def moe_step(cs, device, label):
    """Phase 9's MoE local step of the tree that ``cs`` came from."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synth import make_lm_dataset
    from repro_torch.fl.engine import BatchedRoundEngine
    T = cs.MOE_TRAIN
    fam = cs.train_family(get_config(cs.MOE_SLICE["arch"]), T["n_layers"])
    params0 = fam.init_params(seed=T["seed"], device=device)
    train = [make_lm_dataset(T["train_seqs"], T["seq_len"],
                             fam.cfg.vocab_size, seed=T["seed"] * 100 + c,
                             chain_seed=1000 + c)
             for c in range(T["clients"])]
    eng = BatchedRoundEngine(fam, lr=T["lr"], momentum=T["momentum"],
                             grad_clip=T["grad_clip"], backend="auto",
                             device=device)
    step = cs.local_step_fn(eng, fam, params0, cs.train_specs(fam), train,
                            T["batch"], device)
    for _ in range(3):
        step()
    torch.cuda.synchronize(device)
    walls = [cs.step_wall_ms(step, device, steps=10) for _ in range(5)]
    busy, _, by_name = cs.step_device_ms(step, device)
    gathers = {n: sum(v for key, v in by_name.items()
                      if any(f in key for f in fs))
               for n, fs in cs.KERNEL_FUNCTIONS.items()
               if n.startswith("gather")}
    return {"tree": label, "wall_ms": walls,
            "median_ms": statistics.median(walls), "device_busy_ms": busy,
            "gathers_device_ms": gathers}


def cnn_round(cs, device, label, rounds=4):
    """Phase 14's CFL and FedAvg sync rounds of the tree ``cs`` came
    from, on the kernel path, through ``CFLSession``'s own round."""
    import time
    import torch
    from repro_torch.configs.paper_cnn import PAPER_CNN
    from repro_torch.fl.server import CFLConfig
    from repro_torch.fl.session import CFLSession
    S = cs.CNN_SLICE

    def make(algorithm):
        return CFLSession.from_synthetic(
            PAPER_CNN, kind=S["kind"], n_workers=S["n_workers"],
            n_samples=S["n_samples"], heterogeneity=S["heterogeneity"],
            seed=S["seed"], device=device, algorithm=algorithm,
            fl_cfg=CFLConfig(n_workers=S["n_workers"], elastic_kernels=True,
                             seed=S["seed"]))
    out = {"tree": label}
    for algorithm in ("cfl", "fedavg"):
        warm = make(algorithm)
        warm.run(1)
        del warm
        sess = make(algorithm)
        secs, host = [], []
        for _ in range(rounds):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            rec = sess.server.run_round()
            torch.cuda.synchronize(device)
            secs.append(time.perf_counter() - t)
            host.append({k: v for k, v in rec.get("host_seconds",
                                                   {}).items()
                         if k != "round"})
        busy, top, _ = cs.step_device_ms(sess.server.run_round, device,
                                         steps=1)
        out[algorithm] = {"round_s": secs,
                          "median_s": statistics.median(secs),
                          "host_s": host, "device_busy_ms": busy,
                          "top_kernels_ms": top}
    return out


def main() -> int:
    commands = ("shapes", "moe-step", "cnn-round")
    if len(sys.argv) < 2 or sys.argv[1] not in commands:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[2] if sys.argv[1] != "shapes"
                           else os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    build.build_all()
    device = torch.device("cuda", 0)
    if sys.argv[1] == "shapes":
        out = shapes(cs, device)
    elif sys.argv[1] == "moe-step":
        out = moe_step(cs, device, sys.argv[3])
    else:
        out = cnn_round(cs, device, sys.argv[3])
    print(cs.card_line())
    print("PROBE " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
