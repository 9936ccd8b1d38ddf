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
    python3 chip_probe.py flash-bits ROOT OUT [REF]
        K2's o and lse and K3 / K4's dq, dk, dv in both variants at head
        dims 32, 64, 128 and 256 of the tree at ROOT, on inputs drawn on the
        CPU from a fixed seed (causal GQA with head prefixes; non-causal
        with a window and a softcap), saved to the npz file OUT; with REF
        (another tree's OUT) each array is compared bit for bit. Run it on
        the parent and the change in one call to show that a kernel edit
        left those head dims' bits unchanged.
    python3 chip_probe.py conv-error
        the fp32 error of each convolution of the paper CNN's masked
        forward (the stem and the stage convs, 8 clients × 32 images) on
        the card, against the same op in fp64: the dense path's grouped
        ``F.conv2d`` (cuDNN) and K1 through ``elastic_conv2d``, forward,
        dx and dw, each as max |err| over max |value|; with the TF32
        settings the port's entry points leave.
    python3 chip_probe.py il-drift
        IL at phase 14's budget (``CNN_SLICE``: 8 clients, 2 rounds' local
        steps) on the kernel path's recorded ReLU decisions: the dense path
        replaying them in fp32 with its stage convolutions' forward, dx or
        dw (one at a time, then all three) taken from K1 or from an im2col
        product on cuBLAS instead of cuDNN, each trained cohort's distance
        from the fp64 dense path over its movement, beside the kernel
        path's and the unswapped dense path's.

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


def flash_bits(device, out_path, ref_path=None):
    """K2–K4's outputs at head dims 32–256 saved to ``out_path``, and
    compared with ``ref_path``'s bit for bit where it is given."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator().manual_seed(7)
    out = {}
    for D in (32, 64, 128, 256):
        for label, opts in (("causal", dict(causal=True)),
                            ("window-cap", dict(causal=False, window=9,
                                                cap=30.0))):
            B, S, H, KV = 2, 130, 8, 2
            q, do = (torch.randn((B, S, H, D), generator=gen).to(device)
                     for _ in range(2))
            k, v = (torch.randn((B, S, KV, D), generator=gen).to(device)
                    for _ in range(2))
            ha = torch.tensor([H, 3], dtype=torch.int32, device=device)
            o, lse = fa.flash_attention(q, k, v, ha, **opts)
            delta = (do * o).sum(-1).transpose(1, 2).contiguous()
            res = {"o": o, "lse": lse}
            for variant in fa.FLASH_BWD_VARIANTS:
                args = (q, k, v, do, lse, delta, ha)
                res[f"dq_{variant}"] = fa.flash_attention_dq(
                    *args, variant=variant, **opts)
                res[f"dk_{variant}"], res[f"dv_{variant}"] = \
                    fa.flash_attention_dkv(*args, variant=variant, **opts)
            for n, t in res.items():
                out[f"D{D}_{label}_{n}"] = t.cpu().numpy()
    torch.cuda.synchronize(device)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **out)
    result = {"arrays": len(out)}
    if ref_path:
        ref = np.load(ref_path)
        differ = [n for n in out if not np.array_equal(out[n], ref[n])]
        result.update(bit_equal=not differ, differ=differ)
    return result


def conv_error(cs, device, G=8, B=32):
    """{conv: {path: [forward, dx, dw] relative errors}} at PAPER_CNN's
    convolution shapes, fp32 against fp64 of the dense path's op: the
    dense path's grouped ``F.conv2d`` and K1 through ``elastic_conv2d``."""
    import torch
    from repro_torch.configs.paper_cnn import PAPER_CNN
    from repro_torch.kernels.elastic_conv import elastic_conv2d
    from repro_torch.models.cnn import conv2d
    gen = torch.Generator().manual_seed(0)
    out = {"flags": {
        "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cudnn.deterministic": torch.backends.cudnn.deterministic,
        "float32_matmul_precision": torch.get_float32_matmul_precision()}}
    convs = [("stem", PAPER_CNN.image_size, 1, PAPER_CNN.in_channels,
              PAPER_CNN.stem_channels)] + [
        c[:5] for c in cs.cnn_convs(PAPER_CNN)]
    for name, side, stride, cin, cout in convs:
        x = torch.randn((G, B, side, side, cin), generator=gen).relu()
        w = torch.randn((G, 3, 3, cin, cout), generator=gen) / (9 * cin) ** .5
        b = 0.1 * torch.randn((G, cout), generator=gen)
        oh = -(-side // stride)
        dy = torch.randn((G, B, oh, oh, cout), generator=gen)

        def run(fn, dtype):
            xt, wt, bt = (t.to(device, dtype).requires_grad_(True)
                          for t in (x, w, b))
            y = fn(xt, wt, bt)
            dx, dw = torch.autograd.grad(y, (xt, wt), dy.to(device, dtype))
            return [t.detach().double() for t in (y, dx, dw)]
        paths = {"grouped F.conv2d": lambda a, c, d: conv2d(a, c, d,
                                                            stride),
                 "K1 elastic_conv2d": lambda a, c, d: elastic_conv2d(
                     a, c, d, stride=stride)}
        truth = run(paths["grouped F.conv2d"], torch.float64)
        out[name] = {p: [float((g - t).abs().max() / t.abs().max())
                         for g, t in zip(run(fn, torch.float32), truth)]
                     for p, fn in paths.items()}
        print(f"  {name}: " + "; ".join(
            f"{p} fwd / dx / dw " + " / ".join(f"{e:.2e}" for e in v)
            for p, v in out[name].items()))
    return out


def il_drift(cs, device):
    """{variant: max |trained − fp64 witness| over the movement} of IL's
    trained cohort at ``CNN_SLICE``'s budget, every run on the ReLU
    decisions the kernel path records. ``dense`` is the dense masked path
    as it is (cuDNN's grouped ``F.conv2d`` for every stage conv); ``OP
    ALT`` takes that op of every stage conv — ``forward``, ``dx``, ``dw``,
    or ``all`` three — from ``ALT``: ``K1`` (``elastic_conv2d``, the
    kernel path's op) or ``cuBLAS`` (an im2col product through
    ``torch.matmul``), and the other ops from cuDNN. The stem is cuDNN's on
    every path. With the number of stage convs each variant swapped."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.paper_cnn import PAPER_CNN
    from repro_torch.fl.baselines import independent_learning
    from repro_torch.fl.server import CFLConfig
    from repro_torch.fl.session import CFLSession
    from repro_torch.kernels.elastic_conv import (_im2col,
                                                  conv_weight_matrix,
                                                  elastic_conv2d)
    from repro_torch.models import cnn
    from repro_torch.optim.optimizers import tree_map
    s = cs.CNN_SLICE
    real = cnn.conv2d

    def cublas(x, w, b, stride):
        pat, (B, oh, ow) = _im2col(x, w.shape[-4], w.shape[-3], stride)
        y = torch.matmul(pat, conv_weight_matrix(w)) + b[:, None, :]
        return y.reshape(x.shape[0], B, oh, ow, w.shape[-1])
    alts = {"K1": lambda x, w, b, stride: elastic_conv2d(x, w, b,
                                                         stride=stride),
            "cuBLAS": cublas}

    class Swapped(torch.autograd.Function):
        """A stage conv whose forward, dx and dw each come from cuDNN or
        from ``alt``, as ``ops`` names them; the bias gradient cuDNN's."""

        @staticmethod
        def forward(ctx, x, w, b, stride, alt, ops):
            ctx.save_for_backward(x, w, b)
            ctx.stride, ctx.alt, ctx.ops = stride, alt, ops
            return (alt if "forward" in ops else real)(x, w, b, stride)

        @staticmethod
        def backward(ctx, dy):
            x, w, b = ctx.saved_tensors

            def grads(fn):
                with torch.enable_grad():
                    xs, ws, bs = (t.detach().requires_grad_(True)
                                  for t in (x, w, b))
                    return torch.autograd.grad(fn(xs, ws, bs, ctx.stride),
                                               (xs, ws, bs), dy)
            lib = grads(real)
            alt = grads(ctx.alt) if {"dx", "dw"} & set(ctx.ops) else lib
            return (alt[0] if "dx" in ctx.ops else lib[0],
                    alt[1] if "dw" in ctx.ops else lib[1], lib[2],
                    None, None, None)

    swapped = [0]

    def patch(alt, ops):
        def conv2d(x, w, b, stride=1):
            if w.dim() != 5 or w.shape[-2] == PAPER_CNN.in_channels:
                return real(x, w, b, stride)        # the stem: cuDNN's
            swapped[0] += 1
            return Swapped.apply(x, w, b, stride, alt, ops)
        cnn.conv2d = conv2d

    relus = cs.relu_decisions()

    def session(ek):
        return CFLSession.from_synthetic(
            PAPER_CNN, kind=s["kind"], n_workers=s["n_workers"],
            n_samples=s["n_samples"], heterogeneity=s["heterogeneity"],
            seed=s["seed"], device=device, algorithm="il",
            fl_cfg=CFLConfig(n_workers=s["n_workers"], elastic_kernels=ek,
                             seed=s["seed"]))

    def trained(sess, mode):
        kept = cs.KeptTrained()
        with relus(mode), kept:
            sess.run(s["rounds"])
        if mode == "replay" and relus.pos != len(relus.masks):
            raise cs.PhaseError(f"the replay took {relus.pos} of "
                                f"{len(relus.masks)} ReLU calls")
        return kept.trees[-1]

    k1 = session(True)
    trees = {"kernel path": trained(k1, "record")}
    trees["dense"] = trained(session(False), "replay")
    variants = [(op, alt) for alt in alts for op in
                ("forward", "dx", "dw", "all")]
    counts = {}
    try:
        for op, alt in variants:
            patch(alts[alt], ("forward", "dx", "dw") if op == "all"
                  else (op,))
            swapped[0] = 0
            trees[f"{op} {alt}"] = trained(session(False), "replay")
            counts[f"{op} {alt}"] = swapped[0]
    finally:
        cnn.conv2d = real

    def wide(ds):
        return [dict(d, x=d["x"].astype(np.float64)) for d in ds]
    kept = cs.KeptTrained()
    with relus("replay"), kept:
        independent_learning(
            k1.family, tree_map(lambda a: a.double(), k1._init_params),
            k1.clients, wide(k1.client_data), wide(k1.test_data),
            rounds=s["rounds"], fl_cfg=dataclasses.replace(
                k1.fl, elastic_kernels=False), device=device)
    fp64 = kept.trees[-1]
    out = {"swapped_convs": counts, "ratio": {}, "worst_leaf": {}}
    for name, tree in trees.items():
        out["ratio"][name] = cs.move_ratio(tree, fp64, k1._init_params)[0]
        out["worst_leaf"][name] = max(
            ((n, float((a - b).abs().max())) for (n, a), (_, b) in
             zip(cs.named_leaves(tree), cs.named_leaves(fp64))),
            key=lambda nd: nd[1])[0]
        print(f"  {name}: {out['ratio'][name]:.3e} of the movement from "
              f"fp64, largest at {out['worst_leaf'][name]}"
              + (f" ({counts[name]} stage convs swapped)"
                 if name in counts else ""))
    return out


def main() -> int:
    commands = ("shapes", "moe-step", "cnn-round", "flash-bits",
                "conv-error", "il-drift")
    if len(sys.argv) < 2 or sys.argv[1] not in commands:
        print(__doc__, file=sys.stderr)
        return 2
    here = sys.argv[1] in ("shapes", "conv-error", "il-drift")
    root = os.path.abspath(os.path.dirname(os.path.abspath(__file__))
                           if here else sys.argv[2])
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
    elif sys.argv[1] == "cnn-round":
        out = cnn_round(cs, device, sys.argv[3])
    elif sys.argv[1] == "conv-error":
        from repro_torch.kernels.backend import resolve_device
        out = conv_error(cs, resolve_device(device))
    elif sys.argv[1] == "il-drift":
        from repro_torch.kernels.backend import resolve_device
        out = il_drift(cs, resolve_device(device))
    else:
        out = flash_bits(device, sys.argv[3],
                         sys.argv[4] if len(sys.argv) > 4 else None)
    print(cs.card_line())
    print("PROBE " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
