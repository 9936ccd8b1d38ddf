"""Fig. 7's gate training, the reference's and the port's, side by side on
the CPU at the settings of ``chip_smoke.py`` phase 19a (``GATES``:
``PAPER_CNN`` on 4096 synthetic CIFAR images; 50 ``soft`` steps at quality
3, then 80 ``sample`` steps on ``mixed_quality_dataset``; batch 64, lr
2e-3, penalty 0.15). Not a test: a script that shows whether the
reference's own ``train_gates`` ends where the port's does.

Both train on the port's synthetic images (phase 19a's; the reference's
``make_dataset`` draws other pixels with ``jax.random``), start from one
set of initial parameters — the reference's, bridged into the port, or
with ``--init port`` the port's torch-seeded ones (phase 19a's), bridged
into the reference — and see the same numpy batches. The sampled gates
draw from each package's own generator (``jax.random`` key chain against
``torch.Generator``), and 130 Adam steps amplify rounding through ReLU
flips, so the two runs are two runs of one method, not one run twice. After
training each package prints its history's last entries, and with hard
gates at qualities 3 / 0 / 4 on 256 images the compute share, the gated
and ungated accuracy, and ``gate_depth_policy``'s depth and rates.

    PYTHONPATH=src python3 tests/fig7_gates_compare.py [--init port]

At full width and depth. Prints one ``FIG7 {json}`` line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import GATES  # noqa: E402  (phase 19a's settings)
from repro import data as ref_data  # noqa: E402
from repro.configs.paper_cnn import PAPER_CNN as REF_CNN  # noqa: E402
from repro.core import gating as ref_gating  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.checkpoint.bridge import (params_from_numpy,  # noqa
                                           params_to_numpy)
from repro_torch.configs.paper_cnn import PAPER_CNN  # noqa: E402
from repro_torch.core import (GateTrainConfig, gate_depth_policy,  # noqa
                              train_gates)
from repro_torch.data.loader import batches  # noqa: E402
from repro_torch.data.quality import (apply_quality,  # noqa: E402
                                      mixed_quality_dataset)
from repro_torch.data.synth import make_dataset  # noqa: E402
from repro_torch.models import cnn  # noqa: E402


def _schedule(s):
    return (dict(warmup_steps=s["warmup"], rl_steps=0, lr=s["lr"],
                 compute_penalty=s["penalty"]),
            dict(warmup_steps=0, rl_steps=s["rl"], lr=s["lr"],
                 compute_penalty=s["penalty"]))


def _summary(hist, per_q, depth, rates, seconds):
    return dict(warmup_final_acc=hist[0][-1]["acc"],
                rl_final_acc=hist[1][-1]["acc"],
                rl_final_compute_pct=hist[1][-1]["compute_pct"],
                rl_last10_compute_pct=float(np.mean(
                    [h["compute_pct"] for h in hist[1][-10:]])),
                per_quality=per_q, depth=list(depth),
                rates=[round(float(r), 4) for r in rates],
                seconds=round(seconds, 1))


def run_reference(params, data, worst, mixed, s, cfg):
    t = time.perf_counter()
    warm, rl = _schedule(s)
    as_jnp = (lambda it: ({k: jnp.asarray(v) for k, v in b.items()}
                          for b in it))
    params, h1 = ref_gating.train_gates(
        params, cfg, as_jnp(ref_data.batches(worst, s["batch"],
                                             seed=s["seed"])),
        ref_gating.GateTrainConfig(**warm), seed=s["seed"])
    params, h2 = ref_gating.train_gates(
        params, cfg, as_jnp(ref_data.batches(mixed, s["batch"],
                                              seed=s["seed"] + 1)),
        ref_gating.GateTrainConfig(**rl), seed=s["seed"])
    n, per_q = s["eval_images"], {}
    y = np.asarray(data["y"][:n])
    for q in s["qualities"]:
        x = jnp.asarray(ref_data.apply_quality(data["x"][:n], q))
        logits, info = ref_cnn.forward(params, cfg, x, gate_mode="hard")
        logits_u, _ = ref_cnn.forward(params, cfg, x, gate_mode="off")
        per_q[q] = dict(
            compute_pct=float(info["compute_pct"]),
            gated_acc=float(np.mean(np.asarray(logits).argmax(-1) == y)),
            ungated_acc=float(np.mean(np.asarray(logits_u).argmax(-1) == y)))
    depth, rates = ref_gating.gate_depth_policy(
        params, cfg, {"x": jnp.asarray(mixed["x"][:n])})
    return _summary((h1, h2), per_q, depth, rates, time.perf_counter() - t)


def run_port(params, data, worst, mixed, s, cfg):
    t = time.perf_counter()
    warm, rl = _schedule(s)
    params, h1 = train_gates(params, cfg, batches(worst, s["batch"],
                                                  seed=s["seed"]),
                             GateTrainConfig(**warm), seed=s["seed"])
    params, h2 = train_gates(params, cfg, batches(mixed, s["batch"],
                                                  seed=s["seed"] + 1),
                             GateTrainConfig(**rl), seed=s["seed"])
    n, per_q = s["eval_images"], {}
    y = torch.as_tensor(data["y"][:n]).long()
    with torch.no_grad():
        for q in s["qualities"]:
            x = torch.as_tensor(apply_quality(data["x"][:n], q))
            logits, info = cnn.forward(params, cfg, x, gate_mode="hard")
            logits_u, _ = cnn.forward(params, cfg, x, gate_mode="off")
            per_q[q] = dict(
                compute_pct=float(info["compute_pct"]),
                gated_acc=float((logits.argmax(-1) == y).float().mean()),
                ungated_acc=float((logits_u.argmax(-1) == y).float()
                                  .mean()))
        depth, rates = gate_depth_policy(params, cfg,
                                         {"x": mixed["x"][:n]})
    return _summary((h1, h2), per_q, depth, rates, time.perf_counter() - t)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init", choices=("reference", "port"),
                    default="reference")
    args = ap.parse_args()
    torch.set_num_threads(2)
    s = GATES
    cfg, ref_cfg = PAPER_CNN, REF_CNN
    data = make_dataset("synthcifar", s["n_images"], seed=s["seed"])
    worst = dict(data, x=apply_quality(data["x"], 3))
    mixed = mixed_quality_dataset(data, seed=s["seed"])
    ref_mixed = ref_data.mixed_quality_dataset(data, seed=s["seed"])
    assert all(np.array_equal(mixed[k], ref_mixed[k]) for k in mixed)
    if args.init == "port":
        params = params_to_numpy(cnn.init_params(cfg, seed=s["seed"],
                                                 device="cpu"))
    else:
        params = jax.tree.map(np.asarray, ref_cnn.init_params(
            jax.random.PRNGKey(s["seed"]), ref_cfg))
    out = {"settings": dict(s, qualities=list(s["qualities"])),
           "init": args.init,
           "reference": run_reference(params, data, worst, mixed, s,
                                      ref_cfg),
           "port": run_port(params_from_numpy(params, device="cpu"), data,
                            worst, mixed, s, cfg)}
    for side in ("reference", "port"):
        r = out[side]
        rl_c, last10 = r["rl_final_compute_pct"], r["rl_last10_compute_pct"]
        print(f"{side}: warm-up acc {r['warmup_final_acc']:.3f}; RL acc "
              f"{r['rl_final_acc']:.3f}, compute {rl_c:.3f} (last 10 steps "
              f"{last10:.3f}); hard "
              + "; ".join(f"q{q} compute {v['compute_pct']:.3f} acc "
                          f"{v['gated_acc']:.3f} / {v['ungated_acc']:.3f}"
                          for q, v in r["per_quality"].items())
              + f"; depth {r['depth']}; {r['seconds']} s")
    print("FIG7 " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
