"""The paper's parent model: an elastic residual CNN with layer-wise RL
gates — the port of the reference's ``models/cnn.py`` (``init_params``,
``forward`` in every gate mode, the hybrid supervised + REINFORCE
``loss_fn``, ``flops``).

Layout as the reference's: activations NHWC, conv weights HWIO, SAME
padding, GroupNorm (BN statistics do not aggregate across FL clients).
Channels are kept as a *prefix* in parent order, so Alg. 3's "sort
channels back then zero-pad" is the identity sort + suffix pad
(``core.submodel``).

Every function also takes client-stacked parameters — a leading client
axis G on every leaf, matched by a leading G on the activations (the
reference's ``vmap`` written out): ``conv2d`` then runs one grouped
convolution for all clients.

The RL gates (paper §III-C, SkipNet-style): each residual block has a
gate — global average pool, ``fc1``, ReLU, ``fc2`` — whose sigmoid
``p`` decides whether the block runs: ``soft`` mixes ``x + p·(f(x) − x)``
(the supervised warm-up), ``sample`` draws ``b ~ Bernoulli(p)`` and keeps
its log-probability for REINFORCE, ``hard`` takes ``b = p > 0.5``
(inference). ``jax.random.bernoulli(key, p)`` is ``uniform(key) < p``; the
port draws the uniforms from an explicit ``torch.Generator`` or takes
them from the caller, one (B,) tensor per executed block, so that a test
can replay the reference's draws.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.layers import groupnorm
from repro_torch.optim.optimizers import tree_map


# ---------------------------------------------------------------------------
# SAME convolution
# ---------------------------------------------------------------------------
def same_pads(size: int, k: int, stride: int):
    """(before, after) SAME padding of one spatial axis, as XLA's: the
    output has ⌈size / stride⌉ positions and an odd total pad puts the
    extra row after (H = 32, k = 3, stride 2: 0 before, 1 after)."""
    out = -(-size // stride)
    pad = max((out - 1) * stride + k - size, 0)
    return pad // 2, pad - pad // 2


def pad_same(x, kh: int, kw: int, stride: int):
    """x (..., H, W, C) zero-padded for a SAME kh × kw conv at ``stride``."""
    top, bottom = same_pads(x.shape[-3], kh, stride)
    left, right = same_pads(x.shape[-2], kw, stride)
    return F.pad(x, (0, 0, left, right, top, bottom))


def conv2d(x, w, b, stride: int = 1):
    """SAME conv, NHWC / HWIO: x (..., H, W, Cin), w (kh, kw, Cin, Cout),
    b (Cout,); or per-client weights w (G, kh, kw, Cin, Cout), b (G, Cout)
    with x (G, B, H, W, Cin) — one grouped convolution for all G.
    Returns (..., oh, ow, Cout)."""
    kh, kw, cin, cout = w.shape[-4:]
    xp = pad_same(x, kh, kw, stride)
    if w.dim() == 4:
        lead = xp.shape[:-3]
        xin = xp.reshape((-1,) + xp.shape[-3:]).permute(0, 3, 1, 2)
        y = F.conv2d(xin, w.permute(3, 2, 0, 1), b, stride=stride)
        return y.permute(0, 2, 3, 1).reshape(lead + (y.shape[2],
                                                     y.shape[3], cout))
    G, B, hp, wp, _ = xp.shape
    xin = xp.permute(1, 0, 4, 2, 3).reshape(B, G * cin, hp, wp)
    wt = w.permute(0, 4, 3, 1, 2).reshape(G * cout, cin, kh, kw)
    y = F.conv2d(xin, wt, b.expand(G, cout).reshape(-1), stride=stride,
                 groups=G)
    oh, ow = y.shape[-2:]
    return y.reshape(B, G, cout, oh, ow).permute(1, 0, 3, 4, 2)


def dense(p, x):
    """x (..., Cin) @ w + b; client-stacked w (G, Cin, Cout) with x
    (G, B, Cin) and b (G, Cout)."""
    b = p["b"] if p["b"].dim() == 1 else p["b"][:, None, :]
    return torch.matmul(x, p["w"].to(x.dtype)) + b.to(x.dtype)


# ---------------------------------------------------------------------------
def _conv_init(gen, kh, kw, cin, cout):
    return {"w": torch.randn((kh, kw, cin, cout), generator=gen)
            / math.sqrt(kh * kw * cin),
            "b": torch.zeros((cout,))}


def _dense_init(gen, cin, cout):
    return {"w": torch.randn((cin, cout), generator=gen) / math.sqrt(cin),
            "b": torch.zeros((cout,))}


def init_params(cfg: CNNConfig, seed: int = 0, device=None) -> Dict:
    """Torch-seeded parent parameters, the reference's tree (``gate``
    leaves included) and scales — N(0, 1/fan_in) weights, zero biases —
    from other random numbers; on ``device`` (the card unless the caller
    asks for the CPU). On ``device="meta"`` it makes the tree's shapes
    and dtypes only (a restore template)."""
    dev = resolve_device(device)
    if dev.type == "meta":          # the draws' factories make meta tensors
        with torch.device(dev):
            return _draw_params(cfg, seed)
    return tree_map(lambda t: t.to(dev), _draw_params(cfg, seed))


def _draw_params(cfg: CNNConfig, seed: int) -> Dict:
    gen = torch.Generator().manual_seed(int(seed))
    p: Dict = {"stem": _conv_init(gen, 3, 3, cfg.in_channels,
                                  cfg.stem_channels)}
    stages = []
    cin = cfg.stem_channels
    for cout, n_blocks in cfg.stages:
        stage = {"down": _conv_init(gen, 3, 3, cin, cout), "blocks": []}
        for _ in range(n_blocks):
            stage["blocks"].append({
                "conv1": _conv_init(gen, 3, 3, cout, cout),
                "conv2": _conv_init(gen, 3, 3, cout, cout),
                "gate": {"fc1": _dense_init(gen, cout, cfg.gate_hidden),
                         "fc2": _dense_init(gen, cfg.gate_hidden, 1)},
            })
        stages.append(stage)
        cin = cout
    p["stages"] = stages
    p["head"] = _dense_init(gen, cin, cfg.n_classes)
    return p


def _conv(p, x, stride=1):
    return conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride)


def _block(bp, x, groups, width_mask=None):
    h = F.relu(groupnorm(_conv(bp["conv1"], x), groups))
    if width_mask is not None:
        h = h * width_mask.to(h.dtype)
    h = groupnorm(_conv(bp["conv2"], h), groups)
    return F.relu(x + h)


def _gate_logit(bp, x):
    """The block's gate logit (B,) from its input: GAP, fc1, ReLU, fc2."""
    feat = torch.mean(x, dim=(-3, -2))
    h = F.relu(dense(bp["gate"]["fc1"], feat))
    return dense(bp["gate"]["fc2"], h)[..., 0]


GATE_MODES = ("off", "soft", "sample", "hard")


def forward(params, cfg: CNNConfig, x, *,
            depth: Optional[Sequence[int]] = None,
            width_masks: Optional[List[torch.Tensor]] = None,
            gate_mode: str = "off",
            gate_uniforms: Optional[Sequence[torch.Tensor]] = None,
            generator: Optional[torch.Generator] = None):
    """Forward of a (sub)model. x (B, H, W, C), or (G, B, H, W, C) with
    client-stacked params. ``depth``: blocks kept per stage (None = all);
    ``width_masks``: per-stage (C,) 0/1 masks on the blocks' hidden
    channels. ``gate_mode``:

    * ``"off"``: every kept block runs (the submodel's structure only);
    * ``"soft"``: expected gating ``x + p·(f(x) − x)`` (supervised warm-up);
    * ``"sample"``: ``b = u < p`` with ``u`` uniform — from
      ``gate_uniforms`` (one tensor of x's batch shape per executed block,
      in order) or drawn from ``generator`` (on x's device);
    * ``"hard"``: ``b = p > 0.5`` (inference).

    Returns (logits, info): ``log_prob`` (batch) the sampled gates'
    summed log-probabilities (zeros unless sampling), ``compute_pct`` the
    mean executed fraction over examples and blocks, ``per_example_compute``
    (batch) each example's."""
    if gate_mode not in GATE_MODES:
        raise ValueError(f"gate_mode must be one of {GATE_MODES}, got "
                         f"{gate_mode!r}")
    if gate_mode == "sample" and gate_uniforms is None and generator is None:
        raise ValueError("gate_mode='sample' needs gate_uniforms or a "
                         "generator")
    draws = iter(gate_uniforms) if gate_uniforms is not None else None
    g = cfg.groupnorm_groups
    x = F.relu(groupnorm(_conv(params["stem"], x), g))
    log_probs, executed = [], []
    for si, stage in enumerate(params["stages"]):
        x = F.relu(groupnorm(_conv(stage["down"], x, stride=2), g))
        keep = cfg.stages[si][1] if depth is None else depth[si]
        wm = None if width_masks is None else width_masks[si]
        for bp in stage["blocks"][:keep]:
            if gate_mode == "off":
                x = _block(bp, x, g, wm)
                continue
            p = torch.sigmoid(_gate_logit(bp, x))
            y = _block(bp, x, g, wm)
            if gate_mode == "soft":
                b = p
            elif gate_mode == "sample":
                u = next(draws) if draws is not None else torch.rand(
                    p.shape, generator=generator, device=p.device)
                b = (u.to(p.device) < p).to(x.dtype)
                log_probs.append(b * torch.log(p + 1e-8)
                                 + (1 - b) * torch.log(1 - p + 1e-8))
            else:
                b = (p > 0.5).to(x.dtype)
            x = x + b[..., None, None, None] * (y - x)
            executed.append(b)
    feat = torch.mean(x, dim=(-3, -2))
    logits = dense(params["head"], feat)
    batch = x.shape[:-3]
    if executed:
        frac = torch.stack(executed, -1)
        info = {"compute_pct": frac.mean(),
                "per_example_compute": frac.mean(-1)}
    else:                       # "off": every kept block ran
        info = {"compute_pct": torch.ones((), device=x.device),
                "per_example_compute": torch.ones(batch, device=x.device)}
    info["log_prob"] = torch.stack(log_probs, -1).sum(-1) if log_probs \
        else torch.zeros(batch, device=x.device)
    return logits, info


def loss_fn(params, cfg: CNNConfig, batch, *, depth=None, width_masks=None,
            gate_mode="off", gate_uniforms=None, generator=None,
            compute_penalty=0.1):
    """The hybrid supervised (+ REINFORCE) objective (§III-C). ``sample``
    adds REINFORCE with reward ``−(ce_i + λ · compute_i)`` (``ce_i``
    detached) and the batch-mean baseline; ``soft`` adds ``λ ·
    compute_pct``. Returns (loss, {"ce", "acc", "compute_pct"})."""
    logits, info = forward(params, cfg, batch["x"], depth=depth,
                           width_masks=width_masks, gate_mode=gate_mode,
                           gate_uniforms=gate_uniforms, generator=generator)
    labels = batch["y"].long()
    lp = F.log_softmax(logits, dim=-1)
    ce_i = -torch.gather(lp, -1, labels[..., None])[..., 0]
    ce = ce_i.mean()
    loss = ce
    if gate_mode == "sample":
        reward = -(ce_i.detach()
                   + compute_penalty * info["per_example_compute"])
        baseline = reward.mean()
        loss = ce + torch.mean(-(reward - baseline) * info["log_prob"])
    elif gate_mode == "soft":
        loss = ce + compute_penalty * info["compute_pct"]
    acc = (torch.argmax(logits, -1) == labels).float().mean()
    return loss, {"ce": ce, "acc": acc, "compute_pct": info["compute_pct"]}


def flops(cfg: CNNConfig, depth=None, widths=None) -> float:
    """Analytic FLOPs of a submodel (latency LUT input)."""
    hw = cfg.image_size * cfg.image_size
    total = 2 * 9 * cfg.in_channels * cfg.stem_channels * hw
    cin = cfg.stem_channels
    for si, (cout, n_blocks) in enumerate(cfg.stages):
        hw = hw // 4
        w = 1.0 if widths is None else widths[si]
        keep = n_blocks if depth is None else depth[si]
        total += 2 * 9 * cin * cout * hw
        total += keep * (2 * 9 * cout * (cout * w) * hw * 2)
        cin = cout
    total += 2 * cin * cfg.n_classes
    return float(total)
