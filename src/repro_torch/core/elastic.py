"""Elastic families: spec algebra, masks, masked compute.

The port of the reference's ``core/elastic.py``, two families:

* ``CNNElasticFamily`` — the paper's parent (§III): per-stage prefix
  channels and prefix depth, with the masked GroupNorm; the spec-space
  surface the control plane runs on (``random_spec``, ``mutate``,
  ``crossover`` for the search, Alg. 1; ``featurize`` for the predictor,
  Alg. 2; ``flops`` / ``param_bytes`` / ``lut_specs`` for the latency
  LUT); ``masked_loss`` / ``masked_metric`` over client-stacked
  parameters, on the dense masked path or through the ``conv`` op of
  ``kernels.dispatch`` (K1 via ``kernels.elastic_conv``); and the
  sequential path's submodel surface (``extract``, ``sub_ctx``,
  ``sub_init_params``, ``sub_logits``, ``sub_loss``, ``sub_metric``,
  ``pad_delta``).
* ``TransformerElasticFamily`` for the zoo's decoder parents — GQA or MLA
  attention, dense or MoE, local / global attention pairs, Mamba2 SSM
  blocks with or without the shared hybrid block (kept whole by every
  submodel: no mask reaches it, every client covers it): the spec
  algebra (``full_spec``, ``minimal_spec``, ``random_spec``), the
  search surface (``mutate``, ``crossover``; ``featurize`` /
  ``feature_dim``; ``flops`` / ``param_bytes`` /
  ``flops_fraction`` / ``lut_specs``, priced on the submodel's analytic
  config, ``core.submodel.sub_transformer_config``), parent init, the
  forward masks of a spec (``decode_masks``, the serving surface), the
  training surface the batched round engine runs on — ``spec_masks``
  (coverage + forward masks, LRU-cached by genes), ``cohort_masks``
  (stacked over clients, on the device) and ``masked_loss`` /
  ``masked_metric`` over client-stacked parameters — and the sequential
  path's surface (``extract`` / ``pad_delta``, ``sub_ctx``,
  ``sub_init_params``, ``sub_logits`` / ``sub_loss`` / ``sub_metric``,
  ``evaluate``). The submodel forward is ``models.transformer.forward``
  on a one-client stack with no kernel table, as the reference's plain
  forward.

Coverage is built per leaf from the spec's prefixes as broadcast factors
(``core.submodel.coverage_factors``): the reference builds it by the
extract → pad round trip on a parent-sized all-ones template, which at
full width is as large as the parent itself. ``grad * mask`` and
``delta * mask`` give the reference's numbers either way.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import OrderedDict
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, flops_per_token
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core.submodel import (SubmodelSpec, TransformerSubSpec,
                                       channels_of, coverage_factors,
                                       extract_cnn, extract_transformer,
                                       full_spec, full_transformer_spec,
                                       mask_cnn, minimal_spec,
                                       minimal_transformer_spec, pad_cnn,
                                       pad_transformer, sub_cnn_config,
                                       sub_transformer_config,
                                       transformer_attn_heads,
                                       transformer_experts,
                                       transformer_ff,
                                       transformer_ssm_heads)
from repro_torch.data.loader import eval_batches
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import cnn
from repro_torch.models import transformer as T
from repro_torch.models.layers import at_least_fp32, groupnorm
from repro_torch.optim.optimizers import tree_map


# ---------------------------------------------------------------------------
# mask containers + the spec-table LRU
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SpecMasks:
    """Per-spec host-side masks: the coverage ``param_mask`` (a tree of
    numpy 0/1 factors, one per parameter leaf, that broadcast to the
    leaf's shape) + the family's forward-mask tree."""
    param_mask: Any
    fwd: Any


@dataclasses.dataclass
class CohortMasks:
    """Stacked (G, ...) device masks for one cohort."""
    param_mask: Any
    fwd: Any


class SpecLRU(OrderedDict):
    """Bounded LRU keyed by ``genes()``: identical specs reuse their mask
    tables instead of rebuilding them every round."""

    def __init__(self, maxsize: int = 128):
        super().__init__()
        self.maxsize = maxsize

    def get_or_build(self, key, build: Callable):
        if key in self:
            self.move_to_end(key)
            return self[key]
        val = build()
        self[key] = val
        while len(self) > self.maxsize:
            self.popitem(last=False)
        return val


def _stack(trees, device):
    """Stack same-shaped trees of numpy arrays along a new leading client
    axis, as tensors on ``device``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], device) for k in first}
    if isinstance(first, (list, tuple)):
        out = [_stack([t[i] for t in trees], device)
               for i in range(len(first))]
        return out if isinstance(first, list) else tuple(out)
    return torch.as_tensor(np.stack(trees), device=device)


# ---------------------------------------------------------------------------
# per-sample statistics of the LM objective
# ---------------------------------------------------------------------------
def _weighted_mean(values, weights):
    """Per-sample statistic (..., B) -> weighted mean over B
    (0-weight-safe)."""
    return torch.sum(values * weights, dim=-1) / torch.clamp(
        torch.sum(weights, dim=-1), min=1.0)


def _lm_per_sample_ce(logits, tokens):
    """Mean next-token CE per sequence. logits (..., S, V); tokens
    (..., S) -> (...)."""
    lp = F.log_softmax(at_least_fp32(logits), dim=-1)
    tgt = tokens[..., 1:].long()
    ce = -torch.gather(lp[..., :-1, :], -1, tgt[..., None])[..., 0]
    return torch.mean(ce, dim=-1)


def _lm_per_sample_acc(logits, tokens):
    pred = torch.argmax(logits[..., :-1, :], dim=-1)
    return torch.mean((pred == tokens[..., 1:].long()).float(), dim=-1)


class TransformerElasticFamily:
    """Parent-space elastic dims of a decoder parent: d_ff prefix
    (``ff_frac``), routed-expert prefix on MoE parents (``expert_frac``:
    the router masks the suffix, the grouped matmul skips it), SSD-head
    prefix on SSM parents (``ssm_head_frac``: the scan skips the suffix),
    query-head prefix in whole GQA groups on parents with GQA attention
    segments (``attn_head_frac``) and
    per-segment kept layers (depth gates).

    ``seq_len``: tokens per sample in the latency cost model (and the
    synthetic LM population's sequence length)."""

    name = "transformer"

    def __init__(self, cfg: ModelConfig, seq_len: int = 32):
        if cfg.frontend is not None or cfg.encoder_only:
            raise ValueError(
                f"{cfg.name}: frontend/encoder-only archs have no token "
                "cohort packing — the CFL engine supports decoder LMs")
        self.cfg = cfg
        self.seq_len = seq_len
        self._spec_cache = SpecLRU(128)
        self._full_flops = None

    @property
    def supports_decode(self) -> bool:
        return True

    @property
    def _attn_elastic(self) -> bool:
        return transformer_attn_heads(self.cfg, 1.0) is not None

    # -- spec algebra ------------------------------------------------------
    def full_spec(self) -> TransformerSubSpec:
        return full_transformer_spec(self.cfg)

    def minimal_spec(self) -> TransformerSubSpec:
        """One kept layer per segment, the smallest width on every elastic
        dim — the fallback when a latency bound admits nothing else."""
        return minimal_transformer_spec(self.cfg)

    def random_spec(self, rng) -> TransformerSubSpec:
        """Feasible random spec drawn with ``rng`` (``random.Random``): ≥1
        kept layer per segment, widths from the config's elastic grid —
        the same draws, in the same order, as the reference."""
        cfg = self.cfg
        layers = []
        for seg in cfg.segments:
            k = rng.randint(1, seg.n_layers)
            layers.append(tuple(sorted(rng.sample(range(seg.n_layers), k))))
        widths = cfg.elastic_widths
        return TransformerSubSpec(
            layers=tuple(layers),
            ff_frac=rng.choice(widths),
            expert_frac=rng.choice(widths) if cfg.moe is not None else 1.0,
            ssm_head_frac=rng.choice(widths) if cfg.ssm is not None else 1.0,
            attn_head_frac=(rng.choice(widths) if self._attn_elastic
                            else 1.0))

    def genes(self, spec: TransformerSubSpec):
        return spec.genes()

    # -- spec-space surface: genetic search (Alg. 1) -----------------------
    def mutate(self, spec: TransformerSubSpec, rng,
               p: float) -> TransformerSubSpec:
        """Independently resample each segment's kept layers and each
        applicable width with probability ``p`` (the reference's draws, in
        its order)."""
        cfg = self.cfg
        layers = list(spec.layers)
        for i, seg in enumerate(cfg.segments):
            if rng.random() < p:
                k = rng.randint(1, seg.n_layers)
                layers[i] = tuple(sorted(rng.sample(range(seg.n_layers), k)))
        widths = cfg.elastic_widths
        ff = rng.choice(widths) if rng.random() < p else spec.ff_frac
        ex = spec.expert_frac
        if cfg.moe is not None and rng.random() < p:
            ex = rng.choice(widths)
        sh = spec.ssm_head_frac
        if cfg.ssm is not None and rng.random() < p:
            sh = rng.choice(widths)
        ah = spec.attn_head_frac
        if self._attn_elastic and rng.random() < p:
            ah = rng.choice(widths)
        return TransformerSubSpec(tuple(layers), ff, ex, sh, ah)

    def crossover(self, a: TransformerSubSpec, b: TransformerSubSpec,
                  rng) -> TransformerSubSpec:
        """Uniform per-gene crossover (a segment's kept layers are one
        gene)."""
        layers = tuple(rng.choice([x, y])
                       for x, y in zip(a.layers, b.layers))
        return TransformerSubSpec(
            layers,
            ff_frac=rng.choice([a.ff_frac, b.ff_frac]),
            expert_frac=rng.choice([a.expert_frac, b.expert_frac]),
            ssm_head_frac=rng.choice([a.ssm_head_frac, b.ssm_head_frac]),
            attn_head_frac=rng.choice([a.attn_head_frac, b.attn_head_frac]))

    # -- spec-space surface: predictor features (Alg. 2) -------------------
    def featurize(self, spec: TransformerSubSpec) -> np.ndarray:
        """Kept-layer fraction per segment, the four width fractions, then
        the FLOPs fraction."""
        cfg = self.cfg
        depth_f = [len(keep) / seg.n_layers
                   for seg, keep in zip(cfg.segments, spec.layers)]
        width_f = [spec.ff_frac, spec.expert_frac, spec.ssm_head_frac,
                   spec.attn_head_frac]
        return np.asarray(depth_f + width_f + [self.flops_fraction(spec)],
                          np.float32)

    @property
    def feature_dim(self) -> int:
        return len(self.cfg.segments) + 5

    # -- spec-space surface: cost model (latency LUT input) ----------------
    def flops(self, spec: TransformerSubSpec) -> float:
        """Analytic forward FLOPs of one ``seq_len``-token sample of the
        spec's submodel."""
        sub_cfg = sub_transformer_config(self.cfg, spec)
        return float(flops_per_token(sub_cfg, self.seq_len) * self.seq_len)

    def param_bytes(self, spec: TransformerSubSpec,
                    bytes_per_param: int = 4) -> float:
        sub_cfg = sub_transformer_config(self.cfg, spec)
        return float(sub_cfg.param_count() * bytes_per_param)

    def flops_fraction(self, spec: TransformerSubSpec) -> float:
        """spec FLOPs / full-parent FLOPs (cached denominator)."""
        if self._full_flops is None:
            self._full_flops = self.flops(self.full_spec())
        return self.flops(spec) / self._full_flops

    def lut_specs(self, depth_choices=None):
        """Nothing to pre-tabulate: layer subsets are combinatorial, so the
        latency LUT fills lazily on lookup."""
        del depth_choices
        return ()

    def decode_masks(self, spec: TransformerSubSpec) -> Dict:
        """Host (numpy) forward masks of ``spec``: ``ff`` (d_ff,),
        ``experts`` (E,) on MoE parents, ``ssm_heads`` (H_ssm,) on SSM
        parents, ``heads`` (H,) and ``depth`` (one (n_layers,) per segment)
        — the values the reference's ``_build_spec_masks`` gives them
        (all-ones at frac 1.0, so every cohort member's tree matches)."""
        cfg = self.cfg
        fwd: Dict = {}
        if cfg.d_ff:
            m = np.zeros((cfg.d_ff,), np.float32)
            m[:transformer_ff(cfg, spec.ff_frac)] = 1.0
            fwd["ff"] = m
        if cfg.moe is not None:
            m = np.zeros((cfg.moe.n_experts,), np.float32)
            m[:transformer_experts(cfg, spec.expert_frac)] = 1.0
            fwd["experts"] = m
        if cfg.ssm is not None:
            nh = cfg.ssm.n_heads(cfg.d_model)
            keep = (nh if spec.ssm_head_frac >= 1.0
                    else transformer_ssm_heads(cfg, spec.ssm_head_frac))
            m = np.zeros((nh,), np.float32)
            m[:keep] = 1.0
            fwd["ssm_heads"] = m
        if self._attn_elastic:
            ah = (cfg.n_heads if spec.attn_head_frac >= 1.0
                  else transformer_attn_heads(cfg, spec.attn_head_frac))
            m = np.zeros((cfg.n_heads,), np.float32)
            m[:ah] = 1.0
            fwd["heads"] = m
        depth = []
        for seg, keep in zip(cfg.segments, spec.layers):
            dm = np.zeros((seg.n_layers,), np.float32)
            dm[np.asarray(keep, np.int64)] = 1.0
            depth.append(dm)
        fwd["depth"] = tuple(depth)
        return fwd

    def init_params(self, seed: int = 0, device=None,
                    dtype=torch.float32):
        """Torch-seeded parent parameters on ``device`` (the card unless
        the caller asks for the CPU)."""
        return T.init_params(self.cfg, seed=seed,
                             device=resolve_device(device), dtype=dtype)

    # -- masks (spec table, LRU by genes) ----------------------------------
    def spec_masks(self, spec: TransformerSubSpec) -> SpecMasks:
        """Coverage factors and forward masks of ``spec`` (host numpy),
        built once per distinct ``genes()``."""
        return self._spec_cache.get_or_build(
            self.genes(spec), lambda: self._build_spec_masks(spec))

    def _build_spec_masks(self, spec: TransformerSubSpec) -> SpecMasks:
        return SpecMasks(
            coverage_factors(self.cfg, spec, T.param_shapes(self.cfg)),
            self.decode_masks(spec))

    def cohort_masks(self, specs: Sequence[TransformerSubSpec],
                     device=None) -> CohortMasks:
        """Stack per-spec masks along a leading client axis on ``device``
        (the card unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        per = [self.spec_masks(s) for s in specs]
        return CohortMasks(_stack([p.param_mask for p in per], dev),
                           _stack([p.fwd for p in per], dev))

    # -- parent-space masked compute over client-stacked params ------------
    def masked_logits(self, params, fwd, x, kernels=None):
        """Logits (G, B, S, V) of each client's masked submodel in parent
        coordinates: the cohort forward on client-stacked ``params`` and
        ``fwd`` with the caller's kernel table (the distillation teacher
        runs it on a one-client stack); x (G, B, S) tokens."""
        return T.forward(params, self.cfg, x, masks=fwd, kernels=kernels)

    def masked_loss(self, params, fwd, x, y, sample_weight, kernels=None):
        """Per-client training loss (G,) of each client's masked submodel
        in parent coordinates: ``params`` and ``fwd`` client-stacked, x
        (G, B, S) tokens, ``sample_weight`` (G, B) 0/1. ``kernels``: an op
        table (``kernels.dispatch``) or None for the dense masked path."""
        del y                                   # targets come from tokens
        logits = self.masked_logits(params, fwd, x, kernels)
        return _weighted_mean(_lm_per_sample_ce(logits, x), sample_weight)

    def masked_metric(self, params, fwd, x, y, valid, kernels=None):
        """Per-client next-token accuracy (G,) over the ``valid`` (G, B)
        sequences; same contract as :meth:`masked_loss`."""
        del y
        logits = self.masked_logits(params, fwd, x, kernels)
        return _weighted_mean(_lm_per_sample_acc(logits, x), valid)

    # -- the sequential path's surface (extract -> train -> pad) -----------
    def sub_ctx(self, spec) -> ModelConfig:
        """The submodel's own config (``sub_transformer_config``)."""
        return sub_transformer_config(self.cfg, spec)

    def sub_init_params(self, seed: int, spec, device=None):
        """Torch-seeded parameters of the submodel alone, as
        ``init_params`` draws the parent's, on ``device`` (the card unless
        the caller asks for the CPU)."""
        return T.init_params(self.sub_ctx(spec), seed=seed,
                             device=resolve_device(device))

    def extract(self, params, spec):
        """(sub_params, sub_cfg): the submodel's slices of the parent."""
        return extract_transformer(params, self.cfg, spec)

    def pad_delta(self, delta, parent_template, spec):
        """A submodel update zero-padded to parent coordinates."""
        return pad_transformer(delta, parent_template, self.cfg, spec)

    def sub_logits(self, sub_params, sub_cfg, x):
        """Logits (B, S, V) of an extracted (unstacked) submodel on tokens
        x (B, S): the cohort forward on a one-client stack, with no kernel
        table (the plain forward)."""
        one = tree_map(lambda t: t.unsqueeze(0), sub_params)
        return T.forward(one, sub_cfg, x.long().unsqueeze(0))[0]

    def sub_loss(self, sub_params, sub_cfg, x, y, sample_weight):
        """Weighted next-token CE of an extracted submodel over the (B,)
        sequences."""
        del y
        return _weighted_mean(
            _lm_per_sample_ce(self.sub_logits(sub_params, sub_cfg, x), x),
            sample_weight)

    def sub_metric(self, sub_params, sub_cfg, x, y, valid):
        """Next-token accuracy of an extracted submodel over the ``valid``
        (B,) sequences."""
        del y
        return _weighted_mean(
            _lm_per_sample_acc(self.sub_logits(sub_params, sub_cfg, x), x),
            valid)

    def evaluate(self, params, data: Dict, batch_size: int = 128) -> float:
        """Full-parent next-token accuracy on one dataset (the server's
        global metric, IL's on the sequential trainer), in batches."""
        return _evaluate(self, params, params["embed"]["table"].device,
                         data, batch_size)


def _evaluate(fam, params, dev, data: Dict, batch_size: int) -> float:
    """``fam``'s full-parent ``sub_metric`` over ``data`` in batches of
    ``batch_size``, weighted by batch size."""
    num = den = 0.0
    with torch.no_grad():
        for b in eval_batches(data, batch_size):
            n = len(b["y"])
            acc = float(fam.sub_metric(
                params, fam.cfg, torch.as_tensor(b["x"], device=dev),
                torch.as_tensor(b["y"], device=dev),
                torch.ones((n,), device=dev)))
            num += acc * n
            den += n
    return num / max(den, 1.0)


# ===========================================================================
# CNN family (the paper's parent)
# ===========================================================================
def _weighted_ce(logits, y, sample_weight):
    """Per-client weighted CE (G,) of logits (G, B, C), labels (G, B)."""
    lp = F.log_softmax(at_least_fp32(logits), dim=-1)
    ce = -torch.gather(lp, -1, y.long()[..., None])[..., 0]
    return _weighted_mean(ce, sample_weight)


def _weighted_acc(logits, y, valid):
    hit = (torch.argmax(logits, -1) == y.long()).float()
    return _weighted_mean(hit, valid)


def _conv(p, x, stride=1):
    """The dense SAME conv of client-stacked params (``models.cnn``)."""
    return cnn.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride)


def _masked_groupnorm(x, A, eps=1e-5):
    """GroupNorm over *active* channels with the submodel's grouping.

    x (G, B, H, W, C) with inactive channels already zeroed; A (G, C, q)
    the masked one-hot: A[g, c, j] = 1 iff channel c is active in client
    g's submodel and that submodel puts it in group j. Inactive channels
    have all-zero rows, which both keeps them out of the statistics and
    re-zeroes them in the output (their mean and inverse std broadcast back
    as 0). Equal to ``models.layers.groupnorm`` on the active prefix."""
    h, w = x.shape[2:4]
    x32 = at_least_fp32(x)
    A = A.to(x32.dtype)
    n = h * w * torch.clamp(A.sum(1), min=1.0)            # (G, q)
    mu_g = torch.einsum("gbhwc,gcq->gbq", x32, A) / n[:, None, :]
    mu_c = torch.einsum("gcq,gbq->gbc", A, mu_g)
    d = x32 - mu_c[:, :, None, None, :]
    var_g = torch.einsum("gbhwc,gcq->gbq", d * d, A) / n[:, None, :]
    inv_c = torch.einsum("gcq,gbq->gbc", A, torch.rsqrt(var_g + eps))
    return (d * inv_c[:, :, None, None, :]).to(x.dtype)


def masked_forward(params, cfg: CNNConfig, x, ch_masks, gn_assign,
                   depth_masks, kernels=None):
    """Parent-shape forward of every client's submodel at once, equal to
    each extracted submodel's forward.

    ``params`` client-stacked (G, ...); x (G, B, H, W, Cin); per stage s:
    ch_masks[s] (G, C_s) 0/1 channels, gn_assign[s] (G, C_s, q) the masked
    one-hot GroupNorm assignment, depth_masks[s] (G, n_blocks_s) 0/1.

    ``kernels``: None (the dense masked path: full-channel convolutions
    times 0/1) or the ``"cnn"`` op table of ``kernels.dispatch`` — every
    stage conv then runs as an im2col ``elastic_dense`` product (K1) that
    skips input channels past the previous stage's prefix and output
    channels past this stage's, with (G,) int32 prefixes derived from the
    masks on the device. The stem (its full input and output channels are
    every submodel's) stays a plain convolution on both paths, as in the
    reference. A dropped block still runs (its output is multiplied by
    its depth gate 0), so the launches do not depend on the specs."""
    conv_op = None if kernels is None else kernels.get("conv")
    g = cfg.groupnorm_groups
    x = F.relu(groupnorm(_conv(params["stem"], x), g))
    cin_active = None            # stem output: every channel active
    for si, stage in enumerate(params["stages"]):
        m = ch_masks[si].to(x.dtype)[:, None, None, None, :]
        A = gn_assign[si]
        if conv_op is None:
            c_act = None
            x = _conv(stage["down"], x, stride=2) * m
        else:
            c_act = (ch_masks[si] > 0).sum(-1).to(torch.int32)
            x = conv_op(stage["down"], x, 2, cin_active, c_act)
        x = F.relu(_masked_groupnorm(x, A))
        for bi, bp in enumerate(stage["blocks"]):
            d = depth_masks[si][:, bi].to(x.dtype)[:, None, None, None, None]
            if conv_op is None:
                h = _conv(bp["conv1"], x) * m
            else:
                h = conv_op(bp["conv1"], x, 1, c_act, c_act)
            h = F.relu(_masked_groupnorm(h, A))
            if conv_op is None:
                h = _conv(bp["conv2"], h) * m
            else:
                h = conv_op(bp["conv2"], h, 1, c_act, c_act)
            h = _masked_groupnorm(h, A)
            # depth skip: x >= 0 after the ReLU, so relu(x + 0) == x exactly
            x = F.relu(x + d * h)
        cin_active = c_act
    return cnn.dense(params["head"], torch.mean(x, dim=(-3, -2)))


class CNNElasticFamily:
    """The paper's elastic CNN: per-stage prefix channels + prefix depth."""

    name = "cnn"

    def __init__(self, cfg: CNNConfig):
        self.cfg = cfg
        self._spec_cache = SpecLRU(128)
        self._full_flops = None

    @property
    def supports_decode(self) -> bool:
        return False

    # -- spec algebra ------------------------------------------------------
    def full_spec(self) -> SubmodelSpec:
        return full_spec(self.cfg)

    def minimal_spec(self) -> SubmodelSpec:
        return minimal_spec(self.cfg)

    def random_spec(self, rng) -> SubmodelSpec:
        """A feasible random spec drawn with ``rng`` (``random.Random``) —
        the same draws, in the same order, as the reference."""
        depth = tuple(rng.randint(1, b) for _, b in self.cfg.stages)
        width = tuple(rng.choice(self.cfg.elastic_widths)
                      for _ in self.cfg.stages)
        return SubmodelSpec(depth=depth, width=width)

    def genes(self, spec: SubmodelSpec):
        return spec.genes()

    # -- spec-space surface: genetic search (Alg. 1) -----------------------
    def mutate(self, spec: SubmodelSpec, rng, p: float) -> SubmodelSpec:
        """Independently resample each gene with probability ``p``."""
        depth = list(spec.depth)
        width = list(spec.width)
        for s, (_, bmax) in enumerate(self.cfg.stages):
            if rng.random() < p:
                depth[s] = rng.randint(1, bmax)
            if rng.random() < p:
                width[s] = rng.choice(self.cfg.elastic_widths)
        return SubmodelSpec(tuple(depth), tuple(width))

    def crossover(self, a: SubmodelSpec, b: SubmodelSpec,
                  rng) -> SubmodelSpec:
        """Uniform per-gene crossover of two specs."""
        depth = tuple(rng.choice([x, y]) for x, y in zip(a.depth, b.depth))
        width = tuple(rng.choice([x, y]) for x, y in zip(a.width, b.width))
        return SubmodelSpec(depth, width)

    # -- spec-space surface: predictor features (Alg. 2) -------------------
    def featurize(self, spec: SubmodelSpec) -> np.ndarray:
        """Depth and width fractions per stage, then the FLOPs fraction."""
        cfg = self.cfg
        depth_f = [spec.depth[s] / cfg.stages[s][1]
                   for s in range(len(cfg.stages))]
        return np.asarray(depth_f + list(spec.width)
                          + [self.flops_fraction(spec)], np.float32)

    @property
    def feature_dim(self) -> int:
        return 2 * len(self.cfg.stages) + 1

    # -- spec-space surface: cost model (latency LUT input) ----------------
    def flops(self, spec: SubmodelSpec) -> float:
        return cnn.flops(self.cfg, depth=spec.depth, widths=spec.width)

    def param_bytes(self, spec: SubmodelSpec,
                    bytes_per_param: int = 4) -> float:
        cfg = self.cfg
        total = 9 * cfg.in_channels * cfg.stem_channels
        cin = cfg.stem_channels
        for si in range(len(cfg.stages)):
            c = channels_of(cfg, si, spec.width[si])
            total += 9 * cin * c
            total += spec.depth[si] * 2 * 9 * c * c
            cin = c
        total += cin * cfg.n_classes
        return float(total * bytes_per_param)

    def flops_fraction(self, spec: SubmodelSpec) -> float:
        """spec FLOPs / full-parent FLOPs (cached denominator)."""
        if self._full_flops is None:
            self._full_flops = self.flops(self.full_spec())
        return self.flops(spec) / self._full_flops

    def lut_specs(self, depth_choices=None):
        """The depth × width grid the latency LUT tabulates offline."""
        cfg = self.cfg
        if depth_choices is not None:
            ranges = [tuple(depth_choices)] * len(cfg.stages)
        else:
            ranges = [tuple(range(1, b + 1)) for _, b in cfg.stages]
        for depth in itertools.product(*ranges):
            for width in itertools.product(cfg.elastic_widths,
                                           repeat=len(cfg.stages)):
                yield SubmodelSpec(depth=depth, width=width)

    # -- parent-model lifecycle --------------------------------------------
    def init_params(self, seed: int = 0, device=None):
        """Torch-seeded parent parameters on ``device`` (the card unless
        the caller asks for the CPU)."""
        return cnn.init_params(self.cfg, seed=seed, device=device)

    # -- the sequential path's surface (extract -> train -> pad) -----------
    def sub_ctx(self, spec) -> CNNConfig:
        """The submodel's own config: the kept channels and blocks."""
        return sub_cnn_config(self.cfg, spec)

    def sub_init_params(self, seed: int, spec, device=None):
        """Torch-seeded parameters of the submodel alone, as
        ``init_params`` draws the parent's."""
        return cnn.init_params(self.sub_ctx(spec), seed=seed, device=device)

    def extract(self, params, spec):
        """(sub_params, sub_cfg): the submodel's slices of the parent."""
        return (extract_cnn(params, self.cfg, spec),
                sub_cnn_config(self.cfg, spec))

    def pad_delta(self, delta, parent_template, spec):
        """A submodel update zero-padded to the parent's shape (Alg. 3)."""
        return pad_cnn(delta, parent_template, self.cfg, spec)

    def sub_logits(self, sub_params, sub_cfg, x):
        """Logits of an extracted (unstacked) submodel on x (B, H, W, C)."""
        logits, _ = cnn.forward(sub_params, sub_cfg, x)
        return logits

    def sub_loss(self, sub_params, sub_cfg, x, y, sample_weight):
        """Weighted CE of an extracted submodel over the (B,) batch."""
        return _weighted_ce(self.sub_logits(sub_params, sub_cfg, x), y,
                            sample_weight)

    def sub_metric(self, sub_params, sub_cfg, x, y, valid):
        """Accuracy of an extracted (unstacked) submodel on x (B, H, W, C)
        over the ``valid`` (B,) samples."""
        return _weighted_acc(self.sub_logits(sub_params, sub_cfg, x), y,
                             valid)

    def evaluate(self, params, data: Dict, batch_size: int = 128) -> float:
        """Full-parent accuracy on one dataset (the server's global
        metric), in batches."""
        return _evaluate(self, params, params["stem"]["w"].device, data,
                         batch_size)

    # -- masks (spec table, LRU by genes) ----------------------------------
    def spec_masks(self, spec: SubmodelSpec) -> SpecMasks:
        """``mask_cnn`` coverage and the forward masks of ``spec`` (host
        numpy), built once per distinct ``genes()``."""
        return self._spec_cache.get_or_build(
            self.genes(spec), lambda: self._build_spec_masks(spec))

    def _build_spec_masks(self, spec: SubmodelSpec) -> SpecMasks:
        cfg = self.cfg
        g = cfg.groupnorm_groups
        ch, gn, de = [], [], []
        for si, (cmax, n_blocks) in enumerate(cfg.stages):
            c = channels_of(cfg, si, spec.width[si])
            cm = np.zeros((cmax,), np.float32)
            cm[:c] = 1.0
            A = np.zeros((cmax, g), np.float32)
            A[np.arange(c), np.arange(c) // (c // g)] = 1.0  # submodel groups
            dm = np.zeros((n_blocks,), np.float32)
            dm[:spec.depth[si]] = 1.0
            ch.append(cm)
            gn.append(A)
            de.append(dm)
        return SpecMasks(mask_cnn(cfg, spec),
                         {"ch": ch, "gn": gn, "depth": de})

    def cohort_masks(self, specs: Sequence[SubmodelSpec],
                     device=None) -> CohortMasks:
        """Stack per-spec masks along a leading client axis on ``device``
        (the card unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        per = [self.spec_masks(s) for s in specs]
        return CohortMasks(_stack([p.param_mask for p in per], dev),
                           _stack([p.fwd for p in per], dev))

    # -- parent-space masked compute over client-stacked params ------------
    def masked_logits(self, params, fwd, x, kernels=None):
        """Logits (G, B, classes) of each client's masked submodel in
        parent coordinates (client-stacked ``params`` and ``fwd``; x
        (G, B, H, W, C))."""
        return masked_forward(params, self.cfg, x, fwd["ch"], fwd["gn"],
                              fwd["depth"], kernels=kernels)

    def masked_loss(self, params, fwd, x, y, sample_weight, kernels=None):
        """Per-client training CE (G,) of each client's masked submodel:
        ``params`` and ``fwd`` client-stacked, x (G, B, H, W, C) images,
        y (G, B) labels, ``sample_weight`` (G, B) 0/1. ``kernels``: the
        ``"cnn"`` op table or None for the dense masked path."""
        return _weighted_ce(self.masked_logits(params, fwd, x, kernels), y,
                            sample_weight)

    def masked_metric(self, params, fwd, x, y, valid, kernels=None):
        """Per-client accuracy (G,) over the ``valid`` (G, B) samples; same
        contract as :meth:`masked_loss`."""
        return _weighted_acc(self.masked_logits(params, fwd, x, kernels), y,
                             valid)


def family_for(cfg):
    """Resolve a model config (or a family) to its elastic family."""
    if isinstance(cfg, (TransformerElasticFamily, CNNElasticFamily)):
        return cfg
    if isinstance(cfg, CNNConfig):
        return CNNElasticFamily(cfg)
    if isinstance(cfg, ModelConfig):
        return TransformerElasticFamily(cfg)
    raise TypeError(f"no elastic family for {type(cfg).__name__}")
