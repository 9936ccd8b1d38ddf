"""The transformer elastic family: spec algebra, masks, masked compute.

The port of the reference's ``core/elastic.py::TransformerElasticFamily``
for GQA parents, dense or MoE, and Mamba2 SSM parents: the spec algebra
(``full_spec``, ``random_spec``), parent init, the forward masks of a
spec (``decode_masks``, the serving surface), and the training surface
the batched round engine runs on —
``spec_masks`` (coverage + forward masks, LRU-cached by genes),
``cohort_masks`` (stacked over clients, on the device) and
``masked_loss`` / ``masked_metric`` over client-stacked parameters.

Coverage is built per leaf from the spec's prefixes as broadcast factors
(``core.submodel.coverage_factors``): the reference builds it by the
extract → pad round trip on a parent-sized all-ones template, which at
full width is as large as the parent itself. ``grad * mask`` and
``delta * mask`` give the reference's numbers either way.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.submodel import (TransformerSubSpec,
                                       coverage_factors,
                                       full_transformer_spec,
                                       transformer_attn_heads,
                                       transformer_experts,
                                       transformer_ff,
                                       transformer_ssm_heads)
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as T


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
    lp = F.log_softmax(logits.float(), dim=-1)
    tgt = tokens[..., 1:].long()
    ce = -torch.gather(lp[..., :-1, :], -1, tgt[..., None])[..., 0]
    return torch.mean(ce, dim=-1)


def _lm_per_sample_acc(logits, tokens):
    pred = torch.argmax(logits[..., :-1, :], dim=-1)
    return torch.mean((pred == tokens[..., 1:].long()).float(), dim=-1)


class TransformerElasticFamily:
    """Parent-space elastic dims of a GQA or SSM parent: d_ff prefix
    (``ff_frac``), routed-expert prefix on MoE parents (``expert_frac``:
    the router masks the suffix, the grouped matmul skips it), SSD-head
    prefix on SSM parents (``ssm_head_frac``: the scan skips the suffix),
    query-head prefix in whole GQA groups (``attn_head_frac``) and
    per-segment kept layers (depth gates)."""

    name = "transformer"

    def __init__(self, cfg: ModelConfig):
        if cfg.frontend is not None or cfg.encoder_only:
            raise ValueError(
                f"{cfg.name}: frontend/encoder-only archs have no decode "
                "path")
        T.check_supported(cfg)
        self.cfg = cfg
        self._spec_cache = SpecLRU(128)

    @property
    def supports_decode(self) -> bool:
        return True

    @property
    def _attn_elastic(self) -> bool:
        return transformer_attn_heads(self.cfg, 1.0) is not None

    def full_spec(self) -> TransformerSubSpec:
        return full_transformer_spec(self.cfg)

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
    def masked_loss(self, params, fwd, x, y, sample_weight, kernels=None):
        """Per-client training loss (G,) of each client's masked submodel
        in parent coordinates: ``params`` and ``fwd`` client-stacked, x
        (G, B, S) tokens, ``sample_weight`` (G, B) 0/1. ``kernels``: an op
        table (``kernels.dispatch``) or None for the dense masked path."""
        del y                                   # targets come from tokens
        logits = T.forward(params, self.cfg, x, masks=fwd, kernels=kernels)
        return _weighted_mean(_lm_per_sample_ce(logits, x), sample_weight)

    def masked_metric(self, params, fwd, x, y, valid, kernels=None):
        """Per-client next-token accuracy (G,) over the ``valid`` (G, B)
        sequences; same contract as :meth:`masked_loss`."""
        del y
        logits = T.forward(params, self.cfg, x, masks=fwd, kernels=kernels)
        return _weighted_mean(_lm_per_sample_acc(logits, x), valid)


def family_for(cfg) -> TransformerElasticFamily:
    """Resolve a model config (or a family) to its elastic family."""
    if isinstance(cfg, TransformerElasticFamily):
        return cfg
    if isinstance(cfg, ModelConfig):
        return TransformerElasticFamily(cfg)
    raise TypeError(f"no elastic family for {type(cfg).__name__} (the CNN "
                    "family comes with ROADMAP A4)")
