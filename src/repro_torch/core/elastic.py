"""The decode surface of the transformer elastic family.

The port of the serving half of the reference's
``core/elastic.py::TransformerElasticFamily``: the spec algebra a server
needs (``full_spec``, ``random_spec``), the forward masks of a spec
(``decode_masks``) and parent init. Training (masked loss, extract / pad,
coverage masks) comes with a later slice.

``decode_masks`` builds only the forward masks (``ff``, ``heads``,
``depth``), with the values the reference's ``_build_spec_masks`` gives
them. The reference builds them through ``spec_masks``, whose parent-sized
coverage template is about as large as the parent itself at full width;
the port leaves coverage to the training slice.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.submodel import (TransformerSubSpec,
                                       full_transformer_spec,
                                       transformer_attn_heads,
                                       transformer_ff)
from repro_torch.models import transformer as T


class TransformerElasticFamily:
    """Parent-space elastic dims of a dense GQA parent: d_ff prefix
    (``ff_frac``), query-head prefix in whole GQA groups
    (``attn_head_frac``) and per-segment kept layers (depth gates)."""

    name = "transformer"

    def __init__(self, cfg: ModelConfig):
        if cfg.frontend is not None or cfg.encoder_only:
            raise ValueError(
                f"{cfg.name}: frontend/encoder-only archs have no decode "
                "path")
        T.check_supported(cfg)
        self.cfg = cfg

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
            attn_head_frac=(rng.choice(widths) if self._attn_elastic
                            else 1.0))

    def decode_masks(self, spec: TransformerSubSpec) -> Dict:
        """Host (numpy) forward masks of ``spec``: ``ff`` (d_ff,),
        ``heads`` (H,) and ``depth`` (one (n_layers,) per segment)."""
        cfg = self.cfg
        fwd: Dict = {}
        if cfg.d_ff:
            m = np.zeros((cfg.d_ff,), np.float32)
            m[:transformer_ff(cfg, spec.ff_frac)] = 1.0
            fwd["ff"] = m
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

    def init_params(self, seed: int = 0, device="cpu",
                    dtype=torch.float32):
        return T.init_params(self.cfg, seed=seed, device=device, dtype=dtype)


def family_for(cfg) -> TransformerElasticFamily:
    """Resolve a model config (or a family) to its elastic family."""
    if isinstance(cfg, TransformerElasticFamily):
        return cfg
    if isinstance(cfg, ModelConfig):
        return TransformerElasticFamily(cfg)
    raise TypeError(f"no elastic family for {type(cfg).__name__} (the CNN "
                    "family comes with ROADMAP Slice 2)")
