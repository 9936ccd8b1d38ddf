"""Transformer submodel specs: which layers and which width prefixes a
client's submodel keeps (the port of the transformer half of the
reference's ``core/submodel.py``; extract and pad come with the training
slice)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class TransformerSubSpec:
    """Per-segment kept layers + global width fractions.

    layers[i]: tuple of kept layer indices (sorted) within segment i.
    ff_frac: fraction of d_ff kept (prefix).
    expert_frac / ssm_head_frac: MoE / SSM dims (1.0 on dense parents).
    attn_head_frac: fraction of GQA query heads kept (whole groups).
    """
    layers: Tuple[Tuple[int, ...], ...]
    ff_frac: float = 1.0
    expert_frac: float = 1.0
    ssm_head_frac: float = 1.0
    attn_head_frac: float = 1.0

    def genes(self) -> Tuple:
        """Hashable spec identity."""
        return (tuple(tuple(k) for k in self.layers),
                int(round(self.ff_frac * 100)),
                int(round(self.expert_frac * 100)),
                int(round(self.ssm_head_frac * 100)),
                int(round(self.attn_head_frac * 100)))


def full_transformer_spec(cfg: ModelConfig) -> TransformerSubSpec:
    return TransformerSubSpec(
        layers=tuple(tuple(range(s.n_layers)) for s in cfg.segments))


def _round8(x: int) -> int:
    return max(8, (int(x) // 8) * 8)


def transformer_ff(cfg: ModelConfig, frac: float) -> int:
    return _round8(int(cfg.d_ff * frac)) if cfg.d_ff else 0


def transformer_attn_heads(cfg: ModelConfig, frac: float) -> Optional[int]:
    """Kept attention query heads: a multiple of the GQA group size (every
    kept KV head keeps its whole query group), at least one group. None
    when the dim is inapplicable (MLA, or no attention segment)."""
    if cfg.attn_type != "gqa":
        return None
    if not any(s.kind in ("attn", "attn_pair") for s in cfg.segments):
        return None
    g = cfg.n_heads // max(cfg.n_kv_heads, 1)
    return max(g, (int(round(cfg.n_heads * frac)) // g) * g)
