"""Submodel specs: which part of a parent a client's submodel keeps,
and which parent entries it covers — the port of the reference's
``core/submodel.py``.

Two parent families:

* the paper's elastic CNN (per-stage prefix depth + prefix width):
  ``SubmodelSpec``, ``channels_of``, ``extract_cnn`` / ``pad_cnn`` (the
  sequential extract → train → pad path's slicing and its zero-pad
  alignment, Alg. 3), ``coverage_cnn`` (that round trip on all-ones) and
  ``mask_cnn`` (the same coverage built directly, host numpy);
* the transformer / SSM zoo: ``TransformerSubSpec``,
  ``minimal_transformer_spec``, ``sub_transformer_config`` (the
  submodel's config, analytic), ``extract_transformer`` /
  ``pad_transformer`` (the sequential path's slicing — kept layers by
  ``index_select``, d_ff / routed experts / query heads / SSD heads as
  prefixes by ``narrow`` on axes addressed from the back — and its
  zero-pad alignment by ``index_copy_`` on the layer axis). Coverage is
  the extract → pad round trip on an all-ones parent: 1 on every parent
  entry the submodel trains, 0 elsewhere. The port builds it per leaf
  from the prefixes, as factors — one 0/1 vector per masked axis (kept
  layers, kept d_ff columns, kept routed experts, kept attention heads,
  kept SSD heads), size-1 axes elsewhere — whose broadcast product is the
  round trip's mask, so no parent-sized template is ever made. An
  ``attn_pair`` segment's ``local`` and ``global`` trees are sliced,
  padded and covered alike, on the same kept pairs; the shared hybrid
  block (``shared_attn``) is kept whole by every submodel and covered by
  every client.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.optim.optimizers import tree_map


# ===========================================================================
# CNN parent (the paper's)
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class SubmodelSpec:
    """depth[s] = blocks kept in stage s; width[s] = channel fraction."""
    depth: Tuple[int, ...]
    width: Tuple[float, ...]

    def genes(self) -> Tuple[int, ...]:
        return self.depth + tuple(int(w * 100) for w in self.width)


def full_spec(cfg: CNNConfig) -> SubmodelSpec:
    return SubmodelSpec(depth=tuple(b for _, b in cfg.stages),
                        width=tuple(1.0 for _ in cfg.stages))


def minimal_spec(cfg: CNNConfig) -> SubmodelSpec:
    """The smallest expressible submodel — the deterministic fallback when
    a latency bound admits nothing else."""
    return SubmodelSpec(depth=tuple(1 for _ in cfg.stages),
                        width=tuple(min(cfg.elastic_widths)
                                    for _ in cfg.stages))


def channels_of(cfg: CNNConfig, stage: int, frac: float) -> int:
    c = cfg.stages[stage][0]
    g = cfg.groupnorm_groups
    return max(g, int(round(c * frac / g)) * g)


def extract_cnn(params: Dict, cfg: CNNConfig, spec: SubmodelSpec) -> Dict:
    """Slice parent params down to the submodel (prefix channels, prefix
    blocks); the leaves are views of the parent's."""
    out = {"stem": params["stem"], "head": None, "stages": []}
    cin_prev = cfg.stem_channels
    for si, stage in enumerate(params["stages"]):
        c = channels_of(cfg, si, spec.width[si])
        sub = {"down": {"w": stage["down"]["w"][:, :, :cin_prev, :c],
                        "b": stage["down"]["b"][:c]},
               "blocks": []}
        for bi in range(spec.depth[si]):
            bp = stage["blocks"][bi]
            sub["blocks"].append({
                "conv1": {"w": bp["conv1"]["w"][:, :, :c, :c],
                          "b": bp["conv1"]["b"][:c]},
                "conv2": {"w": bp["conv2"]["w"][:, :, :c, :c],
                          "b": bp["conv2"]["b"][:c]},
                "gate": {"fc1": {"w": bp["gate"]["fc1"]["w"][:c, :],
                                 "b": bp["gate"]["fc1"]["b"]},
                         "fc2": bp["gate"]["fc2"]},
            })
        out["stages"].append(sub)
        cin_prev = c
    out["head"] = {"w": params["head"]["w"][:cin_prev, :],
                   "b": params["head"]["b"]}
    return out


def sub_cnn_config(cfg: CNNConfig, spec: SubmodelSpec) -> CNNConfig:
    stages = tuple((channels_of(cfg, si, spec.width[si]), spec.depth[si])
                   for si in range(len(cfg.stages)))
    return dataclasses.replace(cfg, stages=stages)


def _pad_to(sub_tree, parent_tree):
    """Zero-pad every leaf of sub_tree up to the parent leaf's shape
    (a prefix in every axis)."""
    def pad_leaf(s, p):
        out = torch.zeros(p.shape, dtype=p.dtype, device=p.device)
        out[tuple(slice(0, n) for n in s.shape)] = s.to(p.dtype)
        return out
    return tree_map(pad_leaf, sub_tree, parent_tree)


def pad_cnn(delta: Dict, parent_template: Dict, cfg: CNNConfig,
            spec: SubmodelSpec) -> Dict:
    """Zero-pad a submodel update to parent shape (Alg. 3 alignment): the
    kept channels in place, zeros elsewhere, and all-zero blocks past the
    kept depth (Fig. 2 depth expansion)."""
    out = {"stem": delta["stem"], "head": None, "stages": []}
    for si, (pstage, dstage) in enumerate(zip(parent_template["stages"],
                                              delta["stages"])):
        sub = {"down": _pad_to(dstage["down"], pstage["down"]),
               "blocks": []}
        for bi, pblock in enumerate(pstage["blocks"]):
            if bi < spec.depth[si]:
                sub["blocks"].append(_pad_to(dstage["blocks"][bi], pblock))
            else:
                sub["blocks"].append(tree_map(torch.zeros_like, pblock))
        out["stages"].append(sub)
    out["head"] = _pad_to(delta["head"], parent_template["head"])
    return out


def coverage_cnn(parent_template: Dict, cfg: CNNConfig,
                 spec: SubmodelSpec) -> Dict:
    """1/0 tensors of which parent entries this submodel covers (the
    extract → pad round trip on all-ones)."""
    ones = tree_map(torch.ones_like, parent_template)
    sub = extract_cnn(ones, cfg, spec)
    return pad_cnn(tree_map(torch.ones_like, sub), parent_template, cfg,
                   spec)


def mask_cnn(cfg: CNNConfig, spec: SubmodelSpec) -> Dict:
    """Parent-shaped 0/1 param mask (host numpy) with the semantics of
    ``coverage_cnn`` — prefix channels, prefix depth — built directly,
    with no extract / pad round trip, so the batched round engine can stack
    one mask per client without touching parent params."""
    def ones(*shape):
        return np.ones(shape, np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ch_mask(n_active, n_total):
        return (np.arange(n_total) < n_active).astype(np.float32)

    out: Dict = {"stem": {"w": ones(3, 3, cfg.in_channels,
                                    cfg.stem_channels),
                          "b": ones(cfg.stem_channels)},
                 "stages": [], "head": None}
    cin_prev = cfg.stem_channels
    m_prev = ch_mask(cin_prev, cin_prev)
    for si, (cmax, n_blocks) in enumerate(cfg.stages):
        c = channels_of(cfg, si, spec.width[si])
        m = ch_mask(c, cmax)
        stage = {"down": {"w": m_prev[None, None, :, None] *
                          m[None, None, None, :] * ones(3, 3, cin_prev, cmax),
                          "b": m},
                 "blocks": []}
        cc = m[None, None, :, None] * m[None, None, None, :]
        for bi in range(n_blocks):
            if bi < spec.depth[si]:
                stage["blocks"].append({
                    "conv1": {"w": cc * ones(3, 3, cmax, cmax), "b": m},
                    "conv2": {"w": cc * ones(3, 3, cmax, cmax), "b": m},
                    "gate": {"fc1": {"w": m[:, None] *
                                     ones(cmax, cfg.gate_hidden),
                                     "b": ones(cfg.gate_hidden)},
                             "fc2": {"w": ones(cfg.gate_hidden, 1),
                                     "b": ones(1)}},
                })
            else:   # depth expansion: block entirely uncovered (Fig. 2)
                stage["blocks"].append({
                    "conv1": {"w": zeros(3, 3, cmax, cmax), "b": zeros(cmax)},
                    "conv2": {"w": zeros(3, 3, cmax, cmax), "b": zeros(cmax)},
                    "gate": {"fc1": {"w": zeros(cmax, cfg.gate_hidden),
                                     "b": zeros(cfg.gate_hidden)},
                             "fc2": {"w": zeros(cfg.gate_hidden, 1),
                                     "b": zeros(1)}},
                })
        out["stages"].append(stage)
        cin_prev, m_prev = cmax, m
    out["head"] = {"w": m_prev[:, None] * ones(cin_prev, cfg.n_classes),
                   "b": ones(cfg.n_classes)}
    return out


# ===========================================================================
# Transformer parent
# ===========================================================================


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


def minimal_transformer_spec(cfg: ModelConfig) -> TransformerSubSpec:
    """Smallest expressible zoo submodel — one kept layer per segment,
    minimum width fraction on every applicable elastic dim (the
    deterministic fallback when a latency bound admits nothing else)."""
    w = min(cfg.elastic_widths)
    return TransformerSubSpec(
        layers=tuple((0,) for _ in cfg.segments),
        ff_frac=w,
        expert_frac=w if cfg.moe is not None else 1.0,
        ssm_head_frac=w if cfg.ssm is not None else 1.0,
        attn_head_frac=w if transformer_attn_heads(cfg, 1.0) is not None
        else 1.0)


def _round8(x: int) -> int:
    return max(8, (int(x) // 8) * 8)


def transformer_ff(cfg: ModelConfig, frac: float) -> int:
    return _round8(int(cfg.d_ff * frac)) if cfg.d_ff else 0


def transformer_experts(cfg: ModelConfig, frac: float) -> Optional[int]:
    """Kept routed experts (a prefix), never fewer than ``top_k``; None on
    parents without MoE."""
    if cfg.moe is None:
        return None
    return max(cfg.moe.top_k, int(round(cfg.moe.n_experts * frac)))


def transformer_ssm_heads(cfg: ModelConfig, frac: float) -> Optional[int]:
    """Kept SSD heads: a multiple of n_groups (the B/C group broadcast must
    still tile the kept heads), at least one group's worth. None on parents
    without SSM blocks."""
    if cfg.ssm is None:
        return None
    nh = cfg.ssm.n_heads(cfg.d_model)
    ng = cfg.ssm.n_groups
    return max(ng, (int(round(nh * frac)) // ng) * ng)


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


def _elastic_dims(cfg: ModelConfig, spec: TransformerSubSpec):
    """Resolved (ff, n_exp, nh_keep, ah_keep) of a spec: the kept d_ff
    prefix (always resolved, as the reference slices it), the kept routed
    experts, the kept SSD heads and the kept query heads (each None when
    the spec keeps them all or the parent has no such dim)."""
    ff = transformer_ff(cfg, spec.ff_frac)
    n_exp = None
    if cfg.moe is not None and spec.expert_frac < 1.0:
        n_exp = transformer_experts(cfg, spec.expert_frac)
    nh_keep = None
    if cfg.ssm is not None and spec.ssm_head_frac < 1.0:
        nh_keep = transformer_ssm_heads(cfg, spec.ssm_head_frac)
    ah_keep = None
    if spec.attn_head_frac < 1.0:
        ah_keep = transformer_attn_heads(cfg, spec.attn_head_frac)
    return ff, n_exp, nh_keep, ah_keep


def _prefix(n: int, keep: int) -> np.ndarray:
    m = np.zeros((n,), np.float32)
    m[:keep] = 1.0
    return m


def _block_coverage(cfg: ModelConfig, tree: Dict, n_layers: int, keep,
                    ff: int, n_exp: Optional[int], nh_keep: Optional[int],
                    ah_keep: Optional[int]) -> Dict:
    """Factors of one segment's stacked (L, ...) block tree: every leaf
    gets its kept-layer vector on axis 0 and, where the spec slices it,
    the kept prefix on its width axis (the reference's ``_slice_width``:
    d_ff, query / KV heads, the routed experts of a ``moe`` leaf — the
    router's last axis and the expert axis ``ndim-3`` of ``wi`` / ``wg`` /
    ``wo``; shared experts are kept whole — and the SSD heads of a
    ``mamba`` leaf, as ``_slice_mamba``: ``wz`` / ``wx`` / ``conv_x`` /
    ``norm`` on the d_inner prefix of their last axis, ``out_proj`` on
    axis ``ndim-2``, ``wdt`` / ``A_log`` / ``D`` / ``dt_bias`` on the head
    prefix; ``wB`` / ``wC`` / ``conv_B`` / ``conv_C`` whole)."""
    layers = np.zeros((n_layers,), np.float32)
    layers[np.asarray(keep, np.int64)] = 1.0
    g = cfg.n_heads // max(cfg.n_kv_heads, 1)
    # every spec gets the same factor shapes (so a cohort stacks): the
    # head axis is always resolved, all heads when the spec keeps them all
    heads = cfg.n_heads if ah_keep is None else ah_keep
    experts = None if cfg.moe is None else (
        cfg.moe.n_experts if n_exp is None else n_exp)
    ssm_heads = di = None
    if cfg.ssm is not None:
        ssm_heads = cfg.ssm.n_heads(cfg.d_model) if nh_keep is None \
            else nh_keep
        di = ssm_heads * cfg.ssm.head_dim

    def factor(shape, axis=None, vec=None):
        f = layers.reshape((n_layers,) + (1,) * (len(shape) - 1))
        if axis is None:
            return f
        w = vec.reshape([vec.shape[0] if a == axis else 1
                         for a in range(len(shape))])
        return f * w

    def last(shape, n):
        return factor(shape, len(shape) - 1, _prefix(shape[-1], n))

    def walk(d, path):
        out = {}
        parent = path[-1] if path else None
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            shape = tuple(v)
            if "mamba" in path:
                if parent == "mamba" and k in ("wz", "wx"):
                    out[k] = last(shape, di)
                elif parent == "mamba" and k in ("wdt", "A_log", "D",
                                                 "dt_bias"):
                    out[k] = last(shape, ssm_heads)
                elif parent in ("conv_x", "norm"):
                    out[k] = last(shape, di)
                elif k == "out_proj":
                    out[k] = factor(shape, len(shape) - 2,
                                    _prefix(shape[-2], di))
                else:
                    out[k] = factor(shape)
            elif parent == "mlp" and ff and k in ("wi", "wg"):
                out[k] = factor(shape, len(shape) - 1, _prefix(shape[-1], ff))
            elif parent == "mlp" and ff and k == "wo":
                out[k] = factor(shape, len(shape) - 2, _prefix(shape[-2], ff))
            elif parent == "moe" and k == "router":
                out[k] = factor(shape, len(shape) - 1,
                                _prefix(shape[-1], experts))
            elif parent == "moe" and k in ("wi", "wg", "wo"):
                out[k] = factor(shape, len(shape) - 3,
                                _prefix(shape[-3], experts))
            elif parent == "attn" and k == "wq":
                out[k] = factor(shape, len(shape) - 2,
                                _prefix(shape[-2], heads))
            elif parent == "attn" and k in ("wk", "wv"):
                out[k] = factor(shape, len(shape) - 2,
                                _prefix(shape[-2], heads // g))
            elif parent == "attn" and k == "wo":
                out[k] = factor(shape, len(shape) - 3,
                                _prefix(shape[-3], heads))
            else:
                out[k] = factor(shape)
        return out
    return walk(tree, ())


def coverage_factors(cfg: ModelConfig, spec: TransformerSubSpec,
                     shapes: Dict) -> Dict:
    """The 0/1 coverage of ``spec`` over a parent, as per-leaf factors
    (numpy, each with its leaf's number of axes) whose broadcast equals
    the reference's extract → pad round trip on all-ones.

    ``shapes``: the parent's tree with each leaf replaced by its shape
    tuple. Embedding, final norm, untied head and the shared hybrid block
    are covered whole; a block leaf (of ``blocks``, or of a pair's
    ``local`` and ``global``) is covered on its kept layers, within the
    kept d_ff prefix (mlp ``wi``/``wg`` columns, ``wo`` rows), within the
    kept routed experts (the router's columns, the experts of
    ``wi``/``wg``/``wo``; shared experts whole), within the kept SSD heads
    of a ``mamba`` leaf and, when the spec drops heads, the kept query
    heads (``wq``/``wo``) and their KV heads (``wk``/``wv``)."""
    ff, n_exp, nh_keep, ah_keep = _elastic_dims(cfg, spec)

    def whole(tree):
        if isinstance(tree, dict):
            return {k: whole(v) for k, v in tree.items()}
        return np.ones((1,) * len(tree), np.float32)

    out = {k: whole(v) for k, v in shapes.items() if k != "segments"}
    out["segments"] = [
        {name: _block_coverage(cfg, tree, seg.n_layers, keep, ff, n_exp,
                               nh_keep, ah_keep)
         for name, tree in seg_shapes.items()}
        for seg_shapes, seg, keep in zip(shapes["segments"], cfg.segments,
                                         spec.layers)]
    return out


# ---------------------------------------------------------------------------
# the sequential path: extract -> train -> pad
# ---------------------------------------------------------------------------
def sub_transformer_config(cfg: ModelConfig,
                           spec: TransformerSubSpec) -> ModelConfig:
    """The submodel's config, computed analytically (no params):
    ``extract_transformer`` produces exactly this config, so the analytic
    FLOPs and parameter counts the latency model prices
    (``configs.base.flops_per_token`` / ``param_count``) are those of the
    submodel the engine trains."""
    ff, n_exp, nh_keep, ah_keep = _elastic_dims(cfg, spec)
    segs = tuple(dataclasses.replace(seg, n_layers=len(keep))
                 for seg, keep in zip(cfg.segments, spec.layers))
    moe = cfg.moe
    if moe is not None and n_exp is not None:
        moe = dataclasses.replace(moe, n_experts=n_exp)
    ssm = cfg.ssm
    if ssm is not None and nh_keep is not None:
        ssm = dataclasses.replace(
            ssm, d_inner_override=nh_keep * ssm.head_dim)
    heads = {}
    if ah_keep is not None:
        g = cfg.n_heads // max(cfg.n_kv_heads, 1)
        heads = dict(n_heads=ah_keep, n_kv_heads=ah_keep // g)
    return dataclasses.replace(
        cfg, name=cfg.name + "-sub", segments=segs,
        n_layers=sum(len(k) for k in spec.layers),
        d_ff=ff or cfg.d_ff, moe=moe, ssm=ssm, **heads)


def extract_transformer(params: Dict, cfg: ModelConfig,
                        spec: TransformerSubSpec):
    """Returns (sub_params, sub_cfg): the kept layers of every stacked
    per-layer leaf (``index_select`` on the leading axis, with an index
    tensor on the leaf's device), then its d_ff / routed-expert / query-
    head / SSD-head prefixes — a pair segment's ``local`` and ``global``
    trees alike. Embedding, final norm, untied head and the shared hybrid
    block are the parent's own tensors."""
    ff, n_exp, nh_keep, ah_keep = _elastic_dims(cfg, spec)

    def slice_block(tree, keep_idx):
        def take(a):
            idx = torch.as_tensor(keep_idx, dtype=torch.long,
                                  device=a.device)
            return a.index_select(0, idx)
        return _slice_width(tree_map(take, tree), ff, n_exp, cfg, nh_keep,
                            ah_keep)

    sub = dict(params)
    sub["segments"] = [{name: slice_block(tree, keep)
                        for name, tree in seg_p.items()}
                       for seg_p, keep in zip(params["segments"],
                                              spec.layers)]
    return sub, sub_transformer_config(cfg, spec)


def _slice_width(block_tree, ff: Optional[int], n_exp: Optional[int],
                 cfg: ModelConfig, nh_keep: Optional[int] = None,
                 ah_keep: Optional[int] = None):
    """Width-slice a (stacked or unstacked) block tree: the mlp's d_ff
    (``wi`` / ``wg`` last axis, ``wo`` second to last), the MoE's routed
    experts, the mamba block's SSD heads and the GQA block's query heads."""
    def walk(d):
        out = {}
        for k, v in d.items():
            if k == "mlp" and ff:
                out[k] = {kk: _slice_mlp_leaf(kk, vv, ff)
                          for kk, vv in v.items()}
            elif k == "moe" and n_exp is not None:
                out[k] = _slice_moe(v, n_exp)
            elif k == "mamba" and nh_keep is not None:
                out[k] = _slice_mamba(v, nh_keep, cfg.ssm.head_dim)
            elif k == "attn" and ah_keep is not None:
                out[k] = _slice_attn(
                    v, ah_keep,
                    ah_keep // (cfg.n_heads // max(cfg.n_kv_heads, 1)))
            elif isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = v
        return out
    return walk(block_tree)


def _slice_mlp_leaf(name, a, ff):
    if name in ("wi", "wg"):
        return a.narrow(a.dim() - 1, 0, ff)
    if name == "wo":
        return a.narrow(a.dim() - 2, 0, ff)
    return a


def _slice_moe(tree, n_exp):
    """The first ``n_exp`` routed experts: the router's columns and the
    expert axis (``ndim-3``, stacked or not) of ``wi`` / ``wg`` / ``wo``;
    shared experts kept whole."""
    out = {}
    for k, v in tree.items():
        if k == "router":
            out[k] = v.narrow(v.dim() - 1, 0, n_exp)
        elif k in ("wi", "wg", "wo"):
            out[k] = v.narrow(v.dim() - 3, 0, n_exp)
        else:
            out[k] = v
    return out


def _slice_attn(tree, ah: int, kv: int):
    """The first ``ah`` query heads of a GQA block and their ``kv`` KV
    heads (whole query groups, so the q → kv head mapping is unchanged);
    the per-head-dim q / k norms stay whole."""
    out = {}
    for k, v in tree.items():
        if k == "wq":                               # (L?, d, H, hd)
            out[k] = v.narrow(v.dim() - 2, 0, ah)
        elif k in ("wk", "wv"):                     # (L?, d, KV, hd)
            out[k] = v.narrow(v.dim() - 2, 0, kv)
        elif k == "wo":                             # (L?, H, hd, d)
            out[k] = v.narrow(v.dim() - 3, 0, ah)
        else:                                       # q_norm, k_norm
            out[k] = v
    return out


def _slice_mamba(tree, nh: int, head_dim: int):
    """The first ``nh`` SSD heads of a mamba block: d_inner-sized axes keep
    ``nh * head_dim`` entries, per-head axes ``nh``; the group-width
    leaves (``wB`` / ``wC`` / ``conv_B`` / ``conv_C``) stay whole (kept
    heads are a multiple of n_groups)."""
    di = nh * head_dim
    out = {}
    for k, v in tree.items():
        if k in ("wz", "wx"):                       # (L?, d, di)
            out[k] = v.narrow(v.dim() - 1, 0, di)
        elif k in ("wdt", "A_log", "D", "dt_bias"):  # (L?, [d,] nh)
            out[k] = v.narrow(v.dim() - 1, 0, nh)
        elif k == "conv_x":                         # w (L?, w, di), b
            out[k] = {kk: vv.narrow(vv.dim() - 1, 0, di)
                      for kk, vv in v.items()}
        elif k == "norm":                           # scale (L?, di)
            out[k] = {"scale": v["scale"].narrow(v["scale"].dim() - 1, 0,
                                                 di)}
        elif k == "out_proj":                       # (L?, di, d)
            out[k] = v.narrow(v.dim() - 2, 0, di)
        else:                                       # wB, wC, conv_B, conv_C
            out[k] = v
    return out


def pad_transformer(delta: Dict, parent_template: Dict, cfg: ModelConfig,
                    spec: TransformerSubSpec) -> Dict:
    """Zero-pad a transformer submodel update to parent coordinates: every
    stacked leaf is width-padded (its kept prefixes in place, zeros after)
    and scattered onto its kept layers (``index_copy_``) of a zero parent
    leaf (a pair segment's ``local`` and ``global`` trees alike);
    embedding, final norm, untied head and the shared hybrid block pass
    through whole (the reference zero-pads the shared block to its own
    shape: the identity)."""

    def scatter_layers(sub_tree, parent_tree, keep_idx):
        def leaf(s, p):
            wide = torch.zeros((s.shape[0],) + tuple(p.shape[1:]),
                               dtype=p.dtype, device=p.device)
            wide[tuple(slice(0, n) for n in s.shape)] = s.to(p.dtype)
            idx = torch.as_tensor(keep_idx, dtype=torch.long,
                                  device=p.device)
            return torch.zeros(p.shape, dtype=p.dtype,
                               device=p.device).index_copy_(0, idx, wide)
        return tree_map(leaf, sub_tree, parent_tree)

    out = dict(delta)
    out["segments"] = [
        {name: scatter_layers(tree, p_seg[name], keep)
         for name, tree in d_seg.items()}
        for d_seg, p_seg, keep in zip(delta["segments"],
                                      parent_template["segments"],
                                      spec.layers)]
    return out
