"""GQA transformer (MLP or MoE blocks) and Mamba2 SSM stacks: parameter
init, the training forward, fused prefill and cached decode.

The port of the reference's ``models/transformer.py`` for ``"attn"`` and
``"ssm"`` segments. A segment's layer weights are stacked with a leading
``n_layers`` axis, as in the reference; a Python loop over the layers
replaces ``lax.scan``. Elastic masks (``masks``: ``ff``, ``heads``,
``depth``) gate d_ff, query heads and layers in parent coordinates.

Two batch layouts replace the reference's ``vmap``:

* serving (``prefill``, ``decode_step``): one parent, and masks that may
  carry a leading batch axis so every row is a different submodel (the
  slot axis);
* training (``forward``): a leading client axis G on every parameter,
  mask and activation — each client its own weights and its own
  submodel — with tokens (G, B, S). No remat: at the training slice's
  shapes the activations of a step fit beside the optimizer state (the
  dense SSD path checkpoints each chunk itself, as the reference does).

MoE blocks (``Segment.use_moe``: a ``moe`` leaf in place of ``mlp``) run
``models.moe.moe_forward`` with the ``experts`` mask and the ``moe`` op:
one group per client in training, one group per row in decode (the
server's ``vmap`` over slots), and in prefill one group for the whole
batch — or one per row when the expert mask carries a batch axis.

SSM blocks (``Segment.kind == "ssm"``: ``{"ln", "mamba"}`` per layer) run
``x + gate · mamba(ln(x))`` (``models.ssm``) with the ``ssm_heads`` mask
and the ``ssd`` op; their decode cache is an ``SSMCache`` (state and conv
histories) per layer.

Not ported yet, and raising NotImplementedError when a config needs them:
MLA attention, ``attn_pair`` segments and the shared hybrid block of
zamba2 (ROADMAP A11); the audio / vision input frontends (A7).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (at_least_fp32, embed, layernorm,
                                       mlp, rmsnorm, softcap)

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming the ROADMAP item for any part of
    ``cfg`` the port does not run."""
    if any(s.kind not in ("attn", "ssm") for s in cfg.segments):
        raise NotImplementedError(f"{cfg.name}: attn_pair segments are not "
                                  "ported yet (ROADMAP A11)")
    if cfg.shared_attn_d_ff or any(s.shared_attn_after
                                   for s in cfg.segments):
        raise NotImplementedError(f"{cfg.name}: the shared hybrid block is "
                                  "not ported yet (ROADMAP A11)")
    if any(s.kind == "attn" for s in cfg.segments) and \
            cfg.attn_type != "gqa":
        raise NotImplementedError(f"{cfg.name}: {cfg.attn_type} attention "
                                  "is not ported yet (ROADMAP A11)")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} input "
                                  "frontend is not ported yet (ROADMAP A7)")


def _norm(cfg: ModelConfig, p, x):
    if cfg.norm_type == "layernorm":
        return layernorm(p, x, cfg.norm_eps)
    return rmsnorm(p, x, cfg.norm_eps)


def _layer(tree, l: int):
    """Layer ``l`` of a tree of stacked (n_layers, ...) weights (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def _unbind_layers(tree, n: int, dim: int):
    """The ``n`` per-layer trees of a tree of stacked weights whose layer
    axis is ``dim``, split once: under autograd the leaf's gradient is one
    ``stack`` of the layers' gradients, not a zero-filled leaf-sized tensor
    per layer (what ``select`` gives) summed over the layers."""
    if isinstance(tree, dict):
        per = {k: _unbind_layers(v, n, dim) for k, v in tree.items()}
        return [{k: v[l] for k, v in per.items()} for l in range(n)]
    return torch.unbind(tree, dim)


def _gate(g, x):
    """A depth gate of shape () or (B,) shaped to broadcast over x."""
    return g.to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))


def _masks_get(masks, name):
    return None if masks is None else masks.get(name)


def _ffn(bp, h, cfg: ModelConfig, masks, kernels, per_row: bool):
    """The block's feed-forward: the MLP, or the MoE layer of a ``moe``
    block. h (B, S, d); with ``per_row`` every row of h is its own MoE
    group (own capacity, own expert prefix), else the B·S tokens form one
    group."""
    if "moe" not in bp:
        return mlp(bp["mlp"], h, cfg.act, width_mask=_masks_get(masks, "ff"),
                   kernel=_masks_get(kernels, "mlp"))
    x = h if per_row else h.reshape(1, -1, h.shape[-1])
    m, _ = moe_lib.moe_forward(
        bp["moe"], x, cfg.moe, act=cfg.act,
        expert_mask=_masks_get(masks, "experts"),
        kernel=_masks_get(kernels, "moe"), return_aux=False)
    return m.reshape(h.shape)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _param_tree(cfg: ModelConfig, leaf) -> Params:
    """The parameter tree of ``cfg``, each leaf made by ``leaf(shape,
    init)``: ``init`` is a normal's std (He-normal ``1/sqrt(fan_in)``
    weights, ``0.02`` for the embedding), ``"zeros"``, ``"ones"`` or one of
    ``models.ssm.INITS``. Leaves are made in the order :func:`init_params`
    draws them."""
    check_supported(cfg)
    d, f = cfg.d_model, cfg.d_ff

    def norm(lead, n):
        if cfg.norm_type == "layernorm":
            return {"scale": leaf(lead + (n,), "ones"),
                    "bias": leaf(lead + (n,), "zeros")}
        return {"scale": leaf(lead + (n,), "zeros")}

    p: Params = {"embed": {"table": leaf((cfg.padded_vocab, d), 0.02)}}

    def stacked(lead, spec):
        if isinstance(spec, dict):
            return {k: stacked(lead, v) for k, v in spec.items()}
        return leaf(lead + spec[0], spec[1])

    segs = []
    for seg in cfg.segments:
        L = (seg.n_layers,)
        if seg.kind == "ssm":
            segs.append({"blocks": {
                "ln": norm(L, d),
                "mamba": stacked(L, ssm_lib.mamba_param_shapes(d, cfg.ssm))}})
            continue
        attn = {}
        for name, spec in attn_lib.gqa_param_shapes(
                d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                cfg.qk_norm).items():
            if isinstance(spec, dict):       # q_norm / k_norm
                attn[name] = {"scale": leaf(L + spec["scale"][0], "zeros")}
            else:
                shape, fan_in = spec
                attn[name] = leaf(L + shape, 1.0 / math.sqrt(fan_in))
        blocks = {"ln1": norm(L, d), "ln2": norm(L, d), "attn": attn}
        if seg.use_moe:
            blocks["moe"] = stacked(L, moe_lib.moe_param_specs(
                d, cfg.moe, cfg.mlp_gated))
        else:
            mlp_p = {"wi": leaf(L + (d, f), 1.0 / math.sqrt(d)),
                     "wo": leaf(L + (f, d), 1.0 / math.sqrt(f))}
            if cfg.mlp_gated:
                mlp_p["wg"] = leaf(L + (d, f), 1.0 / math.sqrt(d))
            blocks["mlp"] = mlp_p
        if cfg.post_norms:
            blocks["post_ln1"] = norm(L, d)
            blocks["post_ln2"] = norm(L, d)
        segs.append({"blocks": blocks})
    p["segments"] = segs
    p["final_norm"] = norm((), d)
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": leaf((d, cfg.padded_vocab),
                                  1.0 / math.sqrt(d))}
    return p


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None,
                dtype=torch.float32) -> Params:
    """Torch-seeded stand-in for the reference's ``init_params``: the same
    tree, shapes and distributions (He-normal ``1/sqrt(fan_in)`` weights,
    embedding ``N(0, 1) × 0.02`` over ``padded_vocab`` rows, zero norm
    scales), drawn from a ``torch.Generator`` on ``device`` (the card
    unless the caller asks for the CPU). Not held bit-equal to
    ``jax.random``; parity tests bridge the reference's own params instead
    (``checkpoint.bridge``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def leaf(shape, init):
        if init == "zeros":
            return torch.zeros(shape, device=dev, dtype=dtype)
        if init == "ones":
            return torch.ones(shape, device=dev, dtype=dtype)
        if init in ssm_lib.INITS:
            return ssm_lib.init_leaf(shape, init, gen, dev).to(dtype)
        t = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return t.mul_(init).to(dtype)

    return _param_tree(cfg, leaf)


def param_shapes(cfg: ModelConfig) -> Params:
    """The tree of :func:`init_params` with each leaf replaced by its shape
    tuple (no tensors are made)."""
    return _param_tree(cfg, lambda shape, init: shape)


def _logits(params, cfg: ModelConfig, x):
    """x (..., d) -> softcapped logits in at least fp32 (fp64 stays fp64);
    the weights may carry a leading client axis matching x's (x (G, T,
    d))."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].transpose(-1, -2).to(x.dtype)
    else:
        logits = x @ params["lm_head"]["w"].to(x.dtype)
    return softcap(at_least_fp32(logits), cfg.final_softcap)


# ---------------------------------------------------------------------------
# training forward (client-stacked parameters)
# ---------------------------------------------------------------------------
def _cohort_attn_block(bp, x, cfg: ModelConfig, seq_len: int, window,
                       masks, kernels, gate=None):
    """One attention block over a cohort: x (G, T, d) with T = B·S token
    rows per client, every weight of ``bp`` with a leading client axis.
    ``gate`` (G,) 0/1 multiplies the block's residual contributions (CFL
    depth elasticity: gate 0 is exactly the identity)."""
    h = _norm(cfg, bp["ln1"], x)
    a = attn_lib.gqa_forward_cohort(
        bp["attn"], h, seq_len, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, causal=cfg.causal,
        window=window, cap=cfg.attn_softcap, qk_norm=cfg.qk_norm,
        norm_eps=cfg.norm_eps, head_mask=_masks_get(masks, "heads"),
        kernel=_masks_get(kernels, "attention"))
    if cfg.post_norms:
        a = _norm(cfg, bp["post_ln1"], a)
    if gate is not None:
        a = a * _gate(gate, a)
    x = x + a
    h = _norm(cfg, bp["ln2"], x)
    m = _ffn(bp, h, cfg, masks, kernels, per_row=True)
    if cfg.post_norms:
        m = _norm(cfg, bp["post_ln2"], m)
    if gate is not None:
        m = m * _gate(gate, m)
    return x + m


def _cohort_ssm_block(bp, x, cfg: ModelConfig, batch: int, masks, kernels,
                      gate=None):
    """One SSM block over a cohort: x (G, T, d) with T = batch·S token rows
    per client; ``x + gate · mamba(ln(x))`` (the reference's
    ``_apply_ssm_block``)."""
    G, T, d = x.shape
    h = _norm(cfg, bp["ln"], x).reshape(G, batch, T // batch, d)
    y = ssm_lib.mamba_forward_cohort(
        bp["mamba"], h, cfg.ssm, norm_eps=cfg.norm_eps,
        head_mask=_masks_get(masks, "ssm_heads"),
        kernel=_masks_get(kernels, "ssd")).reshape(G, T, d)
    if gate is not None:
        y = y * _gate(gate, y)
    return x + y


def forward(params: Params, cfg: ModelConfig, tokens, *, masks=None,
            kernels=None):
    """Full-sequence forward of a cohort: every leaf of ``params`` carries
    a leading client axis G, ``tokens`` is (G, B, S), ``masks`` holds one
    row per client (``ff`` (G, d_ff), ``heads`` (G, H), ``ssm_heads``
    (G, H_ssm), ``depth`` a (G, n_layers) gate per segment). Returns
    softcapped logits (G, B, S, V) in at least fp32. ``kernels``: the op
    table of ``kernels.dispatch`` (the tile-skipping path, differentiable
    through the kernels' closed backward) or None for the dense masked
    path."""
    check_supported(cfg)
    G, B, S = tokens.shape
    x = embed(params["embed"], tokens, scale=cfg.embed_scale)
    x = x.reshape(G, B * S, cfg.d_model)
    depth = _masks_get(masks, "depth")
    for si, (seg_p, seg) in enumerate(zip(params["segments"], cfg.segments)):
        window = seg.sliding_window or cfg.sliding_window
        layers = _unbind_layers(seg_p["blocks"], seg.n_layers, dim=1)
        for l, bp in enumerate(layers):
            g = None if depth is None else depth[si][:, l]
            if seg.kind == "ssm":
                x = _cohort_ssm_block(bp, x, cfg, B, masks, kernels, gate=g)
            else:
                x = _cohort_attn_block(bp, x, cfg, S, window, masks,
                                       kernels, gate=g)
    x = _norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, x).reshape(G, B, S, -1)


# ---------------------------------------------------------------------------
# prefill (full forward that also fills the decode caches)
# ---------------------------------------------------------------------------
def _apply_attn_block(bp, x, positions, cfg: ModelConfig, window, masks,
                      kernels, gate=None, cache_len=None, cache_dtype=None):
    """One attention block over a full sequence. ``gate`` ((), or (B,)
    0/1) multiplies the block's residual contributions — with gate 0 the
    block is exactly the identity (CFL depth elasticity). ``cache_len``:
    also return the block's ring-buffer KV cache (fused prefill)."""
    h = _norm(cfg, bp["ln1"], x)
    kv_len = None if cache_len is None else (
        min(cache_len, window) if window else cache_len)
    res = attn_lib.gqa_forward(
        bp["attn"], h, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, causal=cfg.causal,
        window=window, cap=cfg.attn_softcap, qk_norm=cfg.qk_norm,
        norm_eps=cfg.norm_eps, head_mask=_masks_get(masks, "heads"),
        kernel=_masks_get(kernels, "attention"), cache_len=kv_len,
        cache_dtype=cache_dtype)
    a, cache = res if cache_len is not None else (res, None)
    if cfg.post_norms:
        a = _norm(cfg, bp["post_ln1"], a)
    if gate is not None:
        a = a * _gate(gate, a)
    x = x + a
    h = _norm(cfg, bp["ln2"], x)
    experts = _masks_get(masks, "experts")
    m = _ffn(bp, h, cfg, masks, kernels,
             per_row=experts is not None and experts.dim() == 2)
    if cfg.post_norms:
        m = _norm(cfg, bp["post_ln2"], m)
    if gate is not None:
        m = m * _gate(gate, m)
    x = x + m
    return x if cache_len is None else (x, cache)


def _apply_ssm_block(bp, x, cfg: ModelConfig, masks, kernels, gate=None,
                     cache_dtype=None):
    """One SSM block over a full sequence that also returns the block's
    decode cache (fused prefill): ``x + gate · mamba(ln(x))``."""
    h = _norm(cfg, bp["ln"], x)
    y, cache = ssm_lib.mamba_forward(
        bp["mamba"], h, cfg.ssm, norm_eps=cfg.norm_eps,
        head_mask=_masks_get(masks, "ssm_heads"),
        kernel=_masks_get(kernels, "ssd"), return_cache=True,
        cache_dtype=cache_dtype)
    if gate is not None:
        y = y * _gate(gate, y)
    return x + y, cache


def _stack_caches(caches):
    """Per-layer caches (one NamedTuple each) -> one NamedTuple of stacked
    (L, B, ...) fields."""
    return type(caches[0])(*(torch.stack(f) for f in zip(*caches)))


class DecodeCaches(NamedTuple):
    segments: Tuple[Any, ...]     # per-segment stacked KVCache / SSMCache
    shared: Any                   # shared hybrid block caches (None here)


def prefill(params: Params, cfg: ModelConfig, tokens, max_len: int, *,
            masks=None, kernels=None, cache_dtype=torch.float32):
    """One-shot prefill: full forward over ``tokens`` (B, S) that fills
    :class:`DecodeCaches` for positions 0..S-1.

    Returns ``(last_logits (B, V) fp32 softcapped, caches)``; generation
    continues at ``pos = S`` with :func:`decode_step`."""
    check_supported(cfg)
    x = embed(params["embed"], tokens, scale=cfg.embed_scale)
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds max_len {max_len}")
    positions = torch.arange(S, device=x.device).expand(B, S)
    depth = _masks_get(masks, "depth")
    segs = []
    for si, (seg_p, seg) in enumerate(zip(params["segments"], cfg.segments)):
        window = seg.sliding_window or cfg.sliding_window
        caches = []
        for l in range(seg.n_layers):
            g = None if depth is None else depth[si][..., l]
            bp = _layer(seg_p["blocks"], l)
            if seg.kind == "ssm":
                x, c = _apply_ssm_block(bp, x, cfg, masks, kernels, gate=g,
                                        cache_dtype=cache_dtype)
            else:
                x, c = _apply_attn_block(bp, x, positions, cfg, window,
                                         masks, kernels, gate=g,
                                         cache_len=max_len,
                                         cache_dtype=cache_dtype)
            caches.append(c)
        segs.append(_stack_caches(caches))
    x = _norm(cfg, params["final_norm"], x)
    logits = _logits(params, cfg, x[:, -1:, :])
    return logits[:, 0], DecodeCaches(tuple(segs), None)


# ---------------------------------------------------------------------------
# decode (single token, cached)
# ---------------------------------------------------------------------------
def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.float32, device=None) -> DecodeCaches:
    """Zeroed ring-buffer caches of ``batch`` rows on ``device`` (the card
    unless the caller asks for the CPU)."""
    check_supported(cfg)
    device = resolve_device(device)
    segs = []
    for seg in cfg.segments:
        window = seg.sliding_window or cfg.sliding_window
        if seg.kind == "ssm":
            single = ssm_lib.ssm_cache_init(batch, cfg.d_model, cfg.ssm,
                                            dtype, device)
        else:
            single = attn_lib.gqa_cache_init(batch, max_len, cfg.n_kv_heads,
                                             cfg.head_dim, window, dtype,
                                             device)
        segs.append(type(single)(*(f.new_zeros((seg.n_layers,) + f.shape)
                                   for f in single)))
    return DecodeCaches(tuple(segs), None)


def _decode_attn_block(bp, x, cache, pos, cfg: ModelConfig, window,
                       masks=None, kernels=None, gate=None):
    h = _norm(cfg, bp["ln1"], x)
    a, cache = attn_lib.gqa_decode(
        bp["attn"], h, cache, pos, n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, window=window, cap=cfg.attn_softcap,
        qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
        head_mask=_masks_get(masks, "heads"))
    if cfg.post_norms:
        a = _norm(cfg, bp["post_ln1"], a)
    if gate is not None:
        a = a * _gate(gate, a)
    x = x + a
    h = _norm(cfg, bp["ln2"], x)
    m = _ffn(bp, h, cfg, masks, kernels, per_row=True)
    if cfg.post_norms:
        m = _norm(cfg, bp["post_ln2"], m)
    if gate is not None:
        m = m * _gate(gate, m)
    return x + m, cache


def _decode_ssm_block(bp, x, cache, cfg: ModelConfig, masks=None,
                      gate=None):
    """One SSM block over one token; ``cache`` (per-layer views of the
    stacked caches) is updated in place."""
    h = _norm(cfg, bp["ln"], x)
    y, new = ssm_lib.mamba_decode(bp["mamba"], h, cache, cfg.ssm,
                                  norm_eps=cfg.norm_eps,
                                  head_mask=_masks_get(masks, "ssm_heads"))
    for f, v in zip(cache, new):
        f.copy_(v)
    if gate is not None:
        y = y * _gate(gate, y)
    return x + y


def decode_step(params: Params, cfg: ModelConfig, caches: DecodeCaches,
                token, pos, masks=None, kernels=None):
    """token: (B, 1) integer tensor; pos: (B,) integer tensor of per-row
    positions (or one position for every row). -> (logits (B, V) fp32,
    caches).

    Each row writes its own ring slot and reads its own cache validity;
    the caches are updated **in place** and returned. ``masks`` /
    ``kernels`` mirror :func:`prefill`'s elastic surface; a mask with a
    leading batch axis gives every row its own submodel."""
    check_supported(cfg)
    x = embed(params["embed"], token, scale=cfg.embed_scale)
    depth = _masks_get(masks, "depth")
    for si, (seg_p, seg, seg_c) in enumerate(zip(
            params["segments"], cfg.segments, caches.segments)):
        window = seg.sliding_window or cfg.sliding_window
        for l in range(seg.n_layers):
            g = None if depth is None else depth[si][..., l]
            bp = _layer(seg_p["blocks"], l)
            if seg.kind == "ssm":
                x = _decode_ssm_block(bp, x, type(seg_c)(*(f[l]
                                                           for f in seg_c)),
                                      cfg, masks, gate=g)
                continue
            x, _ = _decode_attn_block(
                bp, x, attn_lib.KVCache(seg_c.k[l], seg_c.v[l]), pos, cfg,
                window, masks, kernels, gate=g)
    x = _norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, x)[:, 0], caches
