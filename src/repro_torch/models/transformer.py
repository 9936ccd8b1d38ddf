"""Dense GQA transformer: parameter init, fused prefill and cached decode.

The port of the serving half of the reference's ``models/transformer.py``
for ``"attn"`` segments. A segment's layer weights are stacked with a
leading ``n_layers`` axis, as in the reference; a Python loop over the
layers replaces ``lax.scan``. Elastic masks (``masks``: ``ff``, ``heads``,
``depth``) gate d_ff, query heads and layers in parent coordinates; each
may carry a leading batch axis so every row of a batch is a different
submodel (the serving slot axis the reference gets from ``vmap``).

Not ported yet, and raising NotImplementedError when a config needs them:
MoE blocks (ROADMAP A9), SSM blocks (A10), MLA attention, ``attn_pair``
segments and the shared hybrid block (A11).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (embed, layernorm, mlp, rmsnorm,
                                       softcap)

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming the ROADMAP item for any part of
    ``cfg`` this slice does not run."""
    if cfg.moe is not None or any(s.use_moe for s in cfg.segments):
        raise NotImplementedError(f"{cfg.name}: MoE blocks are not ported "
                                  "yet (ROADMAP A9)")
    if cfg.ssm is not None or any(s.kind == "ssm" for s in cfg.segments):
        raise NotImplementedError(f"{cfg.name}: SSM blocks are not ported "
                                  "yet (ROADMAP A10)")
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"{cfg.name}: {cfg.attn_type} attention "
                                  "is not ported yet (ROADMAP A11)")
    if any(s.kind != "attn" for s in cfg.segments):
        raise NotImplementedError(f"{cfg.name}: attn_pair segments are not "
                                  "ported yet (ROADMAP A11)")
    if cfg.shared_attn_d_ff or any(s.shared_attn_after
                                   for s in cfg.segments):
        raise NotImplementedError(f"{cfg.name}: the shared hybrid block is "
                                  "not ported yet (ROADMAP A11)")


def _norm(cfg: ModelConfig, p, x):
    if cfg.norm_type == "layernorm":
        return layernorm(p, x, cfg.norm_eps)
    return rmsnorm(p, x, cfg.norm_eps)


def _layer(tree, l: int):
    """Layer ``l`` of a tree of stacked (n_layers, ...) weights (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def _gate(g, x):
    """A depth gate of shape () or (B,) shaped to broadcast over x."""
    return g.to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))


def _masks_get(masks, name):
    return None if masks is None else masks.get(name)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, *, seed: int = 0, device="cpu",
                dtype=torch.float32) -> Params:
    """Torch-seeded stand-in for the reference's ``init_params``: the same
    tree, shapes and distributions (He-normal ``1/sqrt(fan_in)`` weights,
    embedding ``N(0, 1) × 0.02`` over ``padded_vocab`` rows, zero norm
    scales), drawn from a ``torch.Generator`` on ``device``. Not held
    bit-equal to ``jax.random``; parity tests bridge the reference's own
    params instead (``checkpoint.bridge``)."""
    check_supported(cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        t = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return t.mul_(std).to(dtype)

    def norm(lead, d):
        if cfg.norm_type == "layernorm":
            return {"scale": torch.ones(lead + (d,), device=dev, dtype=dtype),
                    "bias": torch.zeros(lead + (d,), device=dev,
                                        dtype=dtype)}
        return {"scale": torch.zeros(lead + (d,), device=dev, dtype=dtype)}

    d, f = cfg.d_model, cfg.d_ff
    p: Params = {"embed": {"table": normal((cfg.padded_vocab, d), 0.02)}}
    segs = []
    for seg in cfg.segments:
        L = (seg.n_layers,)
        attn = {}
        for name, spec in attn_lib.gqa_param_shapes(
                d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                cfg.qk_norm).items():
            if isinstance(spec, dict):       # q_norm / k_norm
                attn[name] = {"scale": torch.zeros(L + spec["scale"][0],
                                                   device=dev, dtype=dtype)}
            else:
                shape, fan_in = spec
                attn[name] = normal(L + shape, 1.0 / math.sqrt(fan_in))
        mlp_p = {"wi": normal(L + (d, f), 1.0 / math.sqrt(d)),
                 "wo": normal(L + (f, d), 1.0 / math.sqrt(f))}
        if cfg.mlp_gated:
            mlp_p["wg"] = normal(L + (d, f), 1.0 / math.sqrt(d))
        blocks = {"ln1": norm(L, d), "ln2": norm(L, d), "attn": attn,
                  "mlp": mlp_p}
        if cfg.post_norms:
            blocks["post_ln1"] = norm(L, d)
            blocks["post_ln2"] = norm(L, d)
        segs.append({"blocks": blocks})
    p["segments"] = segs
    p["final_norm"] = norm((), d)
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": normal((d, cfg.padded_vocab),
                                    1.0 / math.sqrt(d))}
    return p


def _logits(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T.to(x.dtype)
    else:
        logits = x @ params["lm_head"]["w"].to(x.dtype)
    return softcap(logits.float(), cfg.final_softcap)


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
    m = mlp(bp["mlp"], h, cfg.act, width_mask=_masks_get(masks, "ff"),
            kernel=_masks_get(kernels, "mlp"))
    if cfg.post_norms:
        m = _norm(cfg, bp["post_ln2"], m)
    if gate is not None:
        m = m * _gate(gate, m)
    x = x + m
    return x if cache_len is None else (x, cache)


class DecodeCaches(NamedTuple):
    segments: Tuple[Any, ...]     # per-segment stacked KVCache (L, B, ...)
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
        ks, vs = [], []
        for l in range(seg.n_layers):
            g = None if depth is None else depth[si][..., l]
            x, c = _apply_attn_block(_layer(seg_p["blocks"], l), x,
                                     positions, cfg, window, masks, kernels,
                                     gate=g, cache_len=max_len,
                                     cache_dtype=cache_dtype)
            ks.append(c.k)
            vs.append(c.v)
        segs.append(attn_lib.KVCache(torch.stack(ks), torch.stack(vs)))
    x = _norm(cfg, params["final_norm"], x)
    logits = _logits(params, cfg, x[:, -1:, :])
    return logits[:, 0], DecodeCaches(tuple(segs), None)


# ---------------------------------------------------------------------------
# decode (single token, cached)
# ---------------------------------------------------------------------------
def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.float32, device="cpu") -> DecodeCaches:
    check_supported(cfg)
    segs = []
    for seg in cfg.segments:
        window = seg.sliding_window or cfg.sliding_window
        single = attn_lib.gqa_cache_init(batch, max_len, cfg.n_kv_heads,
                                         cfg.head_dim, window, dtype, device)
        segs.append(attn_lib.KVCache(
            single.k.new_zeros((seg.n_layers,) + single.k.shape),
            single.v.new_zeros((seg.n_layers,) + single.v.shape)))
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
    m = mlp(bp["mlp"], h, cfg.act, width_mask=_masks_get(masks, "ff"),
            kernel=_masks_get(kernels, "mlp"))
    if cfg.post_norms:
        m = _norm(cfg, bp["post_ln2"], m)
    if gate is not None:
        m = m * _gate(gate, m)
    return x + m, cache


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
            x, _ = _decode_attn_block(
                _layer(seg_p["blocks"], l), x,
                attn_lib.KVCache(seg_c.k[l], seg_c.v[l]), pos, cfg, window,
                masks, kernels, gate=g)
    x = _norm(cfg, params["final_norm"], x)
    return _logits(params, cfg, x)[:, 0], caches
