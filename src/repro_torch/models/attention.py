"""GQA attention: full-sequence forward (prefill) and cached decode.

The port of the GQA half of the reference's ``models/attention.py`` (MLA
waits for ROADMAP A11). Layouts are the reference's:
``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d),
activations (B, S, H, D), KV caches (B, C, KV, D) ring buffers. The q/k/v/o
projections are plain products (the reference left them to XLA outside
Pallas) and stay ``torch.einsum``.

Elastic masks may carry a leading batch axis: ``head_mask`` (H,) or
(B, H), so every row of a serving batch can be a different submodel.
``gqa_forward_cohort`` is the training form: client-stacked weights with
a leading client axis G, one head mask row per client.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models.layers import apply_rope, rmsnorm, softcap

NEG_INF = -2.0 ** 30


def gqa_param_shapes(d_model, n_heads, n_kv, head_dim, qk_norm=False):
    """Parameter shapes of one GQA block (the reference's ``gqa_init``) and
    each weight's fan-in for He-normal initialisation."""
    shapes = {
        "wq": ((d_model, n_heads, head_dim), d_model),
        "wk": ((d_model, n_kv, head_dim), d_model),
        "wv": ((d_model, n_kv, head_dim), d_model),
        "wo": ((n_heads, head_dim, d_model), n_heads * head_dim),
    }
    if qk_norm:
        shapes["q_norm"] = {"scale": ((head_dim,), None)}
        shapes["k_norm"] = {"scale": ((head_dim,), None)}
    return shapes


def _head_mask_bshd(head_mask, o):
    """A (H,) or (B, H) head mask shaped to broadcast over (B, S, H, D)."""
    m = head_mask.to(o.dtype)
    return m[:, None, :, None] if m.dim() == 2 else m[None, None, :, None]


def dense_attention(q, k, v, *, causal=True, window=None, cap=None,
                    head_mask=None):
    """The dense masked path (no kernel table): full masked softmax over
    KV heads repeated to H, then the head mask multiplied in — the
    counterpart of the reference's ``chunked_attention`` at serving prompt
    lengths (the whole score matrix fits; no chunking)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(D)
    s = softcap(s, cap)
    qpos = torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vf)
    if head_mask is not None:
        o = o * _head_mask_bshd(head_mask, o)
    return o.to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, C, KV, D) — C = min(max_len, window)
    v: torch.Tensor


def gqa_cache_init(batch, max_len, n_kv, head_dim, window=None,
                   dtype=torch.float32, device=None):
    """A zeroed (batch, C, KV, D) cache on ``device`` (the card unless the
    caller asks for the CPU)."""
    device = resolve_device(device)
    c = min(max_len, window) if window else max_len
    shape = (batch, c, n_kv, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _qkv(p, x, positions, rope_theta, qk_norm, norm_eps):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if qk_norm:
        q = rmsnorm(p["q_norm"], q, norm_eps)
        k = rmsnorm(p["k_norm"], k, norm_eps)
    return (apply_rope(q, positions, rope_theta),
            apply_rope(k, positions, rope_theta), v)


def gqa_forward(p, x, positions, *, n_heads, n_kv, head_dim, rope_theta,
                causal=True, window=None, cap=None, qk_norm=False,
                norm_eps=1e-6, head_mask=None, kernel=None,
                cache_len=None, cache_dtype=None):
    """Full-sequence GQA. ``kernel``: the ``attention`` op of
    ``kernels.dispatch`` (the head prefix is then skipped inside the
    kernel), or None for :func:`dense_attention`. ``cache_len``: when set,
    also return the post-rope K/V packed into a ring-buffer
    :class:`KVCache` of that many slots (the fused prefill path)."""
    del n_heads, n_kv, head_dim
    q, k, v = _qkv(p, x, positions, rope_theta, qk_norm, norm_eps)
    if kernel is not None:
        o = kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                   causal=causal, window=window, cap=cap,
                   head_mask=head_mask)
    else:
        o = dense_attention(q, k, v, causal=causal, window=window, cap=cap,
                            head_mask=head_mask)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    if cache_len is None:
        return out
    return out, _ring_pack(k, v, cache_len, cache_dtype or k.dtype)


def gqa_forward_cohort(p, x, seq_len, *, n_heads, n_kv, head_dim,
                       rope_theta, causal=True, window=None, cap=None,
                       qk_norm=False, norm_eps=1e-6, head_mask=None,
                       kernel=None):
    """Full-sequence GQA over a cohort (no cache): x (G, T, d) with
    T = B · seq_len token rows per client, every weight of ``p`` with a
    leading client axis ((G, d, H, hd) ``wq`` and so on), ``head_mask``
    None or (G, H). Attention runs over the G·B sequences at once — the
    row axis is client × sequence, each row with its client's head
    prefix — through ``kernel`` (the differentiable ``attention`` op of
    ``kernels.dispatch``) or :func:`dense_attention`. Returns (G, T, d).
    The projections are plain products, as in the reference."""
    del n_heads, n_kv, head_dim
    G, T, d = x.shape
    B = T // seq_len
    xs = x.reshape(G, B, seq_len, d)
    q = torch.einsum("gbsd,gdhk->gbshk", xs, p["wq"].to(x.dtype))
    k = torch.einsum("gbsd,gdhk->gbshk", xs, p["wk"].to(x.dtype))
    v = torch.einsum("gbsd,gdhk->gbshk", xs, p["wv"].to(x.dtype))
    if qk_norm:
        q = rmsnorm(p["q_norm"], q, norm_eps)
        k = rmsnorm(p["k_norm"], k, norm_eps)
    positions = torch.arange(seq_len, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    rows = lambda t: t.reshape((G * B,) + t.shape[2:])     # noqa: E731
    hm = None if head_mask is None else head_mask.repeat_interleave(B, 0)
    if kernel is not None:
        o = kernel(rows(q).contiguous(), rows(k).contiguous(),
                   rows(v).contiguous(), causal=causal, window=window,
                   cap=cap, head_mask=hm)
    else:
        o = dense_attention(rows(q), rows(k), rows(v), causal=causal,
                            window=window, cap=cap, head_mask=hm)
    o = o.reshape((G, B) + o.shape[1:])
    out = torch.einsum("gbshk,ghkd->gbsd", o, p["wo"].to(x.dtype))
    return out.reshape(G, T, d)


def _ring_pack(k, v, C: int, dtype):
    """Pack full-prefill K/V (B,S,KV,D) into the ring-buffer cache layout:
    slot j holds the *last* prompt position ≡ j (mod C) — the state
    stepwise :func:`gqa_decode` leaves after writing positions 0..S-1."""
    S = k.shape[1]
    slots = torch.arange(C, device=k.device)
    idx = (S - 1) - torch.remainder(S - 1 - slots, C)
    valid = (idx >= 0)[None, :, None, None]
    gather = idx.clamp_min(0)
    zero = torch.zeros((), dtype=k.dtype, device=k.device)
    kc = torch.where(valid, k[:, gather], zero).to(dtype)
    vc = torch.where(valid, v[:, gather], zero).to(dtype)
    return KVCache(kc, vc)


def gqa_decode(p, x, cache: KVCache, pos, *, n_heads, n_kv, head_dim,
               rope_theta, window=None, cap=None, qk_norm=False,
               norm_eps=1e-6, head_mask=None):
    """x: (B,1,d); pos: (B,) integer tensor, each row's own position (a
    Python int or 0-d tensor applies to every row). Returns (out, cache).

    Each row writes its own ring slot ``pos % C`` and masks its own cache
    validity. The write is **in place**: the returned cache holds the same
    tensors as ``cache`` (the serving path keeps one cache allocation).
    head_mask: optional (H,) or (B, H) 0/1 query-head prefix — masked
    heads' outputs are zeroed before ``wo``."""
    del window
    B = x.shape[0]
    C = cache.k.shape[1]
    dev = x.device
    posv = torch.as_tensor(pos, device=dev).to(torch.int64).reshape(-1)
    posv = posv.expand(B) if posv.numel() == 1 else posv
    q, k, v = _qkv(p, x, posv[:, None], rope_theta, qk_norm, norm_eps)

    rows = torch.arange(B, device=dev)
    slot = torch.remainder(posv, C)
    cache.k[rows, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v[:, 0].to(cache.v.dtype)

    G = n_heads // n_kv
    qr = q.reshape(B, n_kv, G, head_dim)
    s = torch.einsum("bkgd,bskd->bkgs", qr.float(),
                     cache.k.float()) / math.sqrt(head_dim)
    s = softcap(s, cap)
    # slot j holds position pos - ((pos - j) mod C); valid iff >= 0
    slots = torch.arange(C, device=dev)
    slot_pos = posv[:, None] - torch.remainder(posv[:, None] - slots, C)
    s = torch.where((slot_pos >= 0)[:, None, None, :], s,
                    torch.full((), NEG_INF, device=dev))
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", pattn, cache.v.float())
    o = o.reshape(B, 1, n_heads, head_dim).to(x.dtype)
    if head_mask is not None:
        o = o * _head_mask_bshd(head_mask, o)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, cache
