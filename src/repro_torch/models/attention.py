"""GQA and MLA attention: full-sequence forward (prefill) and cached
decode.

The port of the reference's ``models/attention.py``. Layouts are the
reference's: GQA ``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo``
(H, hd, d), activations (B, S, H, D), KV caches (B, C, KV, D) ring
buffers; MLA (deepseek-v2) ``wq`` (d, H, nope + rope), ``w_dkv``
(d, kv_lora + rope), ``kv_norm``, ``w_uk`` (kv_lora, H, nope), ``w_uv``
(kv_lora, H, v), ``wo`` (H, v, d), and a compressed-latent cache
(:class:`MLACache`). The projections are plain products (the reference
left them to XLA outside Pallas) and stay ``torch.einsum``; so does MLA's
attention, which the reference runs outside any Pallas kernel
(``dispatch_attention`` → ``chunked_attention``): :func:`dense_attention`
here.

Elastic masks may carry a leading batch axis: ``head_mask`` (H,) or
(B, H), so every row of a serving batch can be a different submodel.
``gqa_forward_cohort`` is the training form: client-stacked weights with
a leading client axis G, one head mask row per client.

Head parallelism (``mesh``, a ``sharding.mesh.HostMesh``): the reference's
``dispatch_attention``. ``wq`` and ``wo`` hold this model rank's block of
the query heads; K/V heads shard with them when ``n_kv`` is a multiple of
the axis, and otherwise every rank holds all of them (gathered over
``model`` where the rules split ``wk`` / ``wv`` unevenly) and takes its
heads' K/V by ``(lo + j) // G``. The head mask is sliced to the block, the
attention runs on the local heads with the local prefix, and ``wo``'s
partial products meet in one all-reduce over ``model``. The reference
leaves decode (``Sq == 1``) to GSPMD; the port shards it by heads the same
way, with the KV cache's head axis over ``model`` where the K/V heads
shard (else whole on every rank).
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


def mla_param_shapes(d_model, n_heads, mla):
    """Parameter shapes of one MLA block (the reference's ``mla_init``)
    and each weight's fan-in for He-normal initialisation."""
    qk = mla.qk_nope_dim + mla.qk_rope_dim
    r = mla.kv_lora_rank
    return {
        "wq": ((d_model, n_heads, qk), d_model),
        "w_dkv": ((d_model, r + mla.qk_rope_dim), d_model),
        "kv_norm": {"scale": ((r,), None)},
        "w_uk": ((r, n_heads, mla.qk_nope_dim), r),
        "w_uv": ((r, n_heads, mla.v_head_dim), r),
        "wo": ((n_heads, mla.v_head_dim, d_model),
               n_heads * mla.v_head_dim),
    }


def _head_mask_bshd(head_mask, o):
    """A (H,) or (B, H) head mask shaped to broadcast over (B, S, H, D)."""
    m = head_mask.to(o.dtype)
    return m[:, None, :, None] if m.dim() == 2 else m[None, None, :, None]


def dense_attention(q, k, v, *, causal=True, window=None, cap=None,
                    head_mask=None):
    """The dense masked path (no kernel table): full masked softmax over
    KV heads repeated to H, then the head mask multiplied in — the
    counterpart of the reference's ``chunked_attention`` at serving prompt
    lengths (the whole score matrix fits; no chunking). The scale is
    ``1/sqrt(D)`` of q's head dim; v's may differ (MLA)."""
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


def _head_block(mesh, n_heads, n_kv):
    """``(lo, hi, kv_local)``: this model rank's query heads and whether
    the K/V heads shard with them (``n_kv`` a multiple of the axis), or
    None where the heads are not sharded (``mesh`` None or the rules
    replicate ``wq``)."""
    if mesh is None or not mesh.sharded(n_heads):
        return None
    lo, hi = mesh.block(n_heads)
    return lo, hi, n_kv % mesh.model == 0


def _kv_for_heads(mesh, k, v, dim, n_heads, n_kv, block):
    """(k, v, k_q, v_q): the K/V this rank keeps in its cache — its block
    of the K/V heads, or all of them (gathered over ``model`` where the
    rules split them) — and the K/V its query heads read: the same block,
    or head ``(lo + j) // G`` for local query head j."""
    lo, hi, kv_local = block
    if kv_local:
        return k, v, k, v
    k = mesh.all_gather(k, dim, n_kv)
    v = mesh.all_gather(v, dim, n_kv)
    idx = (lo + torch.arange(hi - lo, device=k.device)) // (n_heads // n_kv)
    return k, v, k.index_select(dim, idx), v.index_select(dim, idx)


def _local_heads(mask, block):
    return mask if mask is None or block is None else \
        mask[..., block[0]:block[1]]


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
                cache_len=None, cache_dtype=None, mesh=None):
    """Full-sequence GQA. ``kernel``: the ``attention`` op of
    ``kernels.dispatch`` (the head prefix is then skipped inside the
    kernel), or None for :func:`dense_attention`. ``cache_len``: when set,
    also return the post-rope K/V packed into a ring-buffer
    :class:`KVCache` of that many slots (the fused prefill path).
    ``mesh``: head parallel (module docstring)."""
    del head_dim
    block = _head_block(mesh, n_heads, n_kv)
    q, k, v = _qkv(p, x, positions, rope_theta, qk_norm, norm_eps)
    kq, vq = k, v
    if block is not None:
        k, v, kq, vq = _kv_for_heads(mesh, k, v, 2, n_heads, n_kv, block)
    hm = _local_heads(head_mask, block)
    if kernel is not None:
        o = kernel(q.contiguous(), kq.contiguous(), vq.contiguous(),
                   causal=causal, window=window, cap=cap, head_mask=hm)
    else:
        o = dense_attention(q, kq, vq, causal=causal, window=window, cap=cap,
                            head_mask=hm)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    if block is not None:
        out = mesh.all_reduce(out)
    if cache_len is None:
        return out
    return out, _ring_pack(k, v, cache_len, cache_dtype or k.dtype)


def gqa_forward_cohort(p, x, seq_len, *, n_heads, n_kv, head_dim,
                       rope_theta, causal=True, window=None, cap=None,
                       qk_norm=False, norm_eps=1e-6, head_mask=None,
                       kernel=None, mesh=None):
    """Full-sequence GQA over a cohort (no cache): x (G, T, d) with
    T = B · seq_len token rows per client, every weight of ``p`` with a
    leading client axis ((G, d, H, hd) ``wq`` and so on), ``head_mask``
    None or (G, H). Attention runs over the G·B sequences at once — the
    row axis is client × sequence, each row with its client's head
    prefix — through ``kernel`` (the differentiable ``attention`` op of
    ``kernels.dispatch``) or :func:`dense_attention`. Returns (G, T, d).
    The projections are plain products, as in the reference. ``mesh``:
    head parallel (module docstring)."""
    del head_dim
    block = _head_block(mesh, n_heads, n_kv)
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
    if block is not None:
        _, _, k, v = _kv_for_heads(mesh, k, v, 3, n_heads, n_kv, block)
    head_mask = _local_heads(head_mask, block)
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
    if block is not None:
        out = mesh.all_reduce(out)
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
               norm_eps=1e-6, head_mask=None, mesh=None):
    """x: (B,1,d); pos: (B,) integer tensor, each row's own position (a
    Python int or 0-d tensor applies to every row). Returns (out, cache).

    Each row writes its own ring slot ``pos % C`` and masks its own cache
    validity. The write is **in place**: the returned cache holds the same
    tensors as ``cache`` (the serving path keeps one cache allocation).
    head_mask: optional (H,) or (B, H) 0/1 query-head prefix — masked
    heads' outputs are zeroed before ``wo``. ``mesh``: head parallel
    (module docstring); ``cache`` is then this rank's block."""
    del window
    block = _head_block(mesh, n_heads, n_kv)
    B = x.shape[0]
    C = cache.k.shape[1]
    dev = x.device
    posv = torch.as_tensor(pos, device=dev).to(torch.int64).reshape(-1)
    posv = posv.expand(B) if posv.numel() == 1 else posv
    q, k, v = _qkv(p, x, posv[:, None], rope_theta, qk_norm, norm_eps)
    if block is not None and not block[2]:
        k = mesh.all_gather(k, 2, n_kv)
        v = mesh.all_gather(v, 2, n_kv)

    rows = torch.arange(B, device=dev)
    slot = torch.remainder(posv, C)
    cache.k[rows, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v[:, 0].to(cache.v.dtype)

    kc, vc = cache.k, cache.v
    if block is not None:
        lo, hi, kv_local = block
        group = n_heads // n_kv
        n_heads = hi - lo
        if kv_local:
            n_kv = kc.shape[2]
        else:                   # each local query head its own K/V head
            idx = (lo + torch.arange(n_heads, device=dev)) // group
            kc, vc = kc[:, :, idx], vc[:, :, idx]
            n_kv = n_heads
    G = n_heads // n_kv
    qr = q.reshape(B, n_kv, G, head_dim)
    s = torch.einsum("bkgd,bskd->bkgs", qr.float(),
                     kc.float()) / math.sqrt(head_dim)
    s = softcap(s, cap)
    # slot j holds position pos - ((pos - j) mod C); valid iff >= 0
    slots = torch.arange(C, device=dev)
    slot_pos = posv[:, None] - torch.remainder(posv[:, None] - slots, C)
    s = torch.where((slot_pos >= 0)[:, None, None, :], s,
                    torch.full((), NEG_INF, device=dev))
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", pattn, vc.float())
    o = o.reshape(B, 1, n_heads, head_dim).to(x.dtype)
    head_mask = _local_heads(head_mask, block)
    if head_mask is not None:
        o = o * _head_mask_bshd(head_mask, o)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    if block is not None:
        out = mesh.all_reduce(out)
    return out, cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): full forward + absorbed decode on the compressed cache
# ---------------------------------------------------------------------------
MLA_ROPE_THETA = 10_000.0      # the reference's, whatever cfg.rope_theta


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, C, kv_lora)
    k_rope: torch.Tensor  # (B, C, qk_rope)


def mla_cache_init(batch, max_len, mla, dtype=torch.float32, device=None):
    """A zeroed compressed-latent cache of ``max_len`` positions on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return MLACache(
        torch.zeros((batch, max_len, mla.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((batch, max_len, mla.qk_rope_dim), dtype=dtype,
                    device=device))


def _weight(p, name, spec, lead, dtype):
    """(einsum spec, weight) of leaf ``name`` of an MLA block whose own
    axes are ``spec``: a client-stacked weight (one more axis than the
    reference's) also carries the first of x's leading axes ``lead``."""
    t = p[name].to(dtype)
    return ((lead[:1] + spec) if t.dim() > len(spec) else spec), t


def _mla_qkv(p, x, positions, mla, norm_eps, lead=""):
    """(q_nope, q_rope, c_kv, k_rope) of x (lead..., S, d): the query
    heads split into their position-free and rotary parts, and the
    normalised latent with its shared rotary key. ``lead``: einsum letters
    of the leading axes of x (see ``_weight``)."""
    def w(name, spec):
        return _weight(p, name, spec, lead, x.dtype)
    sq, wq = w("wq", "dhk")
    q = torch.einsum(f"{lead}sd,{sq}->{lead}shk", x, wq)
    q_nope, q_rope = torch.split(q, [mla.qk_nope_dim, mla.qk_rope_dim], -1)
    q_rope = apply_rope(q_rope, positions, MLA_ROPE_THETA)
    sd, wd = w("w_dkv", "dc")
    dkv = torch.einsum(f"{lead}sd,{sd}->{lead}sc", x, wd)
    c_kv, k_rope = torch.split(dkv, [mla.kv_lora_rank, mla.qk_rope_dim], -1)
    c_kv = rmsnorm(p["kv_norm"], c_kv, norm_eps)
    k_rope = apply_rope(k_rope.unsqueeze(-2), positions,
                        MLA_ROPE_THETA).squeeze(-2)
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(p, x, q_nope, q_rope, c_kv, k_rope, mla, causal, head_mask,
                lead):
    """Full-sequence MLA attention from the latents: K / V expanded per
    head, q · k over nope + rope at scale ``1/sqrt(nope + rope)``
    (:func:`dense_attention`), then ``wo``. ``lead`` as in
    :func:`_mla_qkv`; the attention runs over the rows of all leading
    axes at once."""
    def w(name, spec):
        return _weight(p, name, spec, lead, x.dtype)
    su, wuk = w("w_uk", "chk")
    k_nope = torch.einsum(f"{lead}sc,{su}->{lead}shk", c_kv, wuk)
    sv, wuv = w("w_uv", "chk")
    v = torch.einsum(f"{lead}sc,{sv}->{lead}shk", c_kv, wuv)
    k = torch.cat([k_nope, k_rope.unsqueeze(-2).expand(
        k_nope.shape[:-1] + (mla.qk_rope_dim,))], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    S, H = q.shape[-3], q.shape[-2]
    rows = lambda t: t.reshape((-1, S, H, t.shape[-1]))      # noqa: E731
    o = dense_attention(rows(q), rows(k), rows(v), causal=causal,
                        head_mask=head_mask)
    o = o.reshape(q.shape[:-1] + (mla.v_head_dim,))
    so, wo = w("wo", "hkd")
    return torch.einsum(f"{lead}shk,{so}->{lead}sd", o, wo)


def mla_forward(p, x, positions, *, n_heads, mla, causal=True,
                norm_eps=1e-6, head_mask=None, cache_len=None,
                cache_dtype=None):
    """Full-sequence MLA over x (B, S, d). ``cache_len``: when set, also
    return the compressed-latent cache (positions 0..S-1 filled, the rest
    zeros) — the fused prefill path."""
    del n_heads
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, positions, mla, norm_eps,
                                            "b")
    out = _mla_attend(p, x, q_nope, q_rope, c_kv, k_rope, mla, causal,
                      head_mask, "b")
    if cache_len is None:
        return out
    dt = cache_dtype or c_kv.dtype
    B, S = x.shape[0], x.shape[1]
    cache = mla_cache_init(B, cache_len, mla, dt, x.device)
    cache.c_kv[:, :S] = c_kv.to(dt)
    cache.k_rope[:, :S] = k_rope.to(dt)
    return out, cache


def mla_forward_cohort(p, x, seq_len, *, n_heads, mla, causal=True,
                       norm_eps=1e-6, head_mask=None):
    """Full-sequence MLA over a cohort (no cache): x (G, T, d) with
    T = B · seq_len token rows per client, every weight of ``p`` with a
    leading client axis, ``head_mask`` None or (G, H). Returns (G, T, d).
    The attention runs over the G·B sequences at once, plain torch ops as
    in the reference."""
    del n_heads
    G, T, d = x.shape
    B = T // seq_len
    xs = x.reshape(G, B, seq_len, d)
    positions = torch.arange(seq_len, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, xs, positions, mla, norm_eps,
                                            "gb")
    hm = None if head_mask is None else head_mask.repeat_interleave(B, 0)
    out = _mla_attend(p, xs, q_nope, q_rope, c_kv, k_rope, mla, causal, hm,
                      "gb")
    return out.reshape(G, T, d)


def mla_decode(p, x, cache: MLACache, pos, *, n_heads, mla, norm_eps=1e-6,
               head_mask=None):
    """Absorbed MLA decode: attention runs in the compressed latent space.
    x (B, 1, d); pos (B,) per-row positions (or one for every row). Each
    row writes its latent at its own position and attends to positions
    0..pos; the write is **in place**. Returns (out (B, 1, d), cache)."""
    del n_heads
    B = x.shape[0]
    dev = x.device
    posv = torch.as_tensor(pos, device=dev).to(torch.int64).reshape(-1)
    posv = posv.expand(B) if posv.numel() == 1 else posv
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, posv[:, None], mla,
                                            norm_eps, "b")
    rows = torch.arange(B, device=dev)
    cache.c_kv[rows, posv] = c_kv[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[rows, posv] = k_rope[:, 0].to(cache.k_rope.dtype)
    ck, cr = cache.c_kv.float(), cache.k_rope.float()
    # absorb W_uk into q: (B, H, nope) @ (lora, H, nope) -> (B, H, lora)
    q_abs = torch.einsum("bhk,chk->bhc", q_nope[:, 0],
                         p["w_uk"].to(x.dtype))
    s = torch.einsum("bhc,bsc->bhs", q_abs.float(), ck)
    s = s + torch.einsum("bhk,bsk->bhs", q_rope[:, 0].float(), cr)
    s = s / math.sqrt(mla.qk_nope_dim + mla.qk_rope_dim)
    valid = torch.arange(ck.shape[1], device=dev)[None, :] <= posv[:, None]
    s = torch.where(valid[:, None, :], s, torch.full((), NEG_INF,
                                                     device=dev))
    pr = torch.softmax(s, dim=-1)
    o_c = torch.einsum("bhs,bsc->bhc", pr, ck)
    o = torch.einsum("bhc,chk->bhk", o_c.to(x.dtype), p["w_uv"].to(x.dtype))
    if head_mask is not None:
        m = head_mask.to(o.dtype)
        o = o * (m[:, :, None] if m.dim() == 2 else m[None, :, None])
    out = torch.einsum("bhk,hkd->bd", o, p["wo"].to(x.dtype))
    return out[:, None, :], cache
