"""Transformer (GQA or MLA attention, MLP or MoE blocks, local / global
attention pairs) and Mamba2 SSM stacks with the shared hybrid block:
parameter init, the training forward, fused prefill and cached decode.

The port of the reference's ``models/transformer.py``. A segment's layer
weights are stacked with a leading ``n_layers`` axis, as in the
reference; a Python loop over the layers replaces ``lax.scan``. Elastic
masks (``masks``: ``ff``, ``heads``, ``depth``) gate d_ff, query heads and
layers in parent coordinates.

Two batch layouts replace the reference's ``vmap``:

* serving (``prefill``, ``decode_step``): one parent, and masks that may
  carry a leading batch axis so every row is a different submodel (the
  slot axis);
* training (``forward``): a leading client axis G on every parameter,
  mask and activation — each client its own weights and its own
  submodel — with tokens (G, B, S). The engine's rounds run without
  remat: at the training slice's shapes the activations of a step fit
  beside the optimizer state (the dense SSD path checkpoints each chunk
  itself, as the reference does).
* one model (``forward_batch``, ``loss_fn``): the reference's batch-dict
  forward and LM loss — token, audio-frame or image-embedding inputs
  (``embed_inputs``), the MoE aux loss, optional remat and activation
  dtype, the chunked unembedding + CE — run as a one-client stack of the
  training layout.

Segment kinds (``configs.base.Segment``):

* ``"attn"``: ``{"blocks": ...}`` of attention blocks. GQA attention runs
  the ``attention`` op (K2–K4); MLA attention (``cfg.attn_type ==
  "mla"``, deepseek-v2) runs plain torch ops on its compressed latents,
  as the reference runs it outside any Pallas kernel, with a
  compressed-latent decode cache (``MLACache``) and absorbed decode.
  MoE blocks (``Segment.use_moe``: a ``moe`` leaf in place of ``mlp``)
  run ``models.moe.moe_forward`` with the ``experts`` mask and the ``moe``
  op: one group per client in training, one group per row in decode (the
  server's ``vmap`` over slots), and in prefill one group for the whole
  batch — or one per row when the expert mask carries a batch axis.
* ``"attn_pair"`` (gemma2): ``{"local": ..., "global": ...}``, two stacked
  block trees; pair l runs the local block at ``pair_local_window`` and
  then the global block, both under pair l's depth gate. Their decode
  caches are ``{"local": KVCache, "global": KVCache}`` per segment.
* ``"ssm"``: ``{"blocks": {"ln", "mamba"}}``, ``x + gate · mamba(ln(x))``
  (``models.ssm``) with the ``ssm_heads`` mask and the ``ssd`` op; an
  ``SSMCache`` (state and conv histories) per layer.

The model axis (``mesh``, a ``sharding.mesh.HostMesh`` of ``(data,
model)``; ``prefill``, ``decode_step``, ``forward_batch``,
``init_decode_caches``): ``params`` is this rank's block
(``sharding.specs.shard_params``) — vocab-parallel embedding and logits,
tensor-parallel MLP, head-parallel attention and Mamba2, expert-parallel
MoE (the layers' docstrings) — and the batch goes over ``data`` where
``sharding.specs.input_shardings`` puts it there (else every data rank
runs every row). The entry points take the whole batch and return the
whole (B, V) logits on every rank; a decode cache is this rank's block.
The MoE groups its tokens as the reference's branch for the mesh does: in
the expert-parallel branch (E a multiple of ``model``) one group per data
rank (when the tokens split evenly) with capacity by E, otherwise one
group of the whole batch with capacity by ``capacity_experts``
(``_moe_rows``). Covered: GQA attention, the MLP, the MoE and the Mamba2
block; MLA, local / global pairs, the shared hybrid block and the input
frontends raise on a model axis, as does a decode cache whose sequence the
rules put over ``data`` (batch 1, long context).

The shared hybrid block (zamba2: ``params["shared_attn"]``, one unstacked
attention block with ``shared_attn_d_ff``) runs after every segment with
``shared_attn_after``, at ``cfg.sliding_window``, under the masks with
``ff`` / ``depth`` / ``heads`` stripped (every submodel keeps it whole),
through the same op table; ``DecodeCaches.shared`` holds its KV cache per
site, stacked (n_sites, B, ...).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (at_least_fp32, embed, layernorm,
                                       mlp, rmsnorm, softcap)
from repro_torch.optim.optimizers import tree_map

Params = Dict[str, Any]


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


def _ffn(bp, h, cfg: ModelConfig, masks, kernels, per_row: bool,
         with_aux: bool = False, mesh=None, rows=None):
    """The block's feed-forward: the MLP, or the MoE layer of a ``moe``
    block. h (B, S, d); with ``per_row`` every row of h is its own MoE
    group (own capacity, own expert prefix), else the B·S tokens form one
    group. Returns (out, aux): with ``with_aux`` a MoE block's aux loss
    (load balance + router z) per group, else None. ``mesh``: the model
    axis; ``rows`` ``(lo, hi, B)``, this data rank's rows of the batch
    (``_moe_rows``)."""
    if "moe" not in bp:
        return mlp(bp["mlp"], h, cfg.act, width_mask=_masks_get(masks, "ff"),
                   kernel=_masks_get(kernels, "mlp"), mesh=mesh,
                   d_ff=cfg.d_ff), None
    kw = dict(act=cfg.act, expert_mask=_masks_get(masks, "experts"),
              kernel=_masks_get(kernels, "moe"), return_aux=with_aux)
    if mesh is not None and not per_row:
        m, aux = _moe_rows(bp["moe"], h, cfg, mesh, rows, kw)
    else:
        x = h if per_row else h.reshape(1, -1, h.shape[-1])
        cap = None if mesh is None else moe_lib.expert_plan(
            cfg.moe, mesh, x.shape[1], split=False).cap
        m, aux = moe_lib.moe_forward(bp["moe"], x, cfg.moe, mesh=mesh,
                                     cap=cap, **kw)
    return m.reshape(h.shape), \
        aux["aux_loss"] + aux["z_loss"] if with_aux else None


def _moe_rows(p, h, cfg: ModelConfig, mesh, rows, kw):
    """The MoE over this data rank's rows h (B_loc, S, d) of a batch of B
    (``rows`` ``(lo, hi, B)``) in the reference's token groups: in its
    expert-parallel branch the B·S tokens split into one contiguous group
    per data rank when they split evenly, else (and in its single-device
    branch) they form one group. Where this rank's rows are one such group
    (or it holds every row) it computes them alone; otherwise the rows are
    gathered over ``data``, every group computed and this rank's rows
    kept. Returns (out (B_loc, S, d), aux of the groups or None)."""
    lo, hi, B = rows
    S, d = h.shape[1], h.shape[2]
    T = B * S
    plan = moe_lib.expert_plan(cfg.moe, mesh, T)
    groups, cap = plan.groups, plan.cap
    per = T // groups
    if (lo * S) % per == 0 and (hi - lo) * S == per:
        out, aux = moe_lib.moe_forward(p, h.reshape(1, -1, d), cfg.moe,
                                       mesh=mesh, cap=cap, **kw)
        return out.reshape(h.shape), aux
    if p["router"].dim() == 3:          # a one-client stack: its experts
        p = tree_map(lambda t: t[0], p)
    full = h if hi - lo == B else mesh.all_gather(h, 0, B, "data")
    out, aux = moe_lib.moe_forward(p, full.reshape(groups, per, d), cfg.moe,
                                   mesh=mesh, cap=cap, **kw)
    return out.reshape(B, S, d)[lo:hi], aux


def _check_mesh(cfg: ModelConfig, mesh, batch: int, caches: bool) -> None:
    """Raise for what the model axis does not cover yet (module
    docstring)."""
    if mesh is None:
        return
    if mesh.model > 1 and (cfg.attn_type == "mla" or cfg.shared_attn_d_ff
                           or cfg.frontend is not None or any(
                               s.kind == "attn_pair" for s in cfg.segments)):
        raise NotImplementedError(
            f"{cfg.name}: the model axis covers GQA attention, the MLP, the "
            "MoE and the Mamba2 block; MLA, local / global pairs, the shared "
            "hybrid block and the input frontends wait for the remaining "
            "families of ROADMAP A17b")
    if caches and mesh.data > 1 and not mesh.sharded(batch, "data") and any(
            s.kind != "ssm" for s in cfg.segments):
        raise NotImplementedError(
            f"a decode cache of batch {batch} on {mesh.data} data ranks: the "
            "rules put its sequence over 'data' (sharding.specs."
            "cache_shardings), the sequence-sharded decode cache of ROADMAP "
            "A17b")


def _batch_rows(mesh, batch: int):
    """``(lo, hi, B)``: this data rank's rows of a batch of B — its block
    where ``input_shardings`` puts the batch over ``data``, else all."""
    if mesh is None:
        return 0, batch, batch
    return mesh.block(batch, "data") + (batch,)


def _local_rows(t, rows):
    """A tensor with a leading batch axis, cut to this rank's rows; any
    other tensor (one value for every row) as it is."""
    lo, hi, B = rows
    if (lo, hi) == (0, B) or t.dim() == 0 or t.shape[0] != B:
        return t
    return t[lo:hi]


def _local_masks(masks, rows):
    """The masks of this rank's rows: each mask with a batch axis ((B, n),
    or a (B, n_layers) depth gate) cut to them."""
    if masks is None or rows[:2] == (0, rows[2]):
        return masks
    out = {}
    for k, v in masks.items():
        if k == "depth":
            out[k] = [g[rows[0]:rows[1]] if g.dim() == 2 else g for g in v]
        else:
            out[k] = v[rows[0]:rows[1]] if v.dim() == 2 else v
    return out


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _param_tree(cfg: ModelConfig, leaf) -> Params:
    """The parameter tree of ``cfg``, each leaf made by ``leaf(shape,
    init)``: ``init`` is a normal's std (He-normal ``1/sqrt(fan_in)``
    weights, ``0.02`` for the embedding), ``"zeros"``, ``"ones"`` or one of
    ``models.ssm.INITS``. Leaves are made in the order :func:`init_params`
    draws them."""
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

    def attn_block(L, use_moe, d_ff):
        """An attention block's leaves with leading axes ``L`` (the
        reference's ``_attn_block_init``)."""
        if cfg.attn_type == "mla":
            shapes = attn_lib.mla_param_shapes(d, cfg.n_heads, cfg.mla)
        else:
            shapes = attn_lib.gqa_param_shapes(
                d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.qk_norm)
        attn = {}
        for name, spec in shapes.items():
            if isinstance(spec, dict):       # q_norm / k_norm / kv_norm
                attn[name] = {"scale": leaf(L + spec["scale"][0], "zeros")}
            else:
                shape, fan_in = spec
                attn[name] = leaf(L + shape, 1.0 / math.sqrt(fan_in))
        blocks = {"ln1": norm(L, d), "ln2": norm(L, d), "attn": attn}
        if use_moe:
            blocks["moe"] = stacked(L, moe_lib.moe_param_specs(
                d, cfg.moe, cfg.mlp_gated))
        else:
            mlp_p = {"wi": leaf(L + (d, d_ff), 1.0 / math.sqrt(d)),
                     "wo": leaf(L + (d_ff, d), 1.0 / math.sqrt(d_ff))}
            if cfg.mlp_gated:
                mlp_p["wg"] = leaf(L + (d, d_ff), 1.0 / math.sqrt(d))
            blocks["mlp"] = mlp_p
        if cfg.post_norms:
            blocks["post_ln1"] = norm(L, d)
            blocks["post_ln2"] = norm(L, d)
        return blocks

    segs = []
    for seg in cfg.segments:
        L = (seg.n_layers,)
        if seg.kind == "ssm":
            segs.append({"blocks": {
                "ln": norm(L, d),
                "mamba": stacked(L, ssm_lib.mamba_param_shapes(d, cfg.ssm))}})
        elif seg.kind == "attn_pair":
            segs.append({"local": attn_block(L, seg.use_moe, f),
                         "global": attn_block(L, seg.use_moe, f)})
        elif seg.kind == "attn":
            segs.append({"blocks": attn_block(L, seg.use_moe, f)})
        else:
            raise ValueError(seg.kind)
    p["segments"] = segs
    if cfg.shared_attn_d_ff:
        p["shared_attn"] = attn_block((), False, cfg.shared_attn_d_ff)
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
    (``checkpoint.bridge``). On ``device="meta"`` it makes the tree's
    shapes and dtypes only (a restore template)."""
    dev = resolve_device(device)
    # a meta tensor takes its (unused) draws from a CPU generator
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)

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


def _logits(params, cfg: ModelConfig, x, mesh=None):
    """x (..., d) -> softcapped logits in at least fp32 (fp64 stays fp64);
    the weights may carry a leading client axis matching x's (x (G, T,
    d)). ``mesh``: the weights hold this model rank's block of the vocab,
    and the blocks' logits are gathered over ``model``."""
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].transpose(-1, -2).to(x.dtype)
    else:
        logits = x @ params["lm_head"]["w"].to(x.dtype)
    logits = softcap(at_least_fp32(logits), cfg.final_softcap)
    if mesh is not None:
        logits = mesh.all_gather(logits, -1, cfg.padded_vocab)
    return logits


# ---------------------------------------------------------------------------
# training forward (client-stacked parameters)
# ---------------------------------------------------------------------------
def _shared_masks(masks):
    """The masks of the shared hybrid block: ``ff`` / ``depth`` /
    ``heads`` stripped — every submodel keeps the block whole (its d_ff
    differs from ``cfg.d_ff`` and its weights are shared)."""
    if masks is None:
        return None
    return {k: v for k, v in masks.items()
            if k not in ("ff", "depth", "heads")} or None


def _pairs(seg_p, n: int, dim: int):
    """The ``n`` (local, global) per-layer block trees of an ``attn_pair``
    segment whose layer axis is ``dim``."""
    return list(zip(_unbind_layers(seg_p["local"], n, dim),
                    _unbind_layers(seg_p["global"], n, dim)))


def _cohort_attn_block(bp, x, cfg: ModelConfig, seq_len: int, window,
                       masks, kernels, gate=None, with_aux=False,
                       remat=False, mesh=None, rows=None):
    """One attention block over a cohort: x (G, T, d) with T = B·S token
    rows per client, every weight of ``bp`` with a leading client axis.
    ``gate`` (G,) 0/1 multiplies the block's residual contributions (CFL
    depth elasticity: gate 0 is exactly the identity) and its aux loss.
    Returns (x, aux): with ``with_aux`` the MoE aux loss (G,) of a ``moe``
    block (zeros for an MLP block), else None. ``remat``: the attention
    and the FFN are recomputed in the backward instead of saved
    (``_ckpt``). ``mesh`` / ``rows``: the model axis (one client)."""
    wrap = _ckpt if remat else (lambda fn: fn)
    h = _norm(cfg, bp["ln1"], x)
    if cfg.attn_type == "mla":
        a = wrap(lambda p_, h_: attn_lib.mla_forward_cohort(
            p_, h_, seq_len, n_heads=cfg.n_heads, mla=cfg.mla,
            causal=cfg.causal, norm_eps=cfg.norm_eps,
            head_mask=_masks_get(masks, "heads")))(bp["attn"], h)
    else:
        a = wrap(lambda p_, h_: attn_lib.gqa_forward_cohort(
            p_, h_, seq_len, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, causal=cfg.causal, window=window,
            cap=cfg.attn_softcap, qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
            head_mask=_masks_get(masks, "heads"),
            kernel=_masks_get(kernels, "attention"), mesh=mesh))(
                bp["attn"], h)
    if cfg.post_norms:
        a = _norm(cfg, bp["post_ln1"], a)
    if gate is not None:
        a = a * _gate(gate, a)
    x = x + a
    h = _norm(cfg, bp["ln2"], x)
    if mesh is not None and "moe" in bp:   # one client's tokens, by rows
        hr = h.reshape(rows[1] - rows[0], seq_len, h.shape[-1])
        m, aux = _ffn(bp, hr, cfg, masks, kernels, per_row=False,
                      with_aux=with_aux, mesh=mesh, rows=rows)
        m = m.reshape(h.shape)
    else:
        m, aux = wrap(lambda bp_, h_: _ffn(bp_, h_, cfg, masks, kernels,
                                           per_row=True, with_aux=with_aux,
                                           mesh=mesh))(bp, h)
    if cfg.post_norms:
        m = _norm(cfg, bp["post_ln2"], m)
    if gate is not None:
        m = m * _gate(gate, m)
    if with_aux and aux is None:
        aux = torch.zeros(x.shape[0], device=x.device)
    if with_aux and gate is not None:
        aux = aux * gate.to(aux.dtype)
    return x + m, aux


def _cohort_ssm_block(bp, x, cfg: ModelConfig, batch: int, masks, kernels,
                      gate=None, with_aux=False, remat=False, mesh=None,
                      rows=None):
    """One SSM block over a cohort: x (G, T, d) with T = batch·S token rows
    per client; ``x + gate · mamba(ln(x))`` (the reference's
    ``_apply_ssm_block``). Returns (x, aux): zeros (G,) with
    ``with_aux``, else None."""
    G, T, d = x.shape
    wrap = _ckpt if remat else (lambda fn: fn)
    h = _norm(cfg, bp["ln"], x).reshape(G, batch, T // batch, d)
    y = wrap(lambda p_, h_: ssm_lib.mamba_forward_cohort(
        p_, h_, cfg.ssm, norm_eps=cfg.norm_eps,
        head_mask=_masks_get(masks, "ssm_heads"),
        kernel=_masks_get(kernels, "ssd"), mesh=mesh))(
            bp["mamba"], h).reshape(G, T, d)
    if gate is not None:
        y = y * _gate(gate, y)
    aux = torch.zeros(G, device=x.device) if with_aux else None
    return x + y, aux


def _ckpt(fn):
    """Inner remat (the reference's ``_ckpt``): ``fn``'s activations are
    recomputed in the backward instead of saved (non-reentrant
    ``torch.utils.checkpoint``)."""
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _remat_group(n: int) -> int:
    """Largest divisor of n not exceeding ~sqrt(n): the layers a remat
    group checkpoints at its boundary (the reference's)."""
    target = math.isqrt(n) + 1
    best = 1
    for g in range(1, target + 1):
        if n % g == 0:
            best = g
    return best


def _cohort_stack(params, cfg: ModelConfig, x, seq_len: int, batch: int,
                  masks, kernels, with_aux=False, remat=False, mesh=None,
                  rows=None):
    """Every segment (and the shared block after the segments that have
    it) over a cohort x (G, T, d), T = batch · seq_len, then the final
    norm. Returns (x, aux): the MoE aux losses (G,) summed over the layers
    with ``with_aux``, else None. ``remat``: the reference's two-level
    remat — each segment's layers in groups of ``_remat_group(n)`` (half
    as many pairs) checkpointed at the group's boundary, and each block's
    attention and FFN checkpointed inside (``_ckpt``); the outputs and
    gradients are the same, the forward runs up to three times.
    ``mesh`` / ``rows``: the model axis, for one client (``forward_batch``)."""
    depth = _masks_get(masks, "depth")
    aux = torch.zeros(x.shape[0], device=x.device) if with_aux else None
    kw = dict(with_aux=with_aux, remat=remat)
    if mesh is not None:
        kw.update(mesh=mesh, rows=rows)

    def add(total, a):
        return None if total is None else total + a

    for si, (seg_p, seg) in enumerate(zip(params["segments"], cfg.segments)):
        window = seg.sliding_window or cfg.sliding_window
        gates = None if depth is None else depth[si]
        if seg.kind == "attn_pair":
            units = _pairs(seg_p, seg.n_layers, 1)
        else:
            units = _unbind_layers(seg_p["blocks"], seg.n_layers, dim=1)

        def run(l, x, unit):
            """Layer (or pair) ``l``: (x, aux of the unit or None)."""
            g = None if gates is None else gates[:, l]
            if seg.kind == "attn_pair":
                x, a1 = _cohort_attn_block(unit[0], x, cfg, seq_len,
                                           seg.pair_local_window, masks,
                                           kernels, gate=g, **kw)
                x, a2 = _cohort_attn_block(unit[1], x, cfg, seq_len, None,
                                           masks, kernels, gate=g, **kw)
                return x, None if a1 is None else a1 + a2
            if seg.kind == "ssm":
                return _cohort_ssm_block(unit, x, cfg, batch, masks,
                                         kernels, gate=g, **kw)
            return _cohort_attn_block(unit, x, cfg, seq_len, window, masks,
                                      kernels, gate=g, **kw)

        if not remat:
            for l, unit in enumerate(units):
                x, a = run(l, x, unit)
                aux = add(aux, a)
        else:
            size = _remat_group(seg.n_layers)
            if seg.kind == "attn_pair":
                size = max(1, size // 2)
            for lo in range(0, seg.n_layers, size):
                def group(x, lo=lo):
                    total = torch.zeros(x.shape[0], device=x.device) \
                        if with_aux else None
                    for l in range(lo, min(lo + size, seg.n_layers)):
                        x, a = run(l, x, units[l])
                        total = add(total, a)
                    return x, total
                x, a = checkpoint(group, x, use_reentrant=False)
                aux = add(aux, a)
        if seg.shared_attn_after:
            x, a = _cohort_attn_block(params["shared_attn"], x, cfg, seq_len,
                                      cfg.sliding_window,
                                      _shared_masks(masks), kernels, **kw)
            aux = add(aux, a)
    return _norm(cfg, params["final_norm"], x), aux


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
    G, B, S = tokens.shape
    x = embed(params["embed"], tokens, scale=cfg.embed_scale)
    x = x.reshape(G, B * S, cfg.d_model)
    x, _ = _cohort_stack(params, cfg, x, S, B, masks, kernels)
    return _logits(params, cfg, x).reshape(G, B, S, -1)


# ---------------------------------------------------------------------------
# training: the batch-dict forward of one model, the LM loss
# ---------------------------------------------------------------------------
def embed_inputs(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
                 dtype=None, mesh=None):
    """x (B, S, d) of one (unstacked) model's batch: the token embedding,
    the audio frontend's precomputed ``frames`` (B, S, d), or the vision
    frontend's ``image_embeds`` (B, F, d) over the first F token
    positions; cast to ``dtype`` where one is given. ``mesh``: the table
    is this model rank's vocab block (``layers.embed``)."""
    if cfg.frontend == "audio":
        x = batch["frames"]
    elif cfg.frontend == "vision":
        tok = embed(params["embed"], batch["tokens"], scale=cfg.embed_scale)
        img = batch["image_embeds"].to(tok.dtype)
        x = torch.cat([img, tok[:, img.shape[1]:, :]], dim=1)
    else:
        x = embed(params["embed"], batch["tokens"], scale=cfg.embed_scale,
                  mesh=mesh, vocab=cfg.padded_vocab)
    return x if dtype is None else x.to(dtype)


def _unembed_w(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"]["table"].transpose(-1, -2)
    return params["lm_head"]["w"]


def _one_client(tree):
    """A tree (params or masks) as a one-client stack: a leading axis of
    1 on every leaf (views: gradients reach the caller's leaves)."""
    return tree_map(lambda t: t.unsqueeze(0), tree)


def forward_batch(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
                  *, masks=None, kernels=None, remat: bool = False,
                  activation_dtype=None, last_only: bool = False,
                  return_hidden: bool = False, mesh=None):
    """The reference's batch-dict forward of one model: ``batch`` holds
    ``tokens`` (B, S), and ``image_embeds`` (B, F, d) for a vision
    frontend, or an audio frontend's ``frames`` (B, S, d); ``params`` and
    ``masks`` carry no client axis (``ff`` (d_ff,), ``heads`` (H,),
    ``experts`` (E,), ``depth`` an (n_layers,) gate per segment). It runs
    as a one-client stack of the cohort path (the MoE layer routes the
    B·S tokens as one group, as the reference's ``moe_forward``). Returns
    (logits (B, S, V) in the activation dtype, softcapped, or only the
    last position's with ``last_only``; aux) — with ``return_hidden`` the
    final-normed hidden states (B, S, d) in place of the logits — where
    aux is the scalar MoE aux loss summed over the layers under their
    depth gates. ``activation_dtype`` (e.g. ``torch.bfloat16``) casts the
    embeddings; the weights are cast to it at each product. ``remat``: see
    ``_cohort_stack``.

    ``mesh``: the model axis (module docstring) for the logits — this
    rank's parameter block in, the whole batch's logits out on every rank;
    the aux loss is then not computed (None) and ``return_hidden`` raises
    (the sharded loss and backward wait for ROADMAP A17b)."""
    if mesh is not None:
        B = next(iter(batch.values())).shape[0]
        _check_mesh(cfg, mesh, B, caches=False)
        if return_hidden:
            raise NotImplementedError("forward_batch on a mesh returns "
                                      "logits only (ROADMAP A17b)")
        rows = _batch_rows(mesh, B)
        batch = {k: _local_rows(v, rows) for k, v in batch.items()}
        masks = _local_masks(masks, rows)
    x = embed_inputs(params, cfg, batch, activation_dtype, mesh)
    B, S, d = x.shape
    kw = {} if mesh is None else dict(mesh=mesh, rows=rows)
    h, aux = _cohort_stack(_one_client(params), cfg, x.reshape(1, B * S, d),
                           S, B, None if masks is None
                           else _one_client(masks), kernels,
                           with_aux=mesh is None, remat=remat, **kw)
    h = h.reshape(B, S, d)
    aux = None if aux is None else aux[0]
    if return_hidden:
        return h, aux
    if last_only:
        h = h[:, -1:, :]
    logits = softcap(h @ _unembed_w(params, cfg).to(h.dtype),
                     cfg.final_softcap)
    if mesh is not None:
        logits = mesh.all_gather(logits, -1, cfg.padded_vocab)
        logits = mesh.all_gather(logits, 0, rows[2], "data")
    return logits, aux


class _GradDtypeBarrier(torch.autograd.Function):
    """Identity whose backward casts the cotangent to the primal dtype (the
    reference's ``_grad_dtype_barrier``): fp32 loss-side cotangents do not
    reach bf16 activations as fp32 copies."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def _grad_dtype_barrier(x):
    return _GradDtypeBarrier.apply(x)


def _xent_chunk(xc, w, tc, mc, cap):
    """(Σ masked CE, Σ mask) of one sequence chunk: its logits xc @ w,
    softcapped, in fp32 with the max subtracted; the target logit picked
    by index."""
    logits = softcap(_grad_dtype_barrier(xc) @ w.to(xc.dtype), cap)
    lf = logits.float()
    shifted = lf - lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(shifted).sum(-1))
    tgt = torch.gather(shifted, -1, tc[..., None].long())[..., 0]
    return ((lse - tgt) * mc).sum(), mc.sum()


def chunked_softmax_xent(x, w, targets, mask, *, cap=None, chunk=256):
    """Fused unembedding + CE over sequence chunks, each checkpointed: the
    full (B, S, V) logits never live at once (the backward recomputes each
    chunk's logits from x and w). The chunk is the largest divisor of S
    not above ``chunk``. x (B, S, d) hidden states, w (d, V), targets and
    mask (B, S). Returns the mean CE over the mask."""
    B, S, d = x.shape
    cs = next(c for c in range(min(chunk, S), 0, -1) if S % c == 0)
    x = _grad_dtype_barrier(x)
    ce_sum = torch.zeros((), device=x.device)
    m_sum = torch.zeros((), device=x.device)
    for lo in range(0, S, cs):
        sl = slice(lo, lo + cs)
        c, m = checkpoint(_xent_chunk, x[:, sl], w, targets[:, sl],
                          mask[:, sl].float(), cap, use_reentrant=False)
        ce_sum = ce_sum + c
        m_sum = m_sum + m
    return ce_sum / torch.clamp(m_sum, min=1.0)


def cross_entropy(logits, targets, mask):
    """Masked mean CE of (…, V) logits, reduced in fp32, the max
    subtracted (the reference's ``cross_entropy``)."""
    lf = logits.float()
    shifted = lf - lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(shifted).sum(-1))
    tgt = torch.gather(shifted, -1, targets[..., None].long())[..., 0]
    mask = mask.float()
    return ((lse - tgt) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            masks=None, kernels=None, remat: bool = False,
            activation_dtype=None):
    """The LM objective of one model (the reference's ``loss_fn``): CE of
    the chunked unembedding plus the MoE aux loss. Encoder-only (hubert):
    ``labels`` (B, S) under ``loss_mask`` (all ones by default). Decoders:
    next-token targets (the last position masked), and for a vision
    frontend no loss on the image positions. Returns (loss, {"ce",
    "aux"})."""
    hidden, aux = forward_batch(params, cfg, batch, masks=masks,
                                kernels=kernels, remat=remat,
                                activation_dtype=activation_dtype,
                                return_hidden=True)
    w = _unembed_w(params, cfg)
    if cfg.encoder_only:
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(labels.shape, device=labels.device)
        ce = chunked_softmax_xent(hidden, w, labels, mask,
                                  cap=cfg.final_softcap)
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
        targets = torch.cat([tokens[:, 1:], tokens.new_zeros((B, 1))], 1)
        pos = torch.arange(S, device=tokens.device)[None, :]
        mask = (pos < S - 1).float()
        if cfg.frontend == "vision":
            mask = mask * (pos >= batch["image_embeds"].shape[1]).float()
        ce = chunked_softmax_xent(hidden, w, targets, mask.expand(B, S),
                                  cap=cfg.final_softcap)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# prefill (full forward that also fills the decode caches)
# ---------------------------------------------------------------------------
def _apply_attn_block(bp, x, positions, cfg: ModelConfig, window, masks,
                      kernels, gate=None, cache_len=None, cache_dtype=None,
                      mesh=None, rows=None):
    """One attention block over a full sequence. ``gate`` ((), or (B,)
    0/1) multiplies the block's residual contributions — with gate 0 the
    block is exactly the identity (CFL depth elasticity). ``cache_len``:
    also return the block's decode cache (fused prefill): a ring-buffer
    KV cache, or MLA's compressed latents of ``cache_len`` positions.
    ``mesh`` / ``rows``: the model axis (``_ffn``)."""
    h = _norm(cfg, bp["ln1"], x)
    if cfg.attn_type == "mla":
        res = attn_lib.mla_forward(
            bp["attn"], h, positions, n_heads=cfg.n_heads, mla=cfg.mla,
            causal=cfg.causal, norm_eps=cfg.norm_eps,
            head_mask=_masks_get(masks, "heads"), cache_len=cache_len,
            cache_dtype=cache_dtype)
    else:
        kv_len = None if cache_len is None else (
            min(cache_len, window) if window else cache_len)
        res = attn_lib.gqa_forward(
            bp["attn"], h, positions, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, causal=cfg.causal, window=window,
            cap=cfg.attn_softcap, qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
            head_mask=_masks_get(masks, "heads"),
            kernel=_masks_get(kernels, "attention"), cache_len=kv_len,
            cache_dtype=cache_dtype, mesh=mesh)
    a, cache = res if cache_len is not None else (res, None)
    if cfg.post_norms:
        a = _norm(cfg, bp["post_ln1"], a)
    if gate is not None:
        a = a * _gate(gate, a)
    x = x + a
    h = _norm(cfg, bp["ln2"], x)
    experts = _masks_get(masks, "experts")
    m, _ = _ffn(bp, h, cfg, masks, kernels,
                per_row=experts is not None and experts.dim() == 2,
                mesh=mesh, rows=rows)
    if cfg.post_norms:
        m = _norm(cfg, bp["post_ln2"], m)
    if gate is not None:
        m = m * _gate(gate, m)
    x = x + m
    return x if cache_len is None else (x, cache)


def _apply_ssm_block(bp, x, cfg: ModelConfig, masks, kernels, gate=None,
                     cache_dtype=None, mesh=None):
    """One SSM block over a full sequence that also returns the block's
    decode cache (fused prefill): ``x + gate · mamba(ln(x))``."""
    h = _norm(cfg, bp["ln"], x)
    y, cache = ssm_lib.mamba_forward(
        bp["mamba"], h, cfg.ssm, norm_eps=cfg.norm_eps,
        head_mask=_masks_get(masks, "ssm_heads"),
        kernel=_masks_get(kernels, "ssd"), return_cache=True,
        cache_dtype=cache_dtype, mesh=mesh)
    if gate is not None:
        y = y * _gate(gate, y)
    return x + y, cache


def _stack_caches(caches):
    """Per-layer caches (one NamedTuple each) -> one NamedTuple of stacked
    (L, B, ...) fields."""
    return type(caches[0])(*(torch.stack(f) for f in zip(*caches)))


class DecodeCaches(NamedTuple):
    """``segments``: one stacked (L, B, ...) cache per segment — a
    ``KVCache``, ``MLACache`` or ``SSMCache``, or ``{"local", "global"}``
    ``KVCache``s for a pair segment; ``shared``: the shared block's
    ``KVCache`` per site, stacked (n_sites, B, ...), or None."""
    segments: Tuple[Any, ...]
    shared: Any


def prefill(params: Params, cfg: ModelConfig, tokens, max_len: int, *,
            masks=None, kernels=None, cache_dtype=torch.float32, mesh=None):
    """One-shot prefill: full forward over ``tokens`` (B, S) that fills
    :class:`DecodeCaches` for positions 0..S-1.

    Returns ``(last_logits (B, V) fp32 softcapped, caches)``; generation
    continues at ``pos = S`` with :func:`decode_step`. ``mesh``: the model
    axis (module docstring): ``params`` is this rank's block, the caches
    come back as this rank's block, the logits whole."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds max_len {max_len}")
    rows = _batch_rows(mesh, B)
    if mesh is not None:
        _check_mesh(cfg, mesh, B, caches=True)
        tokens = tokens[rows[0]:rows[1]]
        masks = _local_masks(masks, rows)
    x = embed(params["embed"], tokens, scale=cfg.embed_scale, mesh=mesh,
              vocab=cfg.padded_vocab)
    positions = torch.arange(S, device=x.device).expand(tokens.shape[0], S)
    depth = _masks_get(masks, "depth")
    kw = dict(cache_len=max_len, cache_dtype=cache_dtype)
    if mesh is not None:
        kw.update(mesh=mesh, rows=rows)
    segs, sites = [], []
    for si, (seg_p, seg) in enumerate(zip(params["segments"], cfg.segments)):
        window = seg.sliding_window or cfg.sliding_window
        if seg.kind == "attn_pair":
            loc, glob = [], []
            for l in range(seg.n_layers):
                g = None if depth is None else depth[si][..., l]
                x, c = _apply_attn_block(_layer(seg_p["local"], l), x,
                                         positions, cfg,
                                         seg.pair_local_window, masks,
                                         kernels, gate=g, **kw)
                loc.append(c)
                x, c = _apply_attn_block(_layer(seg_p["global"], l), x,
                                         positions, cfg, None, masks,
                                         kernels, gate=g, **kw)
                glob.append(c)
            segs.append({"local": _stack_caches(loc),
                         "global": _stack_caches(glob)})
        else:
            caches = []
            for l in range(seg.n_layers):
                g = None if depth is None else depth[si][..., l]
                bp = _layer(seg_p["blocks"], l)
                if seg.kind == "ssm":
                    x, c = _apply_ssm_block(bp, x, cfg, masks, kernels,
                                            gate=g, cache_dtype=cache_dtype,
                                            mesh=mesh)
                else:
                    x, c = _apply_attn_block(bp, x, positions, cfg, window,
                                             masks, kernels, gate=g, **kw)
                caches.append(c)
            segs.append(_stack_caches(caches))
        if seg.shared_attn_after:
            x, c = _apply_attn_block(params["shared_attn"], x, positions,
                                     cfg, cfg.sliding_window,
                                     _shared_masks(masks), kernels, **kw)
            sites.append(c)
    x = _norm(cfg, params["final_norm"], x)
    logits = _logits(params, cfg, x[:, -1:, :], mesh)[:, 0]
    if mesh is not None:
        logits = mesh.all_gather(logits, 0, B, "data")
    shared = _stack_caches(sites) if sites else None
    return logits, DecodeCaches(tuple(segs), shared)


# ---------------------------------------------------------------------------
# decode (single token, cached)
# ---------------------------------------------------------------------------
def _stacked_zeros(single, n: int):
    return type(single)(*(f.new_zeros((n,) + f.shape) for f in single))


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.float32, device=None,
                       mesh=None) -> DecodeCaches:
    """Zeroed decode caches of ``batch`` rows on ``device`` (the card
    unless the caller asks for the CPU): ring-buffer KV caches
    (``min(max_len, window)`` slots), MLA latents of ``max_len``
    positions, SSM states and conv histories, and the shared block's KV
    cache per site. ``mesh``: this rank's block of them — its rows where
    the batch goes over ``data``, its K/V heads where they shard with the
    query heads, its SSD heads' state and ``conv_x`` where ``d_inner``
    shards (the layouts ``prefill`` fills)."""
    device = resolve_device(device)
    n_kv, nh = cfg.n_kv_heads, None
    if mesh is not None:
        _check_mesh(cfg, mesh, batch, caches=True)
        lo, hi, _ = _batch_rows(mesh, batch)
        batch = hi - lo
        if mesh.sharded(cfg.n_heads) and n_kv % mesh.model == 0:
            lo, hi = mesh.block(n_kv)
            n_kv = hi - lo
        if cfg.ssm is not None and ssm_lib._head_slice(mesh, cfg.ssm,
                                                       cfg.d_model):
            h0, h1 = ssm_lib._head_slice(mesh, cfg.ssm, cfg.d_model)
            nh = h1 - h0

    def kv(window):
        return attn_lib.gqa_cache_init(batch, max_len, n_kv, cfg.head_dim,
                                       window, dtype, device)
    segs = []
    for seg in cfg.segments:
        window = seg.sliding_window or cfg.sliding_window
        n = seg.n_layers
        if seg.kind == "ssm":
            segs.append(_stacked_zeros(ssm_lib.ssm_cache_init(
                batch, cfg.d_model, cfg.ssm, dtype, device, n_heads=nh), n))
        elif seg.kind == "attn_pair":
            segs.append({"local": _stacked_zeros(kv(seg.pair_local_window),
                                                 n),
                         "global": _stacked_zeros(kv(None), n)})
        elif cfg.attn_type == "mla":
            segs.append(_stacked_zeros(attn_lib.mla_cache_init(
                batch, max_len, cfg.mla, dtype, device), n))
        else:
            segs.append(_stacked_zeros(kv(window), n))
    n_sites = sum(1 for s in cfg.segments if s.shared_attn_after)
    shared = _stacked_zeros(kv(cfg.sliding_window), n_sites) \
        if n_sites else None
    return DecodeCaches(tuple(segs), shared)


def _decode_attn_block(bp, x, cache, pos, cfg: ModelConfig, window,
                       masks=None, kernels=None, gate=None, mesh=None):
    """One attention block over one token; ``cache`` (per-layer views of
    the stacked caches) is updated in place."""
    h = _norm(cfg, bp["ln1"], x)
    if cfg.attn_type == "mla":
        a, _ = attn_lib.mla_decode(bp["attn"], h, cache, pos,
                                   n_heads=cfg.n_heads, mla=cfg.mla,
                                   norm_eps=cfg.norm_eps,
                                   head_mask=_masks_get(masks, "heads"))
    else:
        a, _ = attn_lib.gqa_decode(
            bp["attn"], h, cache, pos, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, window=window, cap=cfg.attn_softcap,
            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
            head_mask=_masks_get(masks, "heads"), mesh=mesh)
    if cfg.post_norms:
        a = _norm(cfg, bp["post_ln1"], a)
    if gate is not None:
        a = a * _gate(gate, a)
    x = x + a
    h = _norm(cfg, bp["ln2"], x)
    m, _ = _ffn(bp, h, cfg, masks, kernels, per_row=True, mesh=mesh)
    if cfg.post_norms:
        m = _norm(cfg, bp["post_ln2"], m)
    if gate is not None:
        m = m * _gate(gate, m)
    return x + m


def _decode_ssm_block(bp, x, cache, cfg: ModelConfig, masks=None,
                      gate=None, mesh=None):
    """One SSM block over one token; ``cache`` (per-layer views of the
    stacked caches) is updated in place."""
    h = _norm(cfg, bp["ln"], x)
    y, new = ssm_lib.mamba_decode(bp["mamba"], h, cache, cfg.ssm,
                                  norm_eps=cfg.norm_eps,
                                  head_mask=_masks_get(masks, "ssm_heads"),
                                  mesh=mesh)
    for f, v in zip(cache, new):
        f.copy_(v)
    if gate is not None:
        y = y * _gate(gate, y)
    return x + y


def _at(stacked, i: int):
    """Entry ``i`` of a NamedTuple of stacked fields (views)."""
    return type(stacked)(*(f[i] for f in stacked))


def decode_step(params: Params, cfg: ModelConfig, caches: DecodeCaches,
                token, pos, masks=None, kernels=None, mesh=None):
    """token: (B, 1) integer tensor; pos: (B,) integer tensor of per-row
    positions (or one position for every row). -> (logits (B, V) fp32,
    caches).

    Each row writes its own cache entry and reads its own cache validity;
    the caches are updated **in place** and returned. ``masks`` /
    ``kernels`` mirror :func:`prefill`'s elastic surface; a mask with a
    leading batch axis gives every row its own submodel. ``mesh``: the
    model axis (module docstring) — ``params`` and ``caches`` this rank's
    blocks, ``token`` / ``pos`` / ``masks`` the whole batch's, the logits
    whole."""
    B = token.shape[0]
    if mesh is not None:
        _check_mesh(cfg, mesh, B, caches=True)
        rows = _batch_rows(mesh, B)
        token = token[rows[0]:rows[1]]
        pos = torch.as_tensor(pos, device=token.device)
        pos = pos if pos.dim() == 0 else _local_rows(pos.reshape(-1), rows)
        masks = _local_masks(masks, rows)
    x = embed(params["embed"], token, scale=cfg.embed_scale, mesh=mesh,
              vocab=cfg.padded_vocab)
    depth = _masks_get(masks, "depth")
    site = 0
    for si, (seg_p, seg, seg_c) in enumerate(zip(
            params["segments"], cfg.segments, caches.segments)):
        window = seg.sliding_window or cfg.sliding_window
        for l in range(seg.n_layers):
            g = None if depth is None else depth[si][..., l]
            if seg.kind == "attn_pair":
                x = _decode_attn_block(_layer(seg_p["local"], l), x,
                                       _at(seg_c["local"], l), pos, cfg,
                                       seg.pair_local_window, masks,
                                       kernels, gate=g)
                x = _decode_attn_block(_layer(seg_p["global"], l), x,
                                       _at(seg_c["global"], l), pos, cfg,
                                       None, masks, kernels, gate=g)
            elif seg.kind == "ssm":
                x = _decode_ssm_block(_layer(seg_p["blocks"], l), x,
                                      _at(seg_c, l), cfg, masks, gate=g,
                                      mesh=mesh)
            else:
                x = _decode_attn_block(_layer(seg_p["blocks"], l), x,
                                       _at(seg_c, l), pos, cfg, window,
                                       masks, kernels, gate=g, mesh=mesh)
        if seg.shared_attn_after:
            x = _decode_attn_block(params["shared_attn"], x,
                                   _at(caches.shared, site), pos, cfg,
                                   cfg.sliding_window, _shared_masks(masks),
                                   kernels)
            site += 1
    x = _norm(cfg, params["final_norm"], x)
    logits = _logits(params, cfg, x, mesh)[:, 0]
    if mesh is not None:
        logits = mesh.all_gather(logits, 0, B, "data")
    return logits, caches
