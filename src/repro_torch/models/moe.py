"""Mixture-of-Experts with sort-based, static-shape token dispatch.

The port of the reference's ``models/moe.py``. Per group of tokens:

1. top-k routing per token (router matmul, softmax, ``torch.topk``, the
   k gates renormalised);
2. stable sort of the (token, expert) assignment list by expert id;
3. per-expert capacity ``cap`` — assignments ranked past capacity are
   dropped (Switch/GShard semantics), as are those to masked experts;
4. scatter into an (E, cap, d) buffer -> batched expert compute ->
   gather-combine weighted by the router's gates.

The reference runs this under ``vmap`` over clients (training) and over
decode slots (serving); the port writes that axis out: x is (G, T, d) and
every step — the sort, ``searchsorted``, the slot tables, the scatter
into ``E·cap + 1`` slots whose last one is the drop sentinel — runs
batched over G, with no loop over groups. Capacity is per group: ``T`` in
``cap = ceil(T·k / E · capacity_factor)`` (rounded up to 8, at least 8)
is one group's token count, as under the reference's ``vmap``.

CFL hook: ``expert_mask`` (E,) or (G, E) disables a suffix of experts per
group (the router gives them logit ``NEG_INF``, and their slots stay
empty) — the elastic expert-width dimension of a submodel.

``kernel``: the ``moe`` op of ``kernels.dispatch`` — the expert compute
then runs ``grouped_matmul`` (experts past the prefix skipped, not zeroed)
and the wide (·, d) dispatch / combine rows run the gather kernels. The
router, softmax, top-k, sort and the int32 slot tables stay plain tensor
ops, as the reference computes them outside any Pallas kernel.

Expert parallelism (``mesh``, a ``sharding.mesh.HostMesh``): the
reference's ``shard_map`` branch. Each model rank holds its block of the
experts (and of the router's columns and the shared experts' width); the
router's columns are gathered over ``model`` so every rank routes every
token alike, each rank dispatches to its *local* experts only (ids
shifted by the block's first expert, ``e_offset``; ids out of the block
dropped, as ``src/repro/models/moe.py`` does), and the partial outputs —
the shared experts' tensor-parallel partial sum riding along — meet in one
all-reduce over ``model``. The expert mask becomes the block's slice, so
the kernels run on the local experts with the local prefix.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import act_fn

NEG_INF = -2.0 ** 30


def moe_param_specs(d_model: int, moe_cfg, gated: bool = True):
    """The reference's ``moe_init`` tree, each leaf ``(shape, std)`` of a
    He-normal ``N(0, 1/fan_in)`` draw."""
    E, f = moe_cfg.n_experts, moe_cfg.d_ff_expert
    he = lambda fan_in: 1.0 / math.sqrt(fan_in)     # noqa: E731
    p = {"router": ((d_model, E), he(d_model)),
         "wi": ((E, d_model, f), he(d_model)),
         "wo": ((E, f, d_model), he(f))}
    if gated:
        p["wg"] = ((E, d_model, f), he(d_model))
    if moe_cfg.n_shared:
        fs = f * moe_cfg.n_shared
        p["shared"] = {"wi": ((d_model, fs), he(d_model)),
                       "wo": ((fs, d_model), he(fs))}
        if gated:
            p["shared"]["wg"] = ((d_model, fs), he(d_model))
    return p


def moe_init(d_model: int, moe_cfg, gated: bool = True, *,
             generator: Optional[torch.Generator] = None, device=None,
             dtype=torch.float32):
    """Torch-seeded stand-in for the reference's ``moe_init``: the same
    tree, shapes and per-leaf std, drawn from ``generator`` (not held
    bit-equal to ``jax.random``)."""
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, std = spec
        t = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return t.mul_(std).to(dtype)
    return make(moe_param_specs(d_model, moe_cfg, gated))


def _group_mask(mask, ndim: int):
    """A (E,) or (G, E) expert mask shaped to broadcast over a tensor whose
    group axis is first and expert axis second-to-``ndim``-th: (G|1, E, 1..)
    — or, for ``ndim`` = 3, over (G, T, E) logits: (G|1, 1, E)."""
    m = mask if mask.dim() == 2 else mask[None]
    if ndim == 3:
        return m[:, None, :]
    return m.reshape(m.shape + (1,) * (ndim - 2))


def _active(mask, G: int, E: int, device) -> torch.Tensor:
    """(G,) int32 expert prefix of each group (E without a mask), computed
    on the device — never a Python int."""
    if mask is None:
        return torch.full((G,), E, dtype=torch.int32, device=device)
    n = (mask > 0).sum(-1).to(torch.int32)
    return n.expand(G).contiguous() if n.dim() == 0 else n


def route(router, xt, moe_cfg, expert_mask=None, mesh=None):
    """Top-k routing of xt (G, T, d): returns ``(logits, probs, gates,
    idx)`` — fp32 logits and probabilities (G, T, E) (masked experts at
    ``NEG_INF`` / exactly 0), the k renormalised gates (G, T, k) in xt's
    dtype and the k expert ids (G, T, k), largest first. With ``mesh`` the
    router holds this model rank's block of the experts' columns, gathered
    over ``model`` first (d·E values): every rank forms the whole logits
    with the unsharded product, so the routes are the unsharded model's to
    the bit and a near tie cannot route a token differently."""
    if mesh is not None:
        router = mesh.all_gather(router, -1, moe_cfg.n_experts)
    logits = torch.matmul(xt, router.to(xt.dtype)).float()
    if expert_mask is not None:
        logits = torch.where(_group_mask(expert_mask, 3) > 0, logits,
                             torch.full((), NEG_INF, device=xt.device))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, moe_cfg.top_k, dim=-1)
    gate_vals = (gate_vals / gate_vals.sum(-1, keepdim=True)).to(xt.dtype)
    return logits, probs, gate_vals, idx


def capacity(n_tokens: int, moe_cfg, experts: Optional[int] = None) -> int:
    """Per-expert slots of one group of ``n_tokens`` tokens: the reference's
    single-device rule, sized by ``capacity_experts`` (default all of E);
    ``experts`` overrides that count (its expert-parallel branch sizes by
    all of E)."""
    e_cap = experts or moe_cfg.capacity_experts or moe_cfg.n_experts
    cap = int(math.ceil(n_tokens * moe_cfg.top_k / e_cap *
                        moe_cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)


class ExpertPlan(NamedTuple):
    """How the model axis runs the MoE over a batch (:func:`expert_plan`).
    ``sharded``: this rank computes its block of the experts (the rules'
    ``_div``, as ``sharding.specs.shard_params`` split them) and the
    partial sums meet in one all-reduce. ``groups``: the batch's token
    groups — one per data rank in the reference's expert-parallel branch
    where its tokens split evenly, else one. ``cap``: a group's slots an
    expert under that branch's rule."""
    sharded: bool
    groups: int
    cap: int


def expert_plan(moe_cfg, mesh, n_tokens: int,
                split: bool = True) -> ExpertPlan:
    """The :class:`ExpertPlan` of ``n_tokens`` tokens on ``mesh`` (None:
    one device). The reference takes its expert-parallel branch where a
    model axis divides E; that branch routes each data rank's tokens on
    their own and sizes capacity by all of E, the single-device branch
    routes every token together and sizes by ``capacity_experts``.
    ``split=False``: the tokens are one group already (a row of its own)."""
    E = moe_cfg.n_experts
    branch = mesh is not None and mesh.model > 1 and E % mesh.model == 0
    groups = mesh.data if (split and branch and mesh.data > 1
                           and n_tokens % mesh.data == 0) else 1
    return ExpertPlan(mesh is not None and mesh.sharded(E), groups,
                      capacity(n_tokens // groups, moe_cfg,
                               E if branch else None))


class SlotTables(NamedTuple):
    """Routing tables of G groups: assignments in expert-sorted order
    (G, T·k) — ``order`` (the stable sort's permutation of the (t, j)
    assignments), ``kept`` (within capacity and to a live expert), ``dest``
    (slot, ``E·cap`` when dropped) — and slot tables (G, E·cap):
    ``slot_src`` (source token, ``T`` when empty) and ``slot_gate`` (the
    kept assignment's gate, 0 when empty); ``ga`` the (G,) int32 expert
    prefixes."""
    order: torch.Tensor
    kept: torch.Tensor
    dest: torch.Tensor
    slot_src: torch.Tensor
    slot_gate: torch.Tensor
    ga: torch.Tensor


def slot_tables(idx, gate_vals, *, E, cap, expert_mask=None,
                e_offset: Optional[int] = None) -> SlotTables:
    """The reference's sort-based capacity assignment, batched over the
    groups of idx / gate_vals (G, T, k): a stable sort by expert, each
    assignment's rank within its expert (``searchsorted``), the drop rule,
    and the scatter into ``E·cap + 1`` slots whose last one is the drop
    sentinel. With ``e_offset`` the ``E`` experts are a model rank's block
    from that global id on: assignments to other experts sort last and are
    dropped."""
    G, T, k = idx.shape
    dev = idx.device
    n = T * k
    n_slots = E * cap
    e_flat = idx.reshape(G, n)
    if e_offset is not None:
        e_flat = e_flat - e_offset
        e_flat = torch.where((e_flat >= 0) & (e_flat < E), e_flat,
                             torch.full((), E, device=dev))
    order = torch.sort(e_flat, dim=-1, stable=True).indices
    se = torch.gather(e_flat, 1, order)
    token_of = order // k
    gate_of = torch.gather(gate_vals.reshape(G, n), 1, order)
    start = torch.searchsorted(
        se, torch.arange(E, device=dev).expand(G, E).contiguous(),
        side="left")
    pos_in_e = torch.arange(n, device=dev) - torch.gather(
        start, 1, se.clamp(max=E - 1))
    # masked experts (the elastic suffix) count as dropped: their slots
    # stay empty and their assignments carry gate 0 on every path
    ga = _active(expert_mask, G, E, dev)
    kept = (se < ga[:, None]) & (pos_in_e < cap)
    dest = torch.where(kept, se * cap + pos_in_e,
                       torch.full((), n_slots, device=dev))
    # slot-centric tables: the wide (·, d) traffic is sized by the capacity
    # buffer, never by T·k
    slot_src = torch.full((G, n_slots + 1), T, dtype=torch.int64,
                          device=dev).scatter(1, dest, token_of)[:, :-1]
    slot_gate = torch.zeros((G, n_slots + 1), dtype=gate_vals.dtype,
                            device=dev).scatter(
        1, dest, kept.to(gate_vals.dtype) * gate_of)[:, :-1]
    return SlotTables(order, kept, dest, slot_src, slot_gate, ga)


def flat_tables(tables: SlotTables, T: int):
    """The gather kernels' 1-D int32 tables of G groups' ``SlotTables``:
    the (t, j)-ordered transpose of the assignment tables, then the group
    axis flattened into the rows — group g's tokens are rows g·T.., its
    slots rows g·E·cap.. — with empty slots and dropped assignments
    pointing past the end (invalid, gate 0). Returns ``(slot_src,
    slot_valid, dest_tj, kept_tj)``: (G·E·cap,) twice, (G·T·k,) twice."""
    order, kept, dest, slot_src = tables[:4]
    G, n_slots = slot_src.shape
    dev = slot_src.device
    dest_tj = torch.empty_like(dest).scatter(1, order, dest)
    kept_tj = torch.empty_like(kept).scatter(1, order, kept)
    slot_valid = slot_src < T
    g0 = torch.arange(G, device=dev)[:, None]
    src_g = torch.where(slot_valid, slot_src + g0 * T,
                        torch.full((), G * T, device=dev))
    dest_g = torch.where(kept_tj, dest_tj + g0 * n_slots,
                         torch.full((), G * n_slots, device=dev))
    return tuple(t.reshape(-1).to(torch.int32)
                 for t in (src_g, slot_valid, dest_g, kept_tj))


def _dispatch_compute_combine(xt, gate_vals, idx, wi, wg, wo, *, E, k, cap,
                              act, expert_mask, kernel=None, e_offset=None):
    """Sort-based dispatch over the experts of every group at once.

    xt (G, T, d); idx / gate_vals (G, T, k); wi / wg / wo: (E, ...) expert
    weights shared by the groups or (G, E, ...) one set per group;
    expert_mask: None, (E,) or (G, E). Returns (G, T, d).

    kernel: optional ``moe`` op (``kernels.dispatch``) — expert blocks past
    a group's prefix are then skipped by ``grouped_matmul``, not merely
    zeroed, and, when the op carries ``.dispatch`` / ``.combine``, the
    (·, d) token rows move through the gather kernels, with the group axis
    flattened into the rows (each group's indices offset by its rows).
    ``e_offset``: the global id of the first of the ``E`` (local) experts —
    see :func:`slot_tables`.
    """
    G, T, d = xt.shape
    a = act_fn(act)
    n_slots = E * cap
    tables = slot_tables(idx, gate_vals, E=E, cap=cap,
                         expert_mask=expert_mask, e_offset=e_offset)
    slot_src, slot_gate = tables.slot_src, tables.slot_gate

    disp = getattr(kernel, "dispatch", None)
    comb = getattr(kernel, "combine", None)
    fused = disp is not None and comb is not None
    if fused:
        src_g, valid_g, dest_g, kept_g = flat_tables(tables, T)
        eb = disp(xt.reshape(G * T, d), src_g, valid_g, dest_g, kept_g,
                  n_experts=E, cap=cap)
    else:
        xt_pad = torch.cat([xt, xt.new_zeros((G, 1, d))], dim=1)
        eb = torch.gather(xt_pad, 1, slot_src[..., None].expand(
            G, n_slots, d)).reshape(G, E, cap, d)

    if kernel is not None:
        g_active = None if expert_mask is None else tables.ga
        h = kernel(eb, wi, g_active)
        h = a(kernel(eb, wg, g_active)) * h if wg is not None else a(h)
        y = kernel(h, wo, g_active)
    else:
        h = torch.matmul(eb, wi.to(xt.dtype))
        if wg is not None:
            h = a(torch.matmul(eb, wg.to(xt.dtype))) * h
        else:
            h = a(h)
        y = torch.matmul(h, wo.to(xt.dtype))
    if expert_mask is not None:
        y = y * _group_mask(expert_mask, 4).to(y.dtype)

    if fused:
        gate_eff = gate_vals * kept_g.reshape(G, T, k).to(gate_vals.dtype)
        out = comb(y.reshape(G * n_slots, d), gate_eff.reshape(G * T, k),
                   dest_g, src_g, valid_g, slot_gate.reshape(-1))
        return out.reshape(G, T, d)
    y_flat = y.reshape(G, n_slots, d) * slot_gate[..., None]
    return torch.zeros((G, T + 1, d), dtype=xt.dtype,
                       device=xt.device).scatter_add(
        1, slot_src[..., None].expand(G, n_slots, d), y_flat)[:, :-1]


def moe_forward(p, x, moe_cfg, *, act="silu", expert_mask=None, kernel=None,
                return_aux: bool = True, mesh=None, cap: Optional[int] = None):
    """x: (G, T, d), G groups of T tokens each routed and dispatched on
    their own (own capacity, own expert prefix). ``p``'s leaves are the
    reference's shapes, or carry a leading G axis (one expert set per
    group). expert_mask: None, (E,) or (G, E). ``cap``: the per-expert
    slots of a group (default :func:`capacity` of T).

    ``mesh``: expert parallelism over its ``model`` axis (see the module
    docstring); ``p`` then holds this rank's block of every expert-sharded
    leaf (``sharding.specs.shard_params``) and ``expert_mask`` stays
    whole.

    Returns ``(y (G, T, d), aux)``, aux = {"aux_loss": (G,), "z_loss":
    (G,)} — the reference's load-balance and router-z terms, per group —
    or None with ``return_aux=False`` (the engine's objective has no aux
    term: the forward then computes neither)."""
    G, T, d = x.shape
    E, k = moe_cfg.n_experts, moe_cfg.top_k
    logits, probs, gate_vals, idx = route(p["router"], x, moe_cfg,
                                          expert_mask, mesh=mesh)
    ep = expert_plan(moe_cfg, mesh, T).sharded
    lo, hi = mesh.block(E) if ep else (0, E)
    local_mask = expert_mask if expert_mask is None or not ep else \
        expert_mask[..., lo:hi]
    out = _dispatch_compute_combine(
        x, gate_vals, idx, p["wi"], p.get("wg"), p["wo"], E=hi - lo, k=k,
        cap=capacity(T, moe_cfg) if cap is None else cap, act=act,
        expert_mask=local_mask, kernel=kernel, e_offset=lo if ep else None)
    # the expert-parallel partial sum (and the shared experts' tensor-
    # parallel one) meet in one all-reduce; a replicated part adds after
    partial, whole = (out, None) if ep else (None, out)
    if "shared" in p:                       # always-on experts, plain
        sp = p["shared"]
        a = act_fn(act)
        hs = torch.matmul(x, sp["wi"].to(x.dtype))
        if "wg" in sp:
            hs = a(torch.matmul(x, sp["wg"].to(x.dtype))) * hs
        else:
            hs = a(hs)
        hs = torch.matmul(hs, sp["wo"].to(x.dtype))
        if mesh is not None and mesh.sharded(moe_cfg.d_ff_expert *
                                              moe_cfg.n_shared):
            partial = hs if partial is None else partial + hs
        else:
            whole = hs if whole is None else whole + hs
    if partial is not None:
        partial = mesh.all_reduce(partial)
        out = partial if whole is None else whole + partial
    else:
        out = whole
    if not return_aux:
        return out, None

    # the balance coefficient counts *active* experts: masked experts add
    # zero to me/ce, and the extracted submodel scales by its own count
    me = probs.mean(1)                                      # (G, E)
    ce = F.one_hot(idx, E).float().sum(2).mean(1)           # (G, E)
    n_active = float(E) if expert_mask is None else \
        (expert_mask > 0).sum(-1).float()
    aux_loss = moe_cfg.aux_loss * n_active * (me * ce).sum(-1)
    z_loss = moe_cfg.router_z_loss * torch.logsumexp(
        logits, dim=-1).square().mean(-1)
    return out, {"aux_loss": aux_loss, "z_loss": z_loss}
