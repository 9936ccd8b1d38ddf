"""Mamba2 / SSD (state-space duality) blocks — arXiv:2405.21060.

The port of the reference's ``models/ssm.py``. Full-sequence path (train,
prefill): the chunked SSD scan — the ``ssd`` op of ``kernels.dispatch``
(K8 forward, K9 backward) or, without kernels, :func:`ssd_chunked`, the
dense masked path. Decode: the O(1) recurrent state update, plain tensor
ops in the reference too. The fused ``in_proj`` is stored as separate
matrices (``wz``, ``wx``, ``wB``, ``wC``, ``wdt``) and the depthwise conv
per component, as in the reference.

Two batch layouts, as in ``models/transformer.py``:

* serving (:func:`mamba_forward`, :func:`mamba_decode`): one parent, x
  (B, S, d), and a head mask (H,) or per row (B, H) — every row may be a
  different submodel;
* training (:func:`mamba_forward_cohort`): a leading client axis G on
  every parameter, x (G, B, S, d) and a (G, H) head mask. The projections
  are batched matmuls (G, B·S, d) @ (G, d, ·) (the reference leaves them to
  XLA); the scan runs on G·B rows, each with its client's A and head
  prefix.

Head parallelism (``mesh``, a ``sharding.mesh.HostMesh``): ``wz``, ``wx``,
``conv_x`` and the gated norm's scale hold this model rank's block of
``d_inner`` — whole SSD heads — and ``out_proj`` its rows; ``dt``, ``A``,
``D`` and ``dt_bias`` are sliced to the block's heads at use and ``B`` /
``C`` (replicated) to the groups those heads read. The scan runs on the
local heads with the local prefix. The gated RMSNorm's statistics run over
the whole ``d_inner``: the block's sum of squares is all-reduced over
``model`` before ``rsqrt`` (the count of active dims under a head mask is
the whole mask's), and ``out_proj``'s partial products meet in a second
all-reduce. The decode cache's state ``h`` and ``conv_x`` are the block's
heads.

The decay is masked *before* the exponential in :func:`ssd_chunked` (the
reference's ``where(tri, exp(diff), 0)`` overflows in the upper triangle
once a chunk's Σ|dt·A| passes ~88 and its gradient turns NaN); ``cum``
is summed in fp64 (``kernels.ssd_scan.chunk_cumsum``) as the kernels sum
it. The causal conv is the reference's shift-and-add in fp32 (not
``F.conv1d``, which runs fp32 convolutions in TF32 under cuDNN's default).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ssd_scan import chunk_cumsum, row_A
from repro_torch.models.layers import rmsnorm

INITS = ("a_log", "dt_bias")     # the inits beyond std / zeros / ones


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def mamba_param_shapes(d_model: int, ssm):
    """The reference's ``mamba_init`` tree, each leaf ``(shape, init)``:
    ``init`` a He-normal std ``1/sqrt(fan_in)``, ``"zeros"``, ``"ones"``,
    ``"a_log"`` (``log(linspace(1, 16, H))``) or ``"dt_bias"`` (the inverse
    softplus of ``exp(U(log 1e-3, log 1e-1))``)."""
    di, nh = ssm.d_inner(d_model), ssm.n_heads(d_model)
    gn, w = ssm.n_groups * ssm.d_state, ssm.d_conv
    he = lambda fan_in: 1.0 / math.sqrt(fan_in)     # noqa: E731
    return {
        "wz": ((d_model, di), he(d_model)),
        "wx": ((d_model, di), he(d_model)),
        "wB": ((d_model, gn), he(d_model)),
        "wC": ((d_model, gn), he(d_model)),
        "wdt": ((d_model, nh), he(d_model)),
        "conv_x": {"w": ((w, di), he(w)), "b": ((di,), "zeros")},
        "conv_B": {"w": ((w, gn), he(w)), "b": ((gn,), "zeros")},
        "conv_C": {"w": ((w, gn), he(w)), "b": ((gn,), "zeros")},
        "A_log": ((nh,), "a_log"),
        "D": ((nh,), "ones"),
        "dt_bias": ((nh,), "dt_bias"),
        "norm": {"scale": ((di,), "zeros")},
        "out_proj": ((di, d_model), he(di)),
    }


def init_leaf(shape, init, generator=None, device=None):
    """A leaf of one of the special ``INITS``, fp32; ``shape`` may carry
    leading (layer) axes before the head axis."""
    nh = shape[-1]
    if init == "a_log":
        a = torch.log(torch.linspace(1.0, 16.0, nh, device=device))
        return a.expand(shape).clone()
    if init == "dt_bias":
        u = torch.rand(shape, generator=generator, device=device)
        u = u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3)
        return torch.log(torch.expm1(torch.exp(u)))
    raise ValueError(init)


def mamba_init(d_model: int, ssm, *, generator=None, device=None,
               dtype=torch.float32):
    """Torch-seeded stand-in for the reference's ``mamba_init``: the same
    tree, shapes and distributions, drawn from ``generator`` (not held
    bit-equal to ``jax.random``)."""
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, init = spec
        if init == "zeros":
            t = torch.zeros(shape, device=device)
        elif init == "ones":
            t = torch.ones(shape, device=device)
        elif init in INITS:
            t = init_leaf(shape, init, generator, device)
        else:
            t = torch.randn(shape, generator=generator,
                            device=device).mul_(init)
        return t.to(dtype)
    return make(mamba_param_shapes(d_model, ssm))


# ---------------------------------------------------------------------------
# helpers over the client-stacked layout
# ---------------------------------------------------------------------------
def _per_client(t, x):
    """A client-stacked (G, C) vector shaped to broadcast over x (G, ...,
    C)."""
    return t.reshape((t.shape[0],) + (1,) * (x.dim() - 2) + (t.shape[-1],))


def _causal_conv(cp, x, w: int):
    """x (G, B, S, C), cp client-stacked (``w`` (G, w, C), ``b`` (G, C)):
    depthwise causal conv of width w, then silu — the reference's
    shift-and-add, accumulated in fp32."""
    S = x.shape[-2]
    pad = F.pad(x, (0, 0, w - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(w):
        out = out + pad[..., i:i + S, :].float() * \
            _per_client(cp["w"][:, i].float(), x)
    out = out + _per_client(cp["b"].float(), x)
    return F.silu(out).to(x.dtype)


# ---------------------------------------------------------------------------
# the chunked SSD scan (dense masked path)
# ---------------------------------------------------------------------------
def _chunk_body(h, xc, dtc, Bc, Cc, Ar):
    """One chunk: xc (R,Q,G,rep,P), dtc (R,Q,G,rep), Bc/Cc (R,Q,G,N), Ar
    (R,G,rep), h (R,G,rep,P,N) -> (h_new, y)."""
    Q = xc.shape[1]
    dA = dtc.float() * Ar[:, None]
    cum = chunk_cumsum(dA, 1)                              # (R,Q,G,rep)
    diff = cum[:, :, None] - cum[:, None, :]               # (R,t,s,G,rep)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xc.device).tril()
    M = diff.masked_fill(~tri[None, :, :, None, None], float("-inf")).exp()
    CB = torch.einsum("btgn,bsgn->btsg", Cc.float(), Bc.float())
    xdt = xc.float() * dtc.float()[..., None]
    y_intra = torch.einsum("btsg,btsgr,bsgrp->btgrp", CB, M, xdt)
    y_inter = torch.einsum("btgr,btgn,bgrpn->btgrp", torch.exp(cum),
                           Cc.float(), h)
    decay_to_end = torch.exp(cum[:, -1:] - cum)            # (R,Q,G,rep)
    S_c = torch.einsum("bsgr,bsgn,bsgrp->bgrpn", decay_to_end, Bc.float(),
                       xdt)
    h_new = h * torch.exp(cum[:, -1])[..., None, None] + S_c
    return h_new, (y_intra + y_inter).to(xc.dtype)


def ssd_chunked(xh, dt, A, Bm, Cm, chunk):
    """SSD over a full sequence, chunk by chunk (the dense masked path).

    xh (R,S,H,P), dt (R,S,H), A (H,) or per row (R,H), Bm/Cm (R,S,G,N) (G
    divides H). Returns y (R,S,H,P) and the final state (R,H,P,N). Heads
    are carried as (G, rep) so that B/C stay at group width. Under autograd
    each chunk runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint(body)``): the backward recomputes a chunk's (Q, Q)
    decay and score blocks instead of keeping them for every chunk."""
    R, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc, rep = S // chunk, H // G
    assert S % chunk == 0
    xr = xh.reshape(R, nc, chunk, G, rep, P)
    dtr = dt.reshape(R, nc, chunk, G, rep)
    Br = Bm.reshape(R, nc, chunk, G, N)
    Cr = Cm.reshape(R, nc, chunk, G, N)
    Ar = row_A(A, R).reshape(R, G, rep)
    h = torch.zeros((R, G, rep, P, N), dtype=torch.float32,
                    device=xh.device)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xh, dt, A, Bm, Cm))
    ys = []
    for c in range(nc):
        args = (h, xr[:, c], dtr[:, c], Br[:, c], Cr[:, c], Ar)
        if grad:
            h, yc = checkpoint(_chunk_body, *args, use_reentrant=False)
        else:
            h, yc = _chunk_body(*args)
        ys.append(yc)
    y = torch.stack(ys, 1).reshape(R, S, H, P)
    return y, h.reshape(R, H, P, N)


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------
def _masked_gated_rmsnorm(p, x, dim_mask, eps):
    """RMSNorm whose statistics run over the *active* d_inner dims only —
    equal to the extracted submodel's rmsnorm on the kept prefix.
    ``dim_mask`` broadcasts over x; its last axis is d_inner."""
    m = dim_mask.float()
    x32 = x.float() * m
    n = torch.clamp(m.sum(-1, keepdim=True), min=1.0)
    var = torch.sum(x32.square(), dim=-1, keepdim=True) / n
    inv = torch.rsqrt(var + eps)
    scale = p["scale"].float()
    if scale.dim() == 2:
        scale = _per_client(scale, x)
    y = (1.0 + scale) * x32 * inv
    return (y * m).to(x.dtype)


def _sharded_gated_norm(p, x, mesh, n_dims, dim_mask=None, eps=1e-6):
    """The gated RMSNorm of a model rank's block x (..., di_loc) of
    ``d_inner``: the block's sum of squares all-reduced over ``model``,
    over ``n_dims`` dims (the whole ``d_inner``, or a tensor of the active
    dims under a head mask, ``dim_mask`` the block's slice of it). The
    statistics of :func:`_masked_gated_rmsnorm` (masked) or of the plain
    ``rmsnorm`` (fp32 variance) over the whole width."""
    scale = p["scale"].float()
    if scale.dim() == 2:
        scale = _per_client(scale, x)
    x32 = x.float() if dim_mask is None else x.float() * dim_mask.float()
    ss = mesh.all_reduce(torch.sum(x32.square(), dim=-1, keepdim=True))
    inv = torch.rsqrt(ss / n_dims + eps)
    y = (1.0 + scale) * x32 * inv
    return (y if dim_mask is None else y * dim_mask.float()).to(x.dtype)


def _head_slice(mesh, ssm, d_model):
    """``(h0, h1)``: this model rank's SSD heads, or None where ``d_inner``
    is not sharded (``mesh`` None or the rules replicate it)."""
    di = ssm.d_inner(d_model)
    if mesh is None or not mesh.sharded(di):
        return None
    lo, hi = mesh.block(di, unit=ssm.head_dim)
    return lo // ssm.head_dim, hi // ssm.head_dim


def _group_slice(t, heads, nh: int, axis: int):
    """B or C (..., ng, N) on ``axis`` for the heads ``[h0, h1)`` of
    ``nh``: the groups the block spans where its heads split evenly over
    them (always so for one group, or a block inside one group), else one
    group per head (the group's row repeated)."""
    h0, h1 = heads
    rep, n = nh // t.shape[axis], h1 - h0
    g0 = h0 // rep
    k = (h1 - 1) // rep + 1 - g0 if n else 0
    if k and n % k == 0 and all((h0 + j) // rep - g0 == j // (n // k)
                                for j in range(n)):
        return t.narrow(axis, g0, k)
    return t.repeat_interleave(rep, dim=axis).narrow(axis, h0, n)


def _ssd_final_state(xh, dt, A, Bm, Cm):
    """Closed-form final SSD state after S tokens — the state the decode
    recurrence reaches: h = Σ_s exp(Σ_{t>s} dA_t) · dt_s · x_s ⊗ B_s. Used
    where the kernel computed y (it returns no final state); the decay is
    formed in fp64 from the fp64 cum, so the long-range sum keeps fp32
    accuracy."""
    R, S, H, _ = xh.shape
    rep = H // Bm.shape[2]
    dA = dt.float() * row_A(A, R)[:, None, :]              # (R,S,H)
    cum = torch.cumsum(dA.double(), 1)
    decay = torch.exp(cum[:, -1:] - cum).float()           # ≤ 1
    xdt = xh.float() * dt.float()[..., None]
    Bh = Bm.float().repeat_interleave(rep, dim=2)
    return torch.einsum("bsh,bshp,bshn->bhpn", decay, xdt, Bh)


def _conv_tail(raw, w: int, dtype):
    """Last w-1 pre-conv rows of raw (..., S, C), front-zero-padded when
    the prompt is shorter — the conv history stepwise decode keeps."""
    S = raw.shape[-2]
    hist = raw.new_zeros(raw.shape[:-2] + (w - 1, raw.shape[-1]),
                         dtype=dtype)
    n = min(w - 1, S)
    if n:
        hist[..., w - 1 - n:, :] = raw[..., S - n:, :].to(dtype)
    return hist


class SSMCache(NamedTuple):
    h: torch.Tensor        # (B, H, P, N) fp32 state
    conv_x: torch.Tensor   # (B, w-1, di) recent pre-conv x inputs
    conv_B: torch.Tensor   # (B, w-1, ng*N)
    conv_C: torch.Tensor   # (B, w-1, ng*N)


def _mamba(p, x, ssm, norm_eps, head_mask, kernel, return_cache,
           cache_dtype, mesh=None):
    """The block over the client-stacked layout: p (G, ...), x (G, B, S,
    d), head_mask None or (G, B|1, H). Returns out (G, B, S, d) [and the
    cache of every (client, row), (G·B, ...)]. ``mesh``: head parallel
    (module docstring)."""
    G, B, S, d = x.shape
    di, nh = ssm.d_inner(d), ssm.n_heads(d)
    ng, N, P = ssm.n_groups, ssm.d_state, ssm.head_dim
    heads = _head_slice(mesh, ssm, d)
    R = G * B
    xt = x.reshape(G, B * S, d)

    def proj(w):
        return torch.matmul(xt, w.to(x.dtype)).reshape(G, B, S, -1)

    def local(t):                    # a per-head vector: the block's heads
        return t if heads is None else t[..., heads[0]:heads[1]]
    z = proj(p["wz"])
    xc_raw = proj(p["wx"])
    Bm_raw = proj(p["wB"])
    Cm_raw = proj(p["wC"])
    xc = _causal_conv(p["conv_x"], xc_raw, ssm.d_conv)
    Bm = _causal_conv(p["conv_B"], Bm_raw, ssm.d_conv)
    Cm = _causal_conv(p["conv_C"], Cm_raw, ssm.d_conv)
    dt = local(proj(p["wdt"]))
    nh_loc = nh if heads is None else heads[1] - heads[0]

    xh = xc.reshape(R, S, nh_loc, P)
    Bm = Bm.reshape(R, S, ng, N)
    Cm = Cm.reshape(R, S, ng, N)
    if heads is not None:
        Bm = _group_slice(Bm, heads, nh, 2)
        Cm = _group_slice(Cm, heads, nh, 2)
    dtv = F.softplus(dt.float() + _per_client(local(p["dt_bias"]).float(),
                                              dt))
    dtv = dtv.reshape(R, S, nh_loc)

    def rows(t):                     # (G, B|1, H) or (G, H) -> (R, H)
        t = t if t.dim() == 3 else t[:, None]
        return t.expand(G, B, t.shape[-1]).reshape(R, t.shape[-1])
    A = rows(-torch.exp(local(p["A_log"]).float()))
    mask = None if head_mask is None else rows(local(head_mask))
    chunk = min(ssm.chunk, S)
    h_final = None
    if kernel is not None:
        # prefix-aware kernels skip masked head blocks; the mask multiply
        # below stays (it also gates the D term)
        y, _ = kernel(xh, dtv, A, Bm, Cm, chunk, head_mask=mask)
        if return_cache:
            h_final = _ssd_final_state(xh, dtv, A, Bm, Cm)
    else:
        y, h_final = ssd_chunked(xh, dtv, A, Bm, Cm, chunk)
    y = y.to(x.dtype) + xh.to(x.dtype) * rows(local(p["D"])).to(x.dtype)[
        :, None, :, None]
    if mask is not None:
        y = y * mask.to(y.dtype)[:, None, :, None]
    y = y.reshape(G, B, S, nh_loc * P)
    gated = y * F.silu(z.float()).to(y.dtype)
    if head_mask is not None:
        hm = head_mask if head_mask.dim() == 3 else head_mask[:, None]
        dim_mask = local(hm).repeat_interleave(P, dim=-1)[:, :, None, :]
        if heads is None:
            y = _masked_gated_rmsnorm(p["norm"], gated, dim_mask, norm_eps)
        else:
            n = torch.clamp((hm > 0).float().sum(-1, keepdim=True)[
                :, :, None, :] * P, min=1.0)
            y = _sharded_gated_norm(p["norm"], gated, mesh, n, dim_mask,
                                    norm_eps)
    elif heads is None:
        y = rmsnorm(p["norm"], gated, norm_eps)
    else:
        y = _sharded_gated_norm(p["norm"], gated, mesh, di, eps=norm_eps)
    out = torch.matmul(y.to(x.dtype).reshape(G, B * S, nh_loc * P),
                       p["out_proj"].to(x.dtype)).reshape(G, B, S, d)
    if heads is not None:
        out = mesh.all_reduce(out)
    if not return_cache:
        return out
    cdt = cache_dtype or x.dtype
    w = ssm.d_conv

    def tail(raw):
        return _conv_tail(raw, w, cdt).reshape(R, w - 1, raw.shape[-1])
    cache = SSMCache(h=h_final.float(), conv_x=tail(xc_raw),
                     conv_B=tail(Bm_raw), conv_C=tail(Cm_raw))
    return out, cache


def _stacked(p):
    """Every leaf of an unstacked parameter tree with a leading client axis
    of 1 (views)."""
    if isinstance(p, dict):
        return {k: _stacked(v) for k, v in p.items()}
    return p[None]


def mamba_forward(p, x, ssm, *, norm_eps=1e-6, head_mask=None, kernel=None,
                  return_cache=False, cache_dtype=None, mesh=None):
    """Full-sequence Mamba2 block, serving layout. x (B, S, d) -> (B, S, d).

    head_mask: None, (H,) or per row (B, H) 0/1 prefix mask over SSD heads
    (CFL elastic width) — masked heads contribute zero and are excluded
    from the gated-norm statistics, so the masked forward equals the
    head-sliced submodel's. kernel: the ``ssd`` op of ``kernels.dispatch``
    or None (:func:`ssd_chunked`).

    return_cache: also return the :class:`SSMCache` stepwise decode would
    hold after these S tokens (final SSD state + conv histories) — the
    fused one-shot prefill path. ``mesh``: head parallel (module
    docstring); the cache then holds this rank's heads."""
    hm = None
    if head_mask is not None:
        hm = head_mask[None, None] if head_mask.dim() == 1 else head_mask[None]
    res = _mamba(_stacked(p), x[None], ssm, norm_eps, hm, kernel,
                 return_cache, cache_dtype, mesh)
    if not return_cache:
        return res[0]
    return res[0][0], res[1]


def mamba_forward_cohort(p, x, ssm, *, norm_eps=1e-6, head_mask=None,
                         kernel=None, mesh=None):
    """Full-sequence Mamba2 block over a cohort: every leaf of ``p`` with a
    leading client axis G, x (G, B, S, d), head_mask None or (G, H).
    Returns (G, B, S, d). ``mesh``: head parallel (module docstring)."""
    return _mamba(p, x, ssm, norm_eps, head_mask, kernel, False, None, mesh)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def ssm_cache_init(batch, d_model, ssm, dtype=torch.float32, device=None,
                   n_heads=None):
    """A zeroed cache of ``batch`` rows; ``n_heads``: a model rank's SSD
    heads (its state and ``conv_x`` block), default all of them."""
    nh = ssm.n_heads(d_model) if n_heads is None else n_heads
    di = nh * ssm.head_dim
    gn, w = ssm.n_groups * ssm.d_state, ssm.d_conv
    return SSMCache(
        h=torch.zeros((batch, nh, ssm.head_dim, ssm.d_state),
                      dtype=torch.float32, device=device),
        conv_x=torch.zeros((batch, w - 1, di), dtype=dtype, device=device),
        conv_B=torch.zeros((batch, w - 1, gn), dtype=dtype, device=device),
        conv_C=torch.zeros((batch, w - 1, gn), dtype=dtype, device=device))


def _conv_step(cp, hist, new):
    """hist (B, w-1, C) previous raw inputs; new (B, 1, C)."""
    seq = torch.cat([hist.to(new.dtype), new], dim=1)
    out = torch.einsum("bwc,wc->bc", seq.float(), cp["w"].float()) + \
        cp["b"].float()
    return F.silu(out).to(new.dtype), seq[:, 1:, :]


def mamba_decode(p, x, cache: SSMCache, ssm, *, norm_eps=1e-6,
                 head_mask=None, mesh=None):
    """x (B, 1, d). Returns (out (B, 1, d), new cache).

    head_mask: None, (H,) or per row (B, H) 0/1 SSD-head prefix — masked
    heads' outputs (the D skip term too) are zeroed and excluded from the
    gated-norm statistics, mirroring :func:`mamba_forward`. ``mesh``: head
    parallel (module docstring); ``cache`` is then this rank's block."""
    B, _, d = x.shape
    di, nh = ssm.d_inner(d), ssm.n_heads(d)
    ng, N = ssm.n_groups, ssm.d_state
    heads = _head_slice(mesh, ssm, d)

    def local(t):                    # a per-head vector: the block's heads
        return t if heads is None else t[..., heads[0]:heads[1]]
    nh_loc = nh if heads is None else heads[1] - heads[0]
    z = x @ p["wz"].to(x.dtype)
    xc_raw = x @ p["wx"].to(x.dtype)
    Bm_raw = x @ p["wB"].to(x.dtype)
    Cm_raw = x @ p["wC"].to(x.dtype)
    dt = x @ p["wdt"].to(x.dtype)

    xc, new_cx = _conv_step(p["conv_x"], cache.conv_x, xc_raw)
    Bm, new_cB = _conv_step(p["conv_B"], cache.conv_B, Bm_raw)
    Cm, new_cC = _conv_step(p["conv_C"], cache.conv_C, Cm_raw)

    xh = xc.reshape(B, nh_loc, ssm.head_dim)
    Bm = Bm.reshape(B, ng, N).repeat_interleave(nh // ng, dim=1)
    Cm = Cm.reshape(B, ng, N).repeat_interleave(nh // ng, dim=1)
    if heads is not None:
        Bm, Cm = Bm[:, heads[0]:heads[1]], Cm[:, heads[0]:heads[1]]
    dtv = F.softplus(local(dt[:, 0]).float() + local(p["dt_bias"]).float())
    A = -torch.exp(local(p["A_log"]).float())
    dA = torch.exp(dtv * A[None, :])                              # (B,H)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dtv, xh.float(), Bm.float())
    h = cache.h * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", h, Cm.float())
    y = y + xh.float() * local(p["D"]).float()[None, :, None]
    hm = None if head_mask is None else local(head_mask)
    if hm is not None:
        y = y * hm.to(y.dtype)[..., None]
    y = y.reshape(B, 1, nh_loc * ssm.head_dim)
    gated = (y * F.silu(z.float())).to(x.dtype)
    if head_mask is not None:
        dim_mask = hm.repeat_interleave(ssm.head_dim, dim=-1)
        if dim_mask.dim() == 2:
            dim_mask = dim_mask[:, None, :]
        if heads is None:
            y = _masked_gated_rmsnorm(p["norm"], gated, dim_mask, norm_eps)
        else:
            n = (head_mask > 0).float().sum(-1, keepdim=True)
            n = torch.clamp((n[:, None, :] if n.dim() == 2 else n)
                            * ssm.head_dim, min=1.0)
            y = _sharded_gated_norm(p["norm"], gated, mesh, n, dim_mask,
                                    norm_eps)
    elif heads is None:
        y = rmsnorm(p["norm"], gated, norm_eps)
    else:
        y = _sharded_gated_norm(p["norm"], gated, mesh, di, eps=norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    if heads is not None:
        out = mesh.all_reduce(out)
    return out, SSMCache(h=h, conv_x=new_cx.to(cache.conv_x.dtype),
                         conv_B=new_cB.to(cache.conv_B.dtype),
                         conv_C=new_cC.to(cache.conv_C.dtype))
