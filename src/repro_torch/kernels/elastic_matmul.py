"""Elastic dense layer: submodel compute that is *skipped*, not zeroed.

The port of the reference's ``kernels/elastic_matmul.py``, forward and
closed VJP. For an input x of shape (G, M, K), a weight w of shape (K, N)
shared by every group or (G, K, N) one per group, and an optional bias
(N,) shared by every group or (G, N) one per group,

    y[g] = R_m · C_n · act((x[g] ⊙ [k < k_active[g]]) @ w[g] + b[g])

with per-group runtime prefixes read from (G,) int32 tensors (None means
the full extent). The explicit group axis is the axis the reference gets
from ``vmap``: decode passes G = slots and M = 1 — every slot a different
submodel in one launch — prefill G = 1, M = prompt length, and training
G = clients with one weight (and, for a conv lowered onto it by
``kernels.elastic_conv``, one bias) per client. ``act`` is one of None,
"silu", "gelu" (tanh approximation), "relu".

``elastic_dense`` is differentiable, and its backward is closed under the
same kernel, as the reference's ``_make_edense``:

    dpre = dy · act'(pre)   (pre recomputed by the kernel, no activation)
    dx   = edense(dpre, wᵀ, k_active=n, n_active=k, m_active=m)
    dw   = edense(xᵀ, dpre, k_active=m, n_active=n, m_active=k)
    db   = Σ_rows (dpre masked to the m and n prefixes), per group for a
           per-group bias

``wᵀ`` and ``xᵀ`` are transposed views; the kernel reads them in place.

Each product launches the Hopper kernel ``csrc/elastic_dense.cu`` (see its
header for the design and what bounds it) for CUDA tensors, and takes
``elastic_dense_plain`` only for tensors on the CPU. ``_plan`` picks the
kernel's variant (``VARIANTS``: the 3×TF32 tensor-core ``tile``, the
weight-streaming ``skinny`` product for at most 64 rows, and the ``simt``
tile for rows that are not 16-byte aligned), its row tile and its split of
the contraction. ``elastic_dense``'s ``launches`` attribute counts kernel
launches, forward and backward, and ``launches_by_variant`` the same
launches by variant.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import stream_handle
from repro_torch.models.layers import ACTIVATIONS

ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "relu": 3}
# layout flags of csrc/elastic_dense.cu::edense_forward
X_TRANS, W_TRANS, W_PER_GROUP = 1, 2, 4


def _library() -> ctypes.CDLL:
    """The loaded library: the counted build inside ``build.counting()``,
    else the fast one."""
    return _library_bound(build.counting_active())


@functools.lru_cache(maxsize=None)
def _library_bound(counted: bool) -> ctypes.CDLL:
    lib = build.library("elastic_dense", counted)
    lib.edense_forward.argtypes = [ctypes.c_void_p] * 8 + \
        [ctypes.c_int] * 10 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    lib.edense_forward.restype = ctypes.c_int
    return lib


# The kernel's variants (csrc/elastic_dense.cu): "simt" the 64 × 64 SIMT
# tile, only for rows that are not 16-byte aligned; "tile" the 128 × 128
# 3×TF32 tensor-core tile; "skinny" the same kernel with a 16-, 32- or
# 64-row tile and a deeper ring, streaming the weight for at most 64 rows.
VARIANTS = ("simt", "tile", "skinny")
TILE_N = {"simt": 64, "tile": 128, "skinny": 128}    # output columns a block
STAGE_K = {"simt": 16, "tile": 32, "skinny": 32}    # contraction a step
STAGES = 3             # depth of the cp.async ring (K1's and K5's tiles)
CHUNK_ALIGN = {"simt": 64, "tile": 32, "skinny": 32}  # a split chunk's unit
SKINNY_ROWS = 64
SIMT_BLOCKS_PER_SM = 8             # 256-thread SIMT blocks that fill an SM
MIN_STEPS_PER_CHUNK = 4            # contraction steps a split chunk keeps
SM_SHARED_BYTES = 233472           # shared memory of an H100 SM
BLOCK_RESERVED_BYTES = 1024        # ... of which each resident block takes


class Plan(NamedTuple):
    variant: str
    bm: int          # rows of a block's tile
    splits: int      # contraction chunks (1: no split, no partials)
    kchunk: int      # contraction a chunk spans


def _row_tiles(G, M, flags, bm):
    """Row tiles of the grid: per group when each group has its own
    weights (or its own transposed x), else over the flattened rows."""
    if flags & (W_PER_GROUP | X_TRANS):
        return G * -(-M // bm)
    return -(-(G * M) // bm)


def plan_blocks(plan: Plan, G, M, N, flags):
    """Blocks of one launch of ``plan``, split chunks included."""
    return (-(-N // TILE_N[plan.variant])
            * _row_tiles(G, M, flags, plan.bm) * plan.splits)


def _stage_floats(rows, k_contiguous, permuted):
    """Floats of one operand's ring stage (``Stage`` in the source)."""
    bk = STAGE_K["tile"]
    if k_contiguous:
        return rows * (bk + (8 if permuted else 4))
    return bk * (rows + 4)


def ring_bytes(bm, bn, flags):
    """Shared memory of the cp.async ring of a BM × BN tensor-core tile in
    the layout ``flags`` (the X_TRANS / W_TRANS bits, the same in K5's
    wrapper): ``tf32x3::Stage`` in csrc/mma_tf32.cuh."""
    x_k, w_k = not flags & X_TRANS, bool(flags & W_TRANS)
    permuted = not (x_k and w_k)
    return 4 * STAGES * (_stage_floats(bm, x_k, permuted)
                         + _stage_floats(bn, w_k, permuted))


def blocks_per_sm(block_bytes, bm):
    """Blocks of a tensor-core tile (K1 or K5) that one SM holds at once:
    what its shared memory allows, at most the blocks its registers are
    bounded for (``MIN_BLOCKS`` of the launches in the sources: 3 up to 32
    rows a block, else 2)."""
    return min(SM_SHARED_BYTES // (block_bytes + BLOCK_RESERVED_BYTES),
               2 if bm > 32 else 3)


def shared_bytes(variant, bm, flags):
    """Shared memory of one block of a tensor-core variant: the ring and
    the per-row tables."""
    return ring_bytes(bm, TILE_N[variant], flags) + 12 * bm + 4


def resident_blocks(variant, bm, flags):
    """Blocks of a tensor-core variant that one SM holds at once."""
    return blocks_per_sm(shared_bytes(variant, bm, flags), bm)


@functools.lru_cache(maxsize=None)
def _plan(G: int, M: int, K: int, N: int, flags: int, aligned: bool,
          sms: int) -> Plan:
    """The launch of one product, from the shapes, the layout flags, the
    16-byte alignment of the operands' rows and the card's SM count alone —
    never from the prefixes, so a change of submodel never changes the
    launch. ``aligned``: every stored row (and group stride) of x and w is
    a multiple of 4 floats and both start on 16 bytes (``_aligned``).

    The split of the contraction: the SIMT tile aims at eight blocks per
    SM; the tensor-core tile splits only when its output tiles do not give
    every SM one block; the skinny product fills every resident slot of
    the card in one wave (each block then streams an equal share of the
    weight, and no second wave leaves SMs idle at the end)."""
    rows = M if flags & (W_PER_GROUP | X_TRANS) else G * M
    if not aligned:
        variant, bm = "simt", 64
    elif rows <= SKINNY_ROWS:
        variant, bm = "skinny", next(b for b in (16, 32, 64) if rows <= b)
    else:
        variant, bm = "tile", 128
    blocks = plan_blocks(Plan(variant, bm, 1, K), G, M, N, flags)
    if variant == "simt":
        want = -(-SIMT_BLOCKS_PER_SM * sms // max(blocks, 1))
    elif variant == "tile":
        want = -(-sms // max(blocks, 1))
    else:
        want = resident_blocks(variant, bm, flags) * sms // max(blocks, 1)
    splits = max(1, min(want, K // (MIN_STEPS_PER_CHUNK * STAGE_K[variant])))
    step = CHUNK_ALIGN[variant]
    kchunk = max(step, -(-(-(-K // splits)) // step) * step)
    return Plan(variant, bm, max(1, -(-K // kchunk)), kchunk)


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index) \
        .multi_processor_count


def _aligned(x, w, flags):
    """Whether cp.async's 16-byte copies can read x and w: each stored row,
    the group strides and both base addresses on 16 bytes."""
    G, M, K = x.shape
    N = w.shape[-1]
    x_row = M if flags & X_TRANS else K
    w_row = K if flags & W_TRANS else N
    strides = [x_row, w_row] + ([w.stride(0)] if flags & W_PER_GROUP else [])
    return all(s % 4 == 0 for s in strides) and \
        x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0


def _check_prefix(name, t, G, device):
    if t is None:
        return
    if t.shape != (G,) or t.dtype != torch.int32 or t.device != device:
        raise ValueError(f"{name} must be a ({G},) int32 tensor on {device},"
                         f" got {tuple(t.shape)} {t.dtype} on {t.device}")


def elastic_dense_plain(x, w, bias=None, *, k_active=None, n_active=None,
                        m_active=None, act=None):
    """The plain PyTorch version of the kernel (written from the reference's
    ``kernels/ref.py::elastic_dense_ref`` plus per-group prefixes and
    weights)."""
    G, M, K = x.shape
    N = w.shape[-1]
    dev = x.device
    if k_active is not None:
        keep = torch.arange(K, device=dev)[None, :] < k_active[:, None]
        x = x * keep[:, None, :].to(x.dtype)
    y = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        b = bias if bias.dim() == 1 else bias[:, None, :]
        y = y + b.to(y.dtype)
    if act is not None:
        y = ACTIVATIONS[act](y)
    live = torch.ones((G, M, N), dtype=torch.bool, device=dev)
    if n_active is not None:
        live = live & (torch.arange(N, device=dev)[None, None, :]
                       < n_active[:, None, None])
    if m_active is not None:
        live = live & (torch.arange(M, device=dev)[None, :, None]
                       < m_active[:, None, None])
    return torch.where(live, y, torch.zeros((), dtype=y.dtype, device=dev))


def _layout(t, name):
    """(transposed?) for an operand stored contiguous, or contiguous in its
    last two dims swapped (a ``.transpose(-1, -2)`` view). A per-group w
    is judged by one group's matrix: its group stride is passed apart."""
    if name == "w" and t.dim() == 3:
        t = t[0]
    if t.is_contiguous():
        return False
    if t.transpose(-1, -2).is_contiguous():
        return True
    raise ValueError(f"elastic_dense kernel takes {name} contiguous or as a "
                     f"transposed view of a contiguous tensor")


def launch_plan(x, w):
    """(layout flags, ``Plan``) of the kernel launch for CUDA operands x
    (G, M, K) and w (K, N) or (G, K, N)."""
    G, M, K = x.shape
    N = w.shape[-1]
    flags = (X_TRANS if _layout(x, "x") else 0) | \
        (W_TRANS if _layout(w, "w") else 0) | \
        (W_PER_GROUP if w.dim() == 3 else 0)
    return flags, _plan(G, M, K, N, flags, _aligned(x, w, flags),
                        _sms(x.device.index))


def _edense(x, w, bias, ka, na, ma, act):
    """One product: the kernel for CUDA tensors, the plain version for CPU
    tensors. Shapes and prefixes are checked by the caller."""
    if x.device.type == "cpu":
        return elastic_dense_plain(x, w, bias, k_active=ka, n_active=na,
                                   m_active=ma, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"elastic_dense runs on cpu or cuda, not {x.device}")
    for t in (x, w, bias):
        if t is not None and (t.device != x.device
                              or t.dtype != torch.float32):
            raise ValueError("elastic_dense kernel takes fp32 tensors on one "
                             "device")
    if bias is not None and bias.stride(-1) != 1:
        raise ValueError("elastic_dense kernel takes a bias whose rows are "
                         "contiguous")
    G, M, K = x.shape
    N = w.shape[-1]
    flags, plan = launch_plan(x, w)
    y = torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    partial = torch.empty((plan.splits, G * M, N), dtype=torch.float32,
                          device=x.device) if plan.splits > 1 else None
    stream = stream_handle(x.device)
    err = _library().edense_forward(
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        *[None if t is None else t.data_ptr()      # None = full extent
          for t in (ka, na, ma)],
        G, M, K, N, VARIANTS.index(plan.variant), plan.bm, plan.splits,
        plan.kchunk, ACT_CODES[act], flags,
        w.stride(0) if w.dim() == 3 else 0,
        bias.stride(0) if bias is not None and bias.dim() == 2 else 0,
        stream)
    if err != 0:
        raise RuntimeError(f"elastic_dense kernel launch failed: CUDA error "
                           f"{err}")
    elastic_dense.launches_by_variant[plan.variant] += 1
    elastic_dense.launches += 1
    return y


def _act_vjp(act, pre, dy):
    """dy through the activation at ``pre`` (the reference takes
    ``jax.vjp`` of the same function)."""
    with torch.enable_grad():
        p = pre.detach().requires_grad_(True)
        dpre, = torch.autograd.grad(ACTIVATIONS[act](p), p, dy)
    return dpre


class _EDense(torch.autograd.Function):
    """The reference's ``_make_edense`` custom VJP: every product of the
    backward is the same kernel again (or its plain version on the CPU).
    The pre-activation is recomputed, not saved, as in the reference: one
    launch more, one (G, M, N) activation fewer held for the backward."""

    @staticmethod
    def forward(ctx, x, w, bias, ka, na, ma, act):
        ctx.save_for_backward(x, w, bias, ka, na, ma)
        ctx.act = act
        return _edense(x, w, bias, ka, na, ma, act)

    @staticmethod
    def backward(ctx, dy):
        x, w, bias, ka, na, ma = ctx.saved_tensors
        dy = dy.contiguous()
        dpre = dy if ctx.act is None else _act_vjp(
            ctx.act, _edense(x, w, bias, ka, na, ma, None), dy)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _edense(dpre, w.transpose(-1, -2), None, na, ka, ma, None)
        if ctx.needs_input_grad[1]:
            dw = _edense(x.transpose(-1, -2), dpre, None, ma, na, ka, None)
            if w.dim() == 2:                     # shared by every group
                dw = dw.sum(0)
        if ctx.needs_input_grad[2]:
            G, M, N = dpre.shape
            live = torch.ones((G, M, N), dtype=torch.bool,
                              device=dpre.device)
            if na is not None:
                live = live & (torch.arange(N, device=dpre.device)
                               < na[:, None, None])
            if ma is not None:
                live = live & (torch.arange(M, device=dpre.device)[:, None]
                               < ma[:, None, None])
            db = torch.where(live, dpre, torch.zeros((), dtype=dpre.dtype,
                                                     device=dpre.device))
            db = db.sum(1) if bias.dim() == 2 else db.sum((0, 1))
            db = db.to(bias.dtype)
        return dx, dw, db, None, None, None, None


def elastic_dense(x, w, bias=None, *, k_active=None, n_active=None,
                  m_active=None, act=None):
    """Tile-skipping elastic dense layer (see the module docstring).

    x: (G, M, K); w: (K, N) or (G, K, N), each contiguous or a
    ``.transpose(-1, -2)`` view of a contiguous tensor (read in place; a
    per-group w may also sit at any group stride, as one layer of a
    client-stacked parameter does);
    bias: (N,), (G, N) (one row per group, at any group stride; a
    broadcast (G, N) view of one row is read in place) or None;
    k_active / n_active / m_active: (G,) int32 tensors or None. Returns
    (G, M, N) in x's dtype; differentiable in x, w and bias.
    """
    if act not in ACT_CODES:
        raise ValueError(f"act must be one of {list(ACT_CODES)}, got {act!r}")
    if x.dim() != 3 or w.dim() not in (2, 3) or x.shape[-1] != w.shape[-2] \
            or (w.dim() == 3 and w.shape[0] != x.shape[0]):
        raise ValueError(f"x (G,M,K) and w (K,N) or (G,K,N) required, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    G = x.shape[0]
    N = w.shape[-1]
    if bias is not None and bias.shape not in ((N,), (G, N)):
        raise ValueError(f"bias must be ({N},) or ({G}, {N}), got "
                         f"{tuple(bias.shape)}")
    for name, t in (("k_active", k_active), ("n_active", n_active),
                    ("m_active", m_active)):
        _check_prefix(name, t, G, x.device)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        return _EDense.apply(x, w, bias, k_active, n_active, m_active, act)
    return _edense(x, w, bias, k_active, n_active, m_active, act)


elastic_dense.launches = 0
# launches per variant of the plan (same increments as ``launches``)
elastic_dense.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def elastic_matmul(x, w, k_active):
    """y[m, n] = Σ_k x[m, k] w[k, n] for n < k_active, else 0 — the PR-1
    entry point of the reference (``k_active`` is the *output-column*
    prefix here), over K1 with one group.

    x: (M, K), w: (K, N), k_active: an int32 scalar tensor (or an int).
    ``elastic_dense`` is the general, differentiable entry point; this one
    is differentiable through it.
    """
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"x (M, K) and w (K, N) required, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    na = torch.as_tensor(k_active, dtype=torch.int32,
                         device=x.device).reshape(1)
    return elastic_dense(x[None], w, n_active=na)[0]
