"""Grouped expert-prefix matmul: the MoE leg of the tile-skipping path.

The port of the reference's ``kernels/grouped_matmul.py`` (K5), forward and
closed VJP. For an expert buffer xs of shape (G, E, M, K) — G groups (the
clients of a training cohort, or the decode slots of a serving batch: the
axis the reference gets from ``vmap``), E experts, M capacity rows — and
expert weights ws of shape (E, K, N), shared by every group, or
(G, E, K, N), one set per group,

    y[g, e] = xs[g, e] @ ws[(g,) e]   if e < g_active[g]   else 0

with the per-group expert prefix read from a (G,) int32 tensor (None: every
expert live). ``grouped_matmul`` is differentiable and closed under the
same kernel, as the reference's ``_make_grouped``:

    dxs = K5(dy, wsᵀ, g_active)       dws = K5(xsᵀ, dy, g_active)

summed over the groups when ws is shared. ``wsᵀ`` and ``xsᵀ`` are
transposed views; the kernel reads them in place.

Each product launches the Hopper kernel ``csrc/grouped_matmul.cu`` (see its
header for the design and what bounds it) for CUDA tensors, and takes
``grouped_matmul_plain`` only for tensors on the CPU. ``_plan`` picks the
kernel's variant (``VARIANTS``: the 3×TF32 tensor-core ``tile`` of 80
rows, the weight-streaming ``stream`` product for at most 64 rows a block,
and the ``simt`` tile for rows that are not 16-byte aligned), its row tile
and its split of the contraction. ``grouped_matmul``'s ``launches``
attribute counts kernel launches, forward and backward, and
``launches_by_variant`` the same launches by variant.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import elastic_matmul as em
from repro_torch.kernels.backend import stream_handle

# layout flags of csrc/grouped_matmul.cu::gmm_forward
X_TRANS, W_TRANS, W_PER_GROUP = 1, 2, 4


def _library() -> ctypes.CDLL:
    """The loaded library: the counted build inside ``build.counting()``,
    else the fast one."""
    return _library_bound(build.counting_active())


@functools.lru_cache(maxsize=None)
def _library_bound(counted: bool) -> ctypes.CDLL:
    lib = build.library("grouped_matmul", counted)
    lib.gmm_forward.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 10 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    lib.gmm_forward.restype = ctypes.c_int
    return lib


# The kernel's variants (csrc/grouped_matmul.cu): "simt" the 64 × 64 SIMT
# tile, for rows that are not 16-byte aligned or x and w both transposed;
# "tile" the 3×TF32 tensor-core tile of 80 or 128 rows; "stream" the same
# kernel with a 16-, 32- or 64-row tile, streaming the weights.
VARIANTS = ("simt", "tile", "stream")
TILE_ROWS = (80, 128)          # 160 capacity rows: two whole 80-row tiles
TILE_N = {"simt": 64, "tile": 128, "stream": 128}  # output columns a block
STAGE_K = em.STAGE_K["tile"]   # contraction of one ring stage
STREAM_ROWS = 64
MIN_STEPS_PER_CHUNK = 4        # ring stages a split chunk keeps


class Plan(NamedTuple):
    variant: str
    bm: int          # rows of a block's tile
    splits: int      # contraction chunks (1: no split, no partials)
    kchunk: int      # contraction a chunk spans


def _grouped(flags) -> bool:
    """A block per (group, expert) — per-group weights or a transposed x —
    rather than per expert with its rows over every group."""
    return bool(flags & (W_PER_GROUP | X_TRANS))


def plan_blocks(plan: Plan, G, E, M, N, flags):
    """Blocks of one launch of ``plan``, split chunks included (dead experts'
    blocks too: the plan never sees the prefixes)."""
    rows, pairs = (M, G * E) if _grouped(flags) else (G * M, E)
    return (-(-N // TILE_N[plan.variant]) * -(-rows // plan.bm) * pairs
            * plan.splits)


def shared_bytes(variant, bm, flags):
    """Shared memory of one block of a tensor-core variant: K1's ring
    (``elastic_matmul.ring_bytes``) and the per-row tables."""
    return em.ring_bytes(bm, TILE_N[variant], flags) + 20 * bm


def resident_blocks(variant, bm, flags):
    """Blocks of a tensor-core variant that one SM holds at once."""
    return em.blocks_per_sm(shared_bytes(variant, bm, flags), bm)


@functools.lru_cache(maxsize=None)
def _plan(G: int, E: int, M: int, K: int, N: int, flags: int, aligned: bool,
          sms: int) -> Plan:
    """The launch of one product, from the shapes, the layout flags, the
    16-byte alignment of the operands' rows and strides and the card's SM
    count alone — never from the prefixes, so a change of submodel never
    changes the launch. ``aligned``: see ``_aligned``.

    At most 64 rows a block with x K-contiguous and w N-contiguous (the
    serving path's shared weights) stream the weights; every other aligned
    product but xᵀ with wᵀ takes the tile of 80 or 128 rows whose last row
    tile is fullest (ties: 128, twice the warps). The split of the
    contraction: the tile splits only when its blocks do not give every SM
    one; the stream product fills every resident slot of the card in one
    wave (each block then streams an equal share of the weights)."""
    rows = M if _grouped(flags) else G * M
    both_t = flags & X_TRANS and flags & W_TRANS
    if not aligned or both_t:
        return Plan("simt", 64, 1, K)
    if rows <= STREAM_ROWS and not flags & (X_TRANS | W_TRANS):
        variant, bm = "stream", next(b for b in (16, 32, 64) if rows <= b)
    else:
        variant, bm = "tile", min(TILE_ROWS[::-1],
                                  key=lambda b: -(-rows // b) * b - rows)
    blocks = plan_blocks(Plan(variant, bm, 1, K), G, E, M, N, flags)
    if variant == "tile":
        want = -(-sms // blocks)
    else:
        want = resident_blocks(variant, bm, flags) * sms // blocks
    splits = max(1, min(want, K // (MIN_STEPS_PER_CHUNK * STAGE_K)))
    kchunk = max(STAGE_K, -(-(-(-K // splits)) // STAGE_K) * STAGE_K)
    return Plan(variant, bm, max(1, -(-K // kchunk)), kchunk)


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index) \
        .multi_processor_count


def _aligned(xs, ws, flags) -> bool:
    """Whether cp.async's 16-byte copies can read xs and ws: each stored
    row, the group and expert strides and both base addresses on 16
    bytes."""
    M, K = xs.shape[-2:]
    N = ws.shape[-1]
    strides = [M if flags & X_TRANS else K, K if flags & W_TRANS else N,
               xs.stride(0), xs.stride(1), ws.stride(-3)] + \
        ([ws.stride(0)] if flags & W_PER_GROUP else [])
    return all(s % 4 == 0 for s in strides) and \
        xs.data_ptr() % 16 == 0 and ws.data_ptr() % 16 == 0


def grouped_matmul_plain(xs, ws, g_active=None):
    """The plain PyTorch version of the kernel (the reference's
    ``kernels/ref.py::grouped_elastic_matmul_ref`` with a group axis and
    per-group prefixes)."""
    y = torch.matmul(xs, ws.to(xs.dtype))
    if g_active is None:
        return y
    E = xs.shape[1]
    live = torch.arange(E, device=xs.device)[None, :] < g_active[:, None]
    return torch.where(live[:, :, None, None], y,
                       torch.zeros((), dtype=y.dtype, device=y.device))


def _inner_layout(t, name) -> bool:
    """(transposed?) of the matrices in the last two dims of ``t``: stored
    row-major, or as a ``.transpose(-1, -2)`` view of row-major matrices.
    The leading axes may sit at any stride (passed apart)."""
    rows, cols = t.shape[-2], t.shape[-1]
    rs, cs = t.stride(-2), t.stride(-1)
    if (cs == 1 or cols == 1) and (rs == cols or rows == 1):
        return False
    if (rs == 1 or rows == 1) and (cs == rows or cols == 1):
        return True
    raise ValueError(f"grouped_matmul kernel takes {name} with row-major "
                     f"matrices or a transposed view of them, got strides "
                     f"{t.stride()} for shape {tuple(t.shape)}")


def launch_plan(xs, ws):
    """(layout flags, ``Plan``) of the kernel launch for CUDA operands xs
    (G, E, M, K) and ws (E, K, N) or (G, E, K, N)."""
    G, E, M, K = xs.shape
    flags = (X_TRANS if _inner_layout(xs, "xs") else 0) | \
        (W_TRANS if _inner_layout(ws, "ws") else 0) | \
        (W_PER_GROUP if ws.dim() == 4 else 0)
    return flags, _plan(G, E, M, K, ws.shape[-1], flags,
                        _aligned(xs, ws, flags), _sms(xs.device.index))


def _gmm(xs, ws, ga):
    """One product: the kernel for CUDA tensors, the plain version for CPU
    tensors. Shapes and the prefix are checked by the caller."""
    if xs.device.type == "cpu":
        return grouped_matmul_plain(xs, ws, ga)
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cpu or cuda, not "
                         f"{xs.device}")
    for t in (xs, ws):
        if t.device != xs.device or t.dtype != torch.float32:
            raise ValueError("grouped_matmul kernel takes fp32 tensors on "
                             "one device")
    G, E, M, K = xs.shape
    N = ws.shape[-1]
    flags, plan = launch_plan(xs, ws)
    y = torch.empty((G, E, M, N), dtype=xs.dtype, device=xs.device)
    partial = torch.empty((plan.splits, G, E, M, N), dtype=torch.float32,
                          device=xs.device) if plan.splits > 1 else None
    err = _library().gmm_forward(
        xs.data_ptr(), ws.data_ptr(), y.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if ga is None else ga.data_ptr(), G, E, M, K, N,
        VARIANTS.index(plan.variant), plan.bm, plan.splits, plan.kchunk,
        flags, xs.stride(0), xs.stride(1),
        ws.stride(0) if flags & W_PER_GROUP else 0, ws.stride(-3),
        stream_handle(xs.device))
    if err != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: CUDA error "
                           f"{err}")
    grouped_matmul.launches_by_variant[plan.variant] += 1
    grouped_matmul.launches += 1
    return y


class _Grouped(torch.autograd.Function):
    """The reference's ``_make_grouped`` custom VJP: both products of the
    backward are the same kernel again (or its plain version on the CPU),
    on transposed operands read in place, skipping the same experts."""

    @staticmethod
    def forward(ctx, xs, ws, ga):
        ctx.save_for_backward(xs, ws, ga)
        return _gmm(xs, ws, ga)

    @staticmethod
    def backward(ctx, dy):
        xs, ws, ga = ctx.saved_tensors
        dy = dy.contiguous()
        dxs = dws = None
        if ctx.needs_input_grad[0]:
            dxs = _gmm(dy, ws.transpose(-1, -2), ga)
        if ctx.needs_input_grad[1]:
            dws = _gmm(xs.transpose(-1, -2), dy, ga)
            if ws.dim() == 3:                    # shared by every group
                dws = dws.sum(0)
        return dxs, dws, None


def grouped_matmul(xs, ws, g_active=None):
    """Expert-prefix grouped matmul (see the module docstring).

    xs: (G, E, M, K); ws: (E, K, N) or (G, E, K, N), the matrices of each
    row-major or a ``.transpose(-1, -2)`` view of row-major ones, the group
    and expert axes at any stride; g_active: (G,) int32 tensor on xs's
    device, or None. Returns (G, E, M, N) in xs's dtype, experts past their
    group's prefix exactly zero; differentiable in xs and ws.
    """
    if xs.dim() != 4 or ws.dim() not in (3, 4) or \
            xs.shape[-1] != ws.shape[-2] or ws.shape[-3] != xs.shape[1] or \
            (ws.dim() == 4 and ws.shape[0] != xs.shape[0]):
        raise ValueError(f"xs (G,E,M,K) and ws (E,K,N) or (G,E,K,N) "
                         f"required, got {tuple(xs.shape)} and "
                         f"{tuple(ws.shape)}")
    G = xs.shape[0]
    if g_active is not None and (g_active.shape != (G,)
                                 or g_active.dtype != torch.int32
                                 or g_active.device != xs.device):
        raise ValueError(f"g_active must be a ({G},) int32 tensor on "
                         f"{xs.device}, got {tuple(g_active.shape)} "
                         f"{g_active.dtype} on {g_active.device}")
    if torch.is_grad_enabled() and (xs.requires_grad or ws.requires_grad):
        return _Grouped.apply(xs, ws, g_active)
    return _gmm(xs, ws, g_active)


grouped_matmul.launches = 0
# launches per variant of the plan (same increments as ``launches``)
grouped_matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)
