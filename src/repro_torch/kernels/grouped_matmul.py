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
``grouped_matmul_plain`` only for tensors on the CPU. ``grouped_matmul``'s
``launches`` attribute counts kernel launches, forward and backward.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# layout flags of csrc/grouped_matmul.cu::gmm_forward
X_TRANS, W_TRANS, W_PER_GROUP = 1, 2, 4


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library("grouped_matmul")
    lib.gmm_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
        [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    lib.gmm_forward.restype = ctypes.c_int
    return lib


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
    per_group = ws.dim() == 4
    flags = (X_TRANS if _inner_layout(xs, "xs") else 0) | \
        (W_TRANS if _inner_layout(ws, "ws") else 0) | \
        (W_PER_GROUP if per_group else 0)
    y = torch.empty((G, E, M, N), dtype=xs.dtype, device=xs.device)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = _library().gmm_forward(
        xs.data_ptr(), ws.data_ptr(), y.data_ptr(),
        None if ga is None else ga.data_ptr(), G, E, M, K, N, flags,
        xs.stride(0), xs.stride(1), ws.stride(0) if per_group else 0,
        ws.stride(-3), stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: CUDA error "
                           f"{err}")
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
