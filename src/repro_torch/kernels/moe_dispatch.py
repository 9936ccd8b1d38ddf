"""MoE token dispatch / combine: gather and gather-reduce row movement.

The port of the reference's ``kernels/moe_dispatch.py``: the wide (·, d)
row traffic around the grouped expert matmul runs as row-movement kernels
(``csrc/moe_dispatch.cu``), driven by the router's index tables
(``models.moe`` builds them):

* ``gather_rows`` (K6) — out[r] = x[idx[r]] if valid[r] else 0: the
  *dispatch* direction, one output row per capacity slot; with ``scale``
  each valid row times scale[r] (one fp32 multiply), the slot cotangent of
  the combine's VJP in one pass;
* ``gather_dot`` (K6's contraction) — out[t, j] = Σ_d z[t, d] ·
  x[idx[t·k + j], d] where valid, else 0: the gate cotangent of the
  combine's VJP without the (T·k, d) rows it contracts;
* ``gather_reduce`` (K7) — out[t] = Σ_j gates[t, j] · y[dest[t, j]]: the
  *combine* direction, one output row per token, its k gathered rows summed
  in the fixed order j = 0 … k−1.

Indices are clamped into range, as in the reference: an invalid slot reads
nothing, an out-of-range assignment must carry gate 0. The contracts are
the reference's 1-D ones; a group axis (clients, decode slots) is flattened
into the rows by the caller, which offsets each group's indices by its
rows on the device.

``moe_dispatch`` / ``moe_combine`` are ``torch.autograd.Function``s whose
backwards are the reference's: the dispatch's cotangent is a K7, the
combine's (``combine_vjp``) a scaled K6 gather and a gather-dot.

Each kernel wrapper launches its kernel for CUDA tensors and takes its
plain version only for tensors on the CPU; each counts its launches in
``.launches``. K6 and K7 have two designs (``GATHER_VARIANTS``,
``REDUCE_VARIANTS``): the redesign (``unrolled``: a warp per row, eight
16-byte loads a lane in flight; ``split``: a warp per (token, 128
columns), the k row loads issued before the FMAs), and ``first``, the first design,
kept for measurement and tests only. The launch of each — warps a block,
or warps a token for ``gather_dot`` — comes from the shapes and the SM
count alone (``gather_plan``, ``reduce_plan``, ``dot_plan``), never from
the indices. ``gather_rows.launches_by_variant`` counts ``first``,
``copy`` and ``scaled`` launches, ``gather_reduce.launches_by_variant``
``first`` and ``split``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import stream_handle

# K6 / K7 designs, in the order of the C entry points' ``variant``
GATHER_VARIANTS = ("first", "unrolled")
REDUCE_VARIANTS = ("first", "split")
# K6's launch counts: the first design, and the redesign's two functions
GATHER_COUNTS = ("first", "copy", "scaled")
WARP_CHOICES = (8, 4, 2, 1)      # warps a block, widest first
DOT_WARPS = 4                    # gather-dot: warps a block (kDotWarps)
DOT_SPLITS = (1, 2, 4)           # gather-dot: warps a token


class GatherPlan(NamedTuple):
    warps: int          # K6 / K7: warps a block (a warp per row, or per
                        # token and 32 column vectors)


class DotPlan(NamedTuple):
    split: int          # gather-dot: warps a token, each a column slice


@functools.lru_cache(maxsize=None)
def gather_plan(R: int, sms: int) -> GatherPlan:
    """K6's launch: a warp per row, as many warps a block as keep at least
    one block an SM (a decode step's 512 slots run 2 warps a block on 256
    blocks; the training dispatch 8 a block)."""
    for w in WARP_CHOICES:
        if -(-R // w) >= sms:
            return GatherPlan(w)
    return GatherPlan(1)


@functools.lru_cache(maxsize=None)
def reduce_plan(T: int, d: int, vec: bool, sms: int) -> GatherPlan:
    """K7's launch: a warp per (token, 32 column vectors — 16-byte vectors
    where ``vec``, else floats), as many warps a block as keep two blocks
    an SM; a 2-token decode step at d = 1024 runs 16 one-warp blocks, on
    16 SMs."""
    n = d // 4 if vec else d
    warps = T * -(-n // 32)
    for w in WARP_CHOICES:
        if -(-warps // w) >= 2 * sms:
            return GatherPlan(w)
    return GatherPlan(1)


@functools.lru_cache(maxsize=None)
def dot_plan(T: int, d: int, vec: bool, sms: int) -> DotPlan:
    """The gather-dot's launch: 1, 2 or 4 warps a token, the fewest that
    give 16 warps an SM, each slice at least 32 vectors wide (the training
    combine's 2048 tokens take 2, the fastest of the three on an H100:
    ``chip_probe.py shapes``)."""
    n = d // 4 if vec else d
    split = 1
    while split < DOT_SPLITS[-1] and T * split < 16 * sms and \
            n // (2 * split) >= 32:
        split *= 2
    return DotPlan(split)


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index) \
        .multi_processor_count


def _library() -> ctypes.CDLL:
    """The loaded library: the counted build inside ``build.counting()``,
    else the fast one."""
    return _library_bound(build.counting_active())


@functools.lru_cache(maxsize=None)
def _library_bound(counted: bool) -> ctypes.CDLL:
    lib = build.library("moe_dispatch", counted)
    lib.gather_rows_forward.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.gather_rows_forward.restype = ctypes.c_int
    lib.gather_dot_forward.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.gather_dot_forward.restype = ctypes.c_int
    lib.gather_reduce_forward.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.gather_reduce_forward.restype = ctypes.c_int
    return lib


def _clamped(idx, n_src):
    return idx.long().clamp(0, max(n_src - 1, 0))


def gather_rows_plain(x, idx, valid, scale=None):
    """The plain PyTorch version of K6 (and of its scaled gather: the copy
    times ``scale[:, None]``)."""
    R, d = idx.shape[0], x.shape[1]
    if x.shape[0] == 0:
        rows = x.new_zeros((R, d))
    else:
        rows = torch.where(valid[:, None] != 0,
                           x[_clamped(idx, x.shape[0])],
                           torch.zeros((), dtype=x.dtype, device=x.device))
    return rows if scale is None else rows * scale[:, None]


def gather_dot_plain(x, idx, valid, z, k):
    """The plain PyTorch version of the gather-dot: the gathered rows, then
    the einsum the reference's VJP contracts them with."""
    T = z.shape[0]
    rows = gather_rows_plain(x, idx, valid).reshape(T, k, -1)
    return torch.einsum("td,tjd->tj", z.float(), rows.float())


def gather_reduce_plain(y, dest, gates):
    """The plain PyTorch version of K7: the k terms summed in order."""
    T, k = dest.shape
    out = y.new_zeros((T, y.shape[1]))
    if y.shape[0] == 0:
        return out
    rows = y[_clamped(dest, y.shape[0])]                    # (T, k, d)
    g = gates.to(y.dtype)
    for j in range(k):
        out = out + g[:, j:j + 1] * rows[:, j]
    return out


def _check_cuda(name, rows, *index_tensors, floats=()):
    for t in (rows,) + tuple(floats):
        if t.device != rows.device or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous fp32 rows, "
                             f"gates and scales on one device")
    for t in index_tensors:
        if t.device != rows.device or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous int32 indices "
                             f"on the rows' device")


def _vec(d, *tensors):
    """Rows move as 16-byte vectors: d a multiple of 4 and every base
    address 16-byte aligned."""
    return d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def _variant(name, variant, variants):
    if variant is None:
        return variants[-1]
    if variant not in variants:
        raise ValueError(f"{name} variant must be one of {variants}, got "
                         f"{variant!r}")
    return variant


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def gather_rows(x, idx, valid, scale=None, *,
                variant: Optional[str] = None):
    """K6: x (R_src, d); idx, valid (R,) int32 -> (R, d) with
    out[r] = x[idx[r]] where valid[r] else 0 (bit-exact copies); with
    ``scale`` (R,), out[r] = scale[r] · x[idx[r]] (one fp32 multiply,
    bit-equal to the copy times the scale). ``variant`` (CUDA tensors
    only): None for the redesign, or one of ``GATHER_VARIANTS`` (``first``
    takes no scale)."""
    if x.dim() != 2 or idx.dim() != 1 or valid.shape != idx.shape or \
            (scale is not None and scale.shape != idx.shape):
        raise ValueError(f"x (R_src, d) and idx/valid/scale (R,) required, "
                         f"got {tuple(x.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(valid.shape)}")
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx, valid, scale)
    if x.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda, not {x.device}")
    variant = _variant("gather_rows", variant, GATHER_VARIANTS)
    if variant == "first" and scale is not None:
        raise ValueError("gather_rows' first design takes no scale")
    _check_cuda("gather_rows", x, idx, valid,
                floats=() if scale is None else (scale,))
    R, (n_src, d) = idx.shape[0], x.shape
    out = torch.empty((R, d), dtype=x.dtype, device=x.device)
    _raise_on(_library().gather_rows_forward(
        x.data_ptr(), idx.data_ptr(), valid.data_ptr(),
        None if scale is None else scale.data_ptr(), out.data_ptr(), R,
        n_src, d, int(_vec(d, x, out)), GATHER_VARIANTS.index(variant),
        gather_plan(R, _sms(x.device.index)).warps,
        stream_handle(x.device)), "gather_rows")
    count = "first" if variant == "first" else \
        ("copy" if scale is None else "scaled")
    gather_rows.launches_by_variant[count] += 1
    gather_rows.launches += 1
    return out


def gather_dot(x, idx, valid, z, k):
    """K6's gather-dot: x (R_src, d); idx, valid (T·k,) int32; z (T, d)
    -> (T, k) fp32 with out[t, j] = Σ_d z[t, d] · x[idx[t·k + j], d] where
    valid[t·k + j], else 0. The kernel sums each dot per lane in column
    order, then over the warp by a butterfly, then over a token's column
    slices in order: deterministic, another order than the plain
    version's."""
    if x.dim() != 2 or z.dim() != 2 or idx.dim() != 1 or \
            valid.shape != idx.shape or idx.shape[0] != z.shape[0] * k or \
            z.shape[1] != x.shape[1]:
        raise ValueError(f"x (R_src, d), idx/valid (T*k,) and z (T, d) "
                         f"required, got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(valid.shape)}, "
                         f"{tuple(z.shape)}, k={k}")
    if x.device.type == "cpu":
        return gather_dot_plain(x, idx, valid, z, k)
    if x.device.type != "cuda":
        raise ValueError(f"gather_dot runs on cpu or cuda, not {x.device}")
    _check_cuda("gather_dot", x, idx, valid, floats=(z,))
    T, (n_src, d) = z.shape[0], x.shape
    out = torch.empty((T, k), dtype=torch.float32, device=x.device)
    vec = _vec(d, x, z)
    _raise_on(_library().gather_dot_forward(
        x.data_ptr(), idx.data_ptr(), valid.data_ptr(), z.data_ptr(),
        out.data_ptr(), T, k, n_src, d, int(vec),
        dot_plan(T, d, vec, _sms(x.device.index)).split,
        stream_handle(x.device)), "gather_dot")
    gather_dot.launches += 1
    return out


def gather_reduce(y, dest, gates, *, variant: Optional[str] = None):
    """K7: y (R_src, d); dest (T, k) int32; gates (T, k) -> (T, d) with
    out[t] = Σ_j gates[t, j] · y[dest[t, j]], summed in fp32 in order
    j = 0 … k−1 (both designs bit-equal). Out-of-range dest entries must
    carry gate 0. ``variant`` (CUDA tensors only): None for the redesign,
    or one of ``REDUCE_VARIANTS``."""
    if y.dim() != 2 or dest.dim() != 2 or gates.shape != dest.shape:
        raise ValueError(f"y (R_src, d) and dest/gates (T, k) required, got "
                         f"{tuple(y.shape)}, {tuple(dest.shape)}, "
                         f"{tuple(gates.shape)}")
    if y.device.type == "cpu":
        return gather_reduce_plain(y, dest, gates)
    if y.device.type != "cuda":
        raise ValueError(f"gather_reduce runs on cpu or cuda, not {y.device}")
    variant = _variant("gather_reduce", variant, REDUCE_VARIANTS)
    _check_cuda("gather_reduce", y, dest, floats=(gates,))
    (T, k), (n_src, d) = dest.shape, y.shape
    out = torch.empty((T, d), dtype=y.dtype, device=y.device)
    vec = _vec(d, y, out)
    _raise_on(_library().gather_reduce_forward(
        y.data_ptr(), dest.data_ptr(), gates.data_ptr(), out.data_ptr(), T,
        k, n_src, d, int(vec), REDUCE_VARIANTS.index(variant),
        reduce_plan(T, d, vec, _sms(y.device.index)).warps,
        stream_handle(y.device)), "gather_reduce")
    gather_reduce.launches_by_variant[variant] += 1
    gather_reduce.launches += 1
    return out


gather_rows.launches = 0
gather_rows.launches_by_variant = dict.fromkeys(GATHER_COUNTS, 0)
gather_dot.launches = 0
gather_reduce.launches = 0
gather_reduce.launches_by_variant = dict.fromkeys(REDUCE_VARIANTS, 0)


# ---------------------------------------------------------------------------
# differentiable dispatch / combine (the model-facing pair)
# ---------------------------------------------------------------------------
class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xt, slot_src, slot_valid, dest_tj, kept_tj, n_experts,
                cap):
        ctx.save_for_backward(dest_tj, kept_tj)
        ctx.n_tokens = xt.shape[0]
        eb = gather_rows(xt, slot_src, slot_valid)
        return eb.reshape(-1, n_experts, cap, xt.shape[-1])

    @staticmethod
    def backward(ctx, deb):
        dest_tj, kept_tj = ctx.saved_tensors
        T = ctx.n_tokens
        d = deb.shape[-1]
        k = dest_tj.shape[0] // T
        dxt = gather_reduce(deb.reshape(-1, d).contiguous(),
                            dest_tj.reshape(T, k),
                            kept_tj.reshape(T, k).to(deb.dtype))
        return dxt, None, None, None, None, None, None


def moe_dispatch(xt, slot_src, slot_valid, dest_tj, kept_tj, *,
                 n_experts: int, cap: int):
    """Token dispatch: xt (T, d) -> (R / (E·cap), E, cap, d) expert buffer,
    R = len(slot_src) (one leading row per group when the group axis is
    flattened into the slots).

    slot_src / slot_valid: (R,) int32 per-slot source token and validity;
    dest_tj / kept_tj: (T·k,) int32 per-assignment destination slot and
    kept flag — the transpose of the slot tables, which the VJP's
    gather-reduce uses. Differentiable in ``xt``.
    """
    return _Dispatch.apply(xt.contiguous(), slot_src, slot_valid, dest_tj,
                           kept_tj, int(n_experts), int(cap))


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y_flat, gate_eff, dest_tj, slot_src, slot_valid,
                slot_gate):
        ctx.save_for_backward(y_flat, gate_eff, dest_tj, slot_src,
                              slot_valid, slot_gate)
        return gather_reduce(y_flat, dest_tj.reshape(gate_eff.shape),
                             gate_eff)

    @staticmethod
    def backward(ctx, dout):
        y_flat, gate_eff, dest_tj, slot_src, slot_valid, slot_gate = \
            ctx.saved_tensors
        dy, dgate = combine_vjp(dout, y_flat, gate_eff, dest_tj, slot_src,
                                slot_valid, slot_gate,
                                need_dy=ctx.needs_input_grad[0],
                                need_dgate=ctx.needs_input_grad[1])
        return dy, dgate, None, None, None, None


def combine_vjp(dout, y_flat, gate_eff, dest_tj, slot_src, slot_valid,
                slot_gate, *, need_dy=True, need_dgate=True):
    """The combine's cotangents (dy (R, d), dgate (T, k)) from the output
    cotangent ``dout`` (T, d) — the reference's VJP, each in one K6 pass:
    dy is the scaled gather (each valid slot reads its owner token's
    cotangent times its gate), dgate the gather-dot of ``dout`` with the
    slot rows each (t, j) pointed at. None where not needed."""
    T, k = gate_eff.shape
    dout = dout.contiguous()
    dy = dgate = None
    if need_dy:
        dy = gather_rows(dout, slot_src, slot_valid,
                         scale=slot_gate.to(dout.dtype).contiguous())
    if need_dgate:
        dgate = gather_dot(y_flat, dest_tj,
                           (gate_eff.reshape(-1) != 0).to(torch.int32),
                           dout, k).to(gate_eff.dtype)
    return dy, dgate


def moe_combine(y_flat, gate_eff, dest_tj, slot_src, slot_valid, slot_gate):
    """Token combine: (R, d) expert outputs -> (T, d).

    gate_eff: (T, k) per-assignment effective gates (0 for assignments
    dropped by capacity or to a masked expert); slot_gate: (R,) the same
    values in slot order (the VJP's dispatch-direction weights; no
    gradient flows into it, as in the reference). Differentiable in
    ``y_flat`` and ``gate_eff``.
    """
    return _Combine.apply(y_flat.contiguous(), gate_eff.contiguous(),
                          dest_tj, slot_src, slot_valid, slot_gate.detach())
