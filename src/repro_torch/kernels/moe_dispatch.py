"""MoE token dispatch / combine: gather and gather-reduce row movement.

The port of the reference's ``kernels/moe_dispatch.py``: the wide (·, d)
row traffic around the grouped expert matmul runs as two row-movement
kernels, driven by the router's index tables (``models.moe`` builds them):

* ``gather_rows`` (K6) — out[r] = x[idx[r]] if valid[r] else 0: the
  *dispatch* direction, one output row per capacity slot;
* ``gather_reduce`` (K7) — out[t] = Σ_j gates[t, j] · y[dest[t, j]]: the
  *combine* direction, one output row per token, its k gathered rows summed
  in the fixed order j = 0 … k−1.

Indices are clamped into range, as in the reference: an invalid slot reads
nothing, an out-of-range assignment must carry gate 0. The contracts are
the reference's 1-D ones; a group axis (clients, decode slots) is flattened
into the rows by the caller, which offsets each group's indices by its
rows on the device.

``moe_dispatch`` / ``moe_combine`` are ``torch.autograd.Function``s whose
backwards are the reference's: the dispatch's cotangent is a K7 and the
combine's is two K6 (the slot rows' cotangent, and the rows its gate
cotangent contracts with) plus the ``dgate`` einsum.

Each kernel wrapper launches ``csrc/moe_dispatch.cu`` for CUDA tensors and
takes its plain version only for tensors on the CPU; ``gather_rows`` and
``gather_reduce`` count their launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library("moe_dispatch")
    lib.gather_rows_forward.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.gather_rows_forward.restype = ctypes.c_int
    lib.gather_reduce_forward.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.gather_reduce_forward.restype = ctypes.c_int
    return lib


def _clamped(idx, n_src):
    return idx.long().clamp(0, max(n_src - 1, 0))


def gather_rows_plain(x, idx, valid):
    """The plain PyTorch version of K6."""
    R, d = idx.shape[0], x.shape[1]
    if x.shape[0] == 0:
        return x.new_zeros((R, d))
    rows = x[_clamped(idx, x.shape[0])]
    return torch.where(valid[:, None] != 0, rows,
                       torch.zeros((), dtype=x.dtype, device=x.device))


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


def _check_cuda(name, rows, *index_tensors, gates=None):
    for t in (rows, gates):
        if t is not None and (t.device != rows.device
                              or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{name} kernel takes contiguous fp32 rows and "
                             f"gates on one device")
    for t in index_tensors:
        if t.device != rows.device or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous int32 indices "
                             f"on the rows' device")


def gather_rows(x, idx, valid):
    """K6: x (R_src, d); idx, valid (R,) int32 -> (R, d) with
    out[r] = x[idx[r]] where valid[r] else 0 (bit-exact copies)."""
    if x.dim() != 2 or idx.dim() != 1 or valid.shape != idx.shape:
        raise ValueError(f"x (R_src, d) and idx/valid (R,) required, got "
                         f"{tuple(x.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(valid.shape)}")
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx, valid)
    if x.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda, not {x.device}")
    _check_cuda("gather_rows", x, idx, valid)
    R, (n_src, d) = idx.shape[0], x.shape
    out = torch.empty((R, d), dtype=x.dtype, device=x.device)
    err = _library().gather_rows_forward(
        x.data_ptr(), idx.data_ptr(), valid.data_ptr(), out.data_ptr(), R,
        n_src, d, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{err}")
    gather_rows.launches += 1
    return out


def gather_reduce(y, dest, gates):
    """K7: y (R_src, d); dest (T, k) int32; gates (T, k) -> (T, d) with
    out[t] = Σ_j gates[t, j] · y[dest[t, j]], summed in fp32 in order
    j = 0 … k−1. Out-of-range dest entries must carry gate 0."""
    if y.dim() != 2 or dest.dim() != 2 or gates.shape != dest.shape:
        raise ValueError(f"y (R_src, d) and dest/gates (T, k) required, got "
                         f"{tuple(y.shape)}, {tuple(dest.shape)}, "
                         f"{tuple(gates.shape)}")
    if y.device.type == "cpu":
        return gather_reduce_plain(y, dest, gates)
    if y.device.type != "cuda":
        raise ValueError(f"gather_reduce runs on cpu or cuda, not {y.device}")
    _check_cuda("gather_reduce", y, dest, gates=gates)
    (T, k), (n_src, d) = dest.shape, y.shape
    out = torch.empty((T, d), dtype=y.dtype, device=y.device)
    err = _library().gather_reduce_forward(
        y.data_ptr(), dest.data_ptr(), gates.data_ptr(), out.data_ptr(), T, k,
        n_src, d, torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_reduce kernel launch failed: CUDA error "
                           f"{err}")
    gather_reduce.launches += 1
    return out


gather_rows.launches = 0
gather_reduce.launches = 0


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
        T, k = gate_eff.shape
        dout = dout.contiguous()
        dy = dgate = None
        if ctx.needs_input_grad[0]:
            # slot ← token: each valid slot reads its owner token's cotangent
            dy = gather_rows(dout, slot_src, slot_valid) * \
                slot_gate[:, None].to(dout.dtype)
        if ctx.needs_input_grad[1]:
            # gate cotangent: re-gather the slot rows this (t, j) pointed at
            yg = gather_rows(y_flat, dest_tj,
                             (gate_eff.reshape(-1) != 0).to(torch.int32))
            dgate = torch.einsum("td,tjd->tj", dout.float(),
                                 yg.reshape(T, k, -1).float()).to(
                                     gate_eff.dtype)
        return dy, dgate, None, None, None, None


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
