"""Mamba2 SSD chunk scan, forward (K8) and transposed backward (K9), with a
per-row head prefix.

The port of the reference's ``kernels/ssd_scan.py``. For xh (R, S, H, P),
dt (R, S, H), A (H,) or one per row (R, H), Bm / Cm (R, S, G, N) with G
dividing H (head h reads group ``h // (H / G)``) and chunks of Q tokens,
every (row, head) runs the chunks in order, carrying a (P, N) fp32 state:

    cum_t  = Σ_{k≤t} dt_k·A                        (within the chunk)
    y_t    = Σ_{s≤t} (C_t·B_s) e^{cum_t − cum_s} dt_s x_s + e^{cum_t} C_t·hᵀ
    h     ← e^{cum_Q} h + Σ_s e^{cum_Q − cum_s} dt_s x_s ⊗ B_s

Heads at or past the row's prefix ``h_active[row]`` ((R,) int32; None =
all heads) give zeros. The decay is masked *before* the exponential (the
upper triangle, where ``cum_t − cum_s > 0``, never reaches ``exp``): the
reference's ``ssd_chunked`` computes ``where(tri, exp(diff), 0)`` and its
gradient turns NaN once a chunk's Σ|dt·A| passes ~88; here it stays
finite. ``cum`` is accumulated in fp64 and rounded to fp32 once, in the
kernels (in index order) and in the plain versions (``torch.cumsum`` in
float64): the two agree to the last bit whatever order the sum runs in.

* ``ssd_scan`` (K8, ``csrc/ssd_scan.cu``) -> y, and with
  ``return_states=True`` also the state each chunk *entered* with,
  (R, S/Q, H, P, N) fp32 — the residual the backward consumes. ``ssd_plan``
  picks its variant from the shapes (``SSD_VARIANTS``: ``mma``, C·Bᵀ once
  per group and the scan on 3×TF32 tensor cores, a block per (row, head,
  P tile); ``simt``, the first design, for shapes the mma variant does not
  take) and the P tile; ``ssd_scan.launches_by_variant`` counts launches
  by variant (one per call, though the mma variant runs three kernels);
* ``ssd_scan_bwd`` (K9, same source) -> (dx, ddt, dA, dB, dC): the
  transposed scan, chunks in reverse carrying the state cotangent. The
  kernel (``ssd_scan_bwd_raw``) emits dx, ddt, du (the cotangent of
  u = dt·A) and dB / dC per head; ``dA = Σ_s du·dt`` (per row) and the
  sums of dB / dC over each group's heads are plain torch reductions
  outside it, as in the reference (deterministic; no atomics across
  heads).

``ssd_scan_plain`` (chunk by chunk) and ``ssd_scan_bwd_raw_plain`` (the
algebra of the reference's ``_bwd_kernel``, chunks in reverse; not
autograd of the forward; ``ssd_scan_bwd_plain`` adds the reductions) are
the plain versions: each wrapper takes them
only for tensors on the CPU, and for CUDA tensors launches its kernel or
raises. ``ssd_scan.launches`` and ``ssd_scan_bwd.launches`` count kernel
launches. The differentiable op over both is ``kernels.dispatch.ssd_op``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

KERNEL_HEAD_DIMS = (32, 64)
KERNEL_MAX_STATE = 128
# K8's variants (csrc/ssd_scan.cu::ssd_scan_fwd)
SSD_VARIANTS = ("simt", "mma")
MMA_MAX_CHUNK = 256      # 16 query tiles of 16: two per warp
CB_TILE = 64             # C·Bᵀ tiles; the buffer's rows are padded to it


class SsdPlan(NamedTuple):
    variant: str
    p_tile: int          # columns of P a block owns (P for simt)


@functools.lru_cache(maxsize=None)
def ssd_plan(R: int, H: int, P: int, N: int, Q: int, aligned: bool,
             sms: int) -> SsdPlan:
    """K8's launch from the shapes, the operands' 16-byte alignment and the
    card's SM count alone — never from ``h_active``. The mma variant owns
    32 columns of P a block (two blocks per SM fit its registers and
    shared memory; the state's P rows are independent, so a slice is
    exact); where that gives fewer blocks than SMs, 16. Shapes it does not
    take (d_state not a multiple of 8, a chunk above 256, unaligned rows)
    run the simt variant, a block per (row, head)."""
    if not aligned or N % 8 or N > KERNEL_MAX_STATE or Q > MMA_MAX_CHUNK:
        return SsdPlan("simt", P)
    wide = SsdPlan("mma", 32)
    return wide if plan_blocks(wide, R, H, P) >= sms else SsdPlan("mma", 16)


def plan_blocks(plan: SsdPlan, R, H, P):
    """Blocks of the scan kernel of ``plan`` (dead heads' blocks too)."""
    return R * H * (P // plan.p_tile)


def shared_bytes(p_tile, N, Q):
    """Shared memory of one block of the mma variant's scan
    (``mma_fwd_floats`` in the source): the state slice (rows padded to
    N + 8), the 3-stage ring of 32-key x and B tiles (rows padded by 4)
    and four chunk vectors."""
    qr = -(-Q // 32) * 32
    return 4 * (p_tile * (N + 8) + 3 * 32 * (p_tile + 4 + N + 4) + 4 * qr)


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index) \
        .multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library("ssd_scan")
    lib.ssd_scan_fwd.argtypes = [ctypes.c_void_p] * 10 + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_bwd.argtypes = [ctypes.c_void_p] * 13 + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.ssd_scan_bwd.restype = ctypes.c_int
    return lib


def chunk_cumsum(u, dim):
    """Cumulative sum of the fp32 tensor ``u`` along ``dim``, accumulated in
    fp64 and rounded to fp32 once — what the kernels compute in index
    order (and what ``torch.cumsum`` of fp32 gives on the CPU)."""
    return torch.cumsum(u.double(), dim).float()


def row_A(A, R):
    """A (H,) or (R, H) -> (R, H) fp32."""
    A = A.float()
    return A.expand(R, A.shape[-1]) if A.dim() == 1 else A


def _live(h_active, R, H, device):
    """(R, H) bool: heads below each row's prefix."""
    if h_active is None:
        return torch.ones((R, H), dtype=torch.bool, device=device)
    return torch.arange(H, device=device)[None, :] < h_active[:, None]


def _heads(t, rep):
    """(R, S, G, N) -> (R, S, H, N): each group repeated over its heads."""
    return t.float().repeat_interleave(rep, dim=2)


def _decay(cum):
    """(R, Q, H) chunk cums -> (R, t, s, H) e^{cum_t − cum_s} on s ≤ t, 0
    above the diagonal (masked before the exponential)."""
    Q = cum.shape[1]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=cum.device).tril()
    diff = cum[:, :, None, :] - cum[:, None, :, :]
    return diff.masked_fill(~tri[None, :, :, None], float("-inf")).exp()


def ssd_scan_plain(xh, dt, A, Bm, Cm, chunk, h_active=None,
                   return_states=False):
    """The plain PyTorch version of K8: the reference's ``_kernel``, chunk
    by chunk, batched over rows and heads."""
    R, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, nc = H // G, S // chunk
    A = row_A(A, R)
    x, dtf = xh.float(), dt.float()
    Bh, Ch = _heads(Bm, rep), _heads(Cm, rep)
    h = torch.zeros((R, H, P, N), dtype=torch.float32, device=xh.device)
    ys, states = [], []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        dtc, Bc, Cc = dtf[:, sl], Bh[:, sl], Ch[:, sl]
        cum = chunk_cumsum(dtc * A[:, None, :], 1)            # (R,Q,H)
        CB = torch.einsum("rthn,rshn->rtsh", Cc, Bc)
        xdt = x[:, sl] * dtc[..., None]
        y_intra = torch.einsum("rtsh,rshp->rthp", CB * _decay(cum), xdt)
        if return_states:
            states.append(h)
        y_inter = torch.exp(cum)[..., None] * torch.einsum(
            "rthn,rhpn->rthp", Cc, h)
        ys.append(y_intra + y_inter)
        decay_end = torch.exp(cum[:, -1:] - cum)              # (R,Q,H)
        S_c = torch.einsum("rshp,rshn->rhpn", xdt * decay_end[..., None], Bc)
        h = h * torch.exp(cum[:, -1])[..., None, None] + S_c
    live = _live(h_active, R, H, xh.device)
    zero = torch.zeros((), dtype=torch.float32, device=xh.device)
    y = torch.where(live[:, None, :, None], torch.cat(ys, 1), zero)
    if not return_states:
        return y.to(xh.dtype)
    st = torch.where(live[:, None, :, None, None], torch.stack(states, 1),
                     zero)
    return y.to(xh.dtype), st


def ssd_scan_bwd_raw_plain(xh, dt, A, Bm, Cm, states, dy, chunk,
                           h_active=None):
    """The plain PyTorch version of K9's own outputs (dx, ddt, du, dB, dC
    per head): a transcription of the reference's ``_bwd_kernel``, chunks
    in reverse carrying the state cotangent."""
    R, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, nc = H // G, S // chunk
    Ar = row_A(A, R)
    x, dtf, dyf = xh.float(), dt.float(), dy.float()
    Bh, Ch = _heads(Bm, rep), _heads(Cm, rep)
    dh = torch.zeros((R, H, P, N), dtype=torch.float32, device=xh.device)
    dx, ddt, du, dB, dC = (torch.zeros_like(x), torch.zeros_like(dtf),
                           torch.zeros_like(dtf), torch.zeros_like(Bh),
                           torch.zeros_like(Ch))
    for c in reversed(range(nc)):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc, Bc, Cc, dyc = x[:, sl], dtf[:, sl], Bh[:, sl], Ch[:, sl], \
            dyf[:, sl]
        h_in = states[:, c].float()                           # (R,H,P,N)
        cum = chunk_cumsum(dtc * Ar[:, None, :], 1)
        L = _decay(cum)
        CB = torch.einsum("rthn,rshn->rtsh", Cc, Bc)
        xdt = xc * dtc[..., None]
        e = torch.exp(cum)
        E_Q = torch.exp(cum[:, -1])                           # (R,H)
        w_end = torch.exp(cum[:, -1:] - cum)
        # intra-chunk: y_intra = (CB∘L) @ xdt
        dG = torch.einsum("rthp,rshp->rtsh", dyc, xdt)
        dCB = dG * L
        DL = dCB * CB
        dxdt = torch.einsum("rtsh,rthp->rshp", CB * L, dyc)
        dCc = torch.einsum("rtsh,rshn->rthn", dCB, Bc)
        dBc = torch.einsum("rtsh,rthn->rshn", dCB, Cc)
        # inter-chunk read: y_inter = e ∘ (C @ h_inᵀ)
        CH = torch.einsum("rthn,rhpn->rthp", Cc, h_in)
        dcum = DL.sum(2) - DL.sum(1) + (dyc * CH).sum(-1) * e
        dCc = dCc + e[..., None] * torch.einsum("rthp,rhpn->rthn", dyc,
                                                h_in)
        dh_y = torch.einsum("rthp,rthn->rhpn", dyc * e[..., None], Cc)
        # state write: h_out = E_Q·h_in + Σ_s w_s·(xdt_s ⊗ B_s)
        XD = torch.einsum("rshp,rhpn->rshn", xdt, dh)
        Tt = (XD * Bc).sum(-1)                                # (R,Q,H)
        dxdt = dxdt + w_end[..., None] * torch.einsum("rshn,rhpn->rshp",
                                                      Bc, dh)
        dBc = dBc + w_end[..., None] * XD
        dcum = dcum - Tt * w_end
        # cum = cumsum(u): du_s = Σ_{t≥s} dcum_t + last, summed in fp64 as
        # the kernel sums it (the offset Σ dcum + last reaches every du_s,
        # and dA = Σ_s du_s·dt_s multiplies its rounding by Σ_s dt_s)
        last = E_Q.double() * (dh.double() * h_in.double()).sum((-1, -2)) \
            + (Tt * w_end).double().sum(1)
        d64 = dcum.double()
        duc = ((d64.sum(1, keepdim=True) + last[:, None])
               - torch.cumsum(d64, 1) + d64).float()
        dh = dh * E_Q[..., None, None] + dh_y
        dx[:, sl] = dxdt * dtc[..., None]
        ddt[:, sl] = (dxdt * xc).sum(-1) + duc * Ar[:, None, :]
        du[:, sl] = duc
        dB[:, sl] = dBc
        dC[:, sl] = dCc
    live = _live(h_active, R, H, xh.device)
    zero = torch.zeros((), dtype=torch.float32, device=xh.device)
    m4, m3 = live[:, None, :, None], live[:, None, :]
    return (torch.where(m4, dx, zero), torch.where(m3, ddt, zero),
            torch.where(m3, du, zero), torch.where(m4, dB, zero),
            torch.where(m4, dC, zero))


def ssd_scan_bwd_plain(xh, dt, A, Bm, Cm, states, dy, chunk, h_active=None):
    """The plain version of ``ssd_scan_bwd``."""
    return _reduce_bwd(ssd_scan_bwd_raw_plain(xh, dt, A, Bm, Cm, states, dy,
                                              chunk, h_active),
                       xh, dt, A, Bm, Cm)


def _reduce_bwd(raw, xh, dt, A, Bm, Cm):
    """K9's per-head outputs -> (dx, ddt, dA, dB, dC): dA = Σ_s du·dt per
    row ((R, H), or (H,) for a shared A) and dB / dC summed over each
    group's heads — plain torch reductions, as in the reference."""
    dx, ddt, du, dBh, dCh = raw
    R, S, H, _ = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dA = torch.einsum("rsh,rsh->rh", du, dt.float())
    if A.dim() == 1:
        dA = dA.sum(0)
    dB = dBh.reshape(R, S, G, H // G, N).sum(3)
    dC = dCh.reshape(R, S, G, H // G, N).sum(3)
    return (dx.to(xh.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(Bm.dtype), dC.to(Cm.dtype))


def _check(xh, dt, A, Bm, Cm, chunk, h_active):
    if xh.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4 or \
            Bm.shape != Cm.shape:
        raise ValueError(f"xh (R,S,H,P), dt (R,S,H), Bm = Cm (R,S,G,N) "
                         f"required, got {tuple(xh.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    R, S, H, P = xh.shape
    G = Bm.shape[2]
    if dt.shape != (R, S, H) or Bm.shape[:2] != (R, S) or G == 0 or H % G:
        raise ValueError(f"incompatible xh {tuple(xh.shape)}, dt "
                         f"{tuple(dt.shape)} and Bm {tuple(Bm.shape)}")
    if A.shape not in ((H,), (R, H)):
        raise ValueError(f"A must be ({H},) or ({R}, {H}), got "
                         f"{tuple(A.shape)}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")
    if h_active is not None and (h_active.shape != (R,)
                                 or h_active.dtype != torch.int32
                                 or h_active.device != xh.device):
        raise ValueError(f"h_active must be a ({R},) int32 tensor on "
                         f"{xh.device}")


def _kernel_args(name, tensors, P, N):
    """Device, dtype and contiguity checks of a launch; returns the
    stream."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous fp32 tensors "
                             f"on one device")
    if P not in KERNEL_HEAD_DIMS or not 0 < N <= KERNEL_MAX_STATE:
        raise ValueError(f"{name} kernel supports head_dim in "
                         f"{KERNEL_HEAD_DIMS} and d_state ≤ "
                         f"{KERNEL_MAX_STATE}, got {P} and {N}")
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def ssd_scan(xh, dt, A, Bm, Cm, chunk, *, h_active=None,
             return_states=False):
    """The SSD chunk scan forward (K8): y (R, S, H, P), and with
    ``return_states`` also the per-chunk initial states (R, S/chunk, H, P,
    N) fp32. See the module docstring for the contract."""
    _check(xh, dt, A, Bm, Cm, chunk, h_active)
    if xh.device.type == "cpu":
        return ssd_scan_plain(xh, dt, A, Bm, Cm, chunk, h_active,
                              return_states)
    R, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    A = row_A(A, R).contiguous()
    stream = _kernel_args("ssd_scan", (xh, dt, A, Bm, Cm), P, N)
    plan = launch_plan(xh, Bm, Cm, chunk)
    y = torch.empty_like(xh)
    states = torch.empty((R, S // chunk, H, P, N), dtype=torch.float32,
                         device=xh.device) if return_states else None
    cb = cum = None
    if plan.variant == "mma":        # C·Bᵀ per group, cum per head
        qp = -(-chunk // CB_TILE) * CB_TILE
        cb = torch.empty((R, G, S // chunk, qp, qp), dtype=torch.float32,
                         device=xh.device)
        cum = torch.empty((R, H, S), dtype=torch.float32, device=xh.device)
    err = _library().ssd_scan_fwd(
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), _ptr(h_active), y.data_ptr(), _ptr(states), _ptr(cb),
        _ptr(cum), R, S, H, P, G, N, chunk,
        SSD_VARIANTS.index(plan.variant), plan.p_tile, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err}")
    ssd_scan.launches_by_variant[plan.variant] += 1
    ssd_scan.launches += 1
    return (y, states) if return_states else y


def launch_plan(xh, Bm, Cm, chunk) -> SsdPlan:
    """K8's ``SsdPlan`` for contiguous CUDA operands: 16-byte-aligned rows
    (d_state a multiple of 4) and base addresses."""
    R, S, H, P = xh.shape
    N = Bm.shape[3]
    aligned = N % 4 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (xh, Bm, Cm))
    return ssd_plan(R, H, P, N, chunk, aligned, _sms(xh.device.index))


def ssd_scan_bwd_raw(xh, dt, A, Bm, Cm, states, dy, chunk, *,
                     h_active=None):
    """K9's own outputs: dx (R, S, H, P), ddt and du (R, S, H), and dB / dC
    per head (R, S, H, N). ``states``: the per-chunk initial states of
    ``ssd_scan(..., return_states=True)``; ``dy`` the output cotangent.
    Heads past the row's prefix get exactly-zero cotangents. The launch
    counts on ``ssd_scan_bwd.launches``."""
    _check(xh, dt, A, Bm, Cm, chunk, h_active)
    R, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if states.shape != (R, S // chunk, H, P, N) or dy.shape != xh.shape:
        raise ValueError(f"states {tuple(states.shape)} or dy "
                         f"{tuple(dy.shape)} do not fit xh "
                         f"{tuple(xh.shape)}")
    if xh.device.type == "cpu":
        return ssd_scan_bwd_raw_plain(xh, dt, A, Bm, Cm, states, dy, chunk,
                                      h_active)
    Ar = row_A(A, R).contiguous()
    stream = _kernel_args("ssd_scan_bwd", (xh, dt, Ar, Bm, Cm, states, dy),
                          P, N)
    dx = torch.empty_like(xh)
    ddt = torch.empty_like(dt)
    du = torch.empty_like(dt)
    dBh = torch.empty((R, S, H, N), dtype=torch.float32, device=xh.device)
    dCh = torch.empty_like(dBh)
    err = _library().ssd_scan_bwd(
        xh.data_ptr(), dt.data_ptr(), Ar.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), states.data_ptr(), dy.data_ptr(), _ptr(h_active),
        dx.data_ptr(), ddt.data_ptr(), du.data_ptr(), dBh.data_ptr(),
        dCh.data_ptr(), R, S, H, P, G, N, chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: CUDA error "
                           f"{err}")
    ssd_scan_bwd.launches += 1
    return dx, ddt, du, dBh, dCh


def ssd_scan_bwd(xh, dt, A, Bm, Cm, states, dy, chunk, *, h_active=None):
    """VJP of ``ssd_scan`` with respect to (xh, dt, A, Bm, Cm): K9
    (``ssd_scan_bwd_raw``), then dA and the group sums in torch. Returns
    (dxh, ddt, dA, dBm, dCm); dA has A's shape."""
    raw = ssd_scan_bwd_raw(xh, dt, A, Bm, Cm, states, dy, chunk,
                           h_active=h_active)
    return _reduce_bwd(raw, xh, dt, A, Bm, Cm)


ssd_scan.launches = 0
# launches per variant of the plan (same increments as ``launches``)
ssd_scan.launches_by_variant = dict.fromkeys(SSD_VARIANTS, 0)
ssd_scan_bwd.launches = 0
