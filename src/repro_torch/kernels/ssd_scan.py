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
  transposed scan. The kernel (``ssd_scan_bwd_raw``) emits dx, ddt, du
  (the cotangent of u = dt·A), dB / dC per group and, in fp64, each
  (row, head, chunk)'s partial ``Σ_s du·dt``; ``dA`` sums those partials
  in fp64 and rounds once (``_reduce_bwd``). The sum cancels: at mamba2's
  widths on
  the reference bench's inputs its terms are ~1e3 times its total, and
  fp32 row and column sums of DL (the decay-weighted dG∘CB of the chunk)
  inside du carry ~1e-5 into it, so the partials come from a du formed in
  fp64 from fp64 sums of DL; du itself keeps its fp32 sums.
  ``ssd_bwd_plan`` picks its variant from the shapes
  (``SSD_BWD_VARIANTS``: ``mma``, the chunks in parallel on 3×TF32 tensor
  cores after a short pass that carries the state cotangent across them,
  dB / dC summed over each group's heads inside the kernel by head slices
  whose partials are summed in a fixed order; ``simt``, the first design,
  a block per (row, head) walking the chunks in reverse, whose per-head
  dB / dC the wrapper sums over each group) and the head slice;
  ``ssd_scan_bwd.launches_by_variant`` counts launches by variant.

``ssd_scan_plain`` (chunk by chunk) and ``ssd_scan_bwd_raw_plain`` (the
algebra of the reference's ``_bwd_kernel``, chunks in reverse; not
autograd of the forward; ``ssd_scan_bwd_plain`` adds dA) are
the plain versions: each wrapper takes them
only for tensors on the CPU, and for CUDA tensors launches its kernel or
raises. ``ssd_scan.launches`` and ``ssd_scan_bwd.launches`` count kernel
launches. The differentiable op over both is ``kernels.dispatch.ssd_op``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import stream_handle

KERNEL_HEAD_DIMS = (32, 64)
KERNEL_MAX_STATE = 128
# K8's variants (csrc/ssd_scan.cu::ssd_scan_fwd)
SSD_VARIANTS = ("simt", "mma")
MMA_MAX_CHUNK = 256      # 16 query tiles of 16: two per warp
CB_TILE = 64             # C·Bᵀ tiles; the buffer's rows are padded to it
SIMT_TILE = 64           # rows of the simt variants' query and key tiles
# K9's variants (csrc/ssd_scan.cu::ssd_scan_bwd)
SSD_BWD_VARIANTS = ("simt", "mma")
BWD_TILE = 64            # queries or keys of a K9 tile block
BWD_STEP = 32            # keys or queries of a tile block's ring stage
# tile blocks per SM the head slice aims at (two fit an SM at once): on an
# H100 at the training slice, narrower slices evened out the causal and
# the head-prefix imbalance and ran faster down to 5 heads, while each
# slice adds a partial of dB and of dC
BWD_BLOCKS_PER_SM = 8


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


class SsdBwdPlan(NamedTuple):
    variant: str
    head_slice: int      # heads of a group a tile block sums (H for simt)


@functools.lru_cache(maxsize=None)
def ssd_bwd_plan(R: int, H: int, P: int, N: int, Q: int, aligned: bool,
                 sms: int) -> SsdBwdPlan:
    """K9's launch from the shapes, the operands' 16-byte alignment and the
    card's SM count alone — never from ``h_active``. The mma variant's
    tile kernels run a block per (64-row tile, row, chunk, head slice of a
    group); the slice is cut for about ``BWD_BLOCKS_PER_SM`` blocks per SM
    counting one chunk and one group (more chunks and groups only add
    blocks), and each further slice costs a (R, S, G, N) partial of dB and
    of dC. Shapes it does not take (d_state not a multiple of 8
    or above 128, a chunk above 256, unaligned rows) run the simt
    variant."""
    if not aligned or N % 8 or N > KERNEL_MAX_STATE or Q > MMA_MAX_CHUNK:
        return SsdBwdPlan("simt", H)
    tiles = -(-Q // BWD_TILE)
    slices = min(H, -(-BWD_BLOCKS_PER_SM * sms // (R * tiles)))
    return SsdBwdPlan("mma", -(-H // slices))


def bwd_slices(plan: SsdBwdPlan, H, G):
    """Head slices of each group under an mma plan (1: no partials)."""
    return -(-(H // G) // plan.head_slice)


def bwd_shared_bytes(P, N, Q):
    """Shared memory of one block of K9's tile kernels
    (``mma_tile_floats`` in the source): a 64-row tile of P and one of N
    (rows padded by 4 and 8), a two-deep ring of 32-row stages of P and N
    (rows padded by 4) and two chunk vectors."""
    qp = -(-Q // CB_TILE) * CB_TILE
    return 4 * (BWD_TILE * (P + 4) + BWD_TILE * (N + 8)
                + 2 * BWD_STEP * (P + 4 + N + 4) + 2 * qp)


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


def _library() -> ctypes.CDLL:
    """The loaded library: the counted build inside ``build.counting()``,
    else the fast one."""
    return _library_bound(build.counting_active())


@functools.lru_cache(maxsize=None)
def _library_bound(counted: bool) -> ctypes.CDLL:
    lib = build.library("ssd_scan", counted)
    lib.ssd_scan_fwd.argtypes = [ctypes.c_void_p] * 10 + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_bwd.argtypes = [ctypes.c_void_p] * 21 + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.ssd_scan_bwd.restype = ctypes.c_int
    return lib


def chunk_cumsum(u, dim):
    """Cumulative sum of the fp32 tensor ``u`` along ``dim``, accumulated in
    fp64 and rounded to fp32 once — what the kernels compute in index
    order (and what ``torch.cumsum`` of fp32 gives on the CPU)."""
    return torch.cumsum(u.double(), dim).float()


def row_A(A, R, dtype=torch.float32):
    """A (H,) or (R, H) -> (R, H) fp32 (or ``dtype``)."""
    A = A.to(dtype)
    return A.expand(R, A.shape[-1]) if A.dim() == 1 else A


def _live(h_active, R, H, device):
    """(R, H) bool: heads below each row's prefix."""
    if h_active is None:
        return torch.ones((R, H), dtype=torch.bool, device=device)
    return torch.arange(H, device=device)[None, :] < h_active[:, None]


def _heads(t, rep, dtype=torch.float32):
    """(R, S, G, N) -> (R, S, H, N): each group repeated over its heads."""
    return t.to(dtype).repeat_interleave(rep, dim=2)


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
    acc = torch.promote_types(xh.dtype, torch.float32)  # fp64 runs in fp64
    A = row_A(A, R, acc)
    x, dtf = xh.to(acc), dt.to(acc)
    Bh, Ch = _heads(Bm, rep, acc), _heads(Cm, rep, acc)
    h = torch.zeros((R, H, P, N), dtype=acc, device=xh.device)
    ys, states = [], []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        dtc, Bc, Cc = dtf[:, sl], Bh[:, sl], Ch[:, sl]
        # dt·A and cum rounded to fp32 as the kernels round them, also in
        # an fp64 run (whose other sums then carry no fp32 rounding)
        cum = chunk_cumsum(dtc.float() * A[:, None, :].float(), 1).to(acc)
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
    zero = torch.zeros((), dtype=acc, device=xh.device)
    y = torch.where(live[:, None, :, None], torch.cat(ys, 1), zero)
    if not return_states:
        return y.to(xh.dtype)
    st = torch.where(live[:, None, :, None, None], torch.stack(states, 1),
                     zero)
    return y.to(xh.dtype), st


def ssd_scan_bwd_raw_plain(xh, dt, A, Bm, Cm, states, dy, chunk,
                           h_active=None):
    """The plain PyTorch version of K9's own outputs (dx, ddt, du, dB / dC
    per group, and the fp64 partials ``Σ_s du·dt`` per (row, head, chunk),
    (R, H, S/chunk)): a transcription of the reference's ``_bwd_kernel``,
    chunks in reverse carrying the state cotangent, then dB / dC summed
    over each group's heads."""
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
    dap = torch.zeros((R, H, nc), dtype=torch.float64, device=xh.device)
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
        # dA's partial: du again in fp64, from DL's sums in fp64
        e64 = (DL.sum(2, dtype=torch.float64)
               - DL.sum(1, dtype=torch.float64)) \
            + ((dyc * CH).sum(-1) * e).double() - (Tt * w_end).double()
        du64 = (e64.sum(1, keepdim=True) + last[:, None]) \
            - torch.cumsum(e64, 1) + e64
        dap[:, :, c] = (du64 * dtc.double()).sum(1)
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
            torch.where(m3, du, zero), group_sum(torch.where(m4, dB, zero), G),
            group_sum(torch.where(m4, dC, zero), G),
            torch.where(live[..., None], dap, zero.double()))


def group_sum(t, G):
    """(R, S, H, N) per head -> (R, S, G, N): each group's heads summed."""
    R, S, H, N = t.shape
    return t.reshape(R, S, G, H // G, N).sum(3)


def ssd_scan_bwd_plain(xh, dt, A, Bm, Cm, states, dy, chunk, h_active=None):
    """The plain version of ``ssd_scan_bwd``."""
    return _reduce_bwd(ssd_scan_bwd_raw_plain(xh, dt, A, Bm, Cm, states, dy,
                                              chunk, h_active),
                       xh, dt, A, Bm, Cm)


def _reduce_bwd(raw, xh, dt, A, Bm, Cm):
    """K9's outputs -> (dx, ddt, dA, dB, dC): dA = Σ_s du·dt per row
    ((R, H), or (H,) for a shared A), summed from the fp64 partials over
    the chunks (and rows) in fp64 and rounded once, and each output in its
    input's dtype."""
    dx, ddt, _, dB, dC, dap = raw
    dA = dap.sum(-1)
    if A.dim() == 1:
        dA = dA.sum(0)
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
    return stream_handle(dev)


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


def bwd_launch_plan(xh, Bm, Cm, states, dy, chunk) -> SsdBwdPlan:
    """K9's ``SsdBwdPlan`` for contiguous CUDA operands: 16-byte-aligned
    rows (d_state a multiple of 4) and base addresses."""
    R, S, H, P = xh.shape
    N = Bm.shape[3]
    aligned = N % 4 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (xh, Bm, Cm, states, dy))
    return ssd_bwd_plan(R, H, P, N, chunk, aligned, _sms(xh.device.index))


def _bwd_plan(xh, Bm, Cm, states, dy, chunk, variant):
    """The plan of a K9 launch: the operands' own, or with
    ``variant="simt"`` the simt variant's (for measurement and tests);
    ``variant="mma"`` raises where the operands cannot take it."""
    plan = bwd_launch_plan(xh, Bm, Cm, states, dy, chunk)
    if variant is None or variant == plan.variant:
        return plan
    if variant == "simt":
        return SsdBwdPlan("simt", xh.shape[2])
    raise ValueError(f"ssd_scan_bwd variant {variant!r} cannot run on "
                     f"these operands (plan {plan.variant!r}; variants "
                     f"{SSD_BWD_VARIANTS})")


def ssd_scan_bwd_raw(xh, dt, A, Bm, Cm, states, dy, chunk, *,
                     h_active=None, variant: Optional[str] = None):
    """K9's own outputs: dx (R, S, H, P), ddt and du (R, S, H), dB / dC
    per group (R, S, G, N), and the fp64 partials of dA, Σ_s du·dt per
    (row, head, chunk), (R, H, S/chunk). ``states``: the per-chunk initial states of
    ``ssd_scan(..., return_states=True)``; ``dy`` the output cotangent.
    Heads past the row's prefix get exactly-zero cotangents and add
    nothing to their group's dB / dC. ``variant`` (CUDA tensors only):
    None for the plan's, or one of ``SSD_BWD_VARIANTS``. The launch counts
    on ``ssd_scan_bwd.launches`` (one per call, though the mma variant
    runs six or seven kernels)."""
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
    plan = _bwd_plan(xh, Bm, Cm, states, dy, chunk, variant)
    dev, f32 = xh.device, torch.float32
    dx = torch.empty_like(xh)
    ddt = torch.empty_like(dt)
    du = torch.empty_like(dt)
    nc = S // chunk
    dap = torch.empty((R, H, nc), dtype=torch.float64, device=dev)
    scratch = dict(cum=None, cb=None, dhs=None, dhh=None, vecs=None,
                   vecs64=None, parts=None)
    if plan.variant == "simt":       # per head, summed over groups below
        dB = torch.empty((R, S, H, N), dtype=f32, device=dev)
        dC = torch.empty_like(dB)
    else:
        dB = torch.empty((R, S, G, N), dtype=f32, device=dev)
        dC = torch.empty_like(dB)
        qp = -(-chunk // CB_TILE) * CB_TILE
        ns = bwd_slices(plan, H, G)
        scratch = dict(
            cum=torch.empty((R, H, S), dtype=f32, device=dev),
            cb=torch.empty((R, G, nc, qp, qp), dtype=f32, device=dev),
            dhs=torch.empty((R, nc - 1, H, P, N), dtype=f32, device=dev)
            if nc > 1 else None,
            dhh=torch.empty((R, H, nc, P // 32), dtype=torch.float64,
                            device=dev),
            vecs=torch.empty((4, R, H, S), dtype=f32, device=dev),
            vecs64=torch.empty((2, R, H, S), dtype=torch.float64,
                               device=dev),
            parts=torch.empty((2, ns, R, S, G, N), dtype=f32, device=dev)
            if ns > 1 else None)
    err = _library().ssd_scan_bwd(
        xh.data_ptr(), dt.data_ptr(), Ar.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), states.data_ptr(), dy.data_ptr(), _ptr(h_active),
        dx.data_ptr(), ddt.data_ptr(), du.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), dap.data_ptr(), *(_ptr(scratch[k]) for k in
                         ("cum", "cb", "dhs", "dhh", "vecs", "vecs64",
                          "parts")),
        R, S, H, P, G, N, chunk, SSD_BWD_VARIANTS.index(plan.variant),
        plan.head_slice, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: CUDA error "
                           f"{err}")
    ssd_scan_bwd.launches_by_variant[plan.variant] += 1
    ssd_scan_bwd.launches += 1
    if plan.variant == "simt":
        dB, dC = group_sum(dB, G), group_sum(dC, G)
    return dx, ddt, du, dB, dC, dap


def ssd_scan_bwd(xh, dt, A, Bm, Cm, states, dy, chunk, *, h_active=None,
                 variant: Optional[str] = None):
    """VJP of ``ssd_scan`` with respect to (xh, dt, A, Bm, Cm): K9
    (``ssd_scan_bwd_raw``, in ``variant``), then dA in torch. Returns (dxh,
    ddt, dA, dBm, dCm); dA has A's shape."""
    raw = ssd_scan_bwd_raw(xh, dt, A, Bm, Cm, states, dy, chunk,
                           h_active=h_active, variant=variant)
    return _reduce_bwd(raw, xh, dt, A, Bm, Cm)


ssd_scan.launches = 0
# launches per variant of the plan (same increments as ``launches``)
ssd_scan.launches_by_variant = dict.fromkeys(SSD_VARIANTS, 0)
ssd_scan_bwd.launches = 0
ssd_scan_bwd.launches_by_variant = dict.fromkeys(SSD_BWD_VARIANTS, 0)
