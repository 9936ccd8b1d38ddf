"""Elastic flash attention, forward and backward.

The port of the reference's ``kernels/flash_attention.py``. For
q (B, Sq, H, D) and k, v (B, Sk, KV, D): causal and sliding-window masks,
the logit softcap, ``scale = 1/sqrt(D)`` by default, the GQA mapping
``kv = h // (H / KV)``, and a per-batch runtime query-head prefix
``h_active`` ((B,) int32; None = all heads). Heads at or past the prefix
give o = 0 and lse = NEG_INF; rows with no valid key give o = 0 and
lse = NEG_INF.

Three kernels, each with its plain PyTorch version beside it and a launch
counter on its wrapper:

* ``flash_attention`` (K2, ``csrc/flash_attention_fwd.cu``: 3×TF32
  tensor-core tiles, FlashAttention-2's online softmax) -> (o, lse),
  lse (B, H, Sq) fp32. Differentiable in q, k, v: its backward
  (``flash_attention_bwd``) runs the two kernels below on the saved o and
  lse (the reference reruns the forward in its backward instead; the
  numbers are the same, one launch fewer);
* ``flash_attention_dq`` (K3, ``csrc/flash_attention_bwd.cu``) -> dq;
* ``flash_attention_dkv`` (K4, same source) -> (dk, dv), summed over each
  GQA group onto the KV heads inside the kernel.

K3 and K4 have two variants (``FLASH_BWD_VARIANTS``): ``mma``,
FlashAttention-2's backward on 3×TF32 tensor cores (a block per 64 queries
of a head for dq, per 64 keys of a KV head for dk / dv), and ``simt``, the
first design (fp32 FMAs on 16 × 16 tiles), for rows that are not 16-byte
aligned. ``flash_bwd_plan`` picks the variant and its tiles from the
shapes and the alignment alone, never from the prefixes;
``launches_by_variant`` on each wrapper counts its launches by variant.

The backward kernels take ``delta = rowsum(do · o)`` ((B, H, Sq), a plain
torch op as in the reference). Each wrapper launches its kernel for CUDA
tensors (see the sources' headers for the designs and what bounds them)
and takes its plain version only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import stream_handle

NEG_INF = -2.0 ** 30
KERNEL_HEAD_DIMS = (32, 64, 80, 128, 256)
# K2's query rows a block and keys a step (csrc/flash_attention_fwd.cu)
FWD_TILE = (64, 32)
# K3 / K4's variants (csrc/flash_attention_bwd.cu), in the order of the C
# entry points' ``variant`` argument
FLASH_BWD_VARIANTS = ("simt", "mma")
# row stride of every shared tile of the mma variant: D + 4 floats
BWD_ROW_PAD = 4


class FlashBwdPlan(NamedTuple):
    variant: str
    dq_tile: Tuple[int, int]    # K3: (queries a block, keys a step)
    dkv_tile: Tuple[int, int]   # K4: (keys a block, queries a step)


_SIMT_PLAN = FlashBwdPlan("simt", (16, 16), (16, 16))


@functools.lru_cache(maxsize=None)
def flash_bwd_plan(B: int, Sq: int, Sk: int, H: int, KV: int, D: int,
                   aligned: bool) -> FlashBwdPlan:
    """K3's and K4's launch from the shapes and the operands' 16-byte
    alignment alone — never from ``h_active``. The mma variant takes every
    head dim of ``KERNEL_HEAD_DIMS`` and any sequence lengths: a dq block
    of 64 queries stepping over 32-key blocks, a dk / dv block of 64 keys
    stepping over 16-query blocks (on an H100, 16 ran at or under 32 at
    both training shapes); at D = 256 one block of either takes an SM
    (``bwd_shared_bytes``) and K4 sums dK / dV in two passes over half of
    D each. Rows that are not 16-byte aligned (its cp.async copies need
    them) run the simt variant's 16 × 16 tiles. D = 80 (hubert-xlarge)
    takes the tiles of D ≤ 64, two blocks of each kernel an SM."""
    if not aligned or D not in KERNEL_HEAD_DIMS:
        return _SIMT_PLAN
    return FlashBwdPlan("mma", (64, 32), (64, 16))


def bwd_shared_bytes(plan: FlashBwdPlan, D: int) -> Tuple[int, int]:
    """Dynamic shared memory of one K3 and one K4 block of an mma plan
    (csrc/flash_attention_bwd.cu, ``DqTiles`` / ``DkvTiles``): K3 holds
    Q and dO once, one or two K / V buffers (two at D ≤ 80) and the
    exchange tile of its warp pairs; K4 holds K and V once, a two-deep ring
    of Q, dO, lse and delta, and the exchange tile. Tiles are rows of
    D + 4 floats; an exchange row is the step's keys or queries + 8."""
    S = D + BWD_ROW_PAD
    (bq, bk), (kb, qb) = plan.dq_tile, plan.dkv_tile
    dq_bufs = 1 if D >= 128 else 2
    return (4 * (2 * bq * S + 2 * dq_bufs * bk * S + bq * (bk + 8)),
            4 * (2 * kb * S + 2 * (2 * qb * S + 2 * qb) + kb * (qb + 8)))


def fwd_shared_bytes(D: int) -> int:
    """Dynamic shared memory of one K2 block (csrc/flash_attention_fwd.cu,
    ``Smem``): the 64-query Q tile once and one (D ≥ 128) or two K / V
    buffers of 32 keys; Q and K rows of D + 8 floats, V rows of D + 4."""
    bq, bk = FWD_TILE
    bufs = 1 if D >= 128 else 2
    return 4 * (bq * (D + 8) + bufs * bk * (2 * D + 12))


def bwd_launch_plan(q, k, v, do) -> FlashBwdPlan:
    """The ``FlashBwdPlan`` of contiguous CUDA operands."""
    B, Sq, H, D = q.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, do))
    return flash_bwd_plan(B, Sq, k.shape[1], H, k.shape[2], D, aligned)


def _library() -> ctypes.CDLL:
    """The loaded library: the counted build inside ``build.counting()``,
    else the fast one."""
    return _library_bound(build.counting_active())


@functools.lru_cache(maxsize=None)
def _library_bound(counted: bool) -> ctypes.CDLL:
    lib = build.library("flash_attention_fwd", counted)
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_float,
                              ctypes.c_void_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _bwd_library() -> ctypes.CDLL:
    """The loaded library: the counted build inside ``build.counting()``,
    else the fast one."""
    return _bwd_library_bound(build.counting_active())


@functools.lru_cache(maxsize=None)
def _bwd_library_bound(counted: bool) -> ctypes.CDLL:
    lib = build.library("flash_attention_bwd", counted)
    lib.flash_attention_dq.argtypes = [ctypes.c_void_p] * 8 + \
        [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                              ctypes.c_void_p]
    lib.flash_attention_dq.restype = ctypes.c_int
    lib.flash_attention_dkv.argtypes = [ctypes.c_void_p] * 9 + \
        [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                              ctypes.c_void_p]
    lib.flash_attention_dkv.restype = ctypes.c_int
    return lib


def _acc(t):
    """t in fp32, or in fp64 when it is fp64 (the gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scores(q, k, causal, window, cap, scale):
    """(s, mask, dcap): the (B, H, Sq, Sk) scores after scale and softcap
    with KV repeated to H, the validity mask, and the softcap derivative
    (None without a cap) — the reference's ``_masked_scores``."""
    Sq, Sk = q.shape[1], k.shape[1]
    G = q.shape[2] // k.shape[2]
    dev = q.device
    kf = _acc(k).repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", _acc(q), kf) * scale
    dcap = None
    if cap is not None:
        t = torch.tanh(s / cap)
        s = cap * t
        dcap = 1.0 - t * t
    qpos = torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    return s, mask, dcap


def _live_heads(h_active, B, H, device):
    """(B, H) bool: heads below each row's prefix."""
    if h_active is None:
        return torch.ones((B, H), dtype=torch.bool, device=device)
    return torch.arange(H, device=device)[None, :] < h_active[:, None]


def flash_attention_fwd_plain(q, k, v, h_active=None, *, causal=True,
                              window=None, cap=None, scale=None):
    """The plain PyTorch version of the forward kernel: full masked softmax
    (written from the reference's ``kernels/ref.py::flash_attention_ref``
    plus the head prefix, fully-masked-row and lse semantics of the
    Pallas forward)."""
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    vf = _acc(v).repeat_interleave(G, dim=2)
    s, mask, _ = _scores(q, k, causal, window, cap, scale)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=dev))
    l = p.sum(dim=-1)                                         # (B,H,Sq)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    o = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(l.clamp_min(1e-30)),
                      torch.full((), NEG_INF, device=dev))
    if h_active is not None:
        live = _live_heads(h_active, B, H, dev)
        o = torch.where(live[:, None, :, None], o, torch.zeros((), device=dev))
        lse = torch.where(live[:, :, None], lse,
                          torch.full((), NEG_INF, device=dev))
    return o.to(q.dtype), lse


def _bwd_plain(q, k, v, do, lse, delta, h_active, causal, window, cap,
               scale):
    """(p, ds), (B, H, Sq, Sk) with KV repeated to H, rebuilt from lse as
    the reference's ``_bwd_tile``; zero on masked pairs, rows with lse =
    NEG_INF and heads past the prefix."""
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    dev = q.device
    s, mask, dcap = _scores(q, k, causal, window, cap, scale)
    live = mask & (lse > NEG_INF * 0.5)[..., None] \
        & _live_heads(h_active, B, H, dev)[:, :, None, None]
    p = torch.where(live, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=dev))
    vf = _acc(v).repeat_interleave(G, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", _acc(do), vf)
    ds = p * (dp - delta[..., None])
    if dcap is not None:
        ds = ds * dcap
    return p, ds * scale


def flash_attention_dq_plain(q, k, v, do, lse, delta, h_active=None, *,
                             causal=True, window=None, cap=None,
                             scale=None):
    """The plain PyTorch version of the dq kernel: ``dq = ds k`` from the
    explicit formulas of the reference's ``_dq_kernel``."""
    D = q.shape[-1]
    G = q.shape[2] // k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    _, ds = _bwd_plain(q, k, v, do, lse, delta, h_active, causal, window,
                       cap, scale)
    kf = _acc(k).repeat_interleave(G, dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, h_active=None, *,
                              causal=True, window=None, cap=None,
                              scale=None):
    """The plain PyTorch version of the dk/dv kernel: ``dk = dsᵀ q`` and
    ``dv = pᵀ do`` per query head (the reference's ``_dkv_kernel``), then
    summed over each GQA group onto its KV head."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    p, ds = _bwd_plain(q, k, v, do, lse, delta, h_active, causal, window,
                       cap, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, _acc(q))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, _acc(do))
    dk = dk.reshape(B, Sk, KV, H // KV, D).sum(3)
    dv = dv.reshape(B, Sk, KV, H // KV, D).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, h_active):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q (B,Sq,H,D), k = v (B,Sk,KV,D) required, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    if h_active is not None and (h_active.shape != (B,)
                                 or h_active.dtype != torch.int32
                                 or h_active.device != q.device):
        raise ValueError(f"h_active must be a ({B},) int32 tensor on "
                         f"{q.device}")


def _check_kernel_args(name, tensors, D):
    """Device, dtype and contiguity checks of a kernel launch; returns the
    stream to launch on."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous fp32 tensors "
                             f"on one device")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} kernel supports head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    return stream_handle(dev)


@functools.lru_cache(maxsize=64)
def _all_heads(B, H, device):
    """A (B,) prefix of all H heads, made once per shape and device: the
    kernels only read it, and a fill per call costs a launch on the
    host-bound serving path."""
    return torch.full((B,), H, dtype=torch.int32, device=device)


def _full_heads(h_active, B, H, device):
    return h_active if h_active is not None else _all_heads(B, H, device)


def _fwd(q, k, v, h_active, causal, window, cap, scale):
    """The forward: K2 for CUDA tensors, its plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, h_active, causal=causal,
                                         window=window, cap=cap, scale=scale)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    stream = _check_kernel_args("flash_attention", (q, k, v), D)
    # the kernel's 16-byte cp.async copies need 16-byte-aligned rows: a
    # contiguous view that starts off them is copied to a fresh tensor
    ptrs = [t.data_ptr() for t in (q, k, v)]
    if any(p % 16 for p in ptrs):
        q, k, v = (t.clone() if p % 16 else t for t, p in zip((q, k, v),
                                                               ptrs))
        ptrs = [t.data_ptr() for t in (q, k, v)]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ha = _full_heads(h_active, B, H, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = _library().flash_attention_fwd(
        *ptrs, o.data_ptr(), lse.data_ptr(), ha.data_ptr(), B, Sq, Sk, H,
        KV, D, int(bool(causal)), int(window or 0), float(cap or 0.0),
        float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return o, lse


def _bwd_plan(q, k, v, do, variant):
    """The plan of a K3 / K4 launch: the operands' own, or with
    ``variant="simt"`` the simt variant's (for measurement and tests);
    ``variant="mma"`` raises where the operands cannot take it."""
    plan = bwd_launch_plan(q, k, v, do)
    if variant is None or variant == plan.variant:
        return plan
    if variant == "simt":
        return _SIMT_PLAN
    raise ValueError(f"flash backward variant {variant!r} cannot run on "
                     f"these operands (plan {plan.variant!r}; variants "
                     f"{FLASH_BWD_VARIANTS})")


def flash_attention_dq(q, k, v, do, lse, delta, h_active=None, *,
                       causal=True, window=None, cap=None, scale=None,
                       variant: Optional[str] = None):
    """dq of elastic flash attention (K3): q, do (B, Sq, H, D), k, v
    (B, Sk, KV, D), lse and delta (B, H, Sq) fp32 -> dq (B, Sq, H, D).
    ``variant`` (CUDA tensors only): None for the plan's, or one of
    ``FLASH_BWD_VARIANTS``."""
    _check(q, k, v, h_active)
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, do, lse, delta, h_active,
                                        causal=causal, window=window,
                                        cap=cap, scale=scale)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    stream = _check_kernel_args("flash_attention_dq",
                                (q, k, v, do, lse, delta), D)
    plan = _bwd_plan(q, k, v, do, variant)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ha = _full_heads(h_active, B, H, q.device)
    dq = torch.empty_like(q)
    err = _bwd_library().flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), ha.data_ptr(), B,
        Sq, Sk, H, KV, D, int(bool(causal)), int(window or 0),
        float(cap or 0.0), float(scale),
        FLASH_BWD_VARIANTS.index(plan.variant), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_dq kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_dq.launches_by_variant[plan.variant] += 1
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, h_active=None, *,
                        causal=True, window=None, cap=None, scale=None,
                        variant: Optional[str] = None):
    """dk, dv of elastic flash attention (K4), each (B, Sk, KV, D): the
    query heads of a GQA group summed onto their KV head. ``variant`` as
    for ``flash_attention_dq``."""
    _check(q, k, v, h_active)
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(q, k, v, do, lse, delta, h_active,
                                         causal=causal, window=window,
                                         cap=cap, scale=scale)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    stream = _check_kernel_args("flash_attention_dkv",
                                (q, k, v, do, lse, delta), D)
    plan = _bwd_plan(q, k, v, do, variant)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ha = _full_heads(h_active, B, H, q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _bwd_library().flash_attention_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ha.data_ptr(), B, Sq, Sk, H, KV, D, int(bool(causal)),
        int(window or 0), float(cap or 0.0), float(scale),
        FLASH_BWD_VARIANTS.index(plan.variant), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_dkv kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_dkv.launches_by_variant[plan.variant] += 1
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, h_active=None, *, causal=True,
                        window=None, cap=None, scale=None):
    """(dq, dk, dv) of ``flash_attention`` from its saved o and lse and the
    output cotangent ``do``: delta = rowsum(do · o) (a plain torch op),
    then K3 and K4."""
    do = do.contiguous()
    # a product and a sum: einsum lowers the rowsum to a batched dot,
    # which ran ~3× slower on an H100
    delta = (_acc(do) * _acc(o)).sum(-1).transpose(1, 2).contiguous()
    opts = dict(causal=causal, window=window, cap=cap, scale=scale)
    dq = flash_attention_dq(q, k, v, do, lse, delta, h_active, **opts)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, h_active, **opts)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """K2 forward; the backward launches K3 and K4 on the saved o and lse
    (the reference's ``_make_flash`` reruns the forward instead)."""

    @staticmethod
    def forward(ctx, q, k, v, h_active, causal, window, cap, scale):
        o, lse = _fwd(q, k, v, h_active, causal, window, cap, scale)
        ctx.save_for_backward(q, k, v, o, lse, h_active)
        ctx.opts = dict(causal=causal, window=window, cap=cap, scale=scale)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, h_active = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, h_active,
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, h_active=None, *, causal=True, window=None,
                    cap=None, scale=None):
    """Elastic flash attention forward -> (o, lse); differentiable in q, k
    and v through K3 and K4. See the module docstring for the contract."""
    _check(q, k, v, h_active)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, h_active, causal, window, cap, scale)
    return _fwd(q, k, v, h_active, causal, window, cap, scale)


flash_attention.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0
# launches per variant of the plan (same increments as ``launches``)
flash_attention_dq.launches_by_variant = dict.fromkeys(FLASH_BWD_VARIANTS, 0)
flash_attention_dkv.launches_by_variant = dict.fromkeys(FLASH_BWD_VARIANTS,
                                                        0)
