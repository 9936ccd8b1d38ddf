"""Elastic flash attention, forward.

The port of the forward half of the reference's
``kernels/flash_attention.py`` (the dq and dk/dv kernels come with the
training slice). For q (B, Sq, H, D) and k, v (B, Sk, KV, D):
causal and sliding-window masks, the logit softcap, ``scale = 1/sqrt(D)``
by default, the GQA mapping ``kv = h // (H / KV)``, and a per-batch
runtime query-head prefix ``h_active`` ((B,) int32; None = all heads).
Heads at or past the prefix give o = 0 and lse = NEG_INF; rows with no
valid key give o = 0 and lse = NEG_INF. Returns (o, lse), lse (B, H, Sq)
in fp32 (the training slice's backward rebuilds p from it).

``flash_attention`` launches the Hopper kernel
``csrc/flash_attention_fwd.cu`` (see its header for the design and what
bounds it) for CUDA tensors, and takes ``flash_attention_fwd_plain`` only
for tensors on the CPU. Its ``launches`` attribute counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -2.0 ** 30
KERNEL_HEAD_DIMS = (32, 64, 128)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library("flash_attention_fwd")
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_float,
                              ctypes.c_void_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def flash_attention_fwd_plain(q, k, v, h_active=None, *, causal=True,
                              window=None, cap=None, scale=None):
    """The plain PyTorch version of the kernel: full masked softmax
    (written from the reference's ``kernels/ref.py::flash_attention_ref``
    plus the head prefix, fully-masked-row and lse semantics of the
    Pallas forward)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=dev))
    l = p.sum(dim=-1)                                         # (B,H,Sq)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    o = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(l.clamp_min(1e-30)),
                      torch.full((), NEG_INF, device=dev))
    if h_active is not None:
        live = torch.arange(H, device=dev)[None, :] < h_active[:, None]
        o = torch.where(live[:, None, :, None], o, torch.zeros((), device=dev))
        lse = torch.where(live[:, :, None], lse,
                          torch.full((), NEG_INF, device=dev))
    return o.to(q.dtype), lse


def flash_attention(q, k, v, h_active=None, *, causal=True, window=None,
                    cap=None, scale=None):
    """Elastic flash attention forward -> (o, lse). See the module
    docstring for the contract."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q (B,Sq,H,D), k = v (B,Sk,KV,D) required, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    if h_active is not None and (h_active.shape != (B,)
                                 or h_active.dtype != torch.int32
                                 or h_active.device != q.device):
        raise ValueError(f"h_active must be a ({B},) int32 tensor on "
                         f"{q.device}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, h_active, causal=causal,
                                         window=window, cap=cap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("flash_attention kernel takes contiguous fp32 "
                             "tensors on one device")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ha = h_active if h_active is not None else torch.full(
        (B,), H, dtype=torch.int32, device=q.device)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), ha.data_ptr(), B, Sq, Sk, H, KV, D,
        int(bool(causal)), int(window or 0), float(cap or 0.0),
        float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
