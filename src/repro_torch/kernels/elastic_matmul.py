"""Elastic dense layer: submodel compute that is *skipped*, not zeroed.

The port of the reference's ``kernels/elastic_matmul.py`` forward (the
closed VJP comes with the training slice). For an input x of shape
(G, M, K), a shared weight w (K, N) and an optional bias (N,),

    y[g] = R_m · C_n · act((x[g] ⊙ [k < k_active[g]]) @ w + b)

with per-group runtime prefixes read from (G,) int32 tensors (None means
the full extent). The explicit group axis is the slot axis the reference
gets from ``vmap`` (``kernels/dispatch.py``): decode passes G = slots and
M = 1 — every slot a different submodel in one launch — and prefill G = 1,
M = prompt length. ``act`` is one of None, "silu", "gelu" (tanh
approximation), "relu".

``elastic_dense`` launches the Hopper kernel ``csrc/elastic_dense.cu``
(see its header for the design and what bounds it) for CUDA tensors, and
takes ``elastic_dense_plain`` only for tensors on the CPU. Its
``launches`` attribute counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import ACTIVATIONS

ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "relu": 3}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library("elastic_dense")
    lib.edense_plan.argtypes = [ctypes.c_int] * 5 + \
        [ctypes.POINTER(ctypes.c_int)]
    lib.edense_plan.restype = ctypes.c_int
    lib.edense_forward.argtypes = [ctypes.c_void_p] * 8 + \
        [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.edense_forward.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _plan(G: int, M: int, K: int, N: int, device_index: int):
    """(splits, kchunk) of a launch: from the shapes and the card's SM
    count only, never from the prefixes, so a change of submodel never
    changes the launch."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    kchunk = ctypes.c_int(0)
    splits = _library().edense_plan(G, M, K, N, sms, ctypes.byref(kchunk))
    return splits, kchunk.value


def _check_prefix(name, t, G, device):
    if t is None:
        return
    if t.shape != (G,) or t.dtype != torch.int32 or t.device != device:
        raise ValueError(f"{name} must be a ({G},) int32 tensor on {device},"
                         f" got {tuple(t.shape)} {t.dtype} on {t.device}")


def elastic_dense_plain(x, w, bias=None, *, k_active=None, n_active=None,
                        m_active=None, act=None):
    """The plain PyTorch version of the kernel (written from the reference's
    ``kernels/ref.py::elastic_dense_ref`` plus per-group prefixes)."""
    G, M, K = x.shape
    N = w.shape[-1]
    dev = x.device
    if k_active is not None:
        keep = torch.arange(K, device=dev)[None, :] < k_active[:, None]
        x = x * keep[:, None, :].to(x.dtype)
    y = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
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


def elastic_dense(x, w, bias=None, *, k_active=None, n_active=None,
                  m_active=None, act=None):
    """Tile-skipping elastic dense layer (see the module docstring).

    x: (G, M, K); w: (K, N); bias: (N,) or None; k_active / n_active /
    m_active: (G,) int32 tensors or None. Returns (G, M, N) in x's dtype.
    """
    if act not in ACT_CODES:
        raise ValueError(f"act must be one of {list(ACT_CODES)}, got {act!r}")
    if x.dim() != 3 or w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"x (G,M,K) and w (K,N) required, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    G, M, K = x.shape
    N = w.shape[1]
    if bias is not None and bias.shape != (N,):
        raise ValueError(f"bias must be ({N},), got {tuple(bias.shape)}")
    for name, t in (("k_active", k_active), ("n_active", n_active),
                    ("m_active", m_active)):
        _check_prefix(name, t, G, x.device)
    if x.device.type == "cpu":
        return elastic_dense_plain(x, w, bias, k_active=k_active,
                                   n_active=n_active, m_active=m_active,
                                   act=act)
    if x.device.type != "cuda":
        raise ValueError(f"elastic_dense runs on cpu or cuda, not {x.device}")
    tensors = [x, w] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("elastic_dense kernel takes contiguous fp32 "
                             "tensors on one device")
    splits, kchunk = _plan(G, M, K, N, x.device.index)
    y = torch.empty((G, M, N), dtype=x.dtype, device=x.device)
    partial = torch.empty((splits, G * M, N), dtype=torch.float32,
                          device=x.device) if splits > 1 else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().edense_forward(
        x.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        *[None if t is None else t.data_ptr()      # None = full extent
          for t in (k_active, n_active, m_active)],
        G, M, K, N, splits, kchunk, ACT_CODES[act], stream)
    if err != 0:
        raise RuntimeError(f"elastic_dense kernel launch failed: CUDA error "
                           f"{err}")
    elastic_dense.launches += 1
    return y


elastic_dense.launches = 0
