"""Backend and device resolution shared by the port's entry points.

Backends (the counterpart of the reference's ``kernels/backend.py``):

* ``"cuda"`` — the hand-written Hopper kernels (``repro_torch/csrc``).
  Each kernel wrapper takes its plain PyTorch version only for tensors
  that lie on the CPU; for a CUDA tensor it launches the kernel or raises.
* ``"auto"`` — resolves to ``"cuda"``.
* ``None`` or ``"dense"`` — no kernel table: the dense masked path of
  plain tensor ops (the reference's ``"xla"`` A/B baseline).

No backend name means "the plain versions on a GPU".
"""
from __future__ import annotations

from typing import Optional

import torch

BACKENDS = ("dense", "cuda")


def resolve_backend(backend: Optional[str] = "auto") -> str:
    """'auto' -> 'cuda'; None -> 'dense' (no kernel table)."""
    if backend is None:
        return "dense"
    if backend == "auto":
        return "cuda"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS} or 'auto', "
                         f"got {backend!r}")
    return backend


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.

    ``None`` means ``cuda``; with no CUDA device present that raises — it
    never drops silently to the CPU. Also turns TF32 off for matmuls and
    cuDNN: the port's parity bounds (≤1e-5 per op) hold only in full fp32.
    And it makes cuDNN pick deterministic algorithms, with no autotuning:
    a convolution's backward may otherwise sum with atomics in a varying
    order (the CNN's stem, the dense path's grouped convolutions), and a
    run would not repeat to the bit.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU")
    return dev


def stream_handle(device: torch.device) -> int:
    """The raw handle of the current CUDA stream of ``device``, for a kernel
    launched through ctypes (the cheap form of
    ``torch.cuda.current_stream(device).cuda_stream``: the serving path
    makes hundreds of launches a decode step and is bound by the host)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
