"""Weight bridge between the reference's parameter pytree and the port.

The caller turns the reference pytree into numpy arrays (``np.asarray``
on each leaf — the port never imports JAX); ``params_from_numpy`` then
builds the port's tree of tensors with the same nesting and the same
layouts (dense ``(in, out)``, ``wq`` ``(d, H, hd)``, stacked per-segment
layer weights with a leading ``n_layers`` axis). ``params_to_numpy`` goes
back. fp32 leaves round-trip bit-equal; bf16 leaves travel as fp32, as
they do in the npz manifest format.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dicts / lists / tuples of numpy arrays -> same nesting of
    tensors on ``device`` (the card unless the caller asks for the CPU)."""
    return _from_numpy(tree, resolve_device(device))


def _from_numpy(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_from_numpy(v, device) for v in tree])
    if isinstance(tree, (list, tuple)):
        vals = [_from_numpy(v, device) for v in tree]
        return vals if isinstance(tree, list) else tuple(vals)
    if tree is None:
        return None
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def params_to_numpy(tree: Any) -> Any:
    """The port's tree of tensors -> the same nesting of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[params_to_numpy(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        vals = [params_to_numpy(v) for v in tree]
        return vals if isinstance(tree, list) else tuple(vals)
    if tree is None:
        return None
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
