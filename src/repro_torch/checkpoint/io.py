"""npz pytree checkpoints in the reference's manifest format.

The same on-disk layout as the JAX package's ``checkpoint/io.py``: leaves
are flattened to ``key.path.like.this`` npz entries (tuples and lists by
position), ``None`` leaves are stored as ``<key>#none`` empty arrays, and
bf16 leaves as fp32 under ``<key>#bf16`` (numpy cannot store bf16). A
file written by either package restores in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch


def _leaf_to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix="", out=None) -> Dict[str, np.ndarray]:
    out = out if out is not None else {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    elif tree is None:
        out[prefix[:-1] + "#none"] = np.zeros((0,))
    else:
        is_bf16 = (isinstance(tree, torch.Tensor)
                   and tree.dtype == torch.bfloat16) or \
            getattr(getattr(tree, "dtype", None), "name", "") == "bfloat16"
        key = prefix[:-1] + ("#bf16" if is_bf16 else "")
        arr = _leaf_to_numpy(tree)
        out[key] = arr.astype(np.float32) if is_bf16 else arr
    return out


def save_checkpoint(path: str, tree: Any, metadata: Dict = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2)


def restore_checkpoint(path: str, template: Any) -> Any:
    """Restore array values into the structure of ``template`` (a tree of
    tensors): each leaf comes back with its template leaf's dtype and
    device."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        def rebuild(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: rebuild(v, f"{prefix}{k}.")
                        for k, v in tree.items()}
            if isinstance(tree, tuple) and hasattr(tree, "_fields"):
                return type(tree)(*[rebuild(v, f"{prefix}{i}.")
                                    for i, v in enumerate(tree)])
            if isinstance(tree, (list, tuple)):
                vals = [rebuild(v, f"{prefix}{i}.")
                        for i, v in enumerate(tree)]
                return vals if isinstance(tree, list) else tuple(vals)
            if tree is None:
                return None
            key = prefix[:-1]
            arr = data[key + "#bf16"] if key + "#bf16" in data else data[key]
            return torch.from_numpy(np.array(arr)).to(
                device=tree.device, dtype=tree.dtype)
        return rebuild(template)

