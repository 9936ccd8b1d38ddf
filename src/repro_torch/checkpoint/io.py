"""npz pytree checkpoints in the reference's manifest format.

The same on-disk layout as the JAX package's ``checkpoint/io.py``: leaves
are flattened to ``key.path.like.this`` npz entries (tuples and lists by
position), ``None`` leaves are stored as ``<key>#none`` empty arrays, and
bf16 leaves as fp32 under ``<key>#bf16`` (numpy cannot store bf16). A
file written by either package restores in the other.

``save_state`` / ``load_state`` snapshot trees that have no template to
restore into (a fleet checkpoint's in-flight groups, specs, event heap):
a pickle of the tree with every tensor pulled to numpy.
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


def restore_checkpoint(path: str, template: Any, device=None) -> Any:
    """Restore array values into the structure of ``template`` (a tree of
    tensors): each leaf comes back with its template leaf's dtype, on
    ``device`` if given (a ``meta`` template), else on the leaf's."""
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
                device=tree.device if device is None else device,
                dtype=tree.dtype)
        return rebuild(template)



def load_metadata(path: str) -> Dict:
    with open(path + ".meta.json") as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# state snapshots of arbitrary host + device trees (checkpoint.fleet)
# ---------------------------------------------------------------------------
def _to_host(tree: Any) -> Any:
    """Every tensor of ``tree`` as numpy, bit for bit (``.detach().cpu()
    .numpy()``), through dicts, lists and tuples (NamedTuples keep their
    type); every other leaf as it is. The result holds no tensor, so it
    unpickles on a machine without a card."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_to_host(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        vals = [_to_host(v) for v in tree]
        return vals if isinstance(tree, list) else tuple(vals)
    return tree


def _to_device(tree: Any, device) -> Any:
    """Inverse of :func:`_to_host`: every numpy array of ``tree`` as a
    tensor on ``device`` (a copy, bit for bit); every other leaf as it
    is."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_to_device(v, device) for v in tree])
    if isinstance(tree, (list, tuple)):
        vals = [_to_device(v, device) for v in tree]
        return vals if isinstance(tree, list) else tuple(vals)
    return tree


def save_state(path: str, state: Any, metadata: Dict = None) -> None:
    """Snapshot an arbitrary host + device state tree (the fleet runtime's
    event heap, in-flight cohorts, ...) to one pickle file, every tensor
    pulled to numpy first (``_to_host``). The write is atomic: a ``.tmp``
    file, then ``os.replace``. Same-version restore only, like the npz
    manifests."""
    import pickle
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = pickle.dumps(_to_host(state), protocol=pickle.HIGHEST_PROTOCOL)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:        # never a torn file at ``path``
        f.write(blob)
    os.replace(tmp, path)
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2)


def load_state(path: str) -> Any:
    import pickle
    with open(path, "rb") as f:
        return pickle.load(f)
