"""Sharding rules for every architecture family — the port of the
reference's ``sharding/specs.py``, rule for rule, under its names.

Baseline layout, as the reference's:

* tensor parallel over ``model``: attention heads, d_ff, MoE experts,
  SSD d_inner / heads, vocab (embedding + lm head);
* data parallel over ``data``: batch;
* KV-head tensors replicate over ``model`` when n_kv does not divide it;
* decode caches: sequence dim over ``data`` when the batch cannot use it
  (long context), else batch over ``data`` and heads over ``model``.

A :class:`Spec` is a tuple with one entry per dim of the leaf: None
(replicated), ``"model"``, or a tuple of batch axes (``batch_axes``) — the
entries of the reference's ``PartitionSpec`` written out to the leaf's
rank. Trees are walked by key path as ``tree_map_with_path`` walks them:
dict keys, list / tuple indices, NamedTuple field names. A leaf is
anything with a ``.shape`` (tensors, numpy arrays, ``meta`` tensors), or
a ``Spec``.

``shard_params`` turns a whole parameter tree into this rank's block of
it (``HostMesh.block``: blocks of ``ceil(n / m)``, the port's counterpart
of GSPMD's padding; an SSD block holds whole heads). The ZeRO-1
``opt_state_shardings`` waits for the sharded train step.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.mesh import _div


class Spec(tuple):
    """One leaf's placement, an entry per dim (a tree leaf, not a
    container)."""

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def _axis_size(mesh, name) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def param_spec(cfg: ModelConfig, mesh, path: Tuple[str, ...], leaf) -> Spec:
    """Sharding rule for one param leaf; ``path`` is the key path
    strings."""
    m = _axis_size(mesh, "model")
    name = path[-1]
    joined = "/".join(path)
    shp = tuple(leaf.shape)
    rep = Spec((None,) * len(shp))

    def msh(axis: int) -> Spec:
        """Shard ``axis`` over 'model' if divisible, else replicate."""
        if _div(shp[axis], m):
            spec = [None] * len(shp)
            spec[axis] = "model"
            return Spec(spec)
        return rep

    # embeddings / unembedding: vocab over model
    if "embed" in path and name == "table":
        return msh(0)
    if "lm_head" in path:
        return msh(len(shp) - 1)

    # attention
    if "attn" in path:
        if name == "wq":                       # (L?, d, H, hd)
            return msh(len(shp) - 2)
        if name in ("wk", "wv"):               # (L?, d, KV, hd)
            return msh(len(shp) - 2)           # replicates when KV < m
        if name == "wo":                       # (L?, H, hd, d)
            return msh(len(shp) - 3)
        if name in ("w_uk", "w_uv"):           # (L?, r, H, hd) — MLA
            return msh(len(shp) - 2)
        if name == "w_dkv":                    # (L?, d, r+rope) small
            return rep

    # dense / shared-expert MLP
    if name in ("wi", "wg") and ("moe" not in joined or "shared" in joined):
        return msh(len(shp) - 1)               # (L?, d, f)
    if name == "wo" and ("moe" not in joined or "shared" in joined):
        return msh(len(shp) - 2)               # (L?, f, d)

    # MoE: expert parallelism
    if "moe" in joined:
        if name == "router":
            return msh(len(shp) - 1)           # (L?, d, E)
        if name in ("wi", "wg", "wo"):         # (L?, E, d, f)
            return msh(len(shp) - 3)
        return rep                             # shared experts above

    # mamba2 components: d_inner / heads over model
    if name in ("wz", "wx"):                   # (L?, d, di)
        return msh(len(shp) - 1)
    if name == "out_proj":                     # (L?, di, d)
        return msh(len(shp) - 2)
    if "conv_x" in path and name == "w":       # (L?, w, di)
        return msh(len(shp) - 1)
    if "conv_x" in path and name == "b":
        return msh(len(shp) - 1)
    if name in ("wB", "wC", "wdt"):
        return rep
    if name in ("A_log", "D", "dt_bias"):
        return rep
    if "norm" in joined and name == "scale" and "mamba" in joined:
        return msh(len(shp) - 1)               # (L?, di) gated norm

    return rep                                 # norms, biases, gates


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and
    NamedTuples (None stays None), keeping its structure."""
    if tree is None:
        return None
    if isinstance(tree, Spec):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(fn, v, path + (str(i),))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)


def leaves_with_path(tree) -> list:
    """``[(path, leaf)]`` of a tree (a spec tree's leaves are its Specs),
    in walking order."""
    out = []
    _map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def params_shardings(cfg: ModelConfig, mesh, params_shape) -> Any:
    """The spec of every leaf of a params(-shaped) tree."""
    return _map_with_path(lambda path, leaf: param_spec(cfg, mesh, path,
                                                        leaf), params_shape)


# ---------------------------------------------------------------------------
# activations / inputs / caches
# ---------------------------------------------------------------------------
def _batch_ok(mesh, global_batch: int):
    axes = batch_axes(mesh)
    dp = 1
    for a in axes:
        dp *= _axis_size(mesh, a)
    return axes, _div(global_batch, dp) and global_batch > 1


def input_shardings(cfg: ModelConfig, mesh, batch_shape_tree,
                    global_batch: int) -> Any:
    """Batch dims over ('pod','data') when divisible, else replicated."""
    axes, batch_ok = _batch_ok(mesh, global_batch)
    bspec = axes if batch_ok else None

    def one(path, leaf):
        spec = [None] * len(leaf.shape)
        if len(leaf.shape) >= 1 and bspec is not None:
            spec[0] = bspec
        return Spec(spec)
    return _map_with_path(one, batch_shape_tree)


def cache_shardings(cfg: ModelConfig, mesh, cache_shape_tree,
                    global_batch: int) -> Any:
    """Decode caches: batch over ('pod','data') when divisible; otherwise
    shard the sequence dim over 'data'. Head-ish dims over 'model' when
    divisible."""
    axes, batch_ok = _batch_ok(mesh, global_batch)
    m = _axis_size(mesh, "model")

    def one(path, leaf):
        shp = leaf.shape  # leading L (stacked layers), then cache dims
        spec = [None] * len(shp)
        field = path[-1] if path else ""
        if field in ("k", "v"):          # (L, B, C, KV, D)
            if batch_ok:
                spec[1] = axes
            else:
                spec[2] = "data"
            if _div(shp[3], m):
                spec[3] = "model"
            elif _div(shp[4], m):
                spec[4] = "model"
        elif field in ("c_kv", "k_rope"):  # (L, B, S, r)
            if batch_ok:
                spec[1] = axes
            else:
                spec[2] = "data"
        elif field == "h":               # (L, B, H, P, N)
            if batch_ok:
                spec[1] = axes
            if _div(shp[2], m):
                spec[2] = "model"
        elif field in ("conv_x",):       # (L, B, w-1, di)
            if batch_ok:
                spec[1] = axes
            if _div(shp[3], m):
                spec[3] = "model"
        elif field in ("conv_B", "conv_C"):
            if batch_ok:
                spec[1] = axes
        return Spec(spec)
    return _map_with_path(one, cache_shape_tree)


# ---------------------------------------------------------------------------
# this rank's block of a whole parameter tree
# ---------------------------------------------------------------------------
def block_unit(cfg: ModelConfig, path: Tuple[str, ...]) -> int:
    """The unit a leaf's ``model`` dim is blocked in: an SSD head's
    ``head_dim`` dims for mamba2's d_inner leaves (a block holds whole
    heads), else 1."""
    if cfg.ssm is not None and "mamba" in path and (
            path[-1] in ("wz", "wx", "out_proj")
            or "conv_x" in path or "norm" in path):
        return cfg.ssm.head_dim
    return 1


def _narrow(leaf, dim: int, lo: int, hi: int):
    if isinstance(leaf, torch.Tensor):
        return leaf.narrow(dim, lo, hi - lo).contiguous()
    sl = [slice(None)] * np.ndim(leaf)
    sl[dim] = slice(lo, hi)
    return np.ascontiguousarray(np.asarray(leaf)[tuple(sl)])


def shard_params(params, cfg: ModelConfig, mesh) -> Any:
    """This rank's block of a whole parameter tree (the port's tensors, or
    the numpy tree ``checkpoint.bridge`` carries across): every leaf sliced
    along the dim ``param_spec`` puts over ``model``, to ``mesh.block`` —
    contiguous copies, so the whole tree can be freed; replicated leaves
    come back as they are."""
    def one(path, leaf):
        spec = param_spec(cfg, mesh, path, leaf)
        if "model" not in spec:
            return leaf
        dim = spec.index("model")
        n = leaf.shape[dim]
        lo, hi = mesh.block(n, "model", block_unit(cfg, path))
        return leaf if (lo, hi) == (0, n) else _narrow(leaf, dim, lo, hi)
    return _map_with_path(one, params)
