"""The port's sharding rules (``repro_torch.sharding.specs``) against the
reference's own ``sharding/specs.py`` (no ranks, no process group).

For every arch in ``ARCHS`` at its published size and the meshes (1, 1),
(1, 2), (1, 4), (2, 2) and (4, 1): the placement of every leaf of the
parameter tree, of each decode shape's cache tree and of its batch trees
(the prefill batch and the decode step's token / position) is the
reference's. The reference's functions take a ``jax.sharding.AbstractMesh``,
so no devices are faked; the port's trees are ``meta`` tensors. Then
``shard_params``: every model rank's blocks, concatenated along the dim the
rules put over ``model``, give the whole tree back bit for bit — over 2, 3
and 4 ranks, where 3 splits the vocab, d_ff and the MoE experts unevenly
(blocks of ``ceil(n / m)``), on tensors and on the numpy tree the bridge
carries.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.launch.steps import (batch_spec, cache_spec, decode_input_spec,
                                params_spec)
from repro.sharding import (cache_shardings as ref_cache_shardings,
                            input_shardings as ref_input_shardings,
                            params_shardings as ref_params_shardings)
from repro.sharding.specs import _path_str
from repro_torch.checkpoint.bridge import params_to_numpy
from repro_torch.configs import ARCHS, INPUT_SHAPES, reduced
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.sharding.mesh import HostMesh, split
from repro_torch.sharding.specs import (block_unit, cache_shardings,
                                        input_shardings, leaves_with_path,
                                        param_spec, params_shardings,
                                        shard_params)

import jax_compile_cache  # noqa: F401  (the shared compile cache)

torch.set_num_threads(2)
MESHES = ((1, 1), (1, 2), (1, 4), (2, 2), (4, 1))
CPU = torch.device("cpu")


def _norm(spec, ndim):
    """A PartitionSpec or port Spec as a tuple of ``ndim`` entries, a
    one-axis tuple entry written as the axis name."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in tuple(spec)]
    return tuple(out + [None] * (ndim - len(out)))


def _paths(tree):
    """{path strings: leaf} of a reference tree."""
    return {tuple(_path_str(k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _held(ref, ref_shapes, port, port_shapes):
    """The port's spec tree names the same leaves, of the same shapes, as
    the reference's, and gives each the reference's placement."""
    shapes = {p: tuple(l.shape) for p, l in _paths(ref_shapes).items()}
    want = {p: _norm(sh.spec, len(shapes[p]))
            for p, sh in _paths(ref).items()}
    port_shapes = {p: tuple(l.shape) for p, l in leaves_with_path(port_shapes)}
    got = {p: _norm(s, len(port_shapes[p])) for p, s in leaves_with_path(port)}
    assert port_shapes == shapes
    bad = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
    assert set(got) == set(want) and not bad, bad


def _meta(shapes_tree):
    """A tree of meta tensors with the reference's ShapeDtypeStruct
    shapes (a batch tree)."""
    return {k: torch.empty(v.shape, device="meta")
            for k, v in shapes_tree.items()}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_rules_match_the_reference(arch):
    """Parameters, and for each shape of the arch the batch tree (each
    decode shape also its cache tree and the decode step's inputs), on
    every mesh: the same axis over ``model`` / ``data`` for every leaf."""
    cfg, ref_cfg = ARCHS[arch], REF_ARCHS[arch]
    ref_ps = params_spec(ref_cfg)
    ps = T.init_params(cfg, device="meta")
    shapes = [s for s in REF_SHAPES if ref_cfg.supports(s)]
    caches = {}
    for s in shapes:
        if REF_SHAPES[s].kind == "decode":
            caches[s] = (cache_spec(ref_cfg, s), T.init_decode_caches(
                cfg, INPUT_SHAPES[s].global_batch, INPUT_SHAPES[s].seq_len,
                device="meta"))
    for dm in MESHES:
        ref_mesh = AbstractMesh(dm, ("data", "model"))
        mesh = HostMesh(dm[0], dm[1], 0, 0, CPU)
        _held(ref_params_shardings(ref_cfg, ref_mesh, ref_ps), ref_ps,
              params_shardings(cfg, mesh, ps), ps)
        for s in shapes:
            B = REF_SHAPES[s].global_batch
            trees = [batch_spec(ref_cfg, s)]
            if s in caches:
                trees.append(decode_input_spec(ref_cfg, s))
                ref_c, port_c = caches[s]
                _held(ref_cache_shardings(ref_cfg, ref_mesh, ref_c, B),
                      ref_c, cache_shardings(cfg, mesh, port_c, B), port_c)
            for tree in trees:
                meta = _meta(tree)
                _held(ref_input_shardings(ref_cfg, ref_mesh, tree, B), tree,
                      input_shardings(cfg, mesh, meta, B), meta)


def test_rules_cover_every_kind_of_split():
    """The rules' outcomes the meshes above reach: granite's KV heads (8)
    shard over 4 ranks, but a single KV head (reduced granite) replicates;
    a batch of 1 puts the KV cache's sequence over ``data``; mamba2's
    d_inner and state heads go over ``model``."""
    mesh = HostMesh(2, 4, 0, 0, CPU)
    path = ("segments", "0", "blocks", "attn", "wk")
    g = T.init_params(ARCHS["granite-3-8b"], device="meta")
    wk = g["segments"][0]["blocks"]["attn"]["wk"]
    assert param_spec(ARCHS["granite-3-8b"], mesh, path, wk) == (
        None, None, "model", None)
    small = reduced(ARCHS["granite-3-8b"], n_layers=2, d_model=256)
    assert small.n_kv_heads == 1
    wk1 = T.init_params(small, device="meta")["segments"][0]["blocks"][
        "attn"]["wk"]
    assert "model" not in param_spec(small, mesh, path, wk1)
    cfg = ARCHS["granite-3-8b"]
    c = T.init_decode_caches(cfg, 1, 64, device="meta")
    assert cache_shardings(cfg, mesh, c, 1).segments[0].k[2] == "data"
    m = ARCHS["mamba2-2.7b"]
    mc = T.init_decode_caches(m, 8, 64, device="meta")
    spec = cache_shardings(m, mesh, mc, 8).segments[0]
    assert spec.h[1:3] == (("data",), "model")
    assert spec.conv_x[3] == "model" and spec.conv_B[3] is None


def _small(arch):
    cfg = reduced(ARCHS[arch], n_layers=2, d_model=64)
    if cfg.moe is not None:  # 6 experts: replicated over 4 ranks; shared 32
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=6, n_shared=1))
    return cfg


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("arch", ["granite-3-8b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b", "deepseek-v2-lite-16b"])
def test_shard_params_round_trips(arch, m):
    """Every model rank's ``shard_params`` blocks, concatenated along the
    dim ``param_spec`` puts over ``model``, are the whole tree bit for bit
    (replicated leaves come back unchanged, and as the same object); the
    blocks are ``ceil(n / m)`` long, the last shorter (over 3 ranks the
    512-row padded vocab splits 171 / 171 / 170); an SSD leaf's block holds
    whole heads. The numpy tree the bridge carries gives the same
    blocks."""
    cfg = _small(arch)
    params = T.init_params(cfg, seed=3, device="cpu")
    whole = dict(leaves_with_path(params))
    blocks = [shard_params(params, cfg, HostMesh(1, m, 0, r, CPU))
              for r in range(m)]
    np_blocks = [shard_params(params_to_numpy(params), cfg,
                              HostMesh(1, m, 0, r, CPU)) for r in range(m)]
    mesh = HostMesh(1, m, 0, 0, CPU)
    split_leaves = 0
    for path, leaf in whole.items():
        spec = param_spec(cfg, mesh, path, leaf)
        parts = [dict(leaves_with_path(b))[path] for b in blocks]
        nparts = [dict(leaves_with_path(b))[path] for b in np_blocks]
        for a, b in zip(parts, nparts):
            np.testing.assert_array_equal(a.numpy(), b)
        if "model" not in spec:
            assert all(p is leaf for p in parts)
            continue
        dim = spec.index("model")
        unit = block_unit(cfg, path)
        n = leaf.shape[dim]
        assert [p.shape[dim] for p in parts] == [
            (hi - lo) * unit for lo, hi in
            (split(n // unit, m, r) for r in range(m))]
        assert torch.equal(torch.cat(parts, dim), leaf), path
        split_leaves += 1
    assert split_leaves >= 3
    if m == 3:
        table = [b["embed"]["table"].shape[0] for b in blocks]
        assert table == [171, 171, 170]


def test_host_mesh_without_a_group():
    """``make_host_mesh`` without a process group: (1, 1) on the device
    asked for, every block the whole dim, no collective (``all_reduce`` /
    ``all_gather`` return their input); a model axis of 2 raises, and so
    does the default device (the card) where there is none."""
    mesh = make_host_mesh(device="cpu")
    assert (mesh.data, mesh.model, mesh.backend) == (1, 1, None)
    t = torch.arange(6.0).reshape(2, 3)
    assert mesh.block(7) == (0, 7) and mesh.block(7, "data") == (0, 7)
    assert mesh.all_reduce(t) is t and mesh.all_gather(t, 1, 3) is t
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()
