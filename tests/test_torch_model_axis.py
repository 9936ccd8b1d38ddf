"""The model axis of the port's serving path (``sharding.specs``,
``launch.mesh.make_host_mesh``, the sharded layers of ``models``) against
the port's unsharded model and the reference, on gloo.

One group of world 2 (meshes (1, 2) and (2, 1)) and one of world 4 ((1, 4)
and (2, 2)) start once for the module (``tests/model_axis_support.py``,
one thread a rank). The parameters are drawn once (the port's seeded
init), and the reference runs on them as they are; each rank carries them
across with ``shard_params`` and runs granite-3-8b, granite-moe-1b-a400m and
mamba2-2.7b, reduced so that the vocab (203 rows) splits unevenly, the KV
heads are replicated (granite's one) or shard (granite-moe's two over 2
ranks) or are gathered (over 4), and the d_ff, query-head, expert and SSD
head prefixes end inside one rank's block and leave the blocks after it
empty. Held:

* on both paths — the kernel table (the kernels' plain versions on the
  CPU) and the dense masked path — the prefill step's last-position
  logits within 1e-5 (of the largest logit) of the port's unsharded step
  on that path, on a batch that splits over
  ``data`` (4 rows), one that does not (3 rows), and one of 1 row (for
  granite-moe 17 rows, which split unevenly over 2); the first two also
  within 1e-5 of the reference's ``make_prefill_step`` (run in fp32);
* fused prefill and 8 greedy decode steps under the prefix masks: tokens
  identical to the unsharded port's and the reference's, logits within
  1e-4 of both over the run; every rank returns the same;
* a ``(1, 1)`` mesh (no group) is the unsharded model to the bit;
* a decode cache whose sequence the rules put over ``data`` (a batch of 3
  or 1 on 2 data ranks) raises for the attention archs, and serves for
  mamba2 (no sequence axis in its cache);
* the MoE layer at binding capacity follows each branch's own rule — the
  expert-parallel branch one group per data rank sized by all of E, the
  single-device branch one group sized by ``capacity_experts`` — against
  the reference's ``_dispatch_compute_combine`` (the local math its
  ``shard_map`` branch runs, summed over the expert blocks).
"""
import functools
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_axis_support as MA
from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.models import moe as ref_moe
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer as T
from repro_torch.sharding.cohort import spawn_cohort

import jax_compile_cache  # noqa: F401  (the shared compile cache)

torch.set_num_threads(2)
PREFILL_TOL = 1e-5
DECODE_TOL = 1e-4
BATCHES = {"granite-3-8b": (4, 3, 1), "granite-moe-1b-a400m": (4, 3, 17),
           "mamba2-2.7b": (4, 3, 1)}
MESHES = {2: (2, 1), 4: (4, 2)}         # model-axis sizes per world
REF_BATCHES = (4, 3)            # the batches the reference runs too


def _tokens(arch):
    rng = np.random.default_rng(5)
    return {B: rng.integers(0, MA.VOCAB, (B, MA.PROMPT)).astype(np.int64)
            for B in BATCHES[arch]}


def _ref_serve(params, cfg, tokens, masks, steps=MA.STEPS):
    """The reference's fused prefill and greedy decode, fp32."""
    B, S = tokens.shape
    masks = {k: jnp.asarray(v) for k, v in masks.items()}
    logits, caches = jax.jit(functools.partial(
        RT.prefill, cfg=cfg, max_len=S + steps, masks=masks),
        static_argnames=())(params, tokens=jnp.asarray(tokens))
    step = jax.jit(lambda p, c, t, pos: RT.decode_step(p, cfg, c, t, pos,
                                                       masks=masks))
    out, toks = [np.asarray(logits)], []
    for i in range(steps):
        tok = out[-1].argmax(-1)
        toks.append(tok)
        logits, caches = step(params, caches, jnp.asarray(tok[:, None]),
                              jnp.int32(S + i))
        out.append(np.asarray(logits))
    return np.stack(out), np.stack(toks).astype(np.int64)


@pytest.fixture(scope="module")
def world():
    """Everything computed once: per arch the parameters, the reference's
    results, the port's unsharded results, and every rank's results of
    both groups (the groups run while this process runs the reference)."""
    params_np = {arch: params_to_numpy(T.init_params(
        MA.case_config(configs, arch), seed=1, device="cpu"))
        for arch in MA.CASES}
    tokens = {arch: _tokens(arch) for arch in MA.CASES}
    with ThreadPoolExecutor(len(MESHES)) as pool:
        groups = {w: pool.submit(spawn_cohort, MA.mesh_rank, w,
                                 backend="gloo", device="cpu",
                                 args=(models, params_np, tokens),
                                 timeout=300)
                  for w, models in MESHES.items()}
        ref = {}
        for arch in MA.CASES:
            rcfg = MA.case_config(ref_configs, arch)
            rp = jax.tree.map(jnp.asarray, params_np[arch])
            with pytest.MonkeyPatch.context() as mp:  # the reference's step
                mp.setattr(ref_steps, "ACT_DTYPE", jnp.float32)  # in fp32
                ref_step = jax.jit(ref_steps.make_prefill_step(rcfg))
                steps = {B: np.asarray(ref_step(rp, {"tokens": jnp.asarray(
                    tokens[arch][B])})) for B in REF_BATCHES}
            ref[arch] = dict(step=steps, serve=_ref_serve(
                rp, rcfg, tokens[arch][BATCHES[arch][0]],
                MA.case_masks(rcfg)))
        port = {}
        for arch in MA.CASES:
            cfg = MA.case_config(configs, arch)
            p = params_from_numpy(params_np[arch], device="cpu")
            masks = {k: torch.from_numpy(v)
                     for k, v in MA.case_masks(cfg).items()}
            t = tokens[arch]
            port[arch] = {}
            for path in MA.PATHS:
                table = MA.path_table(path)
                step = make_prefill_step(cfg, kernels=table,
                                         activation_dtype=torch.float32)
                port[arch][("step", path)] = {
                    B: step(p, {"tokens": torch.from_numpy(x)}).numpy()
                    for B, x in t.items()}
                port[arch][("serve", path)] = MA.serve(
                    T, p, cfg, torch.from_numpy(t[BATCHES[arch][0]]), masks,
                    kernels=table)
            port[arch]["serve1"] = {
                B: MA.serve(T, p, cfg, torch.from_numpy(x), masks, steps=1,
                            kernels=MA.path_table("kernels"))
                for B, x in t.items()}
        ranks = {}
        for w, models in MESHES.items():
            for res in groups[w].result():
                for (m, arch), v in res.items():
                    ranks.setdefault((w // m, m, arch), []).append(v)
    return dict(ref=ref, port=port, ranks=ranks, params=params_np)


MESH_IDS = [(w // m, m) for w, ms in MESHES.items() for m in ms]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("path", MA.PATHS)
@pytest.mark.parametrize("arch", MA.CASES)
@pytest.mark.parametrize("mesh", MESH_IDS, ids=str)
def test_prefill_step_matches_unsharded_and_reference(world, mesh, arch,
                                                      path):
    """Every batch's last-position logits on every rank within 1e-5 of the
    port's unsharded step on the same path and of the reference's; the
    ranks agree to the bit."""
    runs = world["ranks"][mesh + (arch,)]
    assert sorted(r["coords"] for r in runs) == sorted(
        (i, j) for i in range(mesh[0]) for j in range(mesh[1]))
    want = world["port"][arch][("step", path)]
    for B in BATCHES[arch]:
        got = [r[("step", path, B)] for r in runs]
        assert got[0].shape == (B, MA.VOCAB)
        assert all(np.array_equal(g, got[0]) for g in got)
        assert _rel(got[0], want[B]) <= PREFILL_TOL
        if B in REF_BATCHES:
            assert _rel(got[0], world["ref"][arch]["step"][B]) <= PREFILL_TOL
    for B in REF_BATCHES:               # the unsharded port, once a batch
        assert _rel(want[B], world["ref"][arch]["step"][B]) <= PREFILL_TOL


@pytest.mark.parametrize("path", MA.PATHS)
@pytest.mark.parametrize("arch", MA.CASES)
@pytest.mark.parametrize("mesh", MESH_IDS, ids=str)
def test_greedy_decode_matches_unsharded_and_reference(world, mesh, arch,
                                                       path):
    """Fused prefill and 8 greedy decode steps under prefix masks that end
    inside a rank's block: the tokens identical to the unsharded port's
    on the same path and the reference's, the logits within 1e-4 of both
    over the run, the prefill's within 1e-5; every rank the same."""
    runs = world["ranks"][mesh + (arch,)]
    logits, toks = runs[0][("serve", path)]
    for r in runs[1:]:
        assert np.array_equal(r[("serve", path)][0], logits)
        assert np.array_equal(r[("serve", path)][1], toks)
    for want_logits, want_toks in (world["port"][arch][("serve", path)],
                                   world["ref"][arch]["serve"]):
        np.testing.assert_array_equal(toks, want_toks)
        assert _rel(logits[0], want_logits[0]) <= PREFILL_TOL
        assert _rel(logits, want_logits) <= DECODE_TOL


@pytest.mark.parametrize("arch", MA.CASES)
@pytest.mark.parametrize("mesh", MESH_IDS, ids=str)
def test_batches_the_data_axis_cannot_hold(world, mesh, arch):
    """A batch of 3 (and 1) on 2 or 4 data ranks leaves the batch
    replicated, which puts an attention cache's sequence over ``data``:
    that layout raises (naming ROADMAP A17b) for granite and granite-moe;
    mamba2's cache has no sequence axis, so it serves, and its first step
    holds the unsharded one. Where the batch does split it serves."""
    runs = world["ranks"][mesh + (arch,)]
    for B in BATCHES[arch][1:]:
        err = runs[0][("serve_raises", B)]
        seq_over_data = mesh[0] > 1 and (B == 1 or (B % mesh[0] and
                                                     B < 8 * mesh[0]))
        if seq_over_data and arch != "mamba2-2.7b":
            assert err is not None and "A17b" in err
            continue
        assert err is None, err
        logits, toks = runs[0][("serve", B)]
        want_logits, want_toks = world["port"][arch]["serve1"][B]
        np.testing.assert_array_equal(toks, want_toks)
        assert _rel(logits, want_logits) <= DECODE_TOL


@pytest.mark.parametrize("path", MA.PATHS)
@pytest.mark.parametrize("arch", MA.CASES)
def test_mesh_1x1_is_the_unsharded_model_to_the_bit(world, arch, path):
    """``make_host_mesh()`` without a process group is (1, 1) and issues
    no collective: the prefill step and greedy serving on it are the
    unsharded model's to the bit, on each path."""
    mesh = make_host_mesh(device="cpu")
    assert (mesh.data, mesh.model) == (1, 1)
    cfg = MA.case_config(configs, arch)
    p = params_from_numpy(world["params"][arch], device="cpu")
    table = MA.path_table(path)
    step = make_prefill_step(cfg, kernels=table,
                             activation_dtype=torch.float32, mesh=mesh)
    tokens = _tokens(arch)
    for B, t in tokens.items():
        assert np.array_equal(step(p, {"tokens": torch.from_numpy(t)}),
                              world["port"][arch][("step", path)][B])
    masks = {k: torch.from_numpy(v) for k, v in MA.case_masks(cfg).items()}
    logits, toks = MA.serve(T, p, cfg, torch.from_numpy(
        tokens[BATCHES[arch][0]]), masks, mesh, kernels=table)
    want = world["port"][arch][("serve", path)]
    assert np.array_equal(logits, want[0]) and np.array_equal(toks, want[1])


def _ref_moe_layer(params_np, cfg, groups, cap):
    """The reference's MoE of the first block on ``moe_layer_inputs``: its
    router and top-k, then its ``_dispatch_compute_combine`` over all the
    experts for each of ``groups`` contiguous token groups at ``cap``
    slots an expert, and the shared expert."""
    x, moe = MA.moe_layer_inputs(cfg)
    p = jax.tree.map(lambda a: jnp.asarray(a[0]), params_np["segments"][0][
        "blocks"]["moe"])
    xt = jnp.asarray(x.reshape(-1, cfg.d_model))
    probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), -1)
    gv, idx = jax.lax.top_k(probs, moe.top_k)
    gv = gv / jnp.sum(gv, -1, keepdims=True)
    n = xt.shape[0] // groups
    outs = []
    for g in range(groups):
        sl = slice(g * n, (g + 1) * n)
        outs.append(ref_moe._dispatch_compute_combine(
            xt[sl], gv[sl], idx[sl], p["wi"], p["wg"], p["wo"],
            E=moe.n_experts, k=moe.top_k, cap=cap, act=cfg.act,
            expert_mask=None))
    out = jnp.concatenate(outs)
    sp, a = p["shared"], jax.nn.silu
    out = out + (a(xt @ sp["wg"]) * (xt @ sp["wi"])) @ sp["wo"]
    counts = np.asarray(jax.vmap(lambda i: jnp.bincount(
        i.reshape(-1), length=moe.n_experts))(idx.reshape(groups, -1)))
    return np.asarray(out).reshape(x.shape), int(counts.max())


@pytest.mark.parametrize("mesh", MESH_IDS, ids=str)
def test_moe_capacity_follows_each_branch(world, mesh):
    """The MoE layer alone at a capacity factor of 0.5, where assignments
    overflow: the expert-parallel branch (E = 8 a multiple of ``model``)
    routes one group per data rank sized by all 8 experts, the
    single-device branch (``model`` 1) one group of all 64 tokens sized by
    ``capacity_experts`` (4) — 8 slots against 16 — and every rank's
    output is the reference's for its branch within 1e-5."""
    arch = "granite-moe-1b-a400m"
    cfg = MA.case_config(ref_configs, arch)
    _, moe = MA.moe_layer_inputs(cfg)
    d, m = mesh
    T_ = 4 * MA.PROMPT
    ep = m > 1
    groups = d if ep and T_ % d == 0 else 1
    e_cap = moe.n_experts if ep else moe.capacity_experts
    cap = max(8, -(-math.ceil(T_ // groups * moe.top_k / e_cap *
                              moe.capacity_factor) // 8) * 8)
    assert cap == (8 if ep else 16)
    want, most = _ref_moe_layer(world["params"][arch], cfg, groups, cap)
    assert most > cap                   # the capacity binds
    for r in world["ranks"][mesh + (arch,)]:
        assert _rel(r["moe_layer"], want) <= PREFILL_TOL


def _head_blocks(nh, m):
    b = -(-nh // m)
    return [(min(r * b, nh), min((r + 1) * b, nh)) for r in range(m)]


@pytest.mark.parametrize("nh,ng,m,narrow", [
    (80, 1, 2, True), (80, 1, 4, True),     # mamba2-2.7b's heads / groups
    (16, 1, 2, True), (16, 1, 4, True),     # the reduced mamba2 above
    (16, 4, 2, True), (16, 4, 8, True),     # whole groups / inside one
    (12, 4, 8, True),                       # a head in each of two groups
    (12, 3, 2, False)])                     # 4 + 2 heads: misaligned
def test_group_slice_takes_the_groups_a_block_spans(nh, ng, m, narrow):
    """A rank's B / C for its head block: the groups the block spans where
    its heads split evenly over them — one group for mamba2's single group
    at 2 and 4 ranks, not a copy a head — else a group per head; either
    way each local head reads its own group's row, bit for bit."""
    from repro_torch.models.ssm import _group_slice
    t = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, ng, 5)).astype(np.float32))
    rep = nh // ng
    for h0, h1 in _head_blocks(nh, m):
        if h1 == h0:
            continue
        got = _group_slice(t, (h0, h1), nh, 2)
        spans = (h1 - 1) // rep - h0 // rep + 1
        assert got.shape[2] == (spans if narrow else h1 - h0)
        per_head = got.repeat_interleave((h1 - h0) // got.shape[2], dim=2)
        assert torch.equal(per_head, t.repeat_interleave(rep, dim=2)[
            :, :, h0:h1])
    if ng == 1:
        assert MA.case_config(configs, "mamba2-2.7b").ssm.n_groups == 1
