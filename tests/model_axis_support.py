"""Configs and rank programs of the model-axis tests
(``tests/test_torch_model_axis.py``).

The configs are built alike from either package's ``configs`` module
(``case_config``), so the reference and the port run the same reduced
models. ``mesh_rank`` runs in every rank of a gloo group that
``repro_torch.sharding.cohort.spawn_cohort`` starts on the CPU: for each
mesh it asks for, it builds the ``(data, model)`` mesh over the group,
shards the whole parameter tree it was given (the reference's, as numpy)
with ``shard_params`` and runs every case's prefill step and greedy
serving through the port's sharded entry points on both paths — the
kernel table (``PATHS["kernels"]``: the kernels' plain versions on CPU
tensors) and the dense masked path — returning numpy arrays. Nothing here
imports JAX.
"""
import dataclasses

import numpy as np
import torch

CASES = ("granite-3-8b", "granite-moe-1b-a400m", "mamba2-2.7b")
VOCAB = 203          # not a multiple of 2 or 4, and >= 8x either: ragged
PROMPT = 16
STEPS = 8
PATHS = ("kernels", "dense")


def path_table(path):
    """The op table of a path: the hand-kernel table (whose wrappers take
    their plain versions for CPU tensors) or None (the dense masked
    path)."""
    from repro_torch.kernels.dispatch import kernel_dispatch
    return kernel_dispatch("auto" if path == "kernels" else None).table(
        "transformer")


def case_config(configs, arch):
    """The reduced config of ``arch`` from ``configs`` (``repro.configs``
    or ``repro_torch.configs``): 2 layers at d_model 256 (4 query heads;
    granite 1 KV head, granite-moe 2), a 203-row vocab left unpadded (a
    subclass whose ``padded_vocab`` is the vocab), and for granite-moe 8
    experts and a shared expert, capacity sized by 4 experts
    (``capacity_experts``) in the single-device rule, at a capacity factor
    of E / k = 4: no assignment can overflow under either branch's rule,
    so the whole model's values hold across meshes (the MoE layer's own
    check, ``moe_layer_inputs``, makes capacity bind)."""
    cfg = configs.reduced(configs.ARCHS[arch], n_layers=2, d_model=256)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=8, capacity_experts=4, n_shared=1,
            capacity_factor=4.0))
    cls = type("RaggedVocab", (type(cfg),), {
        "padded_vocab": property(lambda self: self.vocab_size)})
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["vocab_size"] = VOCAB
    return cls(**fields)


def case_masks(cfg):
    """Prefix masks that end inside a rank's block and leave the blocks
    after it empty, over 2 and 4 ranks: 3/8 of d_ff, 1 of 4 query heads,
    3 of 8 experts, 6 of 16 SSD heads (numpy, float32)."""
    m = {}
    if cfg.ssm is not None:
        nh = cfg.ssm.n_heads(cfg.d_model)
        m["ssm_heads"] = (np.arange(nh) < 6).astype(np.float32)
    else:
        m["heads"] = (np.arange(cfg.n_heads) < 1).astype(np.float32)
        if cfg.moe is not None:
            m["experts"] = (np.arange(cfg.moe.n_experts) < 3).astype(
                np.float32)
        else:
            m["ff"] = (np.arange(cfg.d_ff) < cfg.d_ff * 3 // 8).astype(
                np.float32)
    return m


def serve(T, params, cfg, tokens, masks, mesh=None, steps=STEPS,
          kernels=None):
    """Fused prefill and ``steps`` greedy decode steps of the port's model
    ``T`` through ``kernels``: (logits (steps + 1, B, V), tokens (steps,
    B)) as numpy."""
    B, S = tokens.shape
    logits, caches = T.prefill(params, cfg, tokens, S + steps, masks=masks,
                               kernels=kernels, mesh=mesh)
    out, toks = [logits], []
    for i in range(steps):
        tok = out[-1].argmax(-1)
        toks.append(tok)
        logits, caches = T.decode_step(params, cfg, caches, tok[:, None],
                                       S + i, masks=masks, kernels=kernels,
                                       mesh=mesh)
        out.append(logits)
    return (torch.stack(out).numpy(),
            torch.stack(toks).numpy().astype(np.int64))


def _raises(fn):
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return None


def mesh_rank(rank, models, params_np, tokens, steps=STEPS):
    """One rank of a gloo group: for each model-axis size in ``models`` (a
    mesh of world / m by m), every case's results: on each path the
    prefill step's logits for each batch in ``tokens[arch]`` (``{B: (B, S)
    int64}``) and the greedy serving run at the first batch; on the
    kernel path the serving run of every other batch (or the
    NotImplementedError it raises); and the MoE layer alone over binding
    capacity (``moe_layer``)."""
    from repro_torch.checkpoint.bridge import params_from_numpy
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.sharding.specs import shard_params
    torch.set_num_threads(1)
    out = {}
    for m in models:
        mesh = make_host_mesh(m, device="cpu")
        for arch in CASES:
            cfg = case_config(configs, arch)
            whole = params_from_numpy(params_np[arch], device="cpu")
            params = shard_params(whole, cfg, mesh)
            masks = {k: torch.from_numpy(v)
                     for k, v in case_masks(cfg).items()}
            res = {"coords": (mesh.data_rank, mesh.model_rank)}
            batches = list(tokens[arch].items())
            for path in PATHS:
                table = path_table(path)
                step = make_prefill_step(cfg, kernels=table,
                                         activation_dtype=torch.float32,
                                         mesh=mesh)
                for B, tok in batches:
                    res[("step", path, B)] = step(
                        params, {"tokens": torch.from_numpy(tok)}).numpy()
                res[("serve", path)] = serve(
                    T, params, cfg, torch.from_numpy(batches[0][1]), masks,
                    mesh, steps, table)
            table = path_table("kernels")
            for B, tok in batches[1:]:
                tok = torch.from_numpy(tok)
                err = _raises(lambda: serve(T, params, cfg, tok, masks, mesh,
                                            1, table))
                res[("serve_raises", B)] = err
                if err is None:
                    res[("serve", B)] = serve(T, params, cfg, tok, masks,
                                              mesh, 1, table)
            if cfg.moe is not None:
                res["moe_layer"] = moe_layer(T, whole, cfg, mesh)
            out[(m, arch)] = res
    return out


def moe_layer_inputs(cfg, B=4):
    """The MoE layer's check: the first block's router and experts under
    a capacity factor of 0.5 (assignments overflow; 64 tokens take 8 slots
    an expert in the expert-parallel rule, 16 in the single-device one),
    on (B, PROMPT, d) activations drawn from a seeded numpy generator."""
    x = np.random.default_rng(11).standard_normal(
        (B, PROMPT, cfg.d_model)).astype(np.float32)
    return x, dataclasses.replace(cfg.moe, capacity_factor=0.5)


def moe_layer(T, whole, cfg, mesh):
    """The port's MoE layer of the first block on ``mesh`` at binding
    capacity (``moe_layer_inputs``), through the transformer's token
    grouping (``_moe_rows``): this rank's rows of the output, whole over
    ``data``, as numpy."""
    from repro_torch.sharding.specs import shard_params
    x, moe = moe_layer_inputs(cfg)
    cfg = dataclasses.replace(cfg, moe=moe)
    p = shard_params(whole, cfg, mesh)["segments"][0]["blocks"]["moe"]
    p = {k: (v[0] if not isinstance(v, dict) else
             {kk: vv[0] for kk, vv in v.items()}) for k, v in p.items()}
    B = x.shape[0]
    rows = T._batch_rows(mesh, B)
    h = torch.from_numpy(x)[rows[0]:rows[1]]
    y, _ = T._moe_rows(p, h, cfg, mesh, rows,
                       dict(act=cfg.act, expert_mask=None, kernel=None,
                            return_aux=False))
    return mesh.all_gather(y, 0, B, "data").numpy()
