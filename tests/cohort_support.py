"""Rank programs of the cohort-sharding tests
(``tests/test_torch_cohort_shard.py``, ``tests/test_torch_cohort_fleet.py``).

Each program runs in every rank of a 2-rank gloo group that
``repro_torch.sharding.cohort.spawn_cohort`` starts on the CPU, runs all of
its scenarios there and returns their readings (numpy trees, lists,
numbers), which the test process compares against the port's unsharded
path and the reference. Nothing here imports JAX: the ranks are fresh
processes that need torch and the port only.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.paper_cnn import CNNConfig
from repro_torch.core.aggregate import aggregate_apply_hierarchical
from repro_torch.core.submodel import SubmodelSpec, TransformerSubSpec
from repro_torch.fl import engine as engine_mod
from repro_torch.fl import faults as faults_mod
from repro_torch.fl.selection import Selection
from repro_torch.fl.server import CFLConfig
from repro_torch.fl.session import CFLSession
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.sharding.cohort import cohort_mesh

# the reduced CNN of tests/test_selection.py's sharded partial round
SMALL = dict(name="sel-shard-sub", in_channels=1, image_size=28,
             stem_channels=8, stages=((16, 2), (32, 2)), groupnorm_groups=4,
             elastic_widths=(0.5, 1.0))
CFG = CNNConfig(**SMALL)
ROUND = dict(batch_size=32, epochs=1)
# the quickstart CNN of tests/test_torch_fleet_ckpt.py
QUICK = dict(SMALL, name="quickstart")
KILL_FAULTS = dict(seed=1, corrupt_rate=0.25, shard_kill_rate=1.0)


class Collectives:
    """Counts ``dist.all_reduce`` / ``dist.all_gather`` calls while active
    (the module attributes the port calls through)."""

    def __init__(self):
        self.counts = {"all_reduce": 0, "all_gather": 0}

    def __enter__(self):
        self._saved = {n: getattr(dist, n) for n in self.counts}
        for n, fn in self._saved.items():
            def wrapped(*a, _n=n, _fn=fn, **kw):
                self.counts[_n] += 1
                return _fn(*a, **kw)
            setattr(dist, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(dist, n, fn)


def _np(tree):
    return params_to_numpy(tree)


def _specs(genes):
    return [SubmodelSpec(tuple(d), tuple(w)) for d, w in genes]


def _engine(cfg, shards, backend="auto", lr=0.05):
    return engine_mod.BatchedRoundEngine(cfg, lr=lr, momentum=0.9,
                                         cohort_shards=shards,
                                         backend=backend, device="cpu")


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


# ---------------------------------------------------------------------------
# tests/test_torch_cohort_shard.py
# ---------------------------------------------------------------------------
def failing_program(rank, how):
    """Rank 1 fails (``how``: "raise" or "exit") while rank 0 waits for it
    in a collective: the caller must fail at once, not hang."""
    if rank == 1:
        if how == "raise":
            raise ValueError("rank 1 fails on purpose")
        import os
        os._exit(3)
    dist.barrier()
    return rank


def shard_program(rank, inputs):
    """Every scenario of the cohort-shard test file, on one rank."""
    torch.set_num_threads(1)
    out = {"rank": rank}
    out["aggregate"] = _aggregate(inputs["aggregate"])
    out["cnn"] = _cnn_round(inputs["cnn"])
    out["partial"] = _partial_round(inputs["cnn"])
    out["three"] = _three_clients(inputs["cnn"])
    out["baselines"] = _baselines()
    out["zoo"] = _zoo_round()
    return out


def _aggregate(inp):
    """The port's hierarchical aggregate on this rank's block, coverage
    norm on and off, participation on and off, and sanitised with a NaN
    slot; the collectives of one call counted."""
    mesh = cohort_mesh(2, device="cpu")
    k = len(inp["weights"])
    lo, hi = mesh.rank * k // 2, (mesh.rank + 1) * k // 2
    params = params_from_numpy(inp["params"], device="cpu")
    out = {}
    for name, case in inp["cases"].items():
        deltas = params_from_numpy({n: v[lo:hi] for n, v in
                                    case["deltas"].items()}, device="cpu")
        covs = None if case["covs"] is None else params_from_numpy(
            {n: v[lo:hi] for n, v in case["covs"].items()}, device="cpu")
        part = None if case["part"] is None else torch.as_tensor(
            case["part"])
        with Collectives() as c:
            new = aggregate_apply_hierarchical(
                params, deltas, covs, torch.as_tensor(inp["weights"]),
                mesh=mesh, coverage_norm=covs is not None,
                participation=part, sanitize=case["sanitize"])
        out[name] = {"params": _np(new), "collectives": c.counts}
    return out


def _cnn_round(inp):
    """A CFL round of 4 clients sharded 2 ways against the unsharded
    engine; this rank's block against an unsharded engine run on the
    block alone; the collectives of the sharded round counted."""
    specs = _specs(inp["specs"])
    params = params_from_numpy(inp["params"], device="cpu")
    kw = dict(ROUND, seeds=inp["seeds"])
    sh = _engine(CFG, 2)
    with Collectives() as c:
        new, accs, steps = sh.run_fl_round(params, specs, inp["train"],
                                           inp["test"], inp["sizes"],
                                           coverage_norm=True, **kw)
    res = sh.train_cohort(sh.broadcast_params(params, 4), specs,
                          inp["train"], eval_datasets=inp["test"], **kw)
    lo, hi = res.block
    alone = _engine(CFG, 1).train_cohort(
        _engine(CFG, 1).broadcast_params(params, hi - lo), specs[lo:hi],
        inp["train"][lo:hi], eval_datasets=inp["test"][lo:hi],
        batch_size=ROUND["batch_size"], epochs=ROUND["epochs"],
        seeds=inp["seeds"][lo:hi])
    un = _engine(CFG, 1)
    new_un, accs_un, steps_un = un.run_fl_round(
        params, specs, inp["train"], inp["test"], inp["sizes"],
        coverage_norm=True, **kw)
    return {"params": _np(new), "accs": accs, "n_steps": list(map(int,
                                                                 steps)),
            "params_unsharded": _np(new_un), "accs_unsharded": accs_un,
            "n_steps_unsharded": list(map(int, steps_un)),
            "block": [lo, hi], "collectives": c.counts,
            "block_equal": _equal_trees(res.deltas, alone.deltas)
            and _equal_trees(res.trained, alone.trained)
            and np.array_equal(res.accs, alone.accs),
            "shards": sh.cohort_sharding(4).mesh.n_shards}


def _partial_round(inp):
    """The reference's failing scenario: M = 2 slots out of 4 clients,
    client 3 and a padding slot, sharded against unsharded."""
    specs = _specs(inp["specs"][:2])
    params = params_from_numpy(inp["params"], device="cpu")
    sel = Selection(np.asarray([3, 3]), np.asarray([1.0, 0.0]),
                    np.asarray([60.0, 0.0]))
    kw = dict(ROUND, seeds=[5, 6], participation=sel)
    sh = _engine(CFG, 2)
    new, accs, steps = sh.run_fl_round(params, specs, inp["train"],
                                       inp["test"], None, **kw)
    new_un, accs_un, steps_un = _engine(CFG, 1).run_fl_round(
        params, specs, inp["train"], inp["test"], None, **kw)
    return {"params": _np(new), "accs": accs, "n_steps": list(map(int,
                                                                 steps)),
            "params_unsharded": _np(new_un), "accs_unsharded": accs_un,
            "n_steps_unsharded": list(map(int, steps_un)),
            "block": list(sh.block(2))}


def _three_clients(inp):
    """Three clients on two ranks: one effective shard, rank 1 idle; the
    round is the unsharded one to the bit, and nothing hangs."""
    specs = _specs(inp["specs"][:3])
    params = params_from_numpy(inp["params"], device="cpu")
    kw = dict(ROUND, seeds=inp["seeds"][:3])
    sh = _engine(CFG, 2)
    with Collectives() as c:
        new, accs, steps = sh.run_fl_round(params, specs, inp["train"][:3],
                                           inp["test"][:3],
                                           inp["sizes"][:3], **kw)
    new_un, accs_un, steps_un = _engine(CFG, 1).run_fl_round(
        params, specs, inp["train"][:3], inp["test"][:3], inp["sizes"][:3],
        **kw)
    return {"equal": _equal_trees(new, new_un) and accs == accs_un
            and list(steps) == list(steps_un),
            "block": list(sh.block(3)),
            "shards": sh.cohort_sharding(3).mesh.n_shards,
            "collectives": c.counts}


def _session(cfg, shards, algorithm, n_samples=240, **fl_kw):
    fl = CFLConfig(n_workers=4, local_epochs=1, batch_size=32, lr=0.05,
                   elastic_kernels=True, cohort_shards=shards, **fl_kw)
    return CFLSession.from_synthetic(
        cfg, kind=None if not isinstance(cfg, CNNConfig) else "synthmnist",
        n_workers=4, n_samples=n_samples, heterogeneity="quality",
        fl_cfg=fl, algorithm=algorithm, device="cpu")


def _baselines():
    """FedAvg (2 rounds) and IL (2 rounds' budget) sharded against
    unsharded."""
    out = {}
    runs = {}
    for shards in (2, 1):
        fed = _session(CFG, shards, "fedavg")
        fed.run(2)
        il = _session(CFG, shards, "il")
        il.run(2)
        runs[shards] = (fed, il)
    (fed2, il2), (fed1, il1) = runs[2], runs[1]
    out["fedavg"] = {"params": _np(fed2.params),
                     "params_unsharded": _np(fed1.params),
                     "init": _np(fed1._init_params),
                     "accs": [h["accs"] for h in fed2.history],
                     "accs_unsharded": [h["accs"] for h in fed1.history]}
    out["il"] = {"accs": il2.il_accs, "accs_unsharded": il1.il_accs}
    return out


def _zoo_round():
    """One round of a reduced granite-3-8b (2 layers, d_model 64) on 4
    clients, sharded against unsharded."""
    from repro_torch.data.synth import make_lm_dataset
    from repro_torch.core.elastic import family_for
    cfg = dataclasses.replace(
        reduced(ARCHS["granite-3-8b"], n_layers=2, d_model=64),
        n_heads=4, n_kv_heads=2, head_dim=16)
    params = family_for(cfg).init_params(seed=0, device="cpu")
    train = [make_lm_dataset(n, 16, 6, seed=k, chain_seed=100 + k)
             for k, n in enumerate([6, 8, 3, 9])]
    test = [make_lm_dataset(4, 16, 6, seed=50 + k, chain_seed=100 + k)
            for k in range(4)]
    specs = [TransformerSubSpec(((1,),), ff_frac=0.75, attn_head_frac=0.5),
             TransformerSubSpec(((0, 1),), ff_frac=0.5)] * 2
    kw = dict(batch_size=4, epochs=2, seeds=[5, 6, 7, 8])
    sizes = [float(len(d["y"])) for d in train]
    out = {"init": _np(params)}
    for shards in (2, 1):
        eng = _engine(cfg, shards, lr=0.5)
        new, accs, _ = eng.run_fl_round(params, specs, train, test, sizes,
                                        coverage_norm=True, **kw)
        out[shards] = {"params": _np(new), "accs": accs}
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_cohort_fleet.py
# ---------------------------------------------------------------------------
def fleet_program(rank, ckpt_dir):
    """Every scenario of the cohort-fleet test file, on one rank."""
    torch.set_num_threads(1)
    return {"rank": rank, "kill": _shard_kill(), "parity": _async_parity(),
            "ckpt": _checkpoint(ckpt_dir), "ring": _ring(),
            "idle": _idle_rank_faults(), "policies": _policies()}


def _quick(shards, **fl_kw):
    return _session(CNNConfig(**QUICK), shards, "cfl", n_samples=320,
                    **fl_kw)


def _events(sess):
    return [{k: h[k] for k in ("participants", "dropped", "quarantined",
                               "staleness", "sim_clock", "n_steps")}
            for h in sess.history]


def _shard_kill():
    """Buffered async with faults and a shard killed every engagement, on
    2 shards; the unsharded run drops the same slots (its draw given the
    sharded run's shard count)."""
    kw = dict(mode="async", async_buffer=2,
              faults=faults_mod.FaultPlan(**KILL_FAULTS))
    sh = _quick(2, **kw)
    sh.run(3)
    draw = faults_mod.FaultPlan.draw
    try:
        faults_mod.FaultPlan.draw = \
            lambda self, stream, key, n_slots, n_shards=1: draw(
                self, stream, key, n_slots, 2)
        un = _quick(1, **kw)
        un.run(3)
    finally:
        faults_mod.FaultPlan.draw = draw
    init = _quick(1)._init_params
    return {"events": _events(sh), "events_unsharded": _events(un),
            "accs": [h["accs"] for h in sh.history],
            "accs_unsharded": [h["accs"] for h in un.history],
            "params": _np(sh.params), "params_unsharded": _np(un.params),
            "init": _np(init),
            "shards": sh.server.engine.cohort_sharding(4).mesh.n_shards}


def _async_parity():
    """Async at the sync point (B = the cohort, no staleness) against sync,
    both sharded: bit for bit."""
    sync = _quick(2)
    sync.run(2)
    asy = _quick(2, mode="async")
    asy.run(2)
    return {"equal": _equal_trees(sync.params, asy.params),
            "accs_equal": [h["accs"] for h in sync.history]
            == [h["accs"] for h in asy.history]}


def _checkpoint(ckpt_dir):
    """A buffered async run with faults, checkpointed on 2 ranks with
    groups in flight and resumed on 2: bit-equal to the uninterrupted
    run. The file stays for the test process's 1-process restore."""
    kw = dict(mode="async", async_buffer=2,
              faults="drop=0.2,straggle=0.2,corrupt=0.3,seed=2")
    a = _quick(2, **kw)
    a.run(4)
    b = _quick(2, **kw)
    b.run(2)
    in_flight = len(b.server.runtime.groups)
    path = b.save_checkpoint(f"{ckpt_dir}/sharded.ckpt")
    c = _quick(2, **kw)
    info = c.restore_checkpoint(path)
    c.run(2)
    return {"equal": _equal_trees(a.params, c.params),
            "events_equal": _events(a) == _events(c),
            "info": info, "in_flight": in_flight, "path": path,
            "params_at_save": _np(b.params)}


def _idle_rank_faults():
    """Three clients on two ranks (one shard, rank 1 idle) with faults,
    sync and buffered async with the gate on: every rank joins every
    collective, and the runs are the unsharded ones to the bit."""
    out = {}
    for mode, kw in (("sync", {}), ("async", {"async_buffer": 2})):
        runs = []
        for shards in (2, 1):
            fl = CFLConfig(n_workers=3, local_epochs=1, batch_size=32,
                           lr=0.05, elastic_kernels=True,
                           cohort_shards=shards, mode=mode,
                           faults="drop=0.2,straggle=0.2,corrupt=0.3,"
                           "seed=2", **kw)
            sess = CFLSession.from_synthetic(
                CNNConfig(**QUICK), kind="synthmnist", n_workers=3,
                n_samples=240, heterogeneity="quality", fl_cfg=fl,
                device="cpu")
            sess.run(3)
            runs.append(sess)
        sh, un = runs
        out[mode] = {"equal": _equal_trees(sh.params, un.params),
                     "events_equal": _events(sh) == _events(un),
                     "block": list(sh.server.engine.block(3)),
                     "faults": sum(h["dropped"] + h["quarantined"]
                                   for h in sh.history)}
    return out


def _policies():
    """Each selection policy's draws over 2 sharded rounds (the host's,
    on every rank alike) against the unsharded run's: participants and
    specs."""
    out = {}
    for policy in ("uniform", "fairness", "latency"):
        runs = []
        for shards in (2, 1):
            sess = _quick(shards, selection=policy)
            sess.run(2)
            runs.append([(h["participants"], h["specs"])
                         for h in sess.history])
        out[policy] = {"sharded": runs[0], "unsharded": runs[1]}
    return out


def _ring():
    """The prefetch ring on, sharded: hits, no misses, and the ring-off
    run's bits."""
    on = _quick(2, overlap=True)
    on.run(2)
    off = _quick(2)
    off.run(2)
    return {"stats": on.server.engine.prefetch_stats(),
            "equal": _equal_trees(on.params, off.params)}
