"""Deterministic fault injection for the fleet runtime — the port of the
reference's ``fl/faults.py``.

Fleets fail where the fairness story lives: slow devices straggle past
the deadline, flaky radios drop updates mid-round, broken edges ship NaN /
Inf or exploded deltas. A frozen :class:`FaultPlan` makes those failures a
reproducible input: every fault is drawn from
``np.random.SeedSequence(entropy=seed, spawn_key=(stream, key))`` (numpy,
as the reference draws it, so the port's fault schedule is the
reference's, bit for bit), keyed per engagement — the dispatch group id in
async mode, the round index in sync mode — so a retried client gets a
fresh draw.

Corruption enters the stacked deltas through one elementwise pass
(:func:`inject_deltas`) taking runtime (M,) code / scale tensors. On one
card the cohort has one shard, so ``shard_kill_rate`` never fires, as in
the reference's unsharded run; sharded cohorts are ROADMAP A17.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_map

# per-slot fault kinds (host-side plan)
OK, DROP, STRAGGLE, NAN, INF, OUTLIER = range(6)

# corruption codes of the injector (runtime data, not kinds)
_CODE_CLEAN, _CODE_NAN, _CODE_INF = 0, 1, 2

# async engagements key on (STREAM_ASYNC, gid), sync rounds on
# (STREAM_SYNC, round_idx): the two never collide
STREAM_ASYNC, STREAM_SYNC = 0, 1


@dataclasses.dataclass(frozen=True)
class GroupFaults:
    """One engagement's drawn faults: per-slot ``kinds`` (OK / DROP / ...)
    and the dead shard index (or -1). Host-side numpy only."""
    kinds: np.ndarray               # (M,) int
    killed_shard: int = -1

    @property
    def drop(self) -> np.ndarray:
        return self.kinds == DROP

    @property
    def straggle(self) -> np.ndarray:
        return self.kinds == STRAGGLE

    @property
    def corrupt(self) -> np.ndarray:
        return (self.kinds == NAN) | (self.kinds == INF) | \
            (self.kinds == OUTLIER)

    def any_fault(self) -> bool:
        return bool((self.kinds != OK).any())

    def codes_scales(self, outlier_scale: float, device=None):
        """Runtime inputs of :func:`inject_deltas` on ``device``: (M,)
        int32 corruption codes and (M,) float32 multipliers (outliers
        scale, the others 1)."""
        codes = np.zeros_like(self.kinds, np.int32)
        codes[self.kinds == NAN] = _CODE_NAN
        codes[self.kinds == INF] = _CODE_INF
        scales = np.ones_like(self.kinds, np.float32)
        scales[self.kinds == OUTLIER] = np.float32(outlier_scale)
        return (torch.as_tensor(codes, device=device),
                torch.as_tensor(scales, device=device))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A reproducible fleet-failure schedule.

    Rates are per dispatched slot per engagement: ``drop_rate`` clients
    vanish mid-round, ``straggle_rate`` clients take ``straggle_factor``×
    their simulated time, ``corrupt_rate`` clients return a bad delta
    (uniformly NaN / Inf / ``outlier_scale``× norm outlier), and with
    probability ``shard_kill_rate`` per engagement one cohort shard dies
    (inert on one card: one shard). ``seed`` namespaces the schedule."""
    seed: int = 0
    drop_rate: float = 0.0
    straggle_rate: float = 0.0
    straggle_factor: float = 8.0
    corrupt_rate: float = 0.0
    outlier_scale: float = 1e6
    shard_kill_rate: float = 0.0

    def __post_init__(self):
        total = self.drop_rate + self.straggle_rate + self.corrupt_rate
        if total > 1.0 + 1e-9:
            raise ValueError(
                f"drop+straggle+corrupt rates must sum to <= 1, got "
                f"{total}")
        for name in ("drop_rate", "straggle_rate", "corrupt_rate",
                     "shard_kill_rate"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{name} must be in [0, 1], got {v}")

    def any_rates(self) -> bool:
        return (self.drop_rate > 0 or self.straggle_rate > 0 or
                self.corrupt_rate > 0 or self.shard_kill_rate > 0)

    def draw(self, stream: int, key: int, n_slots: int,
             n_shards: int = 1) -> GroupFaults:
        """One engagement's faults, a pure function of the plan and
        ``(stream, key)`` (the SeedSequence spawn key)."""
        ss = np.random.SeedSequence(entropy=int(self.seed),
                                    spawn_key=(int(stream), int(key)))
        rng = np.random.RandomState(ss.generate_state(4))
        u = rng.rand(n_slots)
        kinds = np.full((n_slots,), OK, np.int64)
        lo = 0.0
        kinds[(u >= lo) & (u < lo + self.drop_rate)] = DROP
        lo += self.drop_rate
        kinds[(u >= lo) & (u < lo + self.straggle_rate)] = STRAGGLE
        lo += self.straggle_rate
        corrupt = (u >= lo) & (u < lo + self.corrupt_rate)
        # the corrupt mode is drawn apart, so rate changes don't reshuffle
        modes = rng.randint(0, 3, size=n_slots)
        kinds[corrupt] = np.asarray([NAN, INF, OUTLIER])[modes[corrupt]]
        killed = -1
        if n_shards > 1 and rng.rand() < self.shard_kill_rate:
            killed = int(rng.randint(0, n_shards))
            per = n_slots // n_shards
            kinds[killed * per:(killed + 1) * per] = DROP
        return GroupFaults(kinds=kinds, killed_shard=killed)


def inject_deltas(stacked_deltas, codes, scales):
    """Corrupt a stacked (M, ...) delta tree: ``codes`` (M,) int32 — 0
    clean, 1 NaN, 2 Inf; ``scales`` (M,) float32 multipliers (norm
    outliers). A clean slot's delta passes through bit for bit."""
    def leaf(d):
        c = codes.reshape((-1,) + (1,) * (d.dim() - 1))
        s = scales.reshape((-1,) + (1,) * (d.dim() - 1))
        out = d * s.to(d.dtype)
        out = torch.where(c == _CODE_NAN,
                          torch.full((), float("nan"), dtype=d.dtype,
                                     device=d.device), out)
        out = torch.where(c == _CODE_INF,
                          torch.full((), float("inf"), dtype=d.dtype,
                                     device=d.device), out)
        return out.to(d.dtype)
    return tree_map(leaf, stacked_deltas)


def faulty_sync_round(server, specs, sel):
    """The barrier round under a fault plan (``mode="sync"`` with
    ``faults``), shared by CFL and FedAvg: trains the selection's padded
    cohort on the batched engine, draws the round's faults (keyed
    ``(STREAM_SYNC, round_idx)``), sheds dropped and past-deadline clients
    at the barrier (each credited a fairness miss; sync re-selects next
    round, no retry), quarantines bad deltas (``delta_validity``) and
    applies the server step with ``sanitize=True`` over the gated
    participation (a fully shed round is a no-op step). Returns
    ``(accs, times, participants, specs_kept, stats, n_steps)`` over the
    kept clients; ``server.params`` is updated in place."""
    from repro_torch.core.aggregate import aggregate_apply, delta_validity
    fl = server.fl
    engine = server.engine
    if engine is None:
        raise ValueError("fault injection requires the batched engine "
                         "(batched_rounds=True)")
    plan = resolve_fault_plan(fl.faults)
    dev = engine.device
    m = len(sel.idx)
    specs_pad = list(specs) + [specs[0]] * (m - len(specs))
    seeds = [server._client_seed(int(i)) for i in sel.idx]
    theta0 = engine.broadcast_params(server.params, m)
    res = engine.train_cohort(
        theta0, specs_pad, server.client_data, batch_size=fl.batch_size,
        epochs=fl.local_epochs, seeds=seeds,
        eval_datasets=server.test_data, participation=sel,
        prefetch_hook=server._stage_next_round)
    covs = res.masks.param_mask if fl.coverage_norm else None
    deltas = res.deltas

    participants = [int(i) for i in sel.participants]
    valid_slots = np.flatnonzero(sel.valid > 0)
    n_steps_valid = [int(n) for n in sel.take_valid(res.n_steps)]
    times_valid = server._simulated_times(specs, n_steps_valid,
                                          participants)
    times = np.zeros((m,), np.float64)
    times[valid_slots] = times_valid

    kept = sel.valid > 0
    dropped_ids: list = []
    if plan is not None and plan.any_rates():
        gf = plan.draw(STREAM_SYNC, server.round_idx, m, 1)
        if gf.corrupt.any():
            codes, scales = gf.codes_scales(plan.outlier_scale, dev)
            deltas = inject_deltas(deltas, codes, scales)
        # the deadline comes from the clean predicted times, *then* the
        # stragglers inflate: a straggler gets no extra rope
        df = fl.deadline_factor if fl.deadline_factor is not None else 4.0
        deadline = df * max(float(np.median(times_valid)), 1e-9) \
            if len(times_valid) else 0.0
        straggle = gf.straggle & (sel.valid > 0)
        times[straggle] *= plan.straggle_factor
        fail = (gf.drop | (times > deadline)) & (sel.valid > 0)
        kept = kept & ~fail
        dropped_ids = [int(sel.idx[s]) for s in np.flatnonzero(fail)]

    part_np = np.asarray(sel.valid * kept, np.float32)
    with torch.no_grad():
        gatev, _ = delta_validity(deltas, torch.as_tensor(part_np,
                                                          device=dev),
                                  float(fl.norm_clip_factor))
        gv = gatev.cpu().numpy()
        quar_slots = np.flatnonzero((part_np > 0) & (gv == 0))
        part = torch.as_tensor(part_np * gv.astype(np.float32), device=dev)
        weights = torch.as_tensor(np.asarray(sel.weights, np.float32),
                                  device=dev)
        server.params = aggregate_apply(
            server.params, deltas, covs, weights,
            coverage_norm=fl.coverage_norm, participation=part,
            sanitize=True)

    quarantined_ids = [int(sel.idx[s]) for s in quar_slots]
    server.tracker.record_miss(dropped_ids)
    server.tracker.record_miss(quarantined_ids)
    kept_slots = np.flatnonzero(kept)
    accs = [float(res.accs[s]) for s in kept_slots]
    kept_times = [float(times[s]) for s in kept_slots]
    kept_ids = [int(sel.idx[s]) for s in kept_slots]
    specs_kept = [specs_pad[s] for s in kept_slots]
    n_steps = [int(res.n_steps[s]) for s in kept_slots]
    server.tracker.record(kept_ids, accs)
    stats = {"dropped": len(dropped_ids), "retried": 0,
             "quarantined": len(quar_slots),
             "quorum_waited_ms": (max(kept_times) if kept_times else 0.0)
             * 1e3}
    return accs, kept_times, kept_ids, specs_kept, stats, n_steps


def resolve_fault_plan(spec) -> Optional[FaultPlan]:
    """A config value as a FaultPlan: None / False → None, a FaultPlan →
    itself, a dict → ``FaultPlan(**dict)``, a number → its drop rate, a
    string → the ``"drop=0.2,straggle=0.1,corrupt=0.05,kill=0.1,seed=3"``
    shorthand."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, FaultPlan):
        return spec
    if isinstance(spec, dict):
        return FaultPlan(**spec)
    if isinstance(spec, (int, float)) and not isinstance(spec, bool):
        return FaultPlan(drop_rate=float(spec))
    if isinstance(spec, str):
        alias = {"drop": "drop_rate", "straggle": "straggle_rate",
                 "corrupt": "corrupt_rate", "kill": "shard_kill_rate",
                 "seed": "seed", "outlier": "outlier_scale",
                 "factor": "straggle_factor"}
        kwargs = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad --faults token {part!r}; expected "
                                 f"key=value with keys {sorted(alias)}")
            k, v = part.split("=", 1)
            k = alias.get(k.strip(), k.strip())
            kwargs[k] = int(v) if k == "seed" else float(v)
        return FaultPlan(**kwargs)
    raise TypeError(f"faults must be None, a FaultPlan, dict, number or "
                    f"string, got {type(spec).__name__}")
