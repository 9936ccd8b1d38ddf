"""Round-granular fleet checkpoints — the port of the reference's
``checkpoint/fleet.py``: kill a training process at any applied server
step and resume **bit-exact** against the uninterrupted run, in
``mode="sync"`` and ``mode="async"`` alike.

What a snapshot holds (everything whose loss would fork the replay):

* the server's parameters and round counter, its ``history`` and the sync
  path's simulated clock;
* the tracker's :class:`~repro_torch.fl.selection.FleetArrays`
  (participation counts, last accuracies, staleness and pending flags,
  miss counts). The cohort RNG needs no snapshot: round r always draws
  from ``SeedSequence(entropy=seed, spawn_key=(r,))``, the fault schedule
  is a pure function of ``(plan.seed, engagement id)``, the search of
  ``seed + round``, the local streams of ``_client_seed(k, round)`` — the
  determinism is derivational, not stateful;
* CFL's accuracy predictor (``AccuracyPredictor.state_snapshot``);
* the async runtime's whole machine (``FleetRuntime.state_snapshot``);
* the prefetch ring's derivation (``prefetch_snapshot``: round, seeds,
  selection triple — never its tensors; a restore re-stages them).

Every tensor goes to the file as host numpy (``checkpoint.io.save_state``)
and comes back where the port keeps it: the parameters and the runtime's
deltas on the server's device, the fleet columns on the CPU, the
predictor on its own device.

A cohort-sharded run (``sharding.cohort``) snapshots on every rank alike:
the in-flight groups' deltas are gathered from every rank's block, and
rank 0 writes the same single file an unsharded run writes (atomically,
as ``save_state`` does) while the others wait at a barrier. A restore on
the same topology takes each rank's block back and resumes bit for bit.

The degraded path — **reshard and rewind**: a snapshot taken on another
device count (``n_devices``: the process group's world size, 1 without a
group — the reference's ``len(jax.devices())``) or cohort-shard count
cannot replay its in-flight groups bit for bit, so the restore drops them,
clears those clients' pending flags and restarts the event loop from the
last aggregate; the durable state (parameters, fleet columns, history)
survives. ``restore_fleet_checkpoint`` says which path it took.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import (_to_device, _to_host, load_state,
                                       save_state)
from repro_torch.configs.base import config_fingerprint
from repro_torch.sharding.cohort import barrier, group_ready

FORMAT_VERSION = 1


def _n_devices(server) -> int:
    """The devices the server's cohort runs on: the process group's world
    size, 1 without a group."""
    del server
    return dist.get_world_size() if group_ready() else 1


def snapshot_server(server) -> Dict:
    """Snapshot a CFL or FedAvg server (and its runtime, when built) as a
    picklable host dict. Sharded, every rank must call it (the in-flight
    deltas are gathered) and every rank gets the same snapshot."""
    arrays = server.tracker.arrays
    runtime = server._runtime
    predictor = getattr(server, "predictor", None)
    return {
        "format_version": FORMAT_VERSION,
        "round_idx": int(server.round_idx),
        "sim_clock": float(server._sim_clock),
        "mode": server.fl.mode,
        "params": _to_host(server.params),
        "history": list(server.history),
        "fleet_arrays": _to_host({f.name: getattr(arrays, f.name)
                                  for f in dataclasses.fields(arrays)}),
        "predictor": None if predictor is None
        else predictor.state_snapshot(),
        "runtime": None if runtime is None else runtime.state_snapshot(),
        "prefetch": None if server.engine is None
        else server.engine.prefetch_snapshot(),
        # identity and topology: another architecture is an error, another
        # shard or device count the reshard-and-rewind path
        "family": config_fingerprint(server.cfg),
        "cohort_shards": int(server.fl.cohort_shards),
        "n_devices": _n_devices(server),
        "n_clients": len(server.clients),
    }


def save_fleet_checkpoint(path: str, server, metadata: Dict = None) -> None:
    """Write a resumable snapshot of ``server`` to ``path`` (atomically),
    with a ``.meta.json`` naming its round and mode. In a process group
    every rank calls it: rank 0 writes, and all ranks meet at a barrier
    after the write."""
    meta = {"round_idx": int(server.round_idx), "mode": server.fl.mode,
            "format_version": FORMAT_VERSION}
    if metadata:
        meta.update(metadata)
    snap = snapshot_server(server)
    if not group_ready() or dist.get_rank() == 0:
        save_state(path, snap, metadata=meta)
    sh = None if server.engine is None else \
        server.engine.cohort_sharding(len(server.clients))
    barrier(None if sh is None else sh.mesh)


def restore_server(server, snap: Dict) -> Dict:
    """Load a snapshot into a freshly built server (same family, fleet and
    config as the saver's). Returns ``{"round_idx", "resharded",
    "dropped_in_flight"}``: ``resharded`` True means the shard or device
    topology changed and the in-flight work was dropped, not replayed (a
    bit-exact resume needs False)."""
    from repro_torch.fl.selection import FleetArrays
    if snap.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"fleet checkpoint format {snap.get('format_version')} != "
            f"supported {FORMAT_VERSION}")
    if snap["family"] != config_fingerprint(server.cfg):
        raise ValueError(
            "checkpoint was written for a different architecture: "
            f"{snap['family'][:80]}... vs this server's "
            f"{config_fingerprint(server.cfg)[:80]}...")
    if snap["n_clients"] != len(server.clients):
        raise ValueError(
            f"checkpoint is for a {snap['n_clients']}-client fleet; this "
            f"server has {len(server.clients)} — fleet membership must "
            f"match (elastic membership is a tracker.set_fleet concern, "
            f"not a restore concern)")
    server.params = _to_device(snap["params"], server.device)
    server.round_idx = int(snap["round_idx"])
    server._sim_clock = float(snap["sim_clock"])
    server.history = list(snap["history"])
    # the fleet columns live on the CPU (the tracker's own home)
    server.tracker.arrays = FleetArrays(**_to_device(snap["fleet_arrays"],
                                                     "cpu"))
    predictor = getattr(server, "predictor", None)
    if predictor is not None and snap["predictor"] is not None:
        predictor.load_state(snap["predictor"])

    resharded = (int(snap["cohort_shards"]) != int(server.fl.cohort_shards)
                 or int(snap["n_devices"]) != _n_devices(server))
    dropped: list = []
    rt_snap = snap["runtime"]
    if rt_snap is not None and not resharded:
        server.runtime.load_state(rt_snap)
    elif rt_snap is not None:
        # reshard + rewind: the in-flight deltas were made under another
        # topology — drop them, free their clients, restart the event loop
        # from the last aggregate
        for gs in rt_snap["groups"].values():
            idx, valid, _ = gs["sel"]
            live = ~(np.asarray(gs["consumed"]) | np.asarray(gs["failed"])) \
                & (np.asarray(valid) > 0)
            dropped.extend(int(i) for i in np.asarray(idx)[live])
        dropped.extend(int(c) for c in rt_snap["in_backoff"])
        a = server.tracker.arrays
        server.tracker.arrays = dataclasses.replace(
            a, pending=torch.zeros_like(a.pending),
            staleness=torch.zeros_like(a.staleness))
        rt = server.runtime          # a fresh machine, a clean heap
        rt.clock = float(rt_snap["clock"])
        rt._events = []
        rt._push(rt.clock, "dispatch", ())
    engine = server.engine
    if engine is not None:
        if resharded:
            # staged inputs were packed for another topology: drop them
            engine.flush_prefetch("restore-resharded")
            engine.enable_prefetch(
                int((snap.get("prefetch") or {}).get("depth", 0)))
        else:
            engine.prefetch_restore(snap.get("prefetch") or {},
                                    server.client_data, server.test_data)
    return {"round_idx": server.round_idx, "resharded": resharded,
            "dropped_in_flight": sorted(set(dropped))}


def restore_fleet_checkpoint(path: str, server) -> Dict:
    """Read ``path`` and load it into ``server`` (:func:`restore_server`)."""
    return restore_server(server, load_state(path))
