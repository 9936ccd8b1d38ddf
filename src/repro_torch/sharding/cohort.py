"""Cohort-axis sharding over a ``torch.distributed`` group — the port of the
reference's ``sharding/cohort.py``.

The engine stacks every per-client tensor on a leading client axis (K,
...). Clients are independent until the aggregate, so the axis splits over
processes with one collective a round. The reference is single-controller
(one process, a ``P('cohort')`` array over the devices of a mesh); the port
is SPMD in PyTorch's idiom:

* one process a card, started by ``torchrun`` (``init_cohort_group``) or,
  for tests and the chip check, by ``spawn_cohort``;
* the server's host state (fleet, selection, search, predictor, LUT,
  history) replicated on every rank and computed identically there;
* rank r of an s-way split holding the contiguous block ``[r·K/s,
  (r+1)·K/s)`` of the stacked client axis — the block ``P('cohort')`` gives
  device r. Ranks at or past s (``effective_cohort_shards`` may give fewer
  shards than ranks) hold an empty block and still join every collective;
* every collective on the default (world) group: no per-round
  ``new_group``, which would itself be collective.

The backend is ``nccl`` on the card and ``gloo`` on the CPU. NCCL cannot
put two ranks on one card, so a group of more ranks than cards needs
``backend="gloo"`` given explicitly; nothing here picks it by itself.
"""
from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.optimizers import tree_map


def group_ready() -> bool:
    """Whether the default process group is initialised."""
    return dist.is_available() and dist.is_initialized()


@dataclasses.dataclass(frozen=True)
class CohortMesh:
    """A 1-D ``cohort`` mesh: the first ``n_shards`` ranks of the default
    group hold a block each; ``device`` is where this rank trains, and
    ``comm_device`` where its collectives' buffers live (the card under
    NCCL, the host under gloo)."""
    rank: int
    world: int
    n_shards: int
    device: torch.device
    backend: str
    group: Optional[object] = None      # None: the default group

    @property
    def comm_device(self) -> torch.device:
        return self.device if self.backend == "nccl" else torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class CohortSharding:
    """The leading (client) axis over the mesh's shards; trailing dims
    replicated — the counterpart of the reference's
    ``NamedSharding(mesh, P('cohort'))``."""
    mesh: CohortMesh

    def block(self, n: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of a stacked axis of ``n`` slots (empty
        past the shard count)."""
        s = self.mesh.n_shards
        if n % s:
            raise ValueError(f"{n} slots do not split into {s} shards")
        r = self.mesh.rank
        if r >= s:
            return n, n
        per = n // s
        return r * per, (r + 1) * per


def cohort_mesh(n_shards: Optional[int] = None, *, group=None,
                device=None) -> CohortMesh:
    """The mesh over the first ``n_shards`` ranks (default: all) of the
    initialised process group; ``device`` this rank's (default: its current
    card). Raises without a group, or for more shards than ranks."""
    if not group_ready():
        raise RuntimeError("cohort_mesh needs an initialised process group: "
                           "call init_cohort_group() (torchrun) or run "
                           "under spawn_cohort")
    world = dist.get_world_size(group)
    n = int(n_shards or world)
    if not 0 < n <= world:
        raise ValueError(f"cohort_mesh: {n} shards > {world} ranks")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = dist.get_backend(group)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL group runs on the card: use gloo for a "
                         "cohort on the CPU")
    return CohortMesh(rank=dist.get_rank(group), world=world, n_shards=n,
                      device=device, backend=backend, group=group)


def cohort_axis_sharding(mesh: CohortMesh) -> CohortSharding:
    """Leading (client) axis over 'cohort'; all trailing dims replicated."""
    return CohortSharding(mesh)


def effective_cohort_shards(n_clients: int, requested: int,
                            n_devices: Optional[int] = None) -> int:
    """Largest shard count ≤ requested (and ≤ the rank count) that divides
    the cohort, so every block is rectangular. ``n_devices`` defaults to
    the default group's world size, or 1 when no group is initialised (the
    reference's clamp to its device count)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if group_ready() else 1
    cap = max(1, min(int(requested), int(n_devices), int(n_clients)))
    for s in range(cap, 0, -1):
        if n_clients % s == 0:
            return s
    return 1


def shard_cohort(tree, sharding: Optional[CohortSharding],
                 n: Optional[int] = None):
    """This rank's block of every stacked leaf of an ``n``-slot cohort
    (``n`` defaults to each leaf's leading size), as views (numpy arrays or
    tensors); the tree itself when ``sharding`` is None. A leaf that
    already stacks just the block — a sharded call's result carried into
    the next call, as IL carries its trained clients — passes unchanged, as
    the reference's already-committed leaves do; any other leading size
    raises."""
    if sharding is None:
        return tree

    def leaf(a):
        k = a.shape[0] if n is None else n
        lo, hi = sharding.block(k)
        if a.shape[0] == k:
            return a[lo:hi]
        if a.shape[0] == hi - lo:
            return a
        raise ValueError(f"a stacked leaf of {a.shape[0]} slots fits "
                         f"neither the cohort ({k}) nor its block "
                         f"[{lo}, {hi})")
    return tree_map(leaf, tree)


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh: CohortMesh
                    ) -> list:
    """Sum each tensor over the mesh's group with ONE ``all_reduce``: the
    tensors (one dtype) are packed into a flat buffer on the mesh's
    ``comm_device``, reduced, and split back on their own device."""
    if not tensors:
        return []
    dev = tensors[0].device
    flat = torch.cat([t.reshape(-1) for t in tensors]).to(mesh.comm_device)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    flat = flat.to(dev)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def all_gather_slots(columns, n: int, sharding: CohortSharding) -> list:
    """The whole cohort's per-slot columns from every rank's block: each
    of ``columns`` is a 1-D array of this rank's ``hi - lo`` slots; ONE
    ``all_gather`` of a (K/s, len(columns)) float64 block (an empty block
    sends zeros) returns each column over all ``n`` slots, as float64
    numpy arrays, on every rank."""
    mesh = sharding.mesh
    lo, hi = sharding.block(n)
    per = n // mesh.n_shards
    buf = torch.zeros((per, len(columns)), dtype=torch.float64)
    for j, c in enumerate(columns):
        buf[:hi - lo, j] = torch.as_tensor(c, dtype=torch.float64)
    buf = buf.to(mesh.comm_device)
    parts = [torch.empty_like(buf) for _ in range(mesh.world)]
    dist.all_gather(parts, buf, group=mesh.group)
    full = torch.cat(parts[:mesh.n_shards]).cpu().numpy()
    return [full[:, j] for j in range(len(columns))]


def barrier(mesh: Optional[CohortMesh] = None) -> None:
    """All ranks meet (a no-op without a group)."""
    if group_ready():
        if mesh is not None and mesh.backend == "nccl":
            dist.barrier(group=mesh.group,
                         device_ids=[mesh.device.index])
        else:
            dist.barrier(group=None if mesh is None else mesh.group)


def _bind_card(local_rank: int, world: int, backend: str) -> None:
    """Set this rank's current card; NCCL needs a card a rank."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' (gloo) to run "
                           "a cohort group on the CPU")
    if world > count and backend != "gloo":
        raise RuntimeError(
            f"{world} ranks on {count} card(s): NCCL cannot put two ranks "
            f"on one card; pass backend='gloo' explicitly to share it")
    torch.cuda.set_device(local_rank % count)


def init_cohort_group(backend: Optional[str] = None, device=None) -> None:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and its rendezvous, ``env://``). On the
    card (``device`` None or cuda) the backend is ``nccl`` and each rank
    takes card ``LOCAL_RANK``; more ranks than cards raise unless
    ``backend="gloo"`` is given. ``device="cpu"`` uses gloo."""
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if not on_cpu:
        _bind_card(local, world, backend)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)


def _rank_main(rank: int, world: int, backend: str, device: str,
               store_path: str, fn: Callable, args: tuple, results) -> None:
    try:
        if torch.device(device).type == "cuda":
            _bind_card(rank, world, backend)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:       # reported before the group goes down
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_cohort(fn: Callable, world_size: int, *, backend: str,
                 device: str, args: Sequence = (),
                 timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` on ``world_size`` new processes (the spawn
    context) joined in one group through a ``FileStore`` in a temporary
    directory, so no port is opened; returns each rank's result in rank
    order. ``fn`` must be importable by name (a module's top level) and its
    result picklable. A rank that raises, dies or outlasts ``timeout``
    seconds fails the call (the other ranks are stopped)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="cohort_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, backend, str(device),
                               os.path.join(tmp, "store"), fn, tuple(args),
                               results))
             for r in range(world_size)]
    out, failed, started = {}, [], []
    try:
        for p in procs:
            p.start()
            started.append(p)
        deadline = time.monotonic() + timeout
        while len(out) + len(failed) < world_size:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in out]
                if dead and results.empty():
                    time.sleep(1.0)       # a last message may be in flight
                    if results.empty():   # the others would wait forever
                        failed += [(r, f"rank {r} exited with code "
                                    f"{procs[r].exitcode} and no result")
                                   for r in dead]
                        break
                if time.monotonic() > deadline:
                    failed.append((-1, f"cohort of {world_size} ranks did "
                                   f"not finish within {timeout} s"))
                    break
                continue
            if ok:
                out[rank] = val
            else:
                failed.append((rank, val))
                break
        if failed:              # the other ranks' reports, and the dead
            try:
                while True:
                    rank, ok, val = results.get(timeout=0.5)
                    if not ok:
                        failed.append((rank, val))
            except queue_mod.Empty:
                pass
            told = {r for r, _ in failed}
            failed = [(r, f"rank {r} exited with code {p.exitcode} and no "
                       f"result") for r, p in enumerate(procs)
                      if r not in out and r not in told
                      and p.exitcode is not None] + failed
    finally:
        for p in started:
            p.join(timeout=0 if failed else 30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise RuntimeError("cohort rank failed:\n" + "\n".join(
            f"--- rank {r} ---\n{msg}" for r, msg in failed))
    return [out[r] for r in range(world_size)]
