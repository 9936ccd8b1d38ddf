"""The 2-D ``("data", "model")`` mesh over the ranks of a
``torch.distributed`` group — the port of the reference's host mesh
(``launch/mesh.py`` ``make_host_mesh``) for the model axis.

The reference is single-controller: one process, a ``jax.make_mesh((n //
m, m), ("data", "model"))`` over its devices, and GSPMD or ``shard_map``
placing every array. The port is SPMD: one process a card, the same group
as the cohort axis (``sharding.cohort``: ``init_cohort_group`` under
``torchrun``, ``spawn_cohort`` for tests and the chip check). Rank ``i``
of a world of ``n`` sits at ``(i // m, i % m)``, the device order of
``jax.make_mesh``; its *model row* is the ``m`` ranks with its data index,
its *data column* the ``n // m`` ranks with its model index. Each gets one
``dist.new_group``, made alike on every rank (group creation is itself
collective).

A sharded dim of ``n`` splits into blocks of ``ceil(n / size)`` (the last
shorter), the port's counterpart of GSPMD's padding for a dim that is not
a multiple of the axis (``specs._div``); ``unit`` keeps whole units (an
SSD head's ``P`` dims of ``d_inner``) in one block. A dim the rules leave
replicated is one whole block on every rank.

Without a process group the mesh is ``(1, 1)``: every block is the whole
dim and no collective is issued, so a model run on it is the unsharded
model to the bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def _div(n: int, size: int) -> bool:
    """Shardable: divisible, or at least 8x the axis (the reference's
    rule, where GSPMD pads the remainder)."""
    return size > 0 and (n % size == 0 or n >= 8 * size)


def split(n: int, parts: int, index: int) -> Tuple[int, int]:
    """Block ``index`` of ``n`` split into ``parts`` blocks of
    ``ceil(n / parts)`` (the last shorter, or empty): ``[lo, hi)``."""
    per = -(-n // parts)
    lo = min(index * per, n)
    return lo, min(lo + per, n)


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """This rank's place in a ``(data, model)`` mesh: the axis sizes, its
    coordinates, the groups of its model row and data column (None where
    the axis has size 1), ``device`` where it computes and ``backend`` its
    group's (None without a group)."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    device: torch.device
    backend: Optional[str] = None
    model_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return {"data": self.data, "model": self.model}

    @property
    def comm_device(self) -> torch.device:
        """Where a collective's buffers live: the card under NCCL, the host
        under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def _axis(self, axis: str):
        if axis == "model":
            return self.model, self.model_rank, self.model_group
        if axis == "data":
            return self.data, self.data_rank, self.data_group
        raise ValueError(axis)

    def sharded(self, n: int, axis: str = "model") -> bool:
        """Whether a dim of ``n`` splits over ``axis`` (``_div``); always
        False on an axis of size 1."""
        size = self._axis(axis)[0]
        return size > 1 and _div(n, size)

    def block(self, n: int, axis: str = "model",
              unit: int = 1) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of a dim of ``n`` over ``axis``: the
        whole dim where it is not sharded, else its block of ``ceil`` whole
        ``unit``s."""
        size, r, _ = self._axis(axis)
        if not self.sharded(n, axis):
            return 0, n
        lo, hi = split(n // unit, size, r)
        return lo * unit, hi * unit

    def all_reduce(self, t: torch.Tensor, axis: str = "model"
                   ) -> torch.Tensor:
        """The sum of ``t`` over ``axis`` (``t`` itself on an axis of size
        1), on ``t``'s device."""
        size, _, group = self._axis(axis)
        if size == 1:
            return t
        buf = t.contiguous().to(self.comm_device)
        if buf is t:
            buf = buf.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, dim: int, n: int,
                   axis: str = "model") -> torch.Tensor:
        """The whole dim ``dim`` (of ``n``) from every rank's block of it
        over ``axis`` — ``t`` itself where the dim is not sharded. Blocks
        are padded to the longest for one ``all_gather`` and trimmed."""
        size, _, group = self._axis(axis)
        if not self.sharded(n, axis):
            return t
        per = -(-n // size)
        x = t.movedim(dim, 0)
        if x.shape[0] < per:
            x = torch.cat([x, x.new_zeros((per - x.shape[0],) + x.shape[1:])])
        x = x.contiguous().to(self.comm_device)
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        full = torch.cat([p[:hi - lo] for p, (lo, hi) in zip(
            parts, (split(n, size, i) for i in range(size)))])
        return full.to(t.device).movedim(0, dim)


def make_host_mesh(model: int = 1, *, device=None) -> HostMesh:
    """The ``(n // model, model)`` ``("data", "model")`` mesh over the
    ``n`` ranks of the initialised default group (``init_cohort_group``
    under ``torchrun``, or ``spawn_cohort``), one process a card; ``model``
    must divide ``n``. ``(1, 1)`` without a group (``model`` must then be
    1), issuing no collective. ``device``: where this rank computes
    (default its current card; ``"cpu"`` under gloo)."""
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.sharding.cohort import group_ready
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    model = int(model)
    if not group_ready():
        if model != 1:
            raise RuntimeError(f"a model axis of {model} needs an "
                               "initialised process group: call "
                               "init_cohort_group() (torchrun) or run under "
                               "spawn_cohort")
        return HostMesh(1, 1, 0, 0, device)
    n, rank = dist.get_world_size(), dist.get_rank()
    if model < 1 or n % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"{n} ranks")
    backend = dist.get_backend()
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL group runs on the card: use gloo for a "
                         "mesh on the CPU")
    data = n // model
    rows = [list(range(i * model, (i + 1) * model)) for i in range(data)]
    cols = [list(range(j, n, model)) for j in range(model)]
    model_group = data_group = None
    if model > 1:              # every rank makes every group, in one order
        for ranks in rows:
            g = dist.new_group(ranks)
            if rank in ranks:
                model_group = g
    if data > 1:
        for ranks in cols:
            g = dist.new_group(ranks)
            if rank in ranks:
                data_group = g
    return HostMesh(data, model, rank // model, rank % model, device,
                    backend, model_group, data_group)
