"""Client selection for FL rounds — the port of the reference's
``fl/selection.py``.

Only a subset of a fleet trains in a round, and which subset drives the
fairness / efficiency trade-off the paper targets. A policy's
``select(state, rng)`` returns a :class:`Selection`: a fixed-size padded
cohort — ``idx`` (M,) fleet indices, ``valid`` (M,) 0/1 flags and
aggregation ``weights`` (M,) summing to the participating mass. M is
constant across rounds for a policy and fleet, so the engine's tensor
shapes never churn with the subset.

Policies (``SELECTION_POLICIES`` / ``resolve_policy``):

``full``     every client, every round (the paper's regime, the default);
``uniform``  m of K without replacement, weights n_k;
``fairness`` loss-proportional sampling with participation debt (missed
             engagements count as owed rounds), and GIFAIR-style
             quality-group reweighting of the aggregation weights;
``latency``  deadline-aware: predicted stragglers past the deadline
             quantile are dropped.

Two paths give a cohort. The numpy path (``select``) draws from a
``RandomState`` seeded per round (``np.random.SeedSequence(entropy=seed,
spawn_key=(r,))``, or the reference's ``"legacy"`` mixing) and gives the
reference's very ``Selection`` for the same state and seed. The device
path (``select_arrays``, the tracker's default for fleets of at least
``DEVICE_SELECT_THRESHOLD``) scores the (K,) tensor columns of
:class:`FleetArrays` and draws by gumbel-top-k from a ``torch.Generator``
seeded from the same SeedSequence; the reference draws it with
``jax.random``, which torch cannot reproduce, so there the scores and
weights are the reference's and the draw is the port's own.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Type, Union

import numpy as np
import torch

from repro_torch.fl.client import ClientInfo

# fleets at least this large select on the device path (Python loops over
# ClientInfo don't survive K = 10^5)
DEVICE_SELECT_THRESHOLD = 4096


# ---------------------------------------------------------------------------
# state the server maintains for the policies
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FleetArrays:
    """Fleet state as one (K,) tensor per column: the backbone of
    :class:`FleetTracker` (on the CPU) and the device path's input (moved
    by :meth:`to`).
    ``predicted_times`` is NaN where never predicted, ``last_accs`` NaN
    where the client never participated; ``staleness[k]`` counts server
    versions since client k's in-flight delta was dispatched,
    ``pending[k]`` flags a dispatched delta not yet aggregated, and
    ``miss_counts[k]`` its failed engagements (drop, deadline miss,
    quarantine)."""
    n_samples: torch.Tensor             # (K,) float32
    quality: torch.Tensor               # (K,) int32
    last_accs: torch.Tensor             # (K,) float32, NaN = never seen
    participation_counts: torch.Tensor  # (K,) int32
    predicted_times: torch.Tensor       # (K,) float32, NaN = not predicted
    staleness: torch.Tensor             # (K,) int32
    pending: torch.Tensor               # (K,) float32 0/1
    miss_counts: Optional[torch.Tensor] = None   # (K,) int32

    def misses(self) -> torch.Tensor:
        """(K,) float32 failure-miss counts (0 when never recorded)."""
        if self.miss_counts is None:
            return torch.zeros_like(self.n_samples)
        return self.miss_counts.to(torch.float32)

    @property
    def n_clients(self) -> int:
        return int(self.n_samples.shape[0])

    @classmethod
    def from_clients(cls, clients: Sequence[ClientInfo],
                     device=None) -> "FleetArrays":
        k = len(clients)

        def full(v, dtype):
            return torch.full((k,), v, dtype=dtype, device=device)
        return cls(
            n_samples=torch.as_tensor([c.n_samples for c in clients],
                                      dtype=torch.float32, device=device),
            quality=torch.as_tensor([c.quality for c in clients],
                                    dtype=torch.int32, device=device),
            last_accs=full(float("nan"), torch.float32),
            participation_counts=full(0, torch.int32),
            predicted_times=full(float("nan"), torch.float32),
            staleness=full(0, torch.int32),
            pending=full(0.0, torch.float32),
            miss_counts=full(0, torch.int32))

    def to(self, device) -> "FleetArrays":
        """The same columns on ``device``."""
        return dataclasses.replace(self, **{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})

    def lossiness(self) -> torch.Tensor:
        """1 − last_acc, never-seen clients pinned to 1.0 (the maximum)."""
        loss = 1.0 - self.last_accs
        return torch.where(torch.isnan(loss), torch.ones_like(loss),
                           torch.clamp(loss, 0.0, 1.0))


@dataclasses.dataclass
class FleetState:
    """What a policy may look at when picking a round's cohort:
    ``last_accs[k]`` client k's local-test accuracy from its latest round
    (NaN if it never participated: maximally lossy, which doubles as
    exploration), ``participation_counts[k]`` its rounds, and
    ``predicted_times[k]`` the server's full-model round-time estimate
    (None when not asked for); ``staleness`` / ``pending`` / ``misses``
    mirror the :class:`FleetArrays` columns. ``clients`` may be None for
    an array-backed state: pass ``n_samples_arr`` / ``qualities_arr``."""
    clients: Optional[List[ClientInfo]]
    round_idx: int
    last_accs: np.ndarray
    participation_counts: np.ndarray
    predicted_times: Optional[np.ndarray] = None
    staleness: Optional[np.ndarray] = None
    pending: Optional[np.ndarray] = None
    n_samples_arr: Optional[np.ndarray] = None
    qualities_arr: Optional[np.ndarray] = None
    misses: Optional[np.ndarray] = None

    @property
    def n_clients(self) -> int:
        return len(self.clients) if self.clients is not None \
            else len(self.last_accs)

    @property
    def n_samples(self) -> np.ndarray:
        if self.n_samples_arr is not None:
            return np.asarray(self.n_samples_arr, np.float64)
        return np.asarray([c.n_samples for c in self.clients], np.float64)

    @property
    def qualities(self) -> np.ndarray:
        if self.qualities_arr is not None:
            return np.asarray(self.qualities_arr)
        return np.asarray([c.quality for c in self.clients])

    def lossiness(self) -> np.ndarray:
        """1 − last_acc, never-seen clients pinned to 1.0 (the maximum)."""
        loss = 1.0 - np.asarray(self.last_accs, np.float64)
        return np.where(np.isnan(loss), 1.0, np.clip(loss, 0.0, 1.0))


@dataclasses.dataclass
class Selection:
    """A fixed-size padded cohort for one round: ``idx`` (M,) int32 fleet
    indices (padding slots repeat a valid index), ``valid`` (M,) float32
    1/0 flags (0 = padding: no training, no aggregation weight),
    ``weights`` (M,) float32 aggregation weights, 0 on padding slots and
    summing to the participating mass."""
    idx: np.ndarray
    valid: np.ndarray
    weights: np.ndarray

    @property
    def participants(self) -> np.ndarray:
        """Fleet indices of the real (non-padding) cohort members."""
        return self.idx[self.valid > 0]

    def take_valid(self, values: Sequence) -> List:
        """Filter a per-slot sequence down to the real cohort members."""
        return [v for v, f in zip(values, self.valid) if f > 0]

    def __post_init__(self):
        self.idx = np.asarray(self.idx, np.int32)
        self.valid = np.asarray(self.valid, np.float32)
        self.weights = np.asarray(self.weights, np.float32)
        if not (self.idx.shape == self.valid.shape == self.weights.shape):
            raise ValueError("idx/valid/weights must share shape (M,)")


def _pad_selection(chosen: Sequence[int], weights: Sequence[float],
                   m_pad: int) -> Selection:
    """Pad a chosen cohort out to the policy's fixed size ``m_pad``."""
    chosen = list(chosen)
    if not chosen:
        raise ValueError("a selection must keep at least one client")
    idx = np.asarray(chosen + [chosen[0]] * (m_pad - len(chosen)), np.int32)
    valid = np.zeros((m_pad,), np.float32)
    valid[:len(chosen)] = 1.0
    w = np.zeros((m_pad,), np.float32)
    w[:len(chosen)] = np.asarray(weights, np.float32)
    return Selection(idx, valid, w)


def _mass_normalised(raw: np.ndarray, n_samples: np.ndarray) -> np.ndarray:
    """Rescale raw weights to sum to the participating mass Σ n_k."""
    total = float(np.sum(n_samples))
    return raw * (total / max(float(np.sum(raw)), 1e-12))


# ---------------------------------------------------------------------------
# the protocol and the policies
# ---------------------------------------------------------------------------
class SelectionPolicy:
    """Protocol: ``select(state, rng) -> Selection`` with a padded size
    ``cohort_size(K)`` constant across rounds; ``fraction`` is the
    participating share of the fleet.

    The device surface: ``scores(arrays, round_idx)`` (K,) unnormalised
    sampling scores as tensor ops over :class:`FleetArrays`, and
    ``select_arrays(arrays, round_idx, generator)`` the cohort drawn by
    gumbel-top-k (weighted sampling without replacement).

    ``state_dependent``: whether round r+1's draw depends on what round r
    records. Only a policy that says False lets the prefetch ring stage
    the next cohort early (``fl.engine``); an unknown policy says True."""

    name = "abstract"
    state_dependent = True

    def __init__(self, fraction: float = 0.5):
        if not (0.0 < fraction <= 1.0):
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        self.fraction = float(fraction)

    def cohort_size(self, n_clients: int) -> int:
        """Fixed padded cohort size M for this fleet (≥ 1)."""
        return max(1, int(round(self.fraction * n_clients)))

    def select(self, state: FleetState,
               rng: np.random.RandomState) -> Selection:
        raise NotImplementedError

    # -- device surface ---------------------------------------------------
    def scores(self, arrays: FleetArrays, round_idx) -> torch.Tensor:
        """(K,) sampling scores as tensor ops."""
        raise NotImplementedError(
            f"policy {self.name!r} has no vectorized scores()")

    def _array_weights(self, arrays: FleetArrays, idx, w):
        """Per-slot aggregation weights on the device path (default n_k,
        unbiased FedAvg weighting)."""
        return w

    def select_arrays(self, arrays: FleetArrays, round_idx: int,
                      generator: torch.Generator) -> Selection:
        """Device-path selection: scores, gumbel-top-k with
        ``generator`` (on the arrays' device), weights. Returns the
        padded :class:`Selection` contract of ``select``."""
        m = self.cohort_size(arrays.n_clients)
        with torch.no_grad():
            s = torch.clamp(self.scores(arrays, round_idx), min=1e-30)
            u = torch.rand(s.shape, generator=generator, device=s.device,
                           dtype=torch.float32)
            tiny = torch.finfo(torch.float32).tiny
            g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
            idx = torch.topk(torch.log(s) + g, m).indices
            w = self._array_weights(arrays, idx,
                                    arrays.n_samples.index_select(0, idx))
        return Selection(idx.to(torch.int32).cpu().numpy(),
                         np.ones((m,), np.float32),
                         w.to(torch.float32).cpu().numpy())


class FullParticipation(SelectionPolicy):
    """Every client, every round — the paper's regime and the default."""

    name = "full"
    state_dependent = False     # everyone, every round

    def __init__(self, fraction: float = 1.0):
        super().__init__(1.0)

    def select(self, state: FleetState,
               rng: np.random.RandomState) -> Selection:
        k = state.n_clients
        return _pad_selection(range(k), state.n_samples, k)

    def scores(self, arrays: FleetArrays, round_idx) -> torch.Tensor:
        return torch.ones_like(arrays.n_samples)

    def select_arrays(self, arrays: FleetArrays, round_idx: int,
                      generator) -> Selection:
        k = arrays.n_clients
        return Selection(np.arange(k, dtype=np.int32),
                         np.ones((k,), np.float32),
                         arrays.n_samples.cpu().numpy())


class UniformSelection(SelectionPolicy):
    """m of K without replacement; weights n_k."""

    name = "uniform"
    state_dependent = False     # a pure function of the round's RNG

    def select(self, state: FleetState,
               rng: np.random.RandomState) -> Selection:
        m = self.cohort_size(state.n_clients)
        chosen = rng.choice(state.n_clients, size=m, replace=False)
        return _pad_selection(chosen, state.n_samples[chosen], m)

    def scores(self, arrays: FleetArrays, round_idx) -> torch.Tensor:
        return torch.ones_like(arrays.n_samples)


class FairnessSelection(SelectionPolicy):
    """Loss-proportional sampling with participation debt, and GIFAIR-style
    group reweighting.

    Score ``lossiness_k + debt_gamma · debt_k`` with ``debt_k =
    max(round_idx · m/K − participation_counts[k], 0) + miss_counts[k]``;
    m clients drawn without replacement in proportion. Aggregation
    weights: clients grouped by data-quality level, each group's
    multiplier ``1 + group_beta · (group_mean_loss − mean of the group
    means)`` clipped to [0.25, 4], renormalised to the participating
    mass."""

    name = "fairness"
    # scores read last_accs, debt and misses, which change every round
    state_dependent = True
    # the device path's one-hot group table is this wide
    N_QUALITY_LEVELS = 8

    def __init__(self, fraction: float = 0.5, debt_gamma: float = 0.5,
                 group_beta: float = 1.0):
        super().__init__(fraction)
        self.debt_gamma = float(debt_gamma)
        self.group_beta = float(group_beta)

    def select(self, state: FleetState,
               rng: np.random.RandomState) -> Selection:
        k = state.n_clients
        m = self.cohort_size(k)
        loss = state.lossiness()
        expected = state.round_idx * m / k
        debt = np.maximum(expected - state.participation_counts, 0.0)
        if state.misses is not None:
            debt = debt + np.asarray(state.misses, np.float64)
        score = np.maximum(loss + self.debt_gamma * debt, 1e-6)
        probs = score / score.sum()
        chosen = rng.choice(k, size=m, replace=False, p=probs)

        quals = state.qualities[chosen]
        closs = loss[chosen]
        mult = np.ones(m, np.float64)
        group_means = {q: float(closs[quals == q].mean())
                       for q in np.unique(quals)}
        fleet_mean = float(np.mean(list(group_means.values())))
        for q, gm in group_means.items():
            mult[quals == q] = np.clip(
                1.0 + self.group_beta * (gm - fleet_mean), 0.25, 4.0)
        mass = state.n_samples[chosen]
        return _pad_selection(chosen, _mass_normalised(mass * mult, mass), m)

    def scores(self, arrays: FleetArrays, round_idx) -> torch.Tensor:
        k = arrays.n_clients
        m = self.cohort_size(k)
        loss = arrays.lossiness()
        expected = round_idx * (m / k)
        debt = torch.clamp(
            expected - arrays.participation_counts.to(torch.float32),
            min=0.0)
        debt = debt + arrays.misses()
        return torch.clamp(loss + self.debt_gamma * debt, min=1e-6)

    def _array_weights(self, arrays: FleetArrays, idx, w):
        loss = arrays.lossiness().index_select(0, idx)
        quals = arrays.quality.index_select(0, idx).long()
        levels = torch.arange(self.N_QUALITY_LEVELS, device=quals.device)
        onehot = (quals[None, :] == levels[:, None]).to(torch.float32)
        gcount = onehot.sum(1)
        present = (gcount > 0).to(torch.float32)
        gmean = (onehot @ loss) / torch.clamp(gcount, min=1.0)
        fleet_mean = torch.sum(gmean * present) / torch.clamp(
            present.sum(), min=1.0)
        gmult = torch.clamp(1.0 + self.group_beta * (gmean - fleet_mean),
                            0.25, 4.0)
        raw = w * gmult[quals]
        return raw * (torch.sum(w) / torch.clamp(torch.sum(raw), min=1e-12))

    def select_arrays(self, arrays: FleetArrays, round_idx: int,
                      generator) -> Selection:
        # an index past the (N_QUALITY_LEVELS,) group table must not pass
        # silently: the numpy path takes any quality value
        qmax = int(torch.max(arrays.quality))
        if qmax >= self.N_QUALITY_LEVELS:
            raise ValueError(
                f"fairness device path supports quality levels < "
                f"{self.N_QUALITY_LEVELS}, fleet has quality {qmax}; "
                f"raise FairnessSelection.N_QUALITY_LEVELS or use the "
                f"numpy path (device_select=False)")
        return super().select_arrays(arrays, round_idx, generator)


class LatencySelection(SelectionPolicy):
    """Deadline-aware selection: the server's full-model round-time
    predictions set the deadline at their ``deadline_q`` quantile and
    clients past it are dropped; m are drawn uniformly among the feasible
    ones, or, if too few, the fastest stragglers fill the rest. Uniform
    when the server gave no predictions."""

    name = "latency"
    # predicted_times is a cached LUT snapshot; it changes only through
    # invalidate(), which flushes the prefetch ring
    state_dependent = False

    def __init__(self, fraction: float = 0.5, deadline_q: float = 0.75):
        super().__init__(fraction)
        if not (0.0 < deadline_q <= 1.0):
            raise ValueError(f"deadline_q must be in (0, 1], got "
                             f"{deadline_q}")
        self.deadline_q = float(deadline_q)

    def select(self, state: FleetState,
               rng: np.random.RandomState) -> Selection:
        k = state.n_clients
        m = self.cohort_size(k)
        times = state.predicted_times
        if times is None:
            chosen = rng.choice(k, size=m, replace=False)
            return _pad_selection(chosen, state.n_samples[chosen], m)
        times = np.asarray(times, np.float64)
        deadline = float(np.quantile(times, self.deadline_q))
        feasible = np.flatnonzero(times <= deadline)
        if len(feasible) >= m:
            chosen = rng.choice(feasible, size=m, replace=False)
        else:
            by_speed = np.argsort(times, kind="stable")
            stragglers = by_speed[~np.isin(by_speed, feasible)]
            chosen = np.concatenate([feasible,
                                     stragglers[:m - len(feasible)]])
        return _pad_selection(chosen, state.n_samples[chosen], m)

    def scores(self, arrays: FleetArrays, round_idx) -> torch.Tensor:
        """Feasible (≤ the deadline quantile) clients score 1, predicted
        stragglers ~0; no predictions (all NaN) is uniform."""
        t = arrays.predicted_times
        known = ~torch.isnan(t)
        t_filled = torch.where(known, t, torch.full_like(t, float("inf")))
        deadline = torch.nanquantile(t, self.deadline_q)
        feasible = t_filled <= deadline
        base = torch.where(feasible, torch.ones_like(t),
                           1e-9 / (1.0 + torch.where(known, t,
                                                     torch.zeros_like(t))))
        return torch.where(torch.any(known), base, torch.ones_like(t))


SELECTION_POLICIES: Dict[str, Type[SelectionPolicy]] = {
    FullParticipation.name: FullParticipation,
    UniformSelection.name: UniformSelection,
    FairnessSelection.name: FairnessSelection,
    LatencySelection.name: LatencySelection,
}


def predict_full_round_times(family, clients: List[ClientInfo], latency, *,
                             batch_size: int, epochs: int) -> List[float]:
    """Per-client full-model round-time estimate (two-term cost model +
    update exchange); ``latency`` is a ``core.latency.LatencyTable``.
    Device-type lookups are memoised: O(device types) LUT probes."""
    from repro_torch.fl.engine import n_stream_steps
    full = family.full_spec()
    comm = 2 * family.param_bytes(full)
    step_lat = {name: latency.lookup(full, name)
                for name in {c.device for c in clients}}
    comm_lat = {name: latency.fleet[name].comm_latency(comm)
                for name in step_lat}
    return [n_stream_steps(c.n_samples, batch_size, epochs)
            * step_lat[c.device] + comm_lat[c.device] for c in clients]


def _last_wins(ids: Sequence[int], values: Sequence[float]):
    """Unique ids and, for each, its last value: the order numpy's (and
    the reference's CPU scatter's) assignment leaves duplicates in, made
    deterministic on any device."""
    last = {}
    for i, v in zip(ids, values):
        last[int(i)] = v
    return list(last), list(last.values())


class FleetTracker:
    """Server-side selection bookkeeping shared by the servers and the
    async runtime (``fl.runtime``): the policy, the per-round cohort RNG,
    and the fleet state as :class:`FleetArrays` on the CPU, with numpy
    views (``participation_counts``, ``last_accs``). The device path
    copies the columns to ``device`` (the engine's) for its draw; the
    numpy path, and the bookkeeping every round does, never touch the
    card.

    Round r's numpy draw comes from ``np.random.SeedSequence(entropy=seed,
    spawn_key=(r,))``; ``rng_mode="legacy"`` restores the reference's
    older modular mixing and pins selection to the numpy path (asking for
    the device path with it raises). ``device_select``: None picks the
    device path for fleets of at least ``DEVICE_SELECT_THRESHOLD``.
    ``predicted_times_fn`` runs once, lazily, the first time a policy asks
    for predictions; ``invalidate()`` (called by ``set_policy`` and
    ``set_fleet``) drops that cache and fires the hooks registered with
    ``add_invalidate_hook`` (the servers' prefetch-ring flush)."""

    def __init__(self, clients: List[ClientInfo],
                 selection: Union[None, str, SelectionPolicy] = None, *,
                 seed: int = 0, predicted_times_fn=None,
                 rng_mode: str = "seedseq",
                 device_select: Optional[bool] = None, device=None):
        if rng_mode not in ("seedseq", "legacy"):
            raise ValueError(f"rng_mode must be 'seedseq' or 'legacy', "
                             f"got {rng_mode!r}")
        self.clients = clients
        self.policy = resolve_policy(selection)
        self.seed = int(seed)
        self.rng_mode = rng_mode
        self.device_select = device_select
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self._predicted_times_fn = predicted_times_fn
        self._predicted_times: Optional[np.ndarray] = None
        self.arrays = FleetArrays.from_clients(clients)
        self._invalidate_hooks: List = []

    def add_invalidate_hook(self, fn) -> None:
        """Register a no-arg callable that :meth:`invalidate` fires."""
        self._invalidate_hooks.append(fn)

    # -- numpy views (read-only) ----------------------------------------
    @property
    def participation_counts(self) -> np.ndarray:
        return self.arrays.participation_counts.numpy()

    @property
    def last_accs(self) -> np.ndarray:
        return self.arrays.last_accs.numpy().astype(np.float64)

    def set_policy(self, selection: Union[None, str, SelectionPolicy]):
        self.policy = resolve_policy(selection)
        self.invalidate()

    def set_fleet(self, clients: List[ClientInfo]):
        """Replace the fleet (elastic membership): rebuilds the arrays and
        drops the stale latency predictions."""
        self.clients = clients
        self.arrays = FleetArrays.from_clients(clients)
        self.invalidate()

    def invalidate(self):
        """Drop the cached round-time predictions (stale after a LUT,
        policy or fleet change) and fire the invalidate hooks."""
        self._predicted_times = None
        for fn in self._invalidate_hooks:
            fn()

    @property
    def is_full(self) -> bool:
        return isinstance(self.policy, FullParticipation)

    def predicted_times(self) -> Optional[np.ndarray]:
        if self._predicted_times is None and \
                self._predicted_times_fn is not None:
            self._predicted_times = np.asarray(self._predicted_times_fn(),
                                               np.float64)
            self.arrays = dataclasses.replace(
                self.arrays, predicted_times=torch.as_tensor(
                    self._predicted_times, dtype=torch.float32))
        return self._predicted_times

    def state(self, round_idx: int) -> FleetState:
        a = self.arrays
        return FleetState(self.clients, round_idx, self.last_accs,
                          self.participation_counts,
                          self.predicted_times(),
                          staleness=a.staleness.numpy(),
                          pending=a.pending.numpy(),
                          misses=None if a.miss_counts is None
                          else a.miss_counts.numpy())

    def _round_rng(self, round_idx: int) -> np.random.RandomState:
        if self.rng_mode == "legacy":
            return np.random.RandomState(
                (self.seed * 9176 + 31 * round_idx + 7) % (2 ** 31))
        ss = np.random.SeedSequence(entropy=self.seed,
                                    spawn_key=(int(round_idx),))
        return np.random.RandomState(ss.generate_state(4))

    def round_generator(self, round_idx: int) -> torch.Generator:
        """The device path's generator of round r, on ``device``, seeded
        from the SeedSequence word the reference keys its draw with."""
        word = np.random.SeedSequence(
            entropy=self.seed, spawn_key=(int(round_idx),)).generate_state(1)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(word[0]))
        return gen

    def _use_device_path(self) -> bool:
        if self.rng_mode == "legacy":
            # the device path cannot reproduce the legacy numpy draws
            if self.device_select:
                raise ValueError(
                    "rng_mode='legacy' reproduces the pre-runtime numpy "
                    "RNG draws; the device selection path cannot — drop "
                    "device_select=True or use rng_mode='seedseq'")
            return False
        if self.device_select is not None:
            return bool(self.device_select)
        return len(self.clients) >= DEVICE_SELECT_THRESHOLD

    def select(self, round_idx: int) -> Selection:
        if self._use_device_path() and not self.is_full:
            if isinstance(self.policy, LatencySelection):
                self.predicted_times()     # materialise the column
            return self.policy.select_arrays(
                self.arrays.to(self.device), round_idx,
                self.round_generator(round_idx))
        return self.policy.select(self.state(round_idx),
                                  self._round_rng(round_idx))

    @staticmethod
    def _ids(ids: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64))

    def record(self, participants: Sequence[int], accs: Sequence[float]):
        """Fold one round's participant accuracies into the state (each
        listed id counts once per listing)."""
        a = self.arrays
        ids = self._ids(participants)
        counts = a.participation_counts.clone().index_add_(
            0, ids, torch.ones_like(ids, dtype=torch.int32))
        uid, uacc = _last_wins(participants, accs)
        last = a.last_accs.clone()
        last[self._ids(uid)] = torch.as_tensor(
            np.asarray(uacc, np.float32))
        self.arrays = dataclasses.replace(a, participation_counts=counts,
                                          last_accs=last)

    def record_miss(self, participants: Sequence[int]):
        """Credit a failed engagement (drop / deadline miss / quarantine)
        to each client's participation debt."""
        if not len(participants):
            return
        a = self.arrays
        ids = self._ids(participants)
        miss = a.miss_counts if a.miss_counts is not None else \
            torch.zeros_like(a.participation_counts)
        self.arrays = dataclasses.replace(
            a, miss_counts=miss.clone().index_add_(
                0, ids, torch.ones_like(ids, dtype=torch.int32)))

    def miss_counts(self) -> np.ndarray:
        """(K,) failure-miss counts (numpy; zeros if none yet)."""
        if self.arrays.miss_counts is None:
            return np.zeros((len(self.clients),), np.int64)
        return self.arrays.miss_counts.numpy()

    # -- async-runtime bookkeeping ----------------------------------------
    def _set(self, participants, pending: float):
        a = self.arrays
        ids = self._ids(participants)
        pend, stale = a.pending.clone(), a.staleness.clone()
        pend[ids] = pending
        stale[ids] = 0
        self.arrays = dataclasses.replace(a, pending=pend, staleness=stale)

    def mark_pending(self, participants: Sequence[int]):
        """Flag dispatched clients: delta in flight, staleness restarts."""
        self._set(participants, 1.0)

    def clear_pending(self, participants: Sequence[int]):
        """Unflag clients whose deltas were just aggregated."""
        self._set(participants, 0.0)

    def bump_staleness(self):
        """One server version elapsed: every in-flight delta ages by 1."""
        a = self.arrays
        self.arrays = dataclasses.replace(
            a, staleness=torch.where(a.pending > 0, a.staleness + 1,
                                     a.staleness))

    def pending_mask(self) -> np.ndarray:
        return self.arrays.pending.numpy() > 0


def resolve_policy(selection: Union[None, str, SelectionPolicy]
                   ) -> SelectionPolicy:
    """``None`` → FullParticipation; a registered name → that policy with
    its defaults; a SelectionPolicy instance → itself."""
    if selection is None:
        return FullParticipation()
    if isinstance(selection, SelectionPolicy):
        return selection
    if isinstance(selection, str):
        try:
            return SELECTION_POLICIES[selection]()
        except KeyError:
            raise ValueError(
                f"unknown selection policy {selection!r}; registered: "
                f"{sorted(SELECTION_POLICIES)}") from None
    raise TypeError(f"selection must be None, a name, or a "
                    f"SelectionPolicy, got {type(selection).__name__}")
