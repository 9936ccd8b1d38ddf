"""Client selection for FL rounds — the port of the surface of the
reference's ``fl/selection.py`` that a full-participation sync round
needs: the ``Selection`` a policy returns (a fixed-size padded cohort),
the ``SelectionPolicy`` protocol with ``FullParticipation`` (every client,
every round: the paper's regime and the default), the per-client round
time prediction of the latency cost model, and the server's
``FleetTracker`` (numpy, as the reference's legacy views).

The other policies ("uniform", "fairness", "latency"), partial
participation and the device-resident fleet arrays are not ported yet:
``resolve_policy`` raises naming ROADMAP A12 for them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.fl.client import ClientInfo


@dataclasses.dataclass
class FleetState:
    """What a policy may look at when picking a round's cohort:
    ``last_accs[k]`` is client k's local-test accuracy from its latest
    round (NaN if it never participated), ``participation_counts[k]`` the
    rounds it participated in, ``predicted_times[k]`` the server's
    full-model round-time estimate (None when not asked for)."""
    clients: List[ClientInfo]
    round_idx: int
    last_accs: np.ndarray
    participation_counts: np.ndarray
    predicted_times: Optional[np.ndarray] = None

    @property
    def n_clients(self) -> int:
        return len(self.clients)

    @property
    def n_samples(self) -> np.ndarray:
        return np.asarray([c.n_samples for c in self.clients], np.float64)


@dataclasses.dataclass
class Selection:
    """A fixed-size padded cohort for one round: ``idx`` (M,) int32 fleet
    indices (padding slots repeat a valid index), ``valid`` (M,) float32
    1/0 flags (0 = padding: no training, no aggregation weight),
    ``weights`` (M,) float32 aggregation weights, 0 on padding slots and
    summing to the participating mass Σ n_k."""
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


class SelectionPolicy:
    """Protocol: ``select(state, rng) -> Selection`` with a padded size
    ``cohort_size(K)`` constant across rounds."""

    name = "abstract"

    def __init__(self, fraction: float = 0.5):
        if not (0.0 < fraction <= 1.0):
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        self.fraction = float(fraction)

    def cohort_size(self, n_clients: int) -> int:
        return max(1, int(round(self.fraction * n_clients)))

    def select(self, state: FleetState,
               rng: np.random.RandomState) -> Selection:
        raise NotImplementedError


class FullParticipation(SelectionPolicy):
    """Every client, every round — the paper's regime and the default."""

    name = "full"

    def __init__(self, fraction: float = 1.0):
        super().__init__(1.0)

    def select(self, state: FleetState,
               rng: np.random.RandomState) -> Selection:
        k = state.n_clients
        return Selection(np.arange(k), np.ones((k,), np.float32),
                         state.n_samples)


def resolve_policy(selection: Union[None, str, SelectionPolicy]
                   ) -> SelectionPolicy:
    """``None`` / ``'full'`` -> FullParticipation; a SelectionPolicy
    instance -> itself. The reference's other policies raise."""
    if selection is None or selection == "full":
        return FullParticipation()
    if isinstance(selection, SelectionPolicy):
        return selection
    if isinstance(selection, str):
        raise NotImplementedError(
            f"selection policy {selection!r} is not ported yet (ROADMAP "
            "A12); the port runs 'full'")
    raise TypeError(f"selection must be None, a name, or a "
                    f"SelectionPolicy, got {type(selection).__name__}")


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


class FleetTracker:
    """Server-side selection bookkeeping: the policy, the per-round cohort
    RNG (``np.random.SeedSequence(entropy=seed, spawn_key=(r,))``, or the
    reference's ``"legacy"`` modular mixing), and each client's latest
    accuracy and participation count. ``predicted_times_fn`` is called
    once, lazily, the first time a policy asks for predictions."""

    def __init__(self, clients: List[ClientInfo],
                 selection: Union[None, str, SelectionPolicy] = None, *,
                 seed: int = 0, predicted_times_fn=None,
                 rng_mode: str = "seedseq"):
        if rng_mode not in ("seedseq", "legacy"):
            raise ValueError(f"rng_mode must be 'seedseq' or 'legacy', "
                             f"got {rng_mode!r}")
        self.clients = clients
        self.policy = resolve_policy(selection)
        self.seed = int(seed)
        self.rng_mode = rng_mode
        self._predicted_times_fn = predicted_times_fn
        self._predicted_times: Optional[np.ndarray] = None
        self.last_accs = np.full((len(clients),), np.nan)
        self.participation_counts = np.zeros((len(clients),), np.int64)

    def set_policy(self, selection: Union[None, str, SelectionPolicy]):
        self.policy = resolve_policy(selection)
        self._predicted_times = None

    @property
    def is_full(self) -> bool:
        return isinstance(self.policy, FullParticipation)

    def predicted_times(self) -> Optional[np.ndarray]:
        if self._predicted_times is None and \
                self._predicted_times_fn is not None:
            self._predicted_times = np.asarray(self._predicted_times_fn(),
                                               np.float64)
        return self._predicted_times

    def state(self, round_idx: int) -> FleetState:
        return FleetState(self.clients, round_idx, self.last_accs.copy(),
                          self.participation_counts.copy(),
                          self.predicted_times())

    def _round_rng(self, round_idx: int) -> np.random.RandomState:
        if self.rng_mode == "legacy":
            return np.random.RandomState(
                (self.seed * 9176 + 31 * round_idx + 7) % (2 ** 31))
        ss = np.random.SeedSequence(entropy=self.seed,
                                    spawn_key=(int(round_idx),))
        return np.random.RandomState(ss.generate_state(4))

    def select(self, round_idx: int) -> Selection:
        return self.policy.select(self.state(round_idx),
                                  self._round_rng(round_idx))

    def record(self, participants: Sequence[int], accs: Sequence[float]):
        """Fold one round's participant accuracies into the state."""
        ids = np.asarray(participants, np.int64)
        self.participation_counts[ids] += 1
        self.last_accs[ids] = np.asarray(accs, np.float32)
