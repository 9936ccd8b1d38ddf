"""Device profiles + the offline latency lookup table (paper §III-B1) —
the port of the reference's ``core/latency.py`` (host Python, unchanged:
the same specs give the same seconds).

The paper uses an offline-measured latency LUT per device type. Without
edge hardware the standard two-term cost model per device —
``latency = FLOPs/throughput + bytes/mem_bw + fixed`` — is *tabulated*
over the submodel gene space, which is exactly the artifact the search
helper consumes (``g(ω, p_k) < l_k`` in Alg. 1). FLOPs and parameter
bytes come from the family's spec-space surface (``flops`` /
``param_bytes``); a family with an enumerable gene space pre-tabulates
(``lut_specs``), others fill the memo lazily on lookup.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

from repro_torch.core.elastic import family_for


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    flops_per_s: float        # effective sustained
    mem_bw: float             # bytes/s
    net_bw: float             # bytes/s up+down (FL update exchange)
    fixed_s: float = 0.01     # per-batch overhead

    def step_latency(self, flops: float, bytes_touched: float) -> float:
        return flops / self.flops_per_s + bytes_touched / self.mem_bw + \
            self.fixed_s

    def comm_latency(self, update_bytes: float) -> float:
        return update_bytes / self.net_bw


# A heterogeneous edge fleet (spec-sheet-scale numbers; the relative
# spread is what matters for straggler / fairness effects).
EDGE_FLEET = (
    DeviceProfile("jetson-orin", 2.0e12, 6.0e10, 1.2e7),
    DeviceProfile("pixel-7", 6.0e11, 2.0e10, 6.0e6),
    DeviceProfile("rpi-4", 5.0e10, 4.0e9, 2.0e6),
    DeviceProfile("laptop-cpu", 3.0e11, 1.5e10, 1.0e7),
    DeviceProfile("jetson-nano", 2.4e11, 8.0e9, 4.0e6),
)


def fleet_for_workers(n_workers: int,
                      fleet: Sequence[DeviceProfile] = EDGE_FLEET
                      ) -> Tuple[DeviceProfile, ...]:
    return tuple(fleet[i % len(fleet)] for i in range(n_workers))


def train_step_latency(cfg, spec, profile: DeviceProfile,
                       batch_size: int = 32) -> float:
    """Two-term cost model for one local training step of ``spec``'s
    submodel on ``profile`` (any family config or family)."""
    fam = family_for(cfg)
    # fwd + bwd ~ 3x fwd; activations ~ 2 bytes-touched per FLOP/8
    return profile.step_latency(3.0 * fam.flops(spec) * batch_size,
                                fam.param_bytes(spec) * 3)


class LatencyTable:
    """Offline LUT: (genes, device) -> seconds (Alg. 1's ``g``).

    ``cfg`` may be any family config or a family. ``depth_choices``
    narrows the pre-tabulated depth grid for families that enumerate one
    (the CNN: 27 depths × 64 widths of ``PAPER_CNN`` = 1728 specs, times
    the fleet's 5 devices, on the host at construction)."""

    def __init__(self, cfg, fleet: Sequence[DeviceProfile] = EDGE_FLEET,
                 depth_choices: Sequence[int] = None, batch_size: int = 32):
        self.family = family_for(cfg)
        self.cfg = self.family.cfg
        self.fleet = {p.name: p for p in fleet}
        self.batch_size = batch_size
        self._table: Dict[Tuple, float] = {}
        for spec in self.family.lut_specs(depth_choices):
            for p in fleet:
                self._table[(self.family.genes(spec), p.name)] = \
                    train_step_latency(self.family, spec, p, batch_size)

    def lookup(self, spec, device: str) -> float:
        key = (self.family.genes(spec), device)
        if key not in self._table:
            self._table[key] = train_step_latency(
                self.family, spec, self.fleet[device], self.batch_size)
        return self._table[key]

    def __len__(self):
        return len(self._table)
