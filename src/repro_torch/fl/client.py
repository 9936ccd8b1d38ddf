"""FL client metadata — the port of the reference's
``fl/client.py::ClientInfo``. The per-client extract → train loop
(``local_train``, ``evaluate``) comes with the sequential path (ROADMAP
A5); the batched engine trains every client at once."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ClientInfo:
    cid: int
    device: str               # DeviceProfile name
    quality: int              # dominant data-quality level
    n_samples: int
    latency_bound: float      # l_k in Alg. 1 (seconds per local step)
