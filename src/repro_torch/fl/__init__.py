"""Federated learning: the CFL control plane (``fl.session``), its
baselines (``fl.baselines``), the round engines (``fl.engine``) and the
experiment drivers (``fl.rounds``)."""
from repro_torch.fl.rounds import run_cfl, run_fedavg, run_il
from repro_torch.fl.server import CFLConfig
from repro_torch.fl.session import CFLSession

__all__ = ["CFLConfig", "CFLSession", "run_cfl", "run_fedavg", "run_il"]
