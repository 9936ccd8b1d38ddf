"""Federated learning: the CFL control plane (``fl.session``), its
baselines (``fl.baselines``), the round engines (``fl.engine``), client
selection (``fl.selection``), the async runtime (``fl.runtime``), fault
injection (``fl.faults``) and the experiment drivers (``fl.rounds``)."""
from repro_torch.fl.baselines import FedAvgServer, independent_learning
from repro_torch.fl.client import ClientInfo, evaluate, local_train
from repro_torch.fl.engine import (BatchedRoundEngine, CohortResult,
                                   SequentialFamilyTrainer)
from repro_torch.fl.faults import FaultPlan, resolve_fault_plan
from repro_torch.fl.rounds import build_population, run_cfl, run_fedavg, run_il
from repro_torch.fl.runtime import FleetRuntime, InFlightCohort
from repro_torch.fl.selection import (SELECTION_POLICIES, FairnessSelection,
                                      FleetArrays, FleetState, FleetTracker,
                                      FullParticipation, LatencySelection,
                                      Selection, SelectionPolicy,
                                      UniformSelection, resolve_policy)
from repro_torch.fl.server import CFLConfig, CFLServer
from repro_torch.fl.session import CFLSession

__all__ = ["BatchedRoundEngine", "CFLConfig", "CFLServer", "CFLSession",
           "ClientInfo", "CohortResult", "FairnessSelection", "FaultPlan",
           "FedAvgServer", "FleetArrays", "FleetRuntime", "FleetState",
           "FleetTracker", "FullParticipation", "InFlightCohort",
           "LatencySelection", "SELECTION_POLICIES", "Selection",
           "SelectionPolicy", "SequentialFamilyTrainer", "UniformSelection",
           "build_population", "evaluate", "independent_learning",
           "local_train", "resolve_fault_plan", "resolve_policy", "run_cfl",
           "run_fedavg", "run_il"]
