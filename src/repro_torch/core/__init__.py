"""Submodel specs, the elastic family decode surface and the RL-gate
training of the paper's CNN."""
from repro_torch.core.gating import (GateTrainConfig, gate_depth_policy,
                                     make_gate_train_step, train_gates)

__all__ = ["GateTrainConfig", "gate_depth_policy", "make_gate_train_step",
           "train_gates"]
