"""Config registry: ``get_config(arch_id)`` resolves any zoo arch."""
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      Segment, SSMConfig, reduced,
                                      uniform_segments)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}") from None


__all__ = [
    "ARCHS", "MLAConfig", "ModelConfig", "MoEConfig", "Segment",
    "SSMConfig", "get_config", "reduced", "uniform_segments",
]
