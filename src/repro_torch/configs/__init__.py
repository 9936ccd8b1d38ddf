"""Config registry: ``get_config(arch_id)`` resolves any zoo arch."""
from repro_torch.configs.archs import (ARCHS, long_context_variant,
                                       supported_pairs)
from repro_torch.configs.base import (INPUT_SHAPES, InputShape, MLAConfig,
                                      ModelConfig, MoEConfig, Segment,
                                      SSMConfig, config_fingerprint,
                                      flops_per_token, reduced,
                                      uniform_segments)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}") from None


__all__ = [
    "ARCHS", "INPUT_SHAPES", "InputShape", "MLAConfig", "ModelConfig",
    "MoEConfig", "Segment", "SSMConfig", "config_fingerprint",
    "flops_per_token", "get_config", "long_context_variant", "reduced",
    "supported_pairs", "uniform_segments",
]
