"""Selectable config for ``--arch qwen3-4b`` (see archs.py for the full
structural definition + source citation)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["qwen3-4b"]


def get_config():
    return CONFIG
