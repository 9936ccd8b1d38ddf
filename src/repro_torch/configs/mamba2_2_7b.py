"""Selectable config for ``--arch mamba2-2.7b`` (see archs.py for the full
structural definition + source citation)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["mamba2-2.7b"]


def get_config():
    return CONFIG
