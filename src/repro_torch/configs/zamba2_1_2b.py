"""Selectable config for ``--arch zamba2-1.2b`` (see archs.py for the full
structural definition + source citation)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["zamba2-1.2b"]


def get_config():
    return CONFIG
