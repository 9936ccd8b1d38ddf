"""Selectable config for ``--arch gemma2-9b`` (see archs.py for the full
structural definition + source citation)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["gemma2-9b"]


def get_config():
    return CONFIG
