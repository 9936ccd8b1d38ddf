"""Selectable config for ``--arch gemma-7b`` (see archs.py for the full
structural definition + source citation)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["gemma-7b"]


def get_config():
    return CONFIG
