"""Selectable config for ``--arch granite-3-8b`` (see archs.py for the full
structural definition + source citation)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["granite-3-8b"]


def get_config():
    return CONFIG
