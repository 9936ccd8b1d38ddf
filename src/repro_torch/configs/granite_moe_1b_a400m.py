"""Selectable config for ``--arch granite-moe-1b-a400m`` (see archs.py for the full
structural definition + source citation)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["granite-moe-1b-a400m"]


def get_config():
    return CONFIG
