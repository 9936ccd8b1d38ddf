"""Selectable config for ``--arch deepseek-v2-lite-16b`` (see archs.py for the full
structural definition + source citation)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["deepseek-v2-lite-16b"]


def get_config():
    return CONFIG
