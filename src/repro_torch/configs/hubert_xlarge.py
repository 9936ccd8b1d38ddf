"""Selectable config for ``--arch hubert-xlarge`` (see archs.py for the full
structural definition + source citation)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["hubert-xlarge"]


def get_config():
    return CONFIG
