"""Selectable config for ``--arch llava-next-mistral-7b`` (see archs.py for the full
structural definition + source citation)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["llava-next-mistral-7b"]


def get_config():
    return CONFIG
