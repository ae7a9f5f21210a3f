"""Architecture registry: ``get_arch(name)`` -> ArchConfig.

Counterpart of ``repro/models/registry.py:get_arch``; it resolves the
port's own copies of the configs in ``repro_torch.configs``.
"""
from __future__ import annotations

import importlib

from .config import ArchConfig


def get_arch(name: str) -> ArchConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    return mod.CONFIG
