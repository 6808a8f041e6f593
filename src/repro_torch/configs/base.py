"""Config registry: the architectures the port serves so far."""

from __future__ import annotations

import importlib

from ..models.common import ArchConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]

# Dense-family architectures ported so far (repro.configs.base lists all).
ARCH_IDS = ["qwen2_0_5b"]


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown or unported architecture {arch_id!r}; "
                         f"ported: {ARCH_IDS}")
    return importlib.import_module(f".{arch_id}", __package__)


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE
