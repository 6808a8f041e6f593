"""Model registry: dispatch an ArchConfig to its model implementation."""

from __future__ import annotations

from types import ModuleType

from . import convnet, transformer
from .common import ArchConfig

__all__ = ["get_model", "get_weight_mask", "get_cache_layout"]

# Families ported so far; repro.models.registry maps the others.
_FAMILY_TO_MODULE = {"dense": transformer}


def get_model(cfg: ArchConfig) -> ModuleType:
    """The module of ``cfg``'s family (``init_params``, ``weight_mask``,
    ``loss_fn``, ...): a ``convnet.CNNConfig`` is the CNN family."""
    if isinstance(cfg, convnet.CNNConfig):
        return convnet
    try:
        return _FAMILY_TO_MODULE[cfg.family]
    except KeyError:
        raise ValueError(f"architecture family {cfg.family!r} is not ported")


def get_weight_mask(cfg: ArchConfig):
    """Weight-currency mask congruent with ``init_params``."""
    return get_model(cfg).weight_mask(cfg)


def get_cache_layout(cfg: ArchConfig):
    """Quantized-cache layout of the decode cache leaves."""
    return get_model(cfg).cache_layout(cfg)
