"""Architecture registry. ``get_config(arch_id)`` returns the full pool config.

The port registers the architectures whose model families it runs; the
other families of the reference registry arrive with their slices.
"""
from __future__ import annotations

from repro_torch.configs.base import (AttentionConfig, DistConfig,
                                      INPUT_SHAPES, LayerSpec, ModelConfig,
                                      MoEConfig, RecurrentConfig,
                                      ShapeConfig)

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(arch: str) -> ModelConfig:
    _load_all()
    key = arch.replace("_", "-")
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]()


def list_archs():
    _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from repro_torch.configs import olmo_1b  # noqa: F401


__all__ = ["get_config", "list_archs", "register", "ModelConfig", "ShapeConfig",
           "INPUT_SHAPES", "AttentionConfig", "MoEConfig", "RecurrentConfig",
           "LayerSpec", "DistConfig"]
