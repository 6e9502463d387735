"""Architecture registry. ``get_config(arch_id)`` returns the full pool config.

The port registers every config of the reference registry: the attention
decoders (the dense family and the MoE family, MLA and MTP included), the
recurrent ones (xlstm-1.3b, ssm; recurrentgemma-2b, hybrid), the
patch-prefix decoder qwen2-vl-72b (vlm, M-RoPE) and the encoder-decoder
seamless-m4t-medium (audio).
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
    from repro_torch.configs import (arctic_480b,  # noqa: F401
                                     deepseek_v3_671b, gemma_2b, olmo_1b,
                                     phi3_mini_3_8b, qwen2_vl_72b,
                                     recurrentgemma_2b, seamless_m4t_medium,
                                     xlstm_1_3b, yi_34b)


__all__ = ["get_config", "list_archs", "register", "ModelConfig", "ShapeConfig",
           "INPUT_SHAPES", "AttentionConfig", "MoEConfig", "RecurrentConfig",
           "LayerSpec", "DistConfig"]
