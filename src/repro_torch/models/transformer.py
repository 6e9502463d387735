"""Decoder stack for the dense family (counterpart of
``repro/models/transformer.py``).

Layers are grouped into segments exactly as in the reference; each
period position's parameters are stacked along a leading ``n_rep`` axis.
The reference scans over that axis (with remat); here a Python loop indexes
it, which changes no number. Caches (prefill, decode) have the reference's
tree, ``{seg.name: {"p{i}": {"mixer": {"k", "v", "pos"}}}}``, each leaf
stacked on the layer axis first, so a cache row (a batch entry, a serving
slot) is axis 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (activation, apply_mlp, apply_norm,
                                       init_mlp, init_norm)


@dataclass(frozen=True)
class Segment:
    name: str
    specs: Tuple[LayerSpec, ...]  # one period
    n_rep: int
    d_ff_override: Optional[int] = None


def build_segments(cfg: ModelConfig):
    """Split cfg.layer_specs() into stacked segments."""
    specs = list(cfg.layer_specs())
    segments = []
    if cfg.dense_ff_first_k:
        front = tuple(
            LayerSpec(mixer=s.mixer, ffn="swiglu", window=s.window)
            for s in specs[: cfg.dense_ff_first_k])
        segments.append(Segment("front", (front[0],), cfg.dense_ff_first_k,
                                d_ff_override=cfg.dense_ff_size))
        specs = specs[cfg.dense_ff_first_k:]
    period = cfg.layer_period
    p = len(period)
    n_rep = len(specs) // p
    if n_rep > 0:
        segments.append(Segment("main", tuple(period), n_rep))
    tail = specs[n_rep * p:]
    if tail:
        segments.append(Segment("tail", tuple(tail), 1))
    return segments


def _check_dense(lspec: LayerSpec):
    if lspec.mixer != "gqa" or lspec.ffn not in ("swiglu", "geglu"):
        raise NotImplementedError(
            f"layer {lspec}: the port runs the dense family (gqa mixer, "
            "gated MLP) only")


def init_block(generator, cfg: ModelConfig, lspec: LayerSpec, *, device,
               d_ff_override: Optional[int] = None, dtype=torch.float32):
    _check_dense(lspec)
    return {"norm1": init_norm(cfg.norm, cfg.d_model, device=device,
                               dtype=dtype),
            "mixer": attn.init_gqa(generator, cfg, device=device,
                                   dtype=dtype),
            "norm2": init_norm(cfg.norm, cfg.d_model, device=device,
                               dtype=dtype),
            "ffn": init_mlp(generator, cfg.d_model, d_ff_override or cfg.d_ff,
                            device=device, gated=True, dtype=dtype)}


def apply_block(params, x, *, cfg: ModelConfig, lspec: LayerSpec, positions,
                mode: str = "train", cache=None, causal=True,
                cache_max_len=None):
    """One pre-norm block: x + attn(norm(x)), then x + mlp(norm(x)).
    Returns x in train mode, else (x, {"mixer": the attention cache})."""
    _check_dense(lspec)
    h = apply_norm(params["norm1"], x, cfg.norm)
    y, new_cache = attn.gqa_forward(params["mixer"], h, cfg=cfg, lspec=lspec,
                                    positions=positions, mode=mode,
                                    cache=cache, causal=causal,
                                    cache_max_len=cache_max_len)
    x = x + y
    h2 = apply_norm(params["norm2"], x, cfg.norm)
    x = x + apply_mlp(params["ffn"], h2, activation(cfg.act), gated=True)
    if mode == "train":
        return x
    return x, {"mixer": new_cache}


def init_block_cache(cfg: ModelConfig, lspec: LayerSpec, B: int,
                     seq_len: int, *, device, dtype=torch.float32):
    _check_dense(lspec)
    return {"mixer": attn.init_gqa_cache(cfg, lspec, B, seq_len,
                                         device=device, dtype=dtype)}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees, 0)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def init_stack(generator, cfg: ModelConfig, *, device, dtype=torch.float32):
    """Params for all segments: {seg.name: {"p{i}": stacked params}}."""
    out = {}
    for seg in build_segments(cfg):
        out[seg.name] = {
            f"p{i}": _stack([init_block(generator, cfg, ls, device=device,
                                        d_ff_override=seg.d_ff_override,
                                        dtype=dtype)
                             for _ in range(seg.n_rep)])
            for i, ls in enumerate(seg.specs)}
    return out


def init_stack_cache(cfg: ModelConfig, B: int, seq_len: int, *, device,
                     dtype=torch.float32):
    """Empty caches of every layer, each leaf (n_rep, B, ...)."""
    out = {}
    for seg in build_segments(cfg):
        out[seg.name] = {
            f"p{i}": _stack([init_block_cache(cfg, ls, B, seq_len,
                                              device=device, dtype=dtype)
                             for _ in range(seg.n_rep)])
            for i, ls in enumerate(seg.specs)}
    return out


def apply_stack(params, x, *, cfg: ModelConfig, positions, mode="train",
                caches=None, causal=True, cache_max_len=None):
    """Run all segments. Train mode returns x; prefill returns (x, fresh
    caches sized ``cache_max_len``); decode takes ``caches``, writes each
    layer's row of them in place and returns (x, caches)."""
    new_caches = {}
    for seg in build_segments(cfg):
        seg_params = params[seg.name]
        per_rep = []
        for r in range(seg.n_rep):
            blk_caches = {}
            for i, ls in enumerate(seg.specs):
                p = _index(seg_params[f"p{i}"], r)
                if mode == "train":
                    x = apply_block(p, x, cfg=cfg, lspec=ls,
                                    positions=positions, causal=causal)
                    continue
                cache = None
                if mode == "decode":
                    # views of the stacked leaves: decode writes through them
                    cache = _index(caches[seg.name][f"p{i}"], r)["mixer"]
                x, blk_caches[f"p{i}"] = apply_block(
                    p, x, cfg=cfg, lspec=ls, positions=positions, mode=mode,
                    cache=cache, causal=causal, cache_max_len=cache_max_len)
            per_rep.append(blk_caches)
        if mode == "prefill":
            new_caches[seg.name] = _stack(per_rep)
    if mode == "train":
        return x
    return x, (new_caches if mode == "prefill" else caches)
