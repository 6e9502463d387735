"""Public model API: build_model(cfg) -> Model (dense family, train mode).

Counterpart of ``repro/models/model.py``. Parameters are a nested dict of
tensors with the reference's keys and shapes::

    {"decoder": {"main": {"p0": {"ffn": {...}, "mixer": {...},
                                 "norm1": {}, "norm2": {}}}},
     "embed": {"table": (padded_vocab, d_model)}, "final_norm": {}}

The head is tied to the embedding and projects over the PADDED vocabulary
(50432 columns for olmo-1b); the padding columns take part in the softmax
as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_norm, chunked_softmax_xent,
                                       embed_tokens, init_embed, init_norm)


def _dtype(name: str):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


@dataclass
class Model:
    cfg: ModelConfig
    init_params: Callable  # (generator, device) -> params
    loss_fn: Callable  # (params, batch, rng=None) -> (loss, metrics)


def build_model(cfg: ModelConfig) -> Model:
    if (cfg.family != "dense" or cfg.encoder_layers or cfg.mm_prefix
            or cfg.mtp_depth or cfg.moe is not None
            or not cfg.tie_embeddings):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense tied-embedding family only")
    dt = _dtype(cfg.param_dtype)
    V = cfg.padded_vocab

    def init_params(generator, device):
        return {"embed": init_embed(generator, V, cfg.d_model, device=device,
                                    dtype=dt),
                "final_norm": init_norm(cfg.norm, cfg.d_model, device=device,
                                        dtype=dt),
                "decoder": tfm.init_stack(generator, cfg, device=device,
                                          dtype=dt)}

    def loss_fn(params, batch, rng=None):
        """Mean next-token cross-entropy over the masked positions. ``rng``
        is accepted for signature parity and unused: the dense train path
        draws no randomness."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_tokens(params["embed"], tokens, scale=cfg.embed_scale)
        positions = torch.broadcast_to(
            torch.arange(S, dtype=torch.int32, device=x.device), (B, S))
        h = tfm.apply_stack(params["decoder"], x, cfg=cfg,
                            positions=positions)
        h = apply_norm(params["final_norm"], h, cfg.norm)
        targets = batch["targets"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=x.device)
        head_w = params["embed"]["table"].T
        nll, count = chunked_softmax_xent(h, head_w, targets, mask,
                                          cfg.dist.loss_chunk)
        loss = nll / torch.clamp(count, min=1.0)
        return loss, {"nll": loss, "loss": loss}

    return Model(cfg=cfg, init_params=init_params, loss_fn=loss_fn)
