"""Public model API: build_model(cfg) -> Model (the decoders of the dense,
MoE, ssm and hybrid families: training loss, prefill and decode).

Counterpart of ``repro/models/model.py``. Parameters are a nested dict of
tensors with the reference's keys and shapes::

    {"decoder": {"main": {"p0": {"ffn": {...}, "mixer": {...},
                                 "norm1": {}, "norm2": {}}}},
     "embed": {"table": (padded_vocab, d_model)}, "final_norm": {},
     ["head": {"w": (d_model, padded_vocab)}], ["mtp": {...}]}

The head is tied to the embedding (``head_w`` its transpose) or, with
``tie_embeddings=False``, its own ``head.w``; it projects over the PADDED
vocabulary (50432 columns for olmo-1b), and the padding columns take part
in the softmax as in the reference. With ``mtp_depth`` (deepseek-v3) an
``mtp`` subtree holds the multi-token-prediction head (``proj`` of
h ++ emb(t + 1), one stacked block, its norm), trained through the loss
only.

Serving: ``prefill`` runs a prompt and returns the last position's logits
with fresh caches sized for the whole decode horizon; ``decode_step`` feeds
one token a row, each row at its own absolute position, and writes the
caches in place; ``init_cache`` allocates empty ones (attention slots at
pos -1, recurrent states at zero with the mLSTM and sLSTM stabiliser m at
-1e30). Logits are float32 over the padded vocabulary.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_norm, chunked_softmax_xent,
                                       dense_init, embed_tokens, init_embed,
                                       init_norm)

MTP_WEIGHT = 0.3


def _dtype(name: str):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


@dataclass
class Model:
    cfg: ModelConfig
    init_params: Callable  # (generator, device) -> params
    loss_fn: Callable  # (params, batch, rng=None) -> (loss, metrics)
    prefill: Callable  # (params, batch, max_len=None) -> (logits, caches)
    decode_step: Callable  # (params, caches, tokens, index) -> (logits,
    #                        caches), the caches written in place
    init_cache: Callable  # (B, seq_len, dtype=, enc_len=, device=) -> caches
    head_w: Callable  # params -> (d_model, padded_vocab)


def build_model(cfg: ModelConfig) -> Model:
    if (cfg.family not in ("dense", "moe", "ssm", "hybrid")
            or cfg.encoder_layers or cfg.mm_prefix):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (multimodal prefix or "
            "encoder-decoder) is not ported; the port runs the decoders "
            "(dense, moe, ssm and hybrid)")
    dt = _dtype(cfg.param_dtype)
    V = cfg.padded_vocab

    def init_params(generator, device):
        d = cfg.d_model
        p = {"embed": init_embed(generator, V, d, device=device, dtype=dt),
             "final_norm": init_norm(cfg.norm, d, device=device, dtype=dt),
             "decoder": tfm.init_stack(generator, cfg, device=device,
                                       dtype=dt)}
        if not cfg.tie_embeddings:
            p["head"] = {"w": dense_init(generator, d, V, device=device,
                                         dtype=dt)}
        if cfg.mtp_depth:
            p["mtp"] = {
                "proj": dense_init(generator, 2 * d, d, device=device,
                                   dtype=dt),
                "block": tfm._stack([
                    tfm.init_block(generator, cfg, cfg.layer_period[0],
                                   device=device, dtype=dt)
                    for _ in range(cfg.mtp_depth)]),
                "norm": init_norm(cfg.norm, d, device=device, dtype=dt)}
        return p

    def head_w(params):
        if cfg.tie_embeddings:
            return params["embed"]["table"].T
        return params["head"]["w"]

    def loss_fn(params, batch, rng=None):
        """Mean next-token cross-entropy over the masked positions, plus
        MTP_WEIGHT times the MTP head's (predicting t + 2 from h_t and the
        embedding of t + 1) and the MoE load-balance loss. ``rng`` is
        accepted for signature parity and unused: the train path draws no
        randomness."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_tokens(params["embed"], tokens, scale=cfg.embed_scale)
        positions = torch.broadcast_to(
            torch.arange(S, dtype=torch.int32, device=x.device), (B, S))
        h, _, aux = tfm.apply_stack(params["decoder"], x, cfg=cfg,
                                    positions=positions)
        h = apply_norm(params["final_norm"], h, cfg.norm)
        targets = batch["targets"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=x.device)
        hw = head_w(params)
        nll, count = chunked_softmax_xent(h, hw, targets, mask,
                                          cfg.dist.loss_chunk)
        loss = nll / torch.clamp(count, min=1.0)
        metrics = {"nll": loss, "aux": aux}
        if cfg.mtp_depth:
            hm = torch.cat([h[:, :-1], x[:, 1:]], dim=-1)
            hm = hm @ params["mtp"]["proj"]
            blk = tfm._index(params["mtp"]["block"], 0)
            # the block's own MoE loss is not added (as in the reference)
            hm, _, _ = tfm.apply_block(blk, hm, cfg=cfg,
                                       lspec=cfg.layer_period[0],
                                       positions=positions[:, :-1])
            hm = apply_norm(params["mtp"]["norm"], hm, cfg.norm)
            mtp_nll, mtp_cnt = chunked_softmax_xent(
                hm[:, :-1], hw, targets[:, 2:], mask[:, 2:],
                cfg.dist.loss_chunk)
            mtp_loss = mtp_nll / torch.clamp(mtp_cnt, min=1.0)
            metrics["mtp"] = mtp_loss
            loss = loss + MTP_WEIGHT * mtp_loss
        loss = loss + aux
        metrics["loss"] = loss
        return loss, metrics

    def prefill(params, batch, max_len: Optional[int] = None):
        """batch["tokens"] (B, S) -> (logits (B, padded_vocab) float32 of
        the last position, caches of ``max_len`` (default S) slots)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_tokens(params["embed"], tokens, scale=cfg.embed_scale)
        positions = torch.broadcast_to(
            torch.arange(S, dtype=torch.int32, device=x.device), (B, S))
        h, caches, _ = tfm.apply_stack(params["decoder"], x, cfg=cfg,
                                       positions=positions, mode="prefill",
                                       cache_max_len=max_len or S)
        h = apply_norm(params["final_norm"], h[:, -1:], cfg.norm)
        logits = (h @ head_w(params)).to(torch.float32)[:, 0]
        return logits, caches

    def decode_step(params, caches, tokens, index):
        """tokens: (B, 1) int; index: the absolute position(s) — a scalar
        shared by the batch, or a (B,) vector when every row sits at its own
        depth (continuous batching over slots). Writes ``caches`` in place
        and returns (logits (B, padded_vocab) float32, caches)."""
        B = tokens.shape[0]
        x = embed_tokens(params["embed"], tokens, scale=cfg.embed_scale)
        idx = torch.as_tensor(index, dtype=torch.int32, device=x.device)
        positions = (idx.reshape(B, 1) if idx.dim()
                     else torch.full((B, 1), int(idx), dtype=torch.int32,
                                     device=x.device))
        h, caches, _ = tfm.apply_stack(params["decoder"], x, cfg=cfg,
                                       positions=positions, mode="decode",
                                       caches=caches)
        h = apply_norm(params["final_norm"], h, cfg.norm)
        logits = (h @ head_w(params)).to(torch.float32)[:, 0]
        return logits, caches

    def init_cache(B, seq_len, dtype=None, enc_len: int = 0, device=None):
        """Empty caches for B rows of ``seq_len`` positions on ``device``
        (default: the card). ``enc_len`` is accepted for signature parity:
        the port's decoders have no cross-attention cache."""
        return tfm.init_stack_cache(cfg, B, seq_len,
                                    device=resolve_device(device),
                                    dtype=dtype or dt)

    return Model(cfg=cfg, init_params=init_params, loss_fn=loss_fn,
                 prefill=prefill, decode_step=decode_step,
                 init_cache=init_cache, head_w=head_w)
