"""Public model API: build_model(cfg) -> Model (every family of the
registry: dense, MoE, ssm, hybrid, the vlm's patch prefix and the audio
encoder-decoder; training loss, prefill and decode).

Counterpart of ``repro/models/model.py``. Parameters are a nested dict of
tensors with the reference's keys and shapes::

    {"decoder": {"main": {"p0": {"ffn": {...}, "mixer": {...},
                                 "norm1": {}, "norm2": {}}}},
     "embed": {"table": (padded_vocab, d_model)}, "final_norm": {},
     ["head": {"w": (d_model, padded_vocab)}], ["mtp": {...}],
     ["encoder": {"main": {"p0": {...}}}, "enc_norm": {...}]}

The head is tied to the embedding (``head_w`` its transpose) or, with
``tie_embeddings=False``, its own ``head.w``; it projects over the PADDED
vocabulary (50432 columns for olmo-1b), and the padding columns take part
in the softmax as in the reference. With ``mtp_depth`` (deepseek-v3) an
``mtp`` subtree holds the multi-token-prediction head (``proj`` of
h ++ emb(t + 1), one stacked block, its norm), trained through the loss
only. The vlm (qwen2-vl) takes ``batch["patch_embeds"]`` (B, P, d), the
stubbed vision tower's output, as a prefix before the tokens: positions
count from the prefix's first row, M-RoPE's ``positions3`` are the
batch's or the 1-D positions broadcast, and the loss drops the prefix's
rows before the head. The encoder-decoder (seamless-m4t) runs
``batch["frame_embeds"]`` (B, S_src, d) through a non-causal ``encoder``
stack and ``enc_norm``; every decoder block attends to that output through
its ``cross`` leaves.

Serving: ``prefill`` runs a prompt and returns the last position's logits
with fresh caches sized for the whole decode horizon; ``decode_step`` feeds
one token a row, each row at its own absolute position, and writes the
caches in place; ``init_cache`` allocates empty ones (attention slots at
pos -1, recurrent states at zero with the mLSTM and sLSTM stabiliser m at
-1e30). Logits are float32 over the padded vocabulary.

``param_spec()`` and ``cache_spec()`` are the reference's logical specs of
the parameter and cache trees (plain tuples; ``models/sharding.py``
resolves them). ``build_model(cfg, split=)`` (``models/tensor_parallel.py``
's ``Split``; the GQA decoders: the dense ones, arctic-480b's MoE FFN with
its experts over the model line and the capacity rule over the agent's
whole batch, qwen2-vl-72b's M-RoPE and patch prefix) builds the split
route: its loss is the rank's share of one agent's step, and its
``prefill``, ``decode_step`` and ``init_cache`` serve on the rank's pieces
(``tensor_parallel.serve_pieces`` of the whole parameters: the reference's
``build_serve`` layout) and the rank's cache block, for the data rank's
rows that the caller hands them. ``loss_fn.cfg`` is ``cfg``, so a segment
given ``param_shardings`` builds that loss from the model's own.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (apply_norm, chunked_softmax_xent,
                                       dense_init, embed_tokens, init_embed,
                                       init_norm, spec_embed, spec_norm)
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.tensor_parallel import check_family

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
    param_spec: Callable  # () -> the logical spec tree of the parameters
    cache_spec: Callable  # () -> the logical spec tree of the caches
    # the split route's () -> tensor_parallel.serve_plan tree (None
    # without a split): built at its first call, from shapes alone
    serve_plan: Optional[Callable] = None


def extra_inputs(cfg: ModelConfig, S: int) -> dict:
    """The inputs beside the tokens that a model of ``cfg`` reads, unbatched,
    for S tokens: name -> (rows, d_model). The vlm's ``patch_embeds``
    (mm_prefix rows, before the tokens), the encoder-decoder's
    ``frame_embeds`` (S frames, as the reference's test batches carry);
    {} for a decoder of tokens alone."""
    out = {}
    if cfg.mm_prefix > 0:
        out["patch_embeds"] = (cfg.mm_prefix, cfg.d_model)
    if cfg.encoder_layers:
        out["frame_embeds"] = (S, cfg.d_model)
    return out


def build_model(cfg: ModelConfig, split=None) -> Model:
    """The model of ``cfg``. With ``split`` (``tensor_parallel.Split``) its
    ``loss_fn`` is the split route's: given the rank's pieces of the
    parameters (``tensor_parallel.leaf_plan``: split leaves as the rank's
    blocks, the others whole) and the agent's whole batch, it
    differentiates this fsdp rank's rows on this model rank's heads, d_ff
    columns and vocabulary, and returns (the rank's share of the loss,
    metrics whose ``loss`` is the agent's whole loss); the other functions
    are the whole model's. A family the route does not split raises
    NotImplementedError by name."""
    if split is not None:
        check_family(cfg)
    dt = _dtype(cfg.param_dtype)
    V = cfg.padded_vocab
    is_encdec = cfg.encoder_layers > 0
    has_prefix = cfg.mm_prefix > 0  # the vlm's patch prefix
    enc_cfg = (cfg.replace(num_layers=cfg.encoder_layers, dense_ff_first_k=0)
               if is_encdec else None)

    def init_params(generator, device):
        d = cfg.d_model
        p = {"embed": init_embed(generator, V, d, device=device, dtype=dt),
             "final_norm": init_norm(cfg.norm, d, device=device, dtype=dt),
             "decoder": tfm.init_stack(generator, cfg, device=device,
                                       cross=is_encdec, dtype=dt)}
        if not cfg.tie_embeddings:
            p["head"] = {"w": dense_init(generator, d, V, device=device,
                                         dtype=dt)}
        if is_encdec:
            p["encoder"] = tfm.init_stack(generator, enc_cfg, device=device,
                                          dtype=dt)
            p["enc_norm"] = init_norm(cfg.norm, d, device=device, dtype=dt)
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

    def param_spec():
        p = {"embed": spec_embed(), "final_norm": spec_norm(cfg.norm),
             "decoder": tfm.spec_stack(cfg, cross=is_encdec)}
        if not cfg.tie_embeddings:
            p["head"] = {"w": ("fsdp", "model")}
        if is_encdec:
            p["encoder"] = tfm.spec_stack(enc_cfg)
            p["enc_norm"] = spec_norm(cfg.norm)
        if cfg.mtp_depth:
            p["mtp"] = {"proj": ("fsdp", None),
                        "block": tfm.spec_block(cfg, cfg.layer_period[0]),
                        "norm": spec_norm(cfg.norm)}
        return p

    def cache_spec():
        return tfm.spec_stack_cache(cfg, cross=is_encdec)

    def run_encoder(params, frame_embeds):
        """frame_embeds (B, S_src, d) -> the encoder's output (B, S_src, d):
        the encoder stack, non-causal, then ``enc_norm``."""
        B, S, _ = frame_embeds.shape
        pos = torch.broadcast_to(torch.arange(
            S, dtype=torch.int32, device=frame_embeds.device), (B, S))
        h, _, _ = tfm.apply_stack(params["encoder"], frame_embeds,
                                  cfg=enc_cfg, positions=pos, causal=False)
        return apply_norm(params["enc_norm"], h, cfg.norm)

    def with_prefix(x, batch):
        """The token embeddings ``x`` (B, S_tok, d) -> (x after the patch
        prefix when the batch has one, positions 0.. over the whole
        sequence, M-RoPE's (3, B, S) positions: the batch's, else the 1-D
        ones broadcast; None without M-RoPE)."""
        if has_prefix and "patch_embeds" in batch:
            x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
        B, S = x.shape[:2]
        positions = torch.broadcast_to(
            torch.arange(S, dtype=torch.int32, device=x.device), (B, S))
        positions3 = batch.get("positions3")
        if cfg.attn.rope == "mrope" and positions3 is None:
            positions3 = torch.broadcast_to(positions[None], (3, B, S))
        return x, positions, positions3

    def decode_positions(index, B, device):
        """A decode step's (B, 1) positions (``index`` a scalar or (B,))
        and M-RoPE's (3, B, 1) ones (None without M-RoPE)."""
        idx = torch.as_tensor(index, dtype=torch.int32, device=device)
        positions = (idx.reshape(B, 1) if idx.dim()
                     else torch.full((B, 1), int(idx), dtype=torch.int32,
                                     device=device))
        positions3 = (torch.broadcast_to(positions[None], (3, B, 1))
                      if cfg.attn.rope == "mrope" else None)
        return positions, positions3

    def embed_inputs(params, batch):
        """-> (x, positions, positions3, enc_out): :func:`with_prefix` of
        the token embeddings and the encoder's output of the batch's frames
        (None without an encoder)."""
        x = embed_tokens(params["embed"], batch["tokens"],
                         scale=cfg.embed_scale)
        x, positions, positions3 = with_prefix(x, batch)
        enc_out = (run_encoder(params, batch["frame_embeds"]) if is_encdec
                   else None)
        return x, positions, positions3, enc_out

    def loss_fn(params, batch, rng=None):
        """Mean next-token cross-entropy over the masked positions (the
        patch prefix's rows dropped before the head), plus MTP_WEIGHT times
        the MTP head's (predicting t + 2 from h_t and the embedding of
        t + 1) and the MoE load-balance loss. ``rng`` is accepted for
        signature parity and unused: the train path draws no
        randomness."""
        x, positions, positions3, enc_out = embed_inputs(params, batch)
        h, _, aux = tfm.apply_stack(params["decoder"], x, cfg=cfg,
                                    positions=positions,
                                    positions3=positions3, enc_out=enc_out)
        h = apply_norm(params["final_norm"], h, cfg.norm)
        P = (batch["patch_embeds"].shape[1]
             if has_prefix and "patch_embeds" in batch else 0)
        h = h[:, P:]
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
            hm = torch.cat([h[:, :-1], x[:, P + 1:]], dim=-1)
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

    def split_loss_fn(params, batch, rng=None):
        """The split route's loss (``build_model``'s docstring): this fsdp
        rank's rows of ``batch`` (each input cut on its own batch dim:
        M-RoPE's ``positions3`` (3, B, S) on its second), the embedding
        lookup whole (differentiated on model rank 0 only) after the rank's
        rows of the patch prefix, the blocks split where ``split`` splits
        them, the prefix's rows dropped before the head, the head
        vocab-parallel where it splits the vocabulary; the nll over the
        whole batch's token count (summed over fsdp), plus the blocks' MoE
        aux (the whole batch's, equal on every rank, its gradient
        differentiated once: ``moe.py``)."""
        rows = split.batch_rows(batch["tokens"].shape[0])
        batch = {k: v[:, rows] if k == "positions3" else v[rows]
                 for k, v in batch.items()}
        table = params["embed"]["table"]
        x = embed_tokens({"table": split.first_rank_grad(table)},
                         batch["tokens"], scale=cfg.embed_scale)
        x, positions, positions3 = with_prefix(x, batch)
        h, _, aux = tfm.apply_stack(params["decoder"], x, cfg=cfg,
                                    positions=positions,
                                    positions3=positions3, split=split)
        h = apply_norm(params["final_norm"], h, cfg.norm)
        h = h[:, x.shape[1] - batch["tokens"].shape[1]:]
        targets = batch["targets"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=x.device)
        vsplit = split if split.vocab(V) else None
        hw = head_w(params)
        if vsplit is not None:
            h = split.copy_in(h)
            if cfg.tie_embeddings:
                v0, v1 = split.vocab_rows(V)
                hw = table[v0:v1].T
        nll, count = chunked_softmax_xent(h, hw, targets, mask,
                                          cfg.dist.loss_chunk, split=vsplit)
        loss = nll / torch.clamp(split.fsdp_sum(count), min=1.0)
        whole = split.fsdp_sum(loss.detach().clone())
        aux_d = aux.detach()
        return loss + aux, {"nll": whole, "loss": whole + aux_d,
                            "aux": aux_d}

    def prefill(params, batch, max_len: Optional[int] = None):
        """batch["tokens"] (B, S) (and the patch prefix or the encoder's
        frames) -> (logits (B, padded_vocab) float32 of the last position,
        caches of ``max_len`` (default: the prefix and S) slots; with an
        encoder, each block's cross keys and values of its S_src rows)."""
        x, positions, positions3, enc_out = embed_inputs(params, batch)
        S = x.shape[1]
        h, caches, _ = tfm.apply_stack(params["decoder"], x, cfg=cfg,
                                       positions=positions, mode="prefill",
                                       positions3=positions3,
                                       enc_out=enc_out,
                                       cache_max_len=max_len or S)
        h = apply_norm(params["final_norm"], h[:, -1:], cfg.norm)
        logits = (h @ head_w(params)).to(torch.float32)[:, 0]
        return logits, caches

    def decode_step(params, caches, tokens, index):
        """tokens: (B, 1) int; index: the absolute position(s), prefix
        included — a scalar shared by the batch, or a (B,) vector when
        every row sits at its own depth (continuous batching over slots).
        Writes ``caches`` in place and returns (logits (B, padded_vocab)
        float32, caches)."""
        x = embed_tokens(params["embed"], tokens, scale=cfg.embed_scale)
        positions, positions3 = decode_positions(index, tokens.shape[0],
                                                 x.device)
        h, caches, _ = tfm.apply_stack(params["decoder"], x, cfg=cfg,
                                       positions=positions, mode="decode",
                                       positions3=positions3, caches=caches)
        h = apply_norm(params["final_norm"], h, cfg.norm)
        logits = (h @ head_w(params)).to(torch.float32)[:, 0]
        return logits, caches

    def init_cache(B, seq_len, dtype=None, enc_len: int = 0, device=None):
        """Empty caches for B rows of ``seq_len`` positions on ``device``
        (default: the card); with an encoder, each block's cross keys and
        values of ``enc_len`` (default ``seq_len``) slots at pos -1. On the
        split route the rank's block of each (B is the data rank's
        rows)."""
        return tfm.init_stack_cache(cfg, B, seq_len,
                                    device=resolve_device(device),
                                    cross=is_encdec,
                                    enc_len=enc_len or seq_len,
                                    dtype=dtype or dt, split=split)

    serve = {}

    def serve_plan():
        """The serve route's plan of the rank's pieces (built once)."""
        if "plan" not in serve:
            serve["plan"] = tp.serve_plan(
                cfg, split, tp.serve_shardings(model, split.mesh))
        return serve["plan"]

    def split_embed(params, tokens):
        """The lookup on the rank's columns of the table (gathered over the
        data line where it is held by rows there), scaled, then the
        columns gathered over the model line."""
        plan = serve_plan()["embed"]["table"]
        table = tp.materialize(params["embed"]["table"], plan, split)
        x = table[tokens.long()]
        if cfg.embed_scale:
            x = x * math.sqrt(cfg.d_model)
        if plan.entry[-1] == "model":
            x = split.gather(x, "model", -1)
        return x

    def split_logits(params, h):
        """(B, S, d) -> float32 logits (B, S, padded_vocab), whole on every
        model rank: a tied table held by d_model columns sums the ranks'
        partial products over the model line; an untied head held by
        vocabulary columns gathers the ranks' columns."""
        if cfg.tie_embeddings:
            plan = serve_plan()["embed"]["table"]
            table = tp.materialize(params["embed"]["table"], plan, split)
            if plan.entry[-1] != "model":
                return (h @ table.T).to(torch.float32)
            n = table.shape[-1]
            c0 = split.model_rank * n
            return split.model_sum(
                (h[..., c0:c0 + n] @ table.T).to(torch.float32))
        plan = serve_plan()["head"]["w"]
        w = tp.materialize(params["head"]["w"], plan, split)
        lg = (h @ w).to(torch.float32)
        return (split.gather(lg, "model", -1) if plan.entry[-1] == "model"
                else lg)

    def split_prefill(params, batch, max_len: Optional[int] = None):
        """``prefill`` on the rank's pieces for the data rank's rows:
        (logits (B, padded_vocab) float32, whole on every model rank, the
        rank's cache blocks of ``max_len`` slots). The patch prefix (whole
        on every rank) enters after the lookup's columns are gathered."""
        x, positions, positions3 = with_prefix(
            split_embed(params, batch["tokens"]), batch)
        h, caches, _ = tfm.apply_stack(params["decoder"], x, cfg=cfg,
                                       positions=positions, mode="prefill",
                                       positions3=positions3,
                                       cache_max_len=max_len or x.shape[1],
                                       split=split,
                                       plan=serve_plan()["decoder"])
        h = apply_norm(params["final_norm"], h[:, -1:], cfg.norm)
        return split_logits(params, h)[:, 0], caches

    def split_decode_step(params, caches, tokens, index):
        """``decode_step`` on the rank's pieces and cache blocks."""
        x = split_embed(params, tokens)
        positions, positions3 = decode_positions(index, tokens.shape[0],
                                                 x.device)
        h, caches, _ = tfm.apply_stack(params["decoder"], x, cfg=cfg,
                                       positions=positions, mode="decode",
                                       positions3=positions3,
                                       caches=caches, split=split,
                                       plan=serve_plan()["decoder"])
        h = apply_norm(params["final_norm"], h, cfg.norm)
        return split_logits(params, h)[:, 0], caches

    if split is not None:
        loss_fn = split_loss_fn
        prefill, decode_step = split_prefill, split_decode_step
    loss_fn.cfg = cfg
    model = Model(cfg=cfg, init_params=init_params, loss_fn=loss_fn,
                  prefill=prefill, decode_step=decode_step,
                  init_cache=init_cache, head_w=head_w,
                  param_spec=param_spec, cache_spec=cache_spec,
                  serve_plan=serve_plan if split is not None else None)
    return model
