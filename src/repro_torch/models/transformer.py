"""Decoder and encoder stacks (counterpart of
``repro/models/transformer.py``): GQA, MLA or recurrent (RG-LRU, mLSTM,
sLSTM) mixers, gated-MLP, MoE or no FFN (``"none"``: the block is norm +
mixer + residual), deepseek-v3's dense ``front`` segment, and (with
``cross``) a cross-attention sub-block after the mixer (``norm_x`` and
``cross`` leaves: seamless-m4t's decoder).

Layers are grouped into segments exactly as in the reference (e.g.
recurrentgemma-2b: (rglru, rglru, local attention) x 8 and a (rglru,
rglru) ``tail``); each period position's parameters are stacked along a
leading ``n_rep`` axis. The reference scans over that axis (with remat);
here a Python loop indexes it, which changes no number. Caches (prefill,
decode) have the reference's tree, ``{seg.name: {"p{i}": {"mixer":
...}}}`` with the attention caches ``{"k", "v", "pos"}`` (MLA: ``{"ckv",
"krope", "pos"}``) and the recurrent states (RG-LRU ``{"h", "conv"}``,
mLSTM ``{"C", "n", "m"}``, sLSTM ``{"c", "n", "h", "m"}``); a
cross-attention block adds ``"cross"``, ``{"k", "v", "pos"}`` over the
encoder's rows, beside ``"mixer"``. Each leaf is stacked on the layer
axis first, so a cache row (a batch entry, a serving slot) is axis 1.
Decode writes every layer's row of the caches in place.

``spec_block``, ``spec_block_cache``, ``spec_stack`` and
``spec_stack_cache`` are the reference's logical specs of those trees. A
block takes a ``split`` (``models/tensor_parallel.py``): its GQA mixer runs
on the rank's heads and its MLP on the rank's d_ff columns where the model
line divides them, its MoE FFN on the rank's experts. In prefill and
decode ``apply_stack`` is given the serve route's ``plan`` too and gathers
each layer's leaves before its block (``tensor_parallel.materialize``),
and ``init_stack_cache(split=)`` allocates the rank's kv heads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.layers import (activation, apply_mlp, apply_norm,
                                       init_mlp, init_norm, spec_mlp,
                                       spec_norm)


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


_MIXER_INIT = {"gqa": attn.init_gqa, "mla": attn.init_mla,
               "rglru": rec.init_rglru, "mlstm": rec.init_mlstm,
               "slstm": rec.init_slstm}
_MIXER_SPEC = {"gqa": attn.spec_gqa, "mla": attn.spec_mla,
               "rglru": rec.spec_rglru, "mlstm": rec.spec_mlstm,
               "slstm": rec.spec_slstm}
_MIXER_CACHE_SPEC = {"gqa": attn.spec_gqa_cache, "mla": attn.spec_mla_cache,
                     "rglru": rec.spec_rglru_state,
                     "mlstm": rec.spec_mlstm_state,
                     "slstm": rec.spec_slstm_state}
_RECURRENT = {"rglru": rec.rglru_forward, "mlstm": rec.mlstm_forward,
              "slstm": rec.slstm_forward}
_FFNS = ("swiglu", "geglu", "moe", "none")


def _check(lspec: LayerSpec):
    if lspec.mixer not in _MIXER_INIT or lspec.ffn not in _FFNS:
        raise NotImplementedError(
            f"layer {lspec}: the port runs the mixers {tuple(_MIXER_INIT)} "
            f"and the FFNs {_FFNS}")


def init_block(generator, cfg: ModelConfig, lspec: LayerSpec, *, device,
               cross: bool = False, d_ff_override: Optional[int] = None,
               dtype=torch.float32):
    _check(lspec)
    p = {"norm1": init_norm(cfg.norm, cfg.d_model, device=device,
                            dtype=dtype),
         "mixer": _MIXER_INIT[lspec.mixer](generator, cfg, device=device,
                                           dtype=dtype)}
    if cross:
        p["norm_x"] = init_norm(cfg.norm, cfg.d_model, device=device,
                                dtype=dtype)
        p["cross"] = attn.init_cross(generator, cfg, device=device,
                                     dtype=dtype)
    if lspec.ffn == "none":
        return p
    p["norm2"] = init_norm(cfg.norm, cfg.d_model, device=device, dtype=dtype)
    if lspec.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(generator, cfg, device=device,
                                    dtype=dtype)
    else:
        p["ffn"] = init_mlp(generator, cfg.d_model, d_ff_override or cfg.d_ff,
                            device=device, gated=True, dtype=dtype)
    return p


def spec_block(cfg: ModelConfig, lspec: LayerSpec, cross: bool = False):
    p = {"norm1": spec_norm(cfg.norm), "mixer": _MIXER_SPEC[lspec.mixer]()}
    if cross:
        p["norm_x"] = spec_norm(cfg.norm)
        p["cross"] = attn.spec_cross()
    if lspec.ffn != "none":
        p["norm2"] = spec_norm(cfg.norm)
        p["ffn"] = (moe_mod.spec_moe(cfg) if lspec.ffn == "moe"
                    else spec_mlp(gated=True))
    return p


def apply_block(params, x, *, cfg: ModelConfig, lspec: LayerSpec, positions,
                mode: str = "train", cache=None, positions3=None,
                enc_out=None, cross_kv=None, causal=True,
                cache_max_len=None, split=None):
    """One pre-norm block: x + mixer(norm(x)); with cross attention (the
    block has ``cross`` leaves) x + cross(norm_x(x)) over ``cross_kv``, or
    the keys and values projected from ``enc_out`` when none is given;
    then (unless the FFN is "none") x + ffn(norm(x)). Returns (x, cache,
    aux): cache None in train mode, else {"mixer": the attention cache or
    recurrent state[, "cross": the cross keys and values]}; aux the MoE
    load-balance loss (weighted; 0 without a MoE FFN). A MoE FFN runs
    dropless outside training. In decode the mixer's cache is written in
    place (a recurrent state copied into the given tensors). ``split``
    (a GQA block with a gated MLP or an MoE FFN): the mixer on the rank's
    heads where ``split.attn`` holds, the MLP on its d_ff columns where
    ``split.mlp`` does, the MoE FFN on the rank's experts (``moe.py``'s
    split route); the leaves are then the rank's blocks."""
    _check(lspec)
    h = apply_norm(params["norm1"], x, cfg.norm)
    if lspec.mixer in _RECURRENT:
        y, new_cache = _RECURRENT[lspec.mixer](params["mixer"], h, cfg=cfg,
                                               mode=mode, state=cache)
        if mode == "decode":
            # the cache's tensors are views of the stacked serving cache:
            # the new state is copied into them, so the slots advance
            for k, v in new_cache.items():
                cache[k].copy_(v)
            new_cache = cache
    else:
        fwd = attn.gqa_forward if lspec.mixer == "gqa" else attn.mla_forward
        y, new_cache = fwd(params["mixer"], h, cfg=cfg, lspec=lspec,
                           positions=positions, mode=mode, cache=cache,
                           positions3=positions3, causal=causal,
                           cache_max_len=cache_max_len,
                           split=split if split is not None
                           and split.attn(cfg.attn) else None)
    x = x + y
    if "cross" in params:
        hx = apply_norm(params["norm_x"], x, cfg.norm)
        if cross_kv is None:
            cross_kv = attn.cross_kv(params["cross"], enc_out, cfg=cfg)
        x = x + attn.cross_forward(params["cross"], hx, cross_kv, cfg=cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if lspec.ffn != "none":
        h2 = apply_norm(params["norm2"], x, cfg.norm)
        if lspec.ffn == "moe":
            y2, aux = moe_mod.moe_forward(params["ffn"], h2, cfg=cfg,
                                          act_name=cfg.act,
                                          dropless=mode != "train",
                                          split=split)
        else:
            y2 = apply_mlp(params["ffn"], h2, activation(cfg.act),
                           gated=True, split=split if split is not None
                           and split.mlp(cfg.d_ff) else None)
        x = x + y2
    if mode == "train":
        return x, None, aux
    out = {"mixer": new_cache}
    if cross_kv is not None:
        out["cross"] = cross_kv
    return x, out, aux


def spec_block_cache(cfg: ModelConfig, lspec: LayerSpec, cross: bool):
    c = {"mixer": _MIXER_CACHE_SPEC[lspec.mixer]()}
    if cross:
        c["cross"] = {"k": ("data", None, "model", None),
                      "v": ("data", None, "model", None),
                      "pos": ("data", None)}
    return c


def init_block_cache(cfg: ModelConfig, lspec: LayerSpec, B: int,
                     seq_len: int, *, device, cross: bool = False,
                     enc_len: int = 0, dtype=torch.float32, split=None):
    _check(lspec)
    if lspec.mixer == "rglru":
        c = rec.init_rglru_state(cfg, B, device=device, dtype=dtype)
    elif lspec.mixer == "mlstm":
        c = rec.init_mlstm_state(cfg, B, device=device)
    elif lspec.mixer == "slstm":
        c = rec.init_slstm_state(cfg, B, device=device)
    elif lspec.mixer == "gqa":
        kv = (cfg.attn.num_kv_heads // split.model_size
              if split is not None and split.kv(cfg.attn) else None)
        c = attn.init_gqa_cache(cfg, lspec, B, seq_len, device=device,
                                dtype=dtype, kv_heads=kv)
    else:
        c = attn.init_mla_cache(cfg, lspec, B, seq_len, device=device,
                                dtype=dtype)
    out = {"mixer": c}
    if cross:
        a = cfg.attn
        shape = (B, enc_len, a.num_kv_heads, a.head_dim)
        out["cross"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((B, enc_len), -1, dtype=torch.int32,
                              device=device)}
    return out


def _stack(trees):
    """Stack same-shaped trees along a new leading axis. One tree is viewed
    with that axis, not copied: a copy would hold its block twice while the
    stack is built (7 GiB an expert bank at deepseek-v3's width)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if len(trees) == 1:
        return trees[0].unsqueeze(0)
    return torch.stack(trees, 0)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def init_stack(generator, cfg: ModelConfig, *, device, cross: bool = False,
               dtype=torch.float32):
    """Params for all segments: {seg.name: {"p{i}": stacked params}}; with
    ``cross`` every block has cross-attention leaves."""
    out = {}
    for seg in build_segments(cfg):
        out[seg.name] = {
            f"p{i}": _stack([init_block(generator, cfg, ls, device=device,
                                        cross=cross,
                                        d_ff_override=seg.d_ff_override,
                                        dtype=dtype)
                             for _ in range(seg.n_rep)])
            for i, ls in enumerate(seg.specs)}
    return out


def spec_stack(cfg: ModelConfig, cross: bool = False):
    return {seg.name: {f"p{i}": spec_block(cfg, ls, cross=cross)
                       for i, ls in enumerate(seg.specs)}
            for seg in build_segments(cfg)}


def init_stack_cache(cfg: ModelConfig, B: int, seq_len: int, *, device,
                     cross: bool = False, enc_len: int = 0,
                     dtype=torch.float32, split=None):
    """Empty caches of every layer, each leaf (n_rep, B, ...); with
    ``cross`` each block's cross keys and values of ``enc_len`` slots at
    pos -1; with ``split`` the rank's block of each (its Kv / M kv heads
    where the model line divides Kv: ``cache_spec`` under ``serve_rules``;
    B is the data rank's rows)."""
    out = {}
    for seg in build_segments(cfg):
        out[seg.name] = {
            f"p{i}": _stack([init_block_cache(cfg, ls, B, seq_len,
                                              device=device, cross=cross,
                                              enc_len=enc_len, dtype=dtype,
                                              split=split)
                             for _ in range(seg.n_rep)])
            for i, ls in enumerate(seg.specs)}
    return out


def spec_stack_cache(cfg: ModelConfig, cross: bool = False):
    return {seg.name: {f"p{i}": spec_block_cache(cfg, ls, cross)
                       for i, ls in enumerate(seg.specs)}
            for seg in build_segments(cfg)}


def apply_stack(params, x, *, cfg: ModelConfig, positions, mode="train",
                caches=None, positions3=None, enc_out=None, causal=True,
                cache_max_len=None, split=None, plan=None):
    """Run all segments. Returns (x, caches, aux): train mode no caches;
    prefill fresh caches sized ``cache_max_len`` (with cross attention,
    each block's keys and values of ``enc_out``); decode takes ``caches``,
    writes each layer's row of them in place and returns them (the cross
    keys and values read as they are). ``aux`` is the sum of the blocks'
    MoE losses (float32). ``causal=False`` is the encoder's attention;
    ``split`` as ``apply_block``'s; ``plan`` (the serve route: the stack's
    ``tensor_parallel.serve_plan``) gathers each layer's leaves before its
    block, freed after it."""
    new_caches = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg in build_segments(cfg):
        seg_params = params[seg.name]
        per_rep = []
        for r in range(seg.n_rep):
            blk_caches = {}
            for i, ls in enumerate(seg.specs):
                p = _index(seg_params[f"p{i}"], r)
                if plan is not None:
                    p = tp.materialize(p, plan[seg.name][f"p{i}"], split)
                cache = cross_kv = None
                if mode == "decode":
                    # views of the stacked leaves: decode writes through them
                    row = _index(caches[seg.name][f"p{i}"], r)
                    cache, cross_kv = row["mixer"], row.get("cross")
                x, blk_cache, aux = apply_block(
                    p, x, cfg=cfg, lspec=ls, positions=positions, mode=mode,
                    cache=cache, positions3=positions3, enc_out=enc_out,
                    cross_kv=cross_kv, causal=causal,
                    cache_max_len=cache_max_len, split=split)
                aux_total = aux_total + aux
                blk_caches[f"p{i}"] = blk_cache
            per_rep.append(blk_caches)
        if mode == "prefill":
            new_caches[seg.name] = _stack(per_rep)
    if mode == "train":
        return x, None, aux_total
    return x, (new_caches if mode == "prefill" else caches), aux_total
