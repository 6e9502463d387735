"""Parameter counts and MODEL_FLOPS (6 N D) of a model (counterpart of
``repro/utils/flops.py``).

N (and N_active for a MoE) come from the model's own parameter shapes:
``init_params`` run on PyTorch's ``meta`` device, which gives every leaf's
shape and dtype and allocates nothing (the reference takes them from
``jax.eval_shape``). D is the number of tokens of the step.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.utils.tree import tree_flatten


def _count(tree) -> int:
    return int(sum(np.prod(x.shape, dtype=np.int64)
                   for x in tree_flatten(tree)[0]))


def param_shapes(model):
    """The model's parameter tree on the ``meta`` device (shapes and
    dtypes, no storage)."""
    return model.init_params(torch.Generator(), torch.device("meta"))


def _routed(tree) -> int:
    """Scalars of the routed expert banks (w_in, w_gate, w_out of every
    'ffn' that has a router)."""
    n = 0
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "ffn" and isinstance(v, dict) and "router" in v:
                for kk in ("w_in", "w_gate", "w_out"):
                    if kk in v:
                        n += int(np.prod(v[kk].shape, dtype=np.int64))
            else:
                n += _routed(v)
    return n


def param_counts(model) -> dict:
    """{'total': N, 'active': N_active} from the parameter shapes: a token
    reaches top_k of the E routed experts."""
    cfg: ModelConfig = model.cfg
    shapes = param_shapes(model)
    total = _count(shapes)
    active = total
    if cfg.moe is not None:
        routed = _routed(shapes)
        frac = cfg.moe.top_k / cfg.moe.num_experts
        active = total - routed + int(routed * frac)
    return {"total": total, "active": active}


def model_flops(model, shape: ShapeConfig) -> dict:
    """MODEL_FLOPS for one step: 6 N_active D to train, 2 N_active D for
    inference, and the attention score/value FLOPs apart."""
    cfg: ModelConfig = model.cfg
    counts = param_counts(model)
    n_act = counts["active"]
    if shape.kind == "train":
        D = shape.global_batch * shape.seq_len
        base = 6 * n_act * D
    elif shape.kind == "prefill":
        D = shape.global_batch * shape.seq_len
        base = 2 * n_act * D
    else:  # decode: one token per request
        D = shape.global_batch
        base = 2 * n_act * D
    # attention score/value FLOPs (full attention; a window caps the length)
    S = shape.seq_len
    a = cfg.attn
    eff = S
    n_attn_layers = sum(1 for s in cfg.layer_specs()
                        if s.mixer in ("gqa", "mla"))
    if all(s.window for s in cfg.layer_specs() if s.mixer == "gqa"):
        eff = min(S, max((s.window or S) for s in cfg.layer_specs()))
    if shape.kind == "decode":
        attn = (4 * shape.global_batch * eff * a.num_heads * a.head_dim
                * n_attn_layers)
    else:
        mult = 12 if shape.kind == "train" else 4
        attn = (mult * shape.global_batch * S * eff // 2 * a.num_heads
                * a.head_dim * n_attn_layers)
    return {"model_flops": int(base), "attn_flops": int(attn),
            "tokens": D, **counts}
