"""Mixture-of-Experts FFN with capacity-based scatter/gather dispatch
(counterpart of ``repro/models/moe.py``).

Parameters have the reference's keys and shapes: ``router`` (d, E) float32,
expert banks ``w_in``, ``w_gate`` (E, d, f) and ``w_out`` (E, f, d), and the
optional always-on ``shared`` (deepseek-v3) and parallel ``dense`` (arctic)
gated MLPs.

Dispatch as in the reference: each (token, slot) assignment gets its rank
within its expert from a stable sort of the expert ids (the reference's
associative max scan of run starts is ``torch.cummax`` here); assignments
ranked at or past the capacity C go to a discarded column C of the (E,
C + 1, d) buffer and add nothing. The expert products are batched matrix
products over the expert axis, as the reference's einsums; the reference's
sharding constraints (``moe_dispatch_shard``) change no number on one
device. ``spec_moe`` is the reference's logical spec of the leaves.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import activation, apply_mlp, dense_init


def init_moe(generator, cfg: ModelConfig, *, device, dtype=torch.float32):
    m = cfg.moe
    d = cfg.d_model
    scale = 1.0 / math.sqrt(d)

    def expert_bank(d_in, d_out):
        w = torch.randn((m.num_experts, d_in, d_out), generator=generator,
                        device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    def mlp(f):
        return {"w_in": dense_init(generator, d, f, device=device,
                                   dtype=dtype),
                "w_gate": dense_init(generator, d, f, device=device,
                                     dtype=dtype),
                "w_out": dense_init(generator, f, d, device=device,
                                    dtype=dtype)}

    p = {"router": dense_init(generator, d, m.num_experts, device=device,
                              dtype=torch.float32),
         "w_in": expert_bank(d, m.expert_ff),
         "w_gate": expert_bank(d, m.expert_ff),
         "w_out": expert_bank(m.expert_ff, d)}
    if m.shared_ff:
        p["shared"] = mlp(m.shared_ff)
    if m.dense_ff:
        p["dense"] = mlp(m.dense_ff)
    return p


def spec_moe(cfg: ModelConfig):
    """The reference's logical specs of the MoE leaves: the expert banks
    over ``expert``, the shared and dense MLPs as ``spec_mlp``."""
    m = cfg.moe
    p = {"router": (None, None),
         "w_in": ("expert", "fsdp", None),
         "w_gate": ("expert", "fsdp", None),
         "w_out": ("expert", None, "fsdp")}
    mlp = {"w_in": ("fsdp", "model"), "w_gate": ("fsdp", "model"),
           "w_out": ("model", "fsdp")}
    if m.shared_ff:
        p["shared"] = dict(mlp)
    if m.dense_ff:
        p["dense"] = dict(mlp)
    return p


def _route(x2, params, m: MoEConfig):
    """x2: (T, d) -> (weights (T, k), experts (T, k), aux_loss): the top-k
    of the softmax (or, for ``router="sigmoid"``, the sigmoid) scores,
    renormalised to sum to 1, and the load-balance loss E sum_e frac_e
    mean_prob_e."""
    logits = x2.to(torch.float32) @ params["router"]  # (T, E)
    if m.router == "sigmoid":
        scores = torch.sigmoid(logits)
        w, sel = torch.topk(scores, m.top_k, dim=-1)
        w = w / (torch.sum(w, -1, keepdim=True) + 1e-9)
        probs = scores / (torch.sum(scores, -1, keepdim=True) + 1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, sel = torch.topk(probs, m.top_k, dim=-1)
        w = w / (torch.sum(w, -1, keepdim=True) + 1e-9)
    T = x2.shape[0]
    counts = torch.zeros((m.num_experts,), dtype=torch.float32,
                         device=x2.device).index_add_(
        0, sel.reshape(-1),
        torch.ones((sel.numel(),), dtype=torch.float32, device=x2.device))
    frac = counts / (T * m.top_k)
    mean_prob = torch.mean(probs, dim=0)
    aux = m.num_experts * torch.sum(frac * mean_prob)
    return w, sel, aux


def _shared_and_dense(params, x2, y, m: MoEConfig, act):
    if m.shared_ff:
        y = y + apply_mlp(params["shared"], x2, act)
    if m.dense_ff:
        y = y + apply_mlp(params["dense"], x2, act)
    return y


def capacity(T: int, m: MoEConfig, dropless: bool) -> int:
    """Slots an expert takes: T when dropless, else ceil(T k / E cf),
    between 1 and T (the reference's arithmetic, in the same order)."""
    if dropless:
        return T
    C = max(1, int(math.ceil(T * m.top_k / m.num_experts
                             * m.capacity_factor)))
    return min(C, T)


def dispatch_ranks(sel, C: int):
    """sel (T, k) expert ids -> (flat expert ids (T k,), rank of each
    assignment within its expert clamped to C, valid (rank < C)). Ranks
    follow the assignments' order (token, then slot) within each expert."""
    flat_e = sel.reshape(-1)
    Tk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)  # grouped by expert
    sorted_e = flat_e[order]
    idx = torch.arange(Tk, dtype=torch.int64, device=sel.device)
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool,
                                     device=sel.device),
                          sorted_e[1:] != sorted_e[:-1]])
    run_start = torch.cummax(torch.where(is_start, idx, -1), 0).values
    rank = torch.empty_like(idx).scatter_(0, order, idx - run_start)
    return flat_e, torch.clamp(rank, max=C), rank < C


def moe_forward(params, x, *, cfg: ModelConfig, act_name: str,
                dropless: bool = False):
    """x: (B, S, d) -> (y, aux_loss * aux_loss_weight).

    ``dropless=True`` sets the capacity to T, so no assignment overflows:
    prefill and decode run so (whether a token drops would otherwise depend
    on later tokens and on the other requests of a batch); training keeps
    the capped buffer."""
    m = cfg.moe
    act = activation(act_name)
    B, S, d = x.shape
    T = B * S
    x2 = x.reshape(T, d)
    w, sel, aux = _route(x2, params, m)
    E, k = m.num_experts, m.top_k
    C = capacity(T, m, dropless)
    flat_e, rank_c, valid = dispatch_ranks(sel, C)

    tok_idx = torch.arange(T, device=x.device).repeat_interleave(k)
    xg = x2[tok_idx]  # (T k, d)
    buf = x.new_zeros((E, C + 1, d)).index_put((flat_e, rank_c), xg)
    he = buf[:, :C]  # (E, C, d): the overflow column dropped
    h = torch.bmm(he, params["w_in"])
    g = torch.bmm(he, params["w_gate"])
    out = torch.bmm(act(g) * h, params["w_out"])  # (E, C, d)

    out_pad = torch.nn.functional.pad(out, (0, 0, 0, 1))
    y_assign = out_pad[flat_e, rank_c]
    y_assign = y_assign * (w.reshape(-1)[:, None]
                           * valid[:, None]).to(out.dtype)
    y = torch.sum(y_assign.reshape(T, k, d), dim=1)
    y = _shared_and_dense(params, x2, y, m, act)
    return y.reshape(B, S, d), aux * m.aux_loss_weight


def moe_ref(params, x, *, cfg: ModelConfig, act_name: str):
    """The dropless dense twin (every expert on every token, gated by the
    router's weights): for tests, on small shapes."""
    m = cfg.moe
    act = activation(act_name)
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    w, sel, aux = _route(x2, params, m)
    h = torch.einsum("td,edf->tef", x2, params["w_in"])
    g = torch.einsum("td,edf->tef", x2, params["w_gate"])
    out = torch.einsum("tef,efd->ted", act(g) * h, params["w_out"])
    gate = torch.zeros((x2.shape[0], m.num_experts), dtype=out.dtype,
                       device=x.device)
    gate = gate.scatter(1, sel, w.to(out.dtype))
    y = torch.einsum("te,ted->td", gate, out)
    y = _shared_and_dense(params, x2, y, m, act)
    return y.reshape(B, S, d), aux * m.aux_loss_weight
