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

On the split route (``split``, ``models/tensor_parallel.py``) model rank j
holds experts [j E / M, (j + 1) E / M) of the banks where M divides E
(:meth:`Split.experts`; else the banks stay whole on every rank). The
router runs whole on every rank, each rank dispatches to its own experts
only, and their combined output is a part summed over the model line with
the split ``dense`` / ``shared`` MLPs' (Megatron column / row pairs) in one
``reduce_out``; the load-balance aux's gradient then passes on model rank 0
only (the router's gradient is the ``sum`` rule: the aux once, and each
rank's combine part). In training the fsdp line shares the agent's batch,
and the capacity rule is the whole batch's: C = ``capacity`` of the
agent's T tokens, and an assignment's rank within its expert is its place
in the whole batch's (token, slot) order, the exclusive prefix over the
fsdp line of each expert's count (one all-gather of E integers) plus its
rank on this fsdp rank, so each rank keeps exactly the assignments one
process keeps; the buffer holds min(C, T on the rank) slots an expert, and
no routed count is read on the host. The aux's ``frac`` and ``mean_prob``
are the whole batch's (counts and probabilities summed over fsdp). Serving
is dropless on each data rank's own rows.
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


def _scores(x2, params, m: MoEConfig):
    """x2: (T, d) -> (weights (T, k), experts (T, k), probs (T, E)): the
    top-k of the softmax (or, for ``router="sigmoid"``, the sigmoid)
    scores, renormalised to sum to 1, and the probabilities the
    load-balance loss averages."""
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
    return w, sel, probs


def _route(x2, params, m: MoEConfig):
    """x2: (T, d) -> (weights (T, k), experts (T, k), aux_loss): the
    routing of :func:`_scores` and the load-balance loss E sum_e frac_e
    mean_prob_e."""
    w, sel, probs = _scores(x2, params, m)
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


def expert_ranks(sel):
    """sel (T, k) expert ids -> (flat expert ids (T k,), rank of each
    assignment within its expert). Ranks follow the assignments' order
    (token, then slot) within each expert."""
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
    return flat_e, rank


def dispatch_ranks(sel, C: int):
    """sel (T, k) expert ids -> (flat expert ids (T k,), rank of each
    assignment within its expert clamped to C, valid (rank < C))."""
    flat_e, rank = expert_ranks(sel)
    return flat_e, torch.clamp(rank, max=C), rank < C


def split_dispatch(sel, prefix, e0: int, n: int, C: int, slots: int):
    """The split route's dispatch of this rank's assignments ``sel`` (T, k)
    to its experts [e0, e0 + n): (local expert ids, slots, valid), each
    (T k,). An assignment is valid where its expert is the rank's and its
    rank in the whole batch (``prefix`` (E,) the assignments to each
    expert before this rank's tokens, plus its rank here) is below C; a
    valid one takes the slot of its rank here (below ``slots`` = min(C,
    the rank's T): a token reaches an expert at most once), the others
    the dropped column ``slots`` of local expert 0."""
    flat_e, rank = expert_ranks(sel)
    mine = (flat_e >= e0) & (flat_e < e0 + n)
    valid = mine & (rank + prefix[flat_e] < C)
    return (torch.where(mine, flat_e - e0, 0), torch.where(valid, rank, slots),
            valid)


def _experts(params, x2, le, slot, valid, w, n: int, slots: int, k: int,
             act):
    """The banks' output for the assignments (le, slot): x2's tokens
    scattered into an (n, slots + 1, d) buffer (the last column dropped),
    the batched expert products, each valid assignment's output weighted
    by ``w`` and summed over its token's k slots: (T, d)."""
    T, d = x2.shape
    tok_idx = torch.arange(T, device=x2.device).repeat_interleave(k)
    buf = x2.new_zeros((n, slots + 1, d)).index_put((le, slot), x2[tok_idx])
    he = buf[:, :slots]
    h = torch.bmm(he, params["w_in"])
    g = torch.bmm(he, params["w_gate"])
    out = torch.bmm(act(g) * h, params["w_out"])  # (n, slots, d)
    out_pad = torch.nn.functional.pad(out, (0, 0, 0, 1))
    y_assign = out_pad[le, slot] * (w.reshape(-1)[:, None]
                                    * valid[:, None]).to(out.dtype)
    return torch.sum(y_assign.reshape(T, k, d), dim=1)


def moe_forward(params, x, *, cfg: ModelConfig, act_name: str,
                dropless: bool = False, split=None):
    """x: (B, S, d) -> (y, aux_loss * aux_loss_weight).

    ``dropless=True`` sets the capacity to T, so no assignment overflows:
    prefill and decode run so (whether a token drops would otherwise depend
    on later tokens and on the other requests of a batch); training keeps
    the capped buffer. ``split`` (``tensor_parallel.Split``): the split
    route (:func:`_moe_split`)."""
    if split is not None:
        return _moe_split(params, x, cfg=cfg, act_name=act_name,
                          dropless=dropless, split=split)
    m = cfg.moe
    act = activation(act_name)
    B, S, d = x.shape
    T = B * S
    x2 = x.reshape(T, d)
    w, sel, aux = _route(x2, params, m)
    E, k = m.num_experts, m.top_k
    C = capacity(T, m, dropless)
    flat_e, rank_c, valid = dispatch_ranks(sel, C)
    y = _experts(params, x2, flat_e, rank_c, valid, w, E, C, k, act)
    y = _shared_and_dense(params, x2, y, m, act)
    return y.reshape(B, S, d), aux * m.aux_loss_weight


def _moe_split(params, x, *, cfg: ModelConfig, act_name: str,
               dropless: bool, split):
    """``moe_forward`` on the split route (the module's docstring): x the
    rank's rows (B, S, d); the banks the rank's experts where
    ``split.experts(E)`` holds, else whole (then computed whole on every
    rank, outside the model line's sum); a ``dense`` / ``shared`` MLP the
    rank's d_ff columns where ``split.mlp`` holds its width, else whole.
    In training (not ``dropless``) the fsdp line shares the agent's
    batch: the capacity, the ranks within the experts and the aux are the
    whole batch's."""
    m = cfg.moe
    act = activation(act_name)
    B, S, d = x.shape
    T = B * S
    E, k = m.num_experts, m.top_k
    x2 = x.reshape(T, d)
    xc = split.copy_in(x2)  # the input of the parts summed over model
    ex = split.experts(E)
    xe = xc if ex else x2
    w, sel, probs = _scores(xe, params, m)
    counts = torch.zeros((E,), dtype=torch.int64, device=x.device).index_add_(
        0, sel.reshape(-1), torch.ones((sel.numel(),), dtype=torch.int64,
                                       device=x.device))
    prefix = torch.zeros_like(counts)
    psum = torch.sum(probs, dim=0)
    F = 1 if dropless else split.fsdp_size
    if F > 1:
        every = split.gather(counts[None], "fsdp", 0)  # (F, E)
        prefix = torch.sum(every[:split.fsdp_rank], dim=0)
        counts = torch.sum(every, dim=0)
        psum = split.fsdp_reduce_out(psum)
    T_all = F * T
    aux = E * torch.sum(counts.to(torch.float32) / (T_all * k)
                        * (psum / T_all))
    if ex:
        aux = split.first_rank_grad(aux)
    C = capacity(T_all, m, dropless)
    slots = min(C, T)
    e0, n = split.expert_block(E)
    le, slot, valid = split_dispatch(sel, prefix, e0, n, C, slots)
    y_e = _experts(params, xe, le, slot, valid, w, n, slots, k, act)
    parts, whole = ([y_e], []) if ex else ([], [y_e])
    for name, width in (("shared", m.shared_ff), ("dense", m.dense_ff)):
        if not width:
            continue
        if split.mlp(width):
            parts.append(apply_mlp(params[name], xc, act))
        else:
            whole.append(apply_mlp(params[name], x2, act))
    y = None
    for y_p in parts:
        y = y_p if y is None else y + y_p
    if y is not None:
        y = split.reduce_out(y)
    for y_w in whole:
        y = y_w if y is None else y + y_w
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
