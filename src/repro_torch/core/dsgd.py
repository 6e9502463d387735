"""Decentralized training engine (Algorithm 1 of the paper; counterpart of
``repro/core/dsgd.py``).

Two state layouts:

* **Tree state** (:func:`init_state` + :func:`make_dsgd_step` /
  :func:`make_dsgd_round`, and the parallel-SGD baseline
  :func:`init_parallel_state` + :func:`make_parallel_step`) — every
  parameter leaf carries a leading (m,) agent axis; the optimizer runs on a
  flat dict of the agent-stacked leaves (each seen as an (m, size) view,
  updated in place) and the mix is per leaf (``gossip.*_tree``: plain
  ``torch.tensordot``). The reference's figure harness runs on it
  (``repro_torch.bench``).
* **Panel state** (:func:`init_panel_state` + :func:`make_panel_segment`),
  the hot path of the launcher, described below.

Panel state: parameters and AdamW moments live as persistent per-dtype (m,
D) panels (core/panel.py). One round is H local steps per agent —
per-agent gradients of the agent's own batch, then the optimizer on the
whole panel — followed by the round's communication:

* W == I (an idle round): nothing travels and no codec runs (no draw, the
  error-feedback panel passes through untouched); the consensus distance
  Xi comes from the ``panel_mean_consensus`` kernel;
* a global round of a delta codec (topk; W == 1/m): ``merging.merge_panel``,
  the full-bandwidth merge that also resets the mirror; Xi is 0;
* otherwise: the payload is encoded by the spec's wire policy, then one
  ``gossip_mix`` sweep with the 1^T/m row folded in (panel.mix_dense_mean)
  and Xi from the folded mean. The final global merge of every other codec
  is this branch with the fully connected W: every row comes out
  identical, so Xi is exactly 0 — except under bf16, whose rows are
  rounded through bf16 while the folded mean stays float32 (the
  reference's rule), so Xi reports that rounding and
  ``panel.consensus_distance`` of the merged panel is the exact 0.

Wire codecs: every codec of the reference's registry — the float32
identity, ``bf16`` (a cast payload, mixed with float32 accumulation),
``int8`` / ``int8_ef`` (per-row int8) and ``int4`` / ``int4_ef`` (packed
nibbles against grouped scales), both with stochastic rounding, the _ef
variants carrying the quantization residual, and ``topk`` (the sparse
innovation over a mirror panel, mixed in damped delta form). An
error-feedback codec keeps ``state["wire_err"]``, one float32 panel per
dtype group. Stochastic rounding draws from a ``torch.Generator`` (the
segment's ``rng``), one draw per stochastic group per communicating round.

Merge operators (``repro_torch.merging``, named on the spec by
``panel.with_merger`` / ``init_panel_state(merger=...)``): 'uniform' keeps
the path above byte for byte. Any other operator takes the GLOBAL rounds
through ``merging.merge_panel`` (the payload still through the wire
policy, one merged row broadcast back; Xi is 0). A statistical operator
(var, fisher, swa) carries its per-agent statistics panels as
``state["merge_stat"]``, updated in place every local step from the
gradients (fisher) or once per round from the parameters before the
communication (var, swa).

Storage residency (``repro_torch.residency``, named on the spec by
``panel.with_residency`` / ``init_panel_state(residency=...)``) keeps state
panels in a compressed storage for the whole segment: the optimizer
moments (float32 groups), the merge statistics and the error-feedback
panel. The stored moments are built as the canonical stored zero, with no
float32 panel; each local step decodes, updates and re-encodes them — in
one sweep of the ``adamw_fused_int8`` kernel for grouped int8 moments
(``fused``, on by default where it applies), else through the storages'
read, the optimizer and write. Statistics decode once at round entry and
encode once at round exit; the error-feedback panel decodes and encodes
only inside communicating rounds, idle rows keeping their stored bits, and
idle W = I rounds touch no stored bits. A stochastic storage draws its
uniforms a column slab at a time from its own generators
(``residency.storage_generators``: seeded from the segment's ``rng``, the
state kind, the local step or round, the state entry and the dtype group),
never from the wire codec's generator; an f32 policy is no policy.

Liveness (elastic runs): the segment's ``live`` gives each round a DEAD / LIVE
/ RESYNC trit per agent (``core.faults``); the caller hands in the matching
degraded W (``Schedule(faults=)``). A DEAD or RESYNC agent takes no local step:
its gradient is not computed, and its parameter, moment (stored q and scale
bits included) and statistics rows are put back after the local steps, so they
pass through bit for bit, while every generator is drawn as without the mask.
After the communication every non-LIVE row is put back once more (the per-row
idle rule already keeps the codecs off their identity rows of W); a RESYNC row
then takes the live agents' post-mix mean (``panel.merged(live=)``), zero
moments (the storage's canonical zero) and a step count of 0, a fresh
error-feedback row and fresh statistics. Dead rows keep their stored residual
and statistics bits. The metrics average over the live agents and Xi is the
live rows' consensus. A round whose agents are all LIVE is an unmasked round,
so an all-live mask gives ``live=None``'s result bit for bit. Telemetry is a
later slice.

The reference scans a whole segment on device under jit with donated
buffers; here the segment is a Python loop over rounds, the optimizer
updates the state's panels in place, and each round's communication
replaces the panels it consumed (the counterpart of donation — the
caller's state is consumed).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import residency as residency_mod
from repro_torch import wire as wire_mod
from repro_torch.core import gossip
from repro_torch.core import panel as panel_mod
from repro_torch.core.consensus import consensus_distance_tree
from repro_torch.core.faults import LIVE, RESYNC
from repro_torch.kernels.opt_fused import adamw_fused_int8
from repro_torch.device import resolve_device
from repro_torch.merging import get_merger, merge_panel
from repro_torch.optim.optim import Optimizer
from repro_torch.residency import storage_generators
from repro_torch.telemetry.metrics import fused_moments_auto
from repro_torch.utils.tree import tree_flatten, tree_unflatten


def _generator(rng, device):
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(
        0 if rng is None else int(rng))


def _wire_any(spec, flag: str) -> bool:
    """Whether the codec of any dtype group sets ``flag`` (``needs_key``,
    ``error_feedback`` or ``delta_mix``)."""
    return any(getattr(wire_mod.get_codec(c), flag) for _, c in spec.wire)


# ---------------------------------------------------------------------------
# Tree state: every parameter leaf (m, ...), one local step per agent per
# call (make_dsgd_step) or H of them (make_dsgd_round), then the mix.
# ---------------------------------------------------------------------------


def _init_agent_params(init_params: Callable, m: int, gen, same_init: bool):
    """The agent-stacked tree: ``init_params(gen)`` drawn once per agent in
    turn (the paper's independent inits), or once and copied to every row
    (``same_init``: theta_k^0 = theta^0, the theory's setting). The stack
    is allocated once and filled a row at a time; its rows are real copies
    (the optimizer updates them in place)."""
    first, skel = tree_flatten(init_params(gen))
    stacked = [torch.empty((m,) + tuple(x.shape), dtype=x.dtype,
                           device=x.device) for x in first]
    for k in range(m):
        row = first if k == 0 or same_init else tree_flatten(
            init_params(gen))[0]
        for s, x in zip(stacked, row):
            s[k].copy_(x)
        del row
    del first
    return tree_unflatten(skel, stacked)


def _opt_view(tree, stacked: bool = True):
    """The optimizer's flat dict of a parameter (or gradient) tree: leaf i
    as an (m, size) view of the agent-stacked leaf (``stacked``) or a (size,)
    view of a single model's leaf. The optimizer's elementwise update runs
    on the views, in place, a column chunk at a time."""
    return {f"{i:04d}": (x.view(x.shape[0], -1) if stacked else x.view(-1))
            for i, x in enumerate(tree_flatten(tree)[0])}


def init_state(init_params: Callable, optimizer: Optimizer, m: int,
               gen=None, same_init: bool = False):
    """Agent-stacked train state {"params", "opt", "step"}.

    ``init_params(gen)`` returns one agent's parameter tree and is called
    once per agent in turn (once with ``same_init``). Handing over another
    package's initial rows is the same argument: a callable that returns
    them in turn."""
    params = _init_agent_params(init_params, m, gen, same_init)
    return {"params": params, "opt": optimizer.init(_opt_view(params)),
            "step": 0}


def _tree_wire_check(wire) -> bool:
    """Validate a codec for the tree-state drivers when they are built
    (error feedback needs the panel engine's residual state); returns
    whether the codec rounds stochastically."""
    if wire is None:
        return False
    codec = wire_mod.get_codec(wire)
    if codec.error_feedback:
        raise ValueError(
            f"codec '{codec.name}' needs an error-feedback residual; the "
            "tree-state drivers carry none — use the panel engine "
            "(make_panel_segment + init_panel_state(wire=...)) or 'int8'")
    return codec.needs_key


def _wire_gen(rng, needs_key: bool, device):
    if not needs_key:
        return None
    if rng is None:
        raise ValueError("the wire codec rounds stochastically and needs "
                         "rng= (a torch.Generator or an integer seed)")
    return _generator(rng, device)


def _mix(params, W, impl: str, wire_dtype, wire=None, gen=None):
    """The round's per-leaf communication. For impl == "pairwise" the W
    argument IS the (m,) partner array (``topology.partner_array``)."""
    if impl == "dense":
        if wire_dtype is None and wire is None:
            return gossip.mix_dense_tree(params, W)
        # W == I rounds communicate nothing, so no codec may touch the
        # state (the panel engine's idle guard; pairwise idles per row
        # inside mix_pairwise_tree)
        Wh = np.asarray(torch.as_tensor(W, dtype=torch.float32).cpu())
        if np.array_equal(Wh, np.eye(Wh.shape[0], dtype=np.float32)):
            return params
        return gossip.mix_dense_tree(params, W, wire_dtype, wire, gen)
    if impl == "pairwise":
        return gossip.mix_pairwise_tree(params, W, wire_dtype=wire_dtype,
                                        wire=wire, gen=gen)
    if impl == "merge":
        return gossip.global_merge_tree(params, wire_dtype, wire, gen)
    if impl == "none":
        return params
    raise ValueError(impl)


def _agent_batch(batch, k):
    """Agent k's batch out of a tree (tensor, tuple, list or dict) of (m,
    b, ...) leaves."""
    if isinstance(batch, dict):
        return {key: _agent_batch(v, k) for key, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_agent_batch(v, k) for v in batch)
    return batch[k]


def _batch_to(batch, device):
    if isinstance(batch, dict):
        return {key: _batch_to(v, device) for key, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_batch_to(v, device) for v in batch)
    return torch.as_tensor(batch).to(device)


def tree_grads(loss_fn: Callable, params, batch, m: Optional[int] = None):
    """Per-agent gradients: (agent-stacked gradient tree, losses (m,)).

    Agent k's loss is differentiated on its own batch (``batch`` leaves (m,
    b, ...)) at its rows of the agent-stacked ``params`` (detached views),
    one agent at a time as ``panel_grads`` does; its gradient leaves are
    written into row k. With ``m`` the ``params`` are ONE shared model (the
    parallel-SGD baseline) differentiated on each of the m batches."""
    leaves, skel = tree_flatten(params)
    shared = m is not None
    m = m if shared else leaves[0].shape[0]
    dev = leaves[0].device
    grads = [torch.empty((m,) + tuple(x.shape if shared else x.shape[1:]),
                         dtype=x.dtype, device=dev) for x in leaves]
    losses = torch.empty((m,), dtype=torch.float32, device=dev)
    batch = _batch_to(batch, dev)
    for k in range(m):
        ps = [(x if shared else x[k]).detach().requires_grad_(True)
              for x in leaves]
        loss, _ = loss_fn(tree_unflatten(skel, ps), _agent_batch(batch, k),
                          None)
        for out, g in zip(grads, torch.autograd.grad(loss, ps,
                                                     allow_unused=True)):
            if g is None:
                out[k].zero_()
            else:
                out[k].copy_(g)
        losses[k] = loss.detach()
        del ps, loss
    return tree_unflatten(skel, grads), losses


def _mean_grad_norm(grads):
    """Norm of the agent-mean gradient (the grad_norm metric)."""
    leaves = tree_flatten(grads)[0]
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        total = total + torch.sum(torch.square(torch.mean(g, dim=0)))
    return torch.sqrt(total)


def _local_update(loss_fn, optimizer, params, opt, batch):
    """One local step of every agent: per-agent gradients, then the
    optimizer on the stacked leaves, in place. Returns (opt, losses (m,),
    grad norm of the agent mean)."""
    grads, losses = tree_grads(loss_fn, params, batch)
    _, opt = optimizer.update(_opt_view(grads), opt, _opt_view(params))
    return opt, losses, _mean_grad_norm(grads)


def make_dsgd_step(loss_fn: Callable, optimizer: Optimizer, *,
                   gossip_impl: str = "dense", wire_dtype=None, wire=None,
                   monitor: bool = True):
    """One communication round with ONE local step per agent.

    step(state, batch, W, rng=None) -> (state, metrics); batch leaves (m, b,
    ...) (tensors or numpy arrays); W (m, m). With gossip_impl="pairwise"
    pass the (m,) partner array as W; "merge" is the global merge, "none"
    no communication. ``wire`` names a codec of ``repro_torch.wire`` for
    the payload (a stochastic one draws from ``rng``: a torch.Generator or
    an integer seed); ``wire_dtype`` is the legacy payload cast (e.g.
    torch.bfloat16). Error-feedback codecs are panel-engine-only and are
    refused here. Metrics: ``loss`` (mean over agents) and, with
    ``monitor``, ``grad_norm`` (of the agent-mean gradient) and
    ``consensus`` (Xi of the mixed tree, ``consensus_distance_tree``).

    The state's parameter leaves and moments are updated in place (the
    caller's state is consumed, as the panel segment consumes its own);
    the mix makes the new parameter leaves."""
    needs_key = _tree_wire_check(wire)

    def step(state, batch, W, rng=None):
        params = state["params"]
        dev = tree_flatten(params)[0][0].device
        gen = _wire_gen(rng, needs_key, dev)
        opt, losses, gn = _local_update(loss_fn, optimizer, params,
                                        state["opt"], batch)
        mixed = _mix(params, W, gossip_impl, wire_dtype, wire, gen)
        metrics = {"loss": torch.mean(losses)}
        if monitor:
            metrics["grad_norm"] = gn
            metrics["consensus"] = consensus_distance_tree(mixed)
        return {"params": mixed, "opt": opt, "step": state["step"] + 1}, \
            metrics

    return step


def make_dsgd_round(loss_fn: Callable, optimizer: Optimizer,
                    local_steps: int, *, gossip_impl: str = "dense",
                    wire_dtype=None, wire=None, monitor: bool = True):
    """One communication round with H local steps (paper: H = 100).

    step(state, batches, W, rng=None): batches leaves (H, m, b, ...).
    ``wire`` / ``wire_dtype`` as in :func:`make_dsgd_step`. Metrics:
    ``loss`` and ``grad_norm`` (means over the H local steps),
    ``grad_norm_max`` (their max: a spike at any local step shows) and,
    with ``monitor``, ``consensus`` of the mixed tree."""
    needs_key = _tree_wire_check(wire)

    def round_fn(state, batches, W, rng=None):
        params, opt = state["params"], state["opt"]
        dev = tree_flatten(params)[0][0].device
        gen = _wire_gen(rng, needs_key, dev)
        losses, gns = [], []
        for h in range(local_steps):
            opt, agent_losses, gn = _local_update(
                loss_fn, optimizer, params, opt,
                _agent_batch(batches, h))
            losses.append(torch.mean(agent_losses))
            gns.append(gn)
        mixed = _mix(params, W, gossip_impl, wire_dtype, wire, gen)
        gns = torch.stack(gns)
        metrics = {"loss": torch.mean(torch.stack(losses)),
                   "grad_norm": torch.mean(gns),
                   "grad_norm_max": torch.max(gns)}
        if monitor:
            metrics["consensus"] = consensus_distance_tree(mixed)
        return {"params": mixed, "opt": opt,
                "step": state["step"] + local_steps}, metrics

    return round_fn


def make_parallel_step(loss_fn: Callable, optimizer: Optimizer):
    """Parallel SGD / FedAvg(H=1) baseline: one shared model; the gradients
    of the m per-agent batches are averaged every step (the paper's
    reference rate O(sigma^2/(m eps^2) + 1/eps)).

    step(state, batch, rng=None) -> (state, {"loss"}); the model is updated
    in place."""

    def step(state, batch, rng=None):
        params = state["params"]
        grads, losses = tree_grads(loss_fn, params, batch,
                                   m=_first_leaf(batch).shape[0])
        gbar = {k: torch.mean(g, dim=0)
                for k, g in _opt_view(grads).items()}
        del grads
        _, opt = optimizer.update(gbar, state["opt"],
                                  _opt_view(params, stacked=False))
        return {"params": params, "opt": opt, "step": state["step"] + 1}, \
            {"loss": torch.mean(losses)}

    return step


def _first_leaf(batch):
    while isinstance(batch, (dict, tuple, list)):
        batch = (batch[sorted(batch)[0]] if isinstance(batch, dict)
                 else batch[0])
    return batch


def init_parallel_state(init_params: Callable, optimizer: Optimizer,
                        gen=None):
    """The parallel baseline's state: ONE model, ``init_params(gen)``."""
    p = init_params(gen)
    return {"params": p, "opt": optimizer.init(_opt_view(p, stacked=False)),
            "step": 0}


# ---------------------------------------------------------------------------
# Panel state.
# ---------------------------------------------------------------------------


def _res_plan(spec):
    """{state kind: {dtype group: Storage}}: where the spec's residency
    policy applies. Moment panels mirror each group's dtype, so only the
    float32 group's moments are stored; merge statistics and
    error-feedback panels are float32 in every group, so they are stored in
    every group."""
    plan = {}
    for kind, name in spec.residency:
        st = residency_mod.get_storage(name)
        groups = [g for g, _ in spec.groups
                  if kind != "moments" or g == "float32"]
        if groups:
            plan[kind] = {g: st for g in groups}
    return plan


def _res_read(stored, sts):
    """Decode a stored {group: panel} dict to its float32 view (groups
    without a storage pass through)."""
    return {k: (sts[k].read(v) if k in sts else v)
            for k, v in stored.items()}


def _res_write(panel, sts, gens):
    """Encode a float32 {group: panel} dict into storage, each stochastic
    group drawing from its generator in ``gens``."""
    return {k: (sts[k].write(v, gen=gens[k]) if k in sts else v)
            for k, v in panel.items()}


def _res_init(panel, sts):
    """Deterministic encode of a fresh {group: panel} dict."""
    return {k: (sts[k].init(v) if k in sts else v)
            for k, v in panel.items()}


def _opt_read(opt, sts, mom_keys):
    """Optimizer state -> its float32 compute view: the moment entries
    decode, everything else (step_count) passes through."""
    return {k: (_res_read(v, sts) if k in mom_keys else v)
            for k, v in opt.items()}


def _opt_write(opt, sts, mom_keys, seed, tick, device):
    """Encode the updated moments back into storage: moment entry i (sorted
    order) draws from its own generators at this local step."""
    out = dict(opt)
    for i, k in enumerate(sorted(k for k in opt if k in mom_keys)):
        gens = storage_generators(sts, seed, tick, "moments", i, device)
        out[k] = _res_write(opt[k], sts, gens)
    return out


def _fused_opt_update(gpan, opt, pan, optimizer, sts, seed, tick):
    """One local step's optimizer update with the stored grouped-int8
    moments updated by the ``adamw_fused_int8`` kernel, in place, a column
    slab at a time: the slab's uniforms for m and v are drawn (from the
    same generators, in the same slabs, as the unfused write draws them),
    then the kernel decodes, updates and re-encodes the slab. No float32
    moment panel is made. Groups without a storage take
    ``optimizer.update``; the per-agent lr, bc1 and bc2 columns come from
    ``optimizer.hyper``, as the optimizer's own update computes them."""
    count = opt["step_count"] + 1
    mom = sorted(k for k in opt if k in optimizer.moment_keys)
    rest = [k for k in pan if k not in sts]
    if rest:
        def sub(d):
            return {k: d[k] for k in rest}
        optimizer.update(sub(gpan), {k: (sub(v) if k in mom else v)
                                     for k, v in opt.items()}, sub(pan))
    for k in pan:
        if k not in sts:
            continue
        st, x = sts[k], pan[k]
        m, D = x.shape
        lr, bc1, bc2 = optimizer.hyper(count, None, x.device)
        gens = {mk: storage_generators(sts, seed, tick, "moments", i,
                                       x.device)[k]
                for i, mk in enumerate(mom)}
        (qm, sm), (qv, sv) = ((opt[mk][k]["q"], opt[mk][k]["scale"])
                              for mk in ("m", "v"))
        step = st.slab()
        for lo in range(0, D, step):
            sl = slice(lo, min(lo + step, D))
            w = sl.stop - lo
            gs = slice(lo // st.group, lo // st.group + st.scale_count(w))
            um, uv = (torch.rand((m, w), generator=gens[mk],
                                 dtype=torch.float32, device=x.device)
                      for mk in ("m", "v"))
            adamw_fused_int8(gpan[k][:, sl], x[:, sl], qm[:, sl], sm[:, gs],
                             qv[:, sl], sv[:, gs], um, uv, lr, bc1, bc2,
                             group=st.group, transform=st.transform,
                             **optimizer.hparams)
            del um, uv
    out = dict(opt)
    out["step_count"] = count
    return pan, out


def _take_rows(tree, rows):
    """Copies of rows ``rows`` of every per-agent leaf of ``tree`` (nested
    dicts of (m, ...) tensors and of the (m,) step-count array), in the
    tree's shape; other leaves (a shared integer count) give None."""
    if isinstance(tree, dict):
        return {k: _take_rows(v, rows) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree[rows].clone()
    if isinstance(tree, np.ndarray):
        return tree[rows].copy()
    return None


def _put_rows(tree, saved, rows):
    """Write rows taken by :func:`_take_rows` back into a tree of the same
    shape, in place."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put_rows(v, saved[k], rows)
    elif saved is not None:
        tree[rows] = saved


def _per_agent_count(opt, m):
    """The optimizer state with its step count per agent (an (m,) int64
    array): an elastic round freezes some agents' counts and restarts
    others'."""
    if not isinstance(opt["step_count"], np.ndarray):
        opt["step_count"] = np.full(m, opt["step_count"], dtype=np.int64)
    return opt


def _init_opt(optimizer, pan, sts):
    """Optimizer state of a fresh panel; the stored moment groups are made
    directly as their storage's canonical zero (the optimizers' moments
    start at zero), so no float32 moment panel is allocated for them."""
    if not sts:
        return optimizer.init(pan)
    opt = optimizer.init({g: x for g, x in pan.items() if g not in sts})
    for k in optimizer.moment_keys:
        zero = {g: sts[g].zeros(*pan[g].shape, pan[g].device) for g in sts}
        opt[k] = {g: (zero[g] if g in zero else opt[k][g]) for g in pan}
    return opt


def _with_wire_state(state, spec, sts=None):
    """Add fresh error-feedback panels when the spec's wire policy has
    error feedback: each dtype group's codec seeds its own (zeros for the
    int8_ef residual, a copy of the panel for the topk mirror —
    Codec.init_err); ``sts`` (the wire_err storages) encodes them
    deterministically."""
    if _wire_any(spec, "error_feedback"):
        werr = {k: wire_mod.get_codec(spec.wire_of(k)).init_err(v)
                for k, v in state["panel"].items()}
        state["wire_err"] = _res_init(werr, sts) if sts else werr
    return state


def _with_merge_stats(state, spec, sts=None):
    """Add fresh statistics panels when the spec's merge operator keeps
    any (``Merger.init_stats`` of the initial parameter panel), encoded
    deterministically by ``sts`` (the stats storages) when given."""
    mg = get_merger(spec.merger)
    if mg.stat_panels:
        stats = mg.init_stats(state["panel"])
        state["merge_stat"] = ({n: _res_init(v, sts)
                                for n, v in stats.items()} if sts else stats)
    return state


def _build_state(pan, spec, optimizer):
    plan = _res_plan(spec)
    state = {"panel": pan, "opt": _init_opt(optimizer, pan,
                                            plan.get("moments")), "step": 0}
    _with_wire_state(state, spec, plan.get("wire_err"))
    return _with_merge_stats(state, spec, plan.get("stats"))


def init_panel_state(init_params: Callable, optimizer: Optimizer, m: int,
                     rng=None, *, device=None, merger=None, wire=None,
                     residency=None):
    """Panel train state: params AND optimizer moments as per-dtype (m, D)
    panels. Returns (state, spec).

    ``init_params(generator, device)`` builds one agent's parameter tree;
    ``rng`` is a ``torch.Generator`` on ``device`` or an integer seed.
    Each agent draws its own init (the paper's main experiments). Rows are
    filled one agent at a time, so no agent-stacked copy of the parameters
    is ever made.

    ``wire`` attaches a wire-codec policy to the spec (panel.with_wire: a
    codec for every dtype group, or a per-group dict). An error-feedback
    codec adds ``state["wire_err"]``: the zero-initialised residual for
    int8_ef and int4_ef, the MIRROR (a copy of the initial panel) for
    topk.

    ``merger`` names the merge operator of global rounds
    (panel.with_merger). A statistical operator (var, fisher, swa) adds
    ``state["merge_stat"]``, its per-agent float32 statistics panels in
    the parameter panel's layout.

    ``residency`` attaches a storage policy (panel.with_residency: a
    {kind: storage} dict or a 'moments=int8,stats=bf16' string). The named
    state panels are built in their stored form: stored moments directly
    as the canonical stored zero (``Storage.zeros``, no float32 panel),
    statistics and error-feedback panels by the deterministic encode."""
    device = resolve_device(device)
    gen = _generator(rng, device)
    first = init_params(gen, device)
    spec = panel_mod.with_merger(panel_mod.make_spec(first, rows=m), merger)
    spec = panel_mod.with_residency(panel_mod.with_wire(spec, wire),
                                    residency)
    pan = {g: torch.empty((m, w), dtype=getattr(torch, g), device=device)
           for g, w in spec.groups}
    panel_mod.write_row(pan, spec, 0, first)
    for k in range(1, m):
        panel_mod.write_row(pan, spec, k, init_params(gen, device))
    del first
    return _build_state(pan, spec, optimizer), spec


def panel_state_from_params(params_stacked, optimizer: Optimizer, *,
                            wire=None, merger=None, residency=None):
    """Panel train state from an agent-stacked parameter tree (e.g. one
    handed over from the reference by ``weights.from_reference_params``),
    with the wire policy, the merge operator and the residency policy of
    :func:`init_panel_state`. Returns (state, spec)."""
    spec = panel_mod.with_residency(panel_mod.with_wire(
        panel_mod.with_merger(panel_mod.make_spec(params_stacked), merger),
        wire), residency)
    pan = panel_mod.to_panel(params_stacked, spec)
    return _build_state(pan, spec, optimizer), spec


def panel_grads(loss_fn: Callable, panel, spec, batch, rows=None):
    """Per-agent gradients as a panel: ({group: (m, D_g)}, losses (m,)).

    Agent k's parameters are leaf views of its panel row; its loss is
    differentiated on its own batch ``{key: v[k]}`` and the gradient leaves
    are written into row k of the gradient panel. The parameter panel stays
    the source of truth. ``rows`` (agent indices) differentiates only those
    agents; the other rows of the gradient panel and their losses are 0."""
    m = spec.rows
    x0 = next(iter(panel.values()))
    if rows is None:
        gpan = {g: torch.empty_like(x) for g, x in panel.items()}
        losses = torch.empty((m,), dtype=torch.float32, device=x0.device)
    else:
        gpan = {g: torch.zeros_like(x) for g, x in panel.items()}
        losses = torch.zeros((m,), dtype=torch.float32, device=x0.device)
    for k in range(m) if rows is None else rows:
        leaves = [panel[ls.group][k, ls.offset:ls.offset + ls.size]
                  .detach().view(ls.shape).requires_grad_(True)
                  for ls in spec.leaves]
        params = tree_unflatten(spec.treedef, leaves)
        loss, _ = loss_fn(params, {key: v[k] for key, v in batch.items()},
                          None)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for ls, g in zip(spec.leaves, grads):
            row = gpan[ls.group][k, ls.offset:ls.offset + ls.size]
            if g is None:
                row.zero_()
            else:
                row.copy_(g.reshape(-1))
        losses[k] = loss.detach()
    return gpan, losses


def make_panel_segment(loss_fn: Callable, optimizer: Optimizer,
                       local_steps: int, spec, *, fused=None,
                       after_step: Optional[Callable] = None):
    """Panel driver for one SCHEDULE SEGMENT of rounds.

    segment(state, batches, Ws, rng=None, global_rounds=None, live=None)
        -> (state, metrics) with
      batches leaves (S, H, m, b, ...) — H DISTINCT batches per round
                                         (numpy arrays or tensors),
      Ws (S, m, m)                     — the rounds' mixing matrices,
      rng                              — a ``torch.Generator`` on the
                                         panel's device or an integer seed;
                                         required when the wire policy or
                                         the residency policy rounds
                                         stochastically (the residency
                                         streams are seeded from it, the
                                         wire draws from it),
      global_rounds (S,) bool          — which rounds are GLOBAL merges
                                         (the launcher reads the schedule's
                                         ``last_kind``); None fingerprints
                                         W against the 1/m matrix,
      live (S, m) int                  — each round's DEAD 0 / LIVE 1 /
                                         RESYNC 2 trit per agent (the
                                         launcher stacks
                                         ``Schedule.last_live``); None: all
                                         live,
      metrics {name: (S,) float32 tensor} on the panel's device:
        ``loss`` and ``grad_norm``/``grad_norm_max`` (mean and max over the
        H local steps of the step's mean loss and of the norm of the
        agent-mean gradient) and ``consensus``, Xi after the round's
        communication; under ``live`` each over the live agents only.

    The wire policy comes from the spec (panel.with_wire,
    init_panel_state(wire=...)). An error-feedback codec carries
    ``state["wire_err"]`` through the segment; it changes only on
    communicating rounds. A delta codec (topk) takes its global rounds
    through ``merging.merge_panel`` and reports Xi = 0 there.

    The merge operator comes from the spec too (panel.with_merger). A
    non-uniform operator takes the global rounds through
    ``merging.merge_panel`` and reports Xi = 0; a statistical one needs
    ``state["merge_stat"]`` (init_panel_state(merger=...)) and updates it
    in place: fisher after each local step's gradients, before the
    optimizer; var and swa after the local steps, before the
    communication. Without ``global_rounds`` a round is global when its W
    equals the 1/m matrix, which a gossip round can equal too (a matched
    pair at m = 2, a 3-agent ring): pass the mask when a non-uniform
    operator runs on such topologies.

    The residency policy comes from the spec (panel.with_residency; see the
    module docstring for where each stored kind is decoded and encoded).
    ``fused`` picks the moment update of grouped-int8 moments: None uses
    the fused kernel wherever ``telemetry.metrics.fused_moments_auto``
    says it applies, True requires it (and raises where it does not
    apply), False forces the unfused read -> update -> write. Both draw the
    same uniforms in the same slabs, so their trajectories are the same bit
    for bit.

    ``live`` makes the run elastic (see the module docstring for the rules;
    the reference's are ``repro/core/dsgd.py:make_panel_segment``). W must
    be the degraded matrix of the round's live agents, and a non-uniform
    operator needs ``global_rounds``: a degraded global W is no longer the
    1/m matrix.

    ``after_step(step, opt)``, if given, is called after each local step's
    optimizer update with the local step's index and the optimizer state
    in its stored form; it is for measurement, and must only read.

    The state is consumed (the counterpart of the reference's donated
    buffers): the segment takes its panels out of the caller's dict, the
    optimizer updates them in place, and each communicating round replaces
    the parameter and error-feedback panels by its output, so the panels it
    consumed are freed at once and no round holds more than one extra
    panel of each."""
    needs_key = _wire_any(spec, "needs_key")
    needs_ef = _wire_any(spec, "error_feedback")
    merger = get_merger(spec.merger)
    # a delta (mirror) codec routes GLOBAL rounds through merge_panel even
    # for the uniform operator: the one-shot merge is its full-bandwidth
    # round and cannot stay inside the damped delta mix
    plain_merge = (merger.name == "uniform"
                   and not _wire_any(spec, "delta_mix"))
    local_stat = not plain_merge and merger.local_stat
    round_stat = not plain_merge and merger.round_stat
    plan = _res_plan(spec)
    res_mom, res_stat = plan.get("moments"), plan.get("stats")
    res_err = plan.get("wire_err")
    res_key = any(st.needs_key for sts in plan.values()
                  for st in sts.values())
    mom_keys = tuple(optimizer.moment_keys)
    fused_ok = fused_moments_auto(spec, optimizer)
    if fused and not fused_ok:
        raise ValueError(
            "fused=True but the fused moment update does not apply: it "
            "needs a grouped-int8 moments storage (fused_update "
            f"capability; policy has '{spec.residency_of('moments')}') "
            "and an optimizer exposing core/hyper with (m, v) moments "
            f"(got '{optimizer.name}')")
    res_fused = fused_ok if fused is None else bool(fused)

    def segment(state, batches, Ws, rng=None, global_rounds=None,
                live=None):
        x0 = next(iter(state["panel"].values()))
        m, dev = x0.shape[0], x0.device
        del x0
        if needs_ef and "wire_err" not in state:
            raise ValueError(
                "spec's wire policy uses error feedback but the state has "
                "no 'wire_err' panel; build the state with "
                "init_panel_state(..., wire=...)")
        if merger.stat_panels and "merge_stat" not in state:
            raise ValueError(
                f"spec's merge operator '{merger.name}' keeps statistics "
                "panels but the state has no 'merge_stat'; build the state "
                "with init_panel_state(..., merger=...)")
        if needs_key and rng is None:
            raise ValueError(
                "spec's wire policy rounds stochastically and needs rng= "
                "(a torch.Generator or an integer seed)")
        if res_key and rng is None:
            raise ValueError(
                "spec's residency policy rounds stochastically and needs "
                "rng= (a torch.Generator or an integer seed)")
        Ws_host = np.asarray(torch.as_tensor(Ws, dtype=torch.float32).cpu())
        S = Ws_host.shape[0]
        glob = (None if global_rounds is None else
                np.asarray(torch.as_tensor(global_rounds).cpu(), bool))
        if glob is not None and glob.shape != (S,):
            raise ValueError(f"global_rounds must be ({S},), got "
                             f"{glob.shape}")
        lives = (None if live is None else
                 np.asarray(torch.as_tensor(live).cpu(), np.int64))
        if lives is not None and (lives.shape != (S, m) or not np.isin(
                lives, (0, 1, 2)).all()):
            raise ValueError(f"live must be ({S}, {m}) trits DEAD 0 / LIVE "
                             f"1 / RESYNC 2, got {lives.shape} {lives}")
        gen = _generator(rng, dev) if needs_key else None
        seed = (None if not res_key else rng.initial_seed()
                if isinstance(rng, torch.Generator) else int(rng))
        step0 = state["step"]
        # the caller's dict gives up its panels, so a panel that a round
        # replaces is freed at once
        pan, opt = state.pop("panel"), state.pop("opt")
        werr = state.pop("wire_err") if needs_ef else None
        mstat = state.pop("merge_stat", None)
        eye = np.eye(m, dtype=np.float32)
        full = np.full((m, m), 1.0 / m, dtype=np.float32)
        batches = {k: torch.as_tensor(v).to(dev) for k, v in batches.items()}
        mets = {"loss": [], "grad_norm": [], "grad_norm_max": [],
                "consensus": []}

        def err_dec(e):
            # the stored residual decodes only inside communicating rounds
            return _res_read(e, res_err) if res_err and e is not None else e

        def err_enc(ne, tick, old, W):
            # re-encode the new residual; idle ROWS of W (agents that sent
            # nothing, their residual untouched by the mix) keep their old
            # stored bits instead of re-quantizing the decoded value
            if not res_err or ne is None:
                return ne
            enc = _res_write(ne, res_err, storage_generators(
                res_err, seed, tick, "wire_err", 0, dev))
            if old is not None:
                for r in panel_mod._idle_rows(W, m):
                    for k in res_err:
                        if isinstance(enc[k], dict):
                            for part in enc[k]:
                                enc[k][part][r] = old[k][part][r]
                        else:
                            enc[k][r] = old[k][r]
            return enc

        for s in range(S):
            losses, gns = [], []
            # round tick of the stats and wire_err streams: the local-step
            # count at the round's end
            tick = step0 + (s + 1) * local_steps
            lv = None if lives is None else lives[s]
            if lv is not None and bool(np.all(lv == LIVE)):
                lv = None  # an all-live round is an unmasked round
            if lv is not None:
                alive = lv == LIVE
                frozen = np.flatnonzero(~alive).tolist()
                sync = np.flatnonzero(lv == RESYNC).tolist()
                lw = panel_mod._live_weights(alive, m, dev)
                opt = _per_agent_count(opt, m)
                # what the non-live rows hold now; they take no local step
                keep = {"panel": _take_rows(pan, frozen),
                        "opt": _take_rows(opt, frozen)}
                if mstat is not None:
                    keep["stat"] = _take_rows(mstat, frozen)
            if res_stat and mstat is not None:
                # one decode at round entry, one encode at round exit
                mstat = {n: _res_read(g, res_stat) for n, g in mstat.items()}
                if lv is not None:
                    keep["stat_view"] = _take_rows(mstat, frozen)
            for h in range(local_steps):
                batch = {k: v[s, h] for k, v in batches.items()}
                gpan, agent_losses = panel_grads(
                    loss_fn, pan, spec, batch,
                    rows=None if lv is None else np.flatnonzero(alive))
                if local_stat:
                    mstat = merger.update_local(mstat, gpan)
                step = step0 + s * local_steps + h
                if not res_mom:
                    pan, opt = optimizer.update(gpan, opt, pan)
                elif res_fused:
                    pan, opt = _fused_opt_update(gpan, opt, pan, optimizer,
                                                 res_mom, seed, step)
                else:
                    opt = _opt_read(opt, res_mom, mom_keys)
                    pan, opt = optimizer.update(gpan, opt, pan)
                    opt = _opt_write(opt, res_mom, mom_keys, seed, step, dev)
                if after_step is not None:
                    after_step(step, opt)
                if lv is None:
                    losses.append(torch.mean(agent_losses))
                    gns.append(panel_mod.panel_norm(gpan, axis_mean=True))
                else:
                    losses.append(torch.sum(lw * agent_losses))
                    gns.append(panel_mod.panel_norm(gpan, axis_mean=True,
                                                    rows=lw))
                del gpan
            if round_stat:
                mstat = merger.update_round(mstat, pan)
            if lv is not None:
                # the non-live rows' updates are discarded
                _put_rows(pan, keep["panel"], frozen)
                _put_rows(opt, keep["opt"], frozen)
                if mstat is not None:
                    _put_rows(mstat, keep.get("stat_view", keep["stat"]),
                              frozen)
            W = Ws_host[s]
            # non-uniform operators (and delta codecs) take the GLOBAL
            # rounds: the explicit mask when given, else the W fingerprint
            is_global = not plain_merge and (
                bool(glob[s]) if glob is not None
                else np.array_equal(W, full))
            werr_in, ne = werr, None
            if is_global:
                pan, _, ne = merge_panel(
                    pan, merger, stats=mstat, spec=spec, gen=gen,
                    err=err_dec(werr), live=None if lv is None else alive)
                werr = err_enc(ne, tick, None, None)
                xi = torch.zeros((), dtype=torch.float32, device=dev)
            # W == I rounds communicate nothing: no sweep over the panel,
            # no codec, no draw, no stored bit touched
            elif np.array_equal(W, eye):
                xi = (panel_mod.consensus_distance(pan) if lv is None
                      else None)
            else:
                pan, mean, ne = panel_mod.mix_dense_mean(
                    pan, W, spec=spec, gen=gen, err=err_dec(werr))
                werr = err_enc(ne, tick, werr, W)
                xi = (panel_mod.consensus_from_mean(pan, mean) if lv is None
                      else None)
                del mean
            del ne
            if lv is not None:
                _live_comm_rows(pan, opt, werr, werr_in, mstat, keep,
                                frozen, sync, alive)
                xi = panel_mod.consensus_distance(pan, live=alive)
            del werr_in
            mets["consensus"].append(xi)
            if res_stat and mstat is not None:
                view = mstat
                mstat = {n: _res_write(view[n], res_stat, storage_generators(
                    res_stat, seed, tick, "stats", i, dev))
                    for i, n in enumerate(sorted(view))}
                if lv is not None:
                    # dead rows keep their stored bits; a RESYNC row's fresh
                    # statistics encode deterministically
                    _put_rows(mstat, keep["stat"], frozen)
                    _put_rows(mstat, {n: _res_init(_take_rows(view[n], sync),
                                                   res_stat)
                                      for n in view}, sync)
                del view
            if lv is not None:
                del keep  # the non-live rows' copies, freed with the round
            gn = torch.stack(gns)
            mets["loss"].append(torch.mean(torch.stack(losses)))
            mets["grad_norm"].append(torch.mean(gn))
            mets["grad_norm_max"].append(torch.max(gn))
        out = {"panel": pan, "opt": opt,
               "step": state["step"] + S * local_steps}
        if werr is not None:
            out["wire_err"] = werr
        if mstat is not None:
            out["merge_stat"] = mstat
        return out, {k: torch.stack(v) for k, v in mets.items()}

    def _live_comm_rows(pan, opt, werr, werr_in, mstat, keep, frozen, sync,
                        alive):
        """An elastic round's rows after the communication, in place: the
        non-live rows as they were before it (they are identity rows of
        the degraded W), then each RESYNC row restarted from the live
        agents' post-mix mean."""
        _put_rows(pan, keep["panel"], frozen)
        if werr is not None and werr is not werr_in:
            _put_rows(werr, _take_rows(werr_in, frozen), frozen)
        if not sync:
            return
        for k, mu in panel_mod.merged(pan, live=alive).items():
            pan[k][sync] = mu.to(pan[k].dtype)
            del mu
        for k, v in opt.items():
            if k == "step_count":
                v[sync] = 0
                continue
            for g, x in v.items():
                if isinstance(x, dict) or (res_mom and g in res_mom):
                    # the stored canonical zero: the row bit for bit a
                    # freshly initialised agent's
                    _put_rows(x, res_mom[g].zero_like(_take_rows(x, sync)),
                              sync)
                else:
                    x[sync] = 0
        rows = {k: x[sync] for k, x in pan.items()}
        if werr is not None:
            for k, e in werr.items():
                fresh = wire_mod.get_codec(spec.wire_of(k)).init_err(
                    rows[k]).to(torch.float32)
                if res_err and k in res_err:
                    fresh = res_err[k].init(fresh)
                _put_rows(e, fresh, sync)
        if mstat is not None:
            fresh = merger.init_stats(rows)
            _put_rows(mstat, fresh, sync)

    return segment
