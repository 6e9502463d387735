"""Decentralized training engine, panel state, main path (Algorithm 1 of the
paper; counterpart of ``repro/core/dsgd.py``).

Parameters and AdamW moments live as persistent per-dtype (m, D) panels
(core/panel.py). One round is H local steps per agent — per-agent gradients
of the agent's own batch, then the optimizer on the whole panel — followed
by the round's communication:

* W == I (an idle round): nothing travels; the consensus distance Xi comes
  from the ``panel_mean_consensus`` kernel;
* otherwise: one ``gossip_mix`` sweep with the 1^T/m row folded in
  (panel.mix_dense_mean) and Xi from the folded mean. The final global
  merge is this branch with the fully connected W: every row comes out
  identical, so Xi is exactly 0.

The slice covers the reference's main path: the float32 wire, the uniform
merger, every agent live, no storage residency and no telemetry. The
reference scans a whole segment on device under jit with donated buffers;
here the segment is a Python loop over rounds, and the state's panels are
updated in place (the counterpart of donation — the caller's state is
consumed).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import panel as panel_mod
from repro_torch.device import resolve_device
from repro_torch.merging import get_merger
from repro_torch.optim.optim import Optimizer
from repro_torch.utils.tree import tree_unflatten


def _generator(rng, device):
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(
        0 if rng is None else int(rng))


def init_panel_state(init_params: Callable, optimizer: Optimizer, m: int,
                     rng=None, *, device=None, merger=None):
    """Panel train state: params AND optimizer moments as per-dtype (m, D)
    panels. Returns (state, spec).

    ``init_params(generator, device)`` builds one agent's parameter tree;
    ``rng`` is a ``torch.Generator`` on ``device`` or an integer seed.
    Each agent draws its own init (the paper's main experiments). Rows are
    filled one agent at a time, so no agent-stacked copy of the parameters
    is ever made."""
    device = resolve_device(device)
    gen = _generator(rng, device)
    first = init_params(gen, device)
    spec = dataclasses.replace(panel_mod.make_spec(first, rows=m),
                               merger=get_merger(merger or "uniform").name)
    pan = {g: torch.empty((m, w), dtype=getattr(torch, g), device=device)
           for g, w in spec.groups}
    panel_mod.write_row(pan, spec, 0, first)
    for k in range(1, m):
        panel_mod.write_row(pan, spec, k, init_params(gen, device))
    del first
    return {"panel": pan, "opt": optimizer.init(pan), "step": 0}, spec


def panel_state_from_params(params_stacked, optimizer: Optimizer):
    """Panel train state from an agent-stacked parameter tree (e.g. one
    handed over from the reference by ``weights.from_reference_params``).
    Returns (state, spec)."""
    spec = panel_mod.make_spec(params_stacked)
    pan = panel_mod.to_panel(params_stacked, spec)
    return {"panel": pan, "opt": optimizer.init(pan), "step": 0}, spec


def panel_grads(loss_fn: Callable, panel, spec, batch):
    """Per-agent gradients as a panel: ({group: (m, D_g)}, losses (m,)).

    Agent k's parameters are leaf views of its panel row; its loss is
    differentiated on its own batch ``{key: v[k]}`` and the gradient leaves
    are written into row k of the gradient panel. The parameter panel stays
    the source of truth."""
    m = spec.rows
    x0 = next(iter(panel.values()))
    gpan = {g: torch.empty_like(x) for g, x in panel.items()}
    losses = torch.empty((m,), dtype=torch.float32, device=x0.device)
    for k in range(m):
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
                       local_steps: int, spec):
    """Panel driver for one SCHEDULE SEGMENT of rounds.

    segment(state, batches, Ws) -> (state, metrics) with
      batches leaves (S, H, m, b, ...) — H DISTINCT batches per round
                                         (numpy arrays or tensors),
      Ws (S, m, m)                     — the rounds' mixing matrices,
      metrics {name: (S,) float32 tensor} on the panel's device:
        ``loss`` and ``grad_norm``/``grad_norm_max`` (mean and max over the
        H local steps of the step's mean loss and of the norm of the
        agent-mean gradient) and ``consensus``, Xi after the round's
        communication.

    The state's panels are updated in place."""

    def segment(state, batches, Ws):
        pan, opt = state["panel"], state["opt"]
        x0 = next(iter(pan.values()))
        m, dev = x0.shape[0], x0.device
        Ws_host = np.asarray(torch.as_tensor(Ws, dtype=torch.float32).cpu())
        S = Ws_host.shape[0]
        eye = np.eye(m, dtype=np.float32)
        batches = {k: torch.as_tensor(v).to(dev) for k, v in batches.items()}
        mets = {"loss": [], "grad_norm": [], "grad_norm_max": [],
                "consensus": []}
        for s in range(S):
            losses, gns = [], []
            for h in range(local_steps):
                batch = {k: v[s, h] for k, v in batches.items()}
                gpan, agent_losses = panel_grads(loss_fn, pan, spec, batch)
                pan, opt = optimizer.update(gpan, opt, pan)
                losses.append(torch.mean(agent_losses))
                gns.append(panel_mod.panel_norm(gpan, axis_mean=True))
                del gpan
            # W == I rounds communicate nothing: no sweep over the panel
            if np.array_equal(Ws_host[s], eye):
                mets["consensus"].append(panel_mod.consensus_distance(pan))
            else:
                pan, mean, _ = panel_mod.mix_dense_mean(pan, Ws_host[s])
                mets["consensus"].append(
                    panel_mod.consensus_from_mean(pan, mean))
            gn = torch.stack(gns)
            mets["loss"].append(torch.mean(torch.stack(losses)))
            mets["grad_norm"].append(torch.mean(gn))
            mets["grad_norm_max"].append(torch.max(gn))
        out = {"panel": pan, "opt": opt,
               "step": state["step"] + S * local_steps}
        return out, {k: torch.stack(v) for k, v in mets.items()}

    return segment
