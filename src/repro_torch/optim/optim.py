"""Optimizers over panels (SGD/momentum, AdamW) + LR schedules.

Counterpart of ``repro/optim/optim.py``. The reference vmaps ``update`` over
the agent axis of its (m, D) panels; every transform here is elementwise, so
it runs on the whole panel at once. State and parameters are dicts of
same-shaped tensors (a panel: ``{group: (m, D)}``).

``update`` writes the new parameters and moments IN PLACE, a column chunk
at a time, into the tensors it was given, and returns them: at full width a
whole-panel expression would hold several (m, D) float32 temporaries (7.6 GB
each for olmo-1b at m = 8). Chunking an elementwise expression changes no
number.

``step_count`` is one integer for all agents, or an (m,) int64 numpy array
once an elastic run's agents diverge (a dead agent's count stands still, a
rejoined agent's restarts at 0; the reference keeps a count per agent).
Then the step's learning rate and bias corrections are each agent's own
scalars, computed one agent at a time as for one count, and stacked into
(m, 1) columns.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

# columns per in-place chunk of the elementwise update (per row-block of m
# agents): bounds each temporary at m * _CHUNK float32 values
_CHUNK = 1 << 22


# ------------------------------------------------------------- LR schedules


def _f32(x, device=None):
    return torch.tensor(x, dtype=torch.float32, device=device)


def constant_schedule(lr):
    return lambda step, device=None: _f32(lr, device)


def cosine_schedule(lr, total_steps, final_frac=0.1):
    def f(step, device=None):
        t = torch.clamp(_f32(step, device) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine(lr, total_steps, warmup=100, final_frac=0.1):
    cos = cosine_schedule(lr, total_steps, final_frac)

    def f(step, device=None):
        w = torch.clamp(_f32(step, device) / max(warmup, 1), max=1.0)
        return w * cos(max(step - warmup, 0), device)
    return f


# ---------------------------------------------------------------- optimizers


@dataclass(frozen=True)
class Optimizer:
    init: Callable  # params -> state
    update: Callable  # (grads, state, params, step=None) -> (params, state)
    name: str = ""
    moment_keys: tuple = ()
    # elementwise update math, (g, m, v, p, *, lr, bc1, bc2) -> (p, m, v):
    # the one expression ``update`` applies (kept separate, as in the
    # reference, for a fused kernel to share)
    core: Callable = None
    # (count, step=None, device=None) -> (lr, bc1, bc2) float32 scalars
    hyper: Callable = None
    # the constants ``core`` applies ({"b1", "b2", "eps", "weight_decay"}
    # for AdamW): the fused int8 kernel takes the same numbers
    hparams: dict = field(default=None, compare=False)


def _per_agent(fn, count):
    """``fn(count)`` -> a tuple of float32 scalars; for an (m,) array of
    per-agent counts, each agent's tuple stacked into (m, 1) columns."""
    if not isinstance(count, np.ndarray):
        return fn(count)
    rows = [fn(int(c)) for c in count]
    return tuple(torch.stack(col).reshape(-1, 1) for col in zip(*rows))


def _column_chunks(width: int):
    for lo in range(0, width, _CHUNK):
        yield slice(lo, min(lo + _CHUNK, width))


def sgd(schedule, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    sched = schedule if callable(schedule) else constant_schedule(schedule)

    def init(params):
        if momentum == 0.0:
            return {"step_count": 0}
        return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "step_count": 0}

    def update(grads, state, params, step=None):
        step = state["step_count"] if step is None else step
        for k, p in params.items():
            lr, = _per_agent(lambda c: (sched(c, p.device),), step)
            for sl in _column_chunks(p.shape[-1]):
                g = grads[k][..., sl]
                if weight_decay:
                    g = g + weight_decay * p[..., sl]
                if momentum == 0.0:
                    p[..., sl] = p[..., sl] - lr * g
                    continue
                mu = momentum * state["mu"][k][..., sl] + g
                state["mu"][k][..., sl] = mu
                upd = momentum * mu + g if nesterov else mu
                p[..., sl] = p[..., sl] - lr * upd
        new_state = {"step_count": state["step_count"] + 1}
        if momentum:
            new_state["mu"] = state["mu"]
        return params, new_state

    return Optimizer(init=init, update=update, name="sgd",
                     moment_keys=("mu",) if momentum else ())


def adamw_core(g, m, v, p, *, lr, bc1, bc2, b1=0.9, b2=0.999, eps=1e-8,
               weight_decay: float = 0.0):
    """Elementwise AdamW step: (grad, moments, param) -> (param, moments).

    A bfloat16 or float16 group keeps its moments in its own dtype (the
    reference's ``init`` is ``zeros_like(params)``) and follows the
    reference's rounding (ROADMAP C): each product of a moment update is
    rounded to the group dtype (its weakly typed constants too) and their
    sum, taken in float32, is rounded to it for the stored moment; the
    update reads that sum unrounded for bfloat16 (as the jitted reference
    does) and the rounded moment for float16 (as the eager reference does;
    jitted XLA keeps float16 products in float32). The bias corrections,
    the learning rate and so the parameter update run in float32 (the
    reference's float32 scalars promote them), the weight-decay product in
    the group dtype. The new parameters are rounded once to the group dtype
    (the reference's update returns them as float32, which its segment's
    scan cannot carry: ROADMAP C)."""
    if p.dtype in (torch.bfloat16, torch.float16):
        dt, f32 = p.dtype, torch.float32

        def c(x):
            return torch.tensor(x, dtype=dt, device=p.device)

        m32 = (c(b1) * m).to(f32) + (c(1 - b1) * g).to(f32)
        v32 = (c(b2) * v).to(f32) + (c(1 - b2) * torch.square(g)).to(f32)
        m, v = m32.to(dt), v32.to(dt)
        if dt == torch.float16:
            m32, v32 = m.to(f32), v.to(f32)
        p32 = p.to(f32) - lr * (
            (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
            + (c(weight_decay) * p).to(f32))
        return p32.to(dt), m, v
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    mhat = m / bc1
    vhat = v / bc2
    p = p - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)
    return p, m, v


def adamw(schedule, b1=0.9, b2=0.999, eps=1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    sched = schedule if callable(schedule) else constant_schedule(schedule)

    def init(params):
        return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
                "v": {k: torch.zeros_like(v) for k, v in params.items()},
                "step_count": 0}

    hparams = {"b1": b1, "b2": b2, "eps": eps,
               "weight_decay": weight_decay}

    def core(g, m, v, p, *, lr, bc1, bc2):
        return adamw_core(g, m, v, p, lr=lr, bc1=bc1, bc2=bc2, **hparams)

    def hyper(count, step=None, device=None):
        def one(count):
            s = count if step is None else step + 1
            c = _f32(count, device)
            return (sched(s - 1, device), 1 - torch.pow(_f32(b1, device), c),
                    1 - torch.pow(_f32(b2, device), c))
        return _per_agent(one, count)

    def update(grads, state, params, step=None):
        count = state["step_count"] + 1
        for k, p in params.items():
            lr, bc1, bc2 = hyper(count, step, p.device)
            m, v = state["m"][k], state["v"][k]
            for sl in _column_chunks(p.shape[-1]):
                p[..., sl], m[..., sl], v[..., sl] = core(
                    grads[k][..., sl], m[..., sl], v[..., sl], p[..., sl],
                    lr=lr, bc1=bc1, bc2=bc2)
        return params, {"m": state["m"], "v": state["v"],
                        "step_count": count}

    return Optimizer(init=init, update=update, name="adamw",
                     moment_keys=("m", "v"), core=core, hyper=hyper,
                     hparams=hparams)


def make_optimizer(name: str, lr, total_steps: int = 1000,
                   weight_decay: float = 5e-4, momentum: float = 0.9,
                   schedule: str = "constant") -> Optimizer:
    sched = {"constant": constant_schedule(lr),
             "cosine": cosine_schedule(lr, total_steps),
             "warmup_cosine": warmup_cosine(lr, total_steps)}[schedule]
    if name == "sgd":
        return sgd(sched, momentum=momentum, weight_decay=weight_decay)
    if name == "adamw":
        return adamw(sched, weight_decay=weight_decay)
    raise ValueError(name)
