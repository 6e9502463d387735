"""Temporal communication schedulers — the paper's object of study.

A scheduler maps round t -> mixing matrix W^(t) (numpy, host side). The
communication *budget* of a run is the accumulated per-round wire cost; the
paper's question is how to place that budget over time. Schedulers:

* ConstantSchedule      — sparse gossip every round (baseline DSGD).
* LocalOnlySchedule     — no communication at all (paper's ablation).
* WindowedSchedule      — fully-connected AllReduce inside [start, end),
                          sparse gossip elsewhere (Fig. 2a/2b).
* FinalMergeSchedule    — sparse gossip + ONE global merging at the last
                          round (the paper's headline method, Fig. 1).
* PeriodicGlobalSchedule— global averaging every H rounds (Chen et al. 2021
                          comparison baseline).
* AdaptiveEdgeSchedule  — beyond-paper: monitors the critical-consensus-edge
                          condition (Prop. 3): go fully-connected when
                          Xi_t > kappa * mu_t, else sparse gossip. This is
                          the adaptive algorithm the paper's §6 calls for.

Every scheduler reports per-round cost in model-size units P:
dense AllReduce ~ 2P (ring), pairwise exchange ~ P, idle ~ 0 — matching the
paper's cost model O(mRPT + 2mP).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import faults as faults_mod
from repro_torch.core import topology as topo


class Schedule:
    """Base: sparse random-matching gossip every round.

    ``merger`` names the merge OPERATOR applied on this schedule's global
    rounds (repro.merging: uniform/weighted/var/fisher/ties/swa) — for
    FinalMergeSchedule that is the paper's single final merging itself.
    The schedule only carries the name; the panel engine
    (dsgd.make_panel_segment via PanelSpec.merger) applies it, and the
    cost model is unchanged (every operator is one AllReduce-shaped
    exchange).

    ``faults`` (a core.faults.FaultPlan) degrades every emitted W to the
    round's surviving subgraph: gossip matrices through
    topology.degrade_to_live (dead agents become identity rows, the
    survivors' lost mass folds into their self-loops), global rounds
    through topology.fully_connected_live (the sub-AllReduce over the
    live agents). An agent on its RESYNC round is treated as dead for
    the MATRIX — the engine performs the rejoin pull itself from the
    per-round mask (``last_live``), so the W stream stays doubly
    stochastic. The topology sampler's rng is consumed identically with
    or without faults, so a faulted run and its fault-free twin share
    the same underlying W draws — and a resumed run replays the same
    stream."""

    def __init__(self, m: int, rounds: int, kind: str = "random",
                 prob: float = 0.2, seed: int = 0,
                 merger: str = "uniform", faults=None):
        self.m, self.rounds = m, rounds
        self.sampler = topo.make_sampler(kind, m, prob)
        self.rng = np.random.default_rng(seed)
        self.merger = merger
        self.faults = faults
        # kind of the last mixing_matrix() call: 'global' | 'idle' |
        # 'gossip'. The launcher reads this to tell the panel engine
        # WHICH rounds are global (dsgd.make_panel_segment
        # global_rounds=): inferring it from the W values alone
        # false-positives when a gossip matrix coincides with the 1/m
        # average (m=2 matched pair, 3-ring, ...)
        self.last_kind = None
        # liveness mask of the last mixing_matrix() call ((m,) int8 of
        # faults.DEAD/LIVE/RESYNC, None without a fault plan) — the
        # launcher stacks these into the engine's (S, m) live argument
        self.last_live = None

    # -- override points ---------------------------------------------------
    def is_global(self, t: int, monitor: Optional[dict] = None) -> bool:
        return False

    def is_local_only(self, t: int) -> bool:
        return False

    # -- public API ---------------------------------------------------------
    def mixing_matrix(self, t: int, monitor: Optional[dict] = None
                      ) -> np.ndarray:
        lv = None if self.faults is None else self.faults.mask(t)
        self.last_live = lv
        # only fully-LIVE agents appear in the matrix: a RESYNC agent's
        # row stays identity (the engine pulls it to the live mean from
        # the mask, outside the wire), a DEAD agent's row/col is e_k
        alive = None if lv is None else lv == faults_mod.LIVE
        if self.is_global(t, monitor):
            self.last_kind = "global"
            if alive is None:
                return topo.fully_connected(self.m)
            return topo.fully_connected_live(alive)
        if self.is_local_only(t):
            self.last_kind = "idle"
            return topo.identity(self.m)
        self.last_kind = "gossip"
        W = self.sampler(t, self.rng)
        return W if alive is None else topo.degrade_to_live(W, alive)

    def round_cost(self, W: np.ndarray) -> float:
        """Wire cost of one round in units of model size P (per agent)."""
        if np.allclose(W, np.eye(self.m)):
            return 0.0
        if np.allclose(W, topo.fully_connected(self.m)):
            return 2.0  # ring AllReduce
        # pairwise matching: 1 P per participating agent
        active = np.sum(np.diag(W) < 1.0 - 1e-12) / self.m
        return float(active)


class ConstantSchedule(Schedule):
    pass


class LocalOnlySchedule(Schedule):
    def is_local_only(self, t: int) -> bool:
        return True


class WindowedSchedule(Schedule):
    """Fully-connected inside [start, end); sparse gossip elsewhere."""

    def __init__(self, m, rounds, start: int, end: int, **kw):
        super().__init__(m, rounds, **kw)
        self.start, self.end = start, end

    def is_global(self, t, monitor=None):
        return self.start <= t < self.end


class FinalMergeSchedule(Schedule):
    """The paper's method: sparse gossip + a single final global merging
    (performed by this schedule's ``merger`` operator)."""

    def is_global(self, t, monitor=None):
        return t == self.rounds - 1


class PeriodicGlobalSchedule(Schedule):
    def __init__(self, m, rounds, period: int = 48, **kw):
        super().__init__(m, rounds, **kw)
        self.period = period

    def is_global(self, t, monitor=None):
        return (t + 1) % self.period == 0


class AdaptiveEdgeSchedule(Schedule):
    """Critical-consensus-edge controller (Prop. 3, Eq. 11).

    Goes fully-connected when the measured consensus distance Xi_t exceeds
    ``kappa * mu_t`` where mu_t is an EMA of the global gradient norm at the
    averaged model; otherwise sparse gossip. As training converges, mu_t
    shrinks, the allowed Xi_t band tightens, and communication automatically
    concentrates in the late phase — exactly the behaviour the paper finds
    optimal empirically.
    """

    def __init__(self, m, rounds, kappa: float = 0.5, ema: float = 0.9, **kw):
        super().__init__(m, rounds, **kw)
        self.kappa, self.ema = kappa, ema
        self._mu = None
        self.global_rounds = []

    def is_global(self, t, monitor=None):
        if not monitor:
            return False
        mu_obs = monitor.get("grad_norm")
        xi = monitor.get("consensus")
        if mu_obs is None or xi is None:
            return False
        self._mu = (mu_obs if self._mu is None
                    else self.ema * self._mu + (1 - self.ema) * mu_obs)
        hit = bool(xi > self.kappa * self._mu)
        if hit:
            self.global_rounds.append(t)
        return hit


SCHEDULES = {"constant": ConstantSchedule, "local": LocalOnlySchedule,
             "windowed": WindowedSchedule,
             "final_merge": FinalMergeSchedule,
             "periodic": PeriodicGlobalSchedule,
             "adaptive": AdaptiveEdgeSchedule}


def make_schedule(name: str, m: int, rounds: int, **kw) -> Schedule:
    """Build a scheduler by registry name (``SCHEDULES`` — the registry
    the property suite round-trips; mirrors wire.CODECS /
    merging.MERGERS)."""
    try:
        cls = SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"unknown schedule {name!r}; known: {sorted(SCHEDULES)}"
        ) from None
    return cls(m, rounds, **kw)
