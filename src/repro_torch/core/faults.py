"""Deterministic fault-injection plans for elastic decentralized runs.

A :class:`FaultPlan` scripts which agents die and rejoin at which round —
the sampled-participation view (Rodio et al.) of agent churn: a dead
agent is just an identity row of a degraded W, not an error case. The
plan is pure host-side data (no randomness of its own), so replaying the
same plan reproduces the same trajectory bit-for-bit — the property the
resume tests and the fault-injection harness lean on.

Per-round, per-agent state (``FaultPlan.mask(t)`` — (m,) int8):

* ``LIVE`` (1)   — the agent trains, communicates, and updates its
  optimizer moments / codec state / merge statistics this round.
* ``DEAD`` (0)   — the agent is down: its parameter, moment, residual
  and statistics rows pass through the round bit-exactly (the engine's
  idle-row rule, extended per agent).
* ``RESYNC`` (2) — the agent's rejoin round: it takes no local steps
  (its state is stale), receives a full-precision pull of the live
  agents' post-mix mean, and re-initializes its optimizer moments,
  wire-codec state and merge statistics from the synced parameters. It
  is fully LIVE from the next round on. Survivors are never perturbed
  by a resync (the pull is row-local).

The launcher syntax (``--faults``) is ``AGENT@KILL[-REJOIN]`` joined by
``;``: ``"2@5-9;0@3"`` kills agent 2 at round 5 (rejoining at round 9)
and agent 0 at round 3 (forever). The process-level fault mode
(SIGKILL between segments) is the launcher's ``--die-after-segments``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

DEAD, LIVE, RESYNC = 0, 1, 2


@dataclass(frozen=True)
class FaultEvent:
    """One kill (and optional rejoin) of one agent.

    The agent is DEAD for rounds ``kill_at <= t < rejoin_at``, RESYNC at
    ``t == rejoin_at``, LIVE again after; ``rejoin_at=None`` means it
    never comes back."""
    agent: int
    kill_at: int
    rejoin_at: Optional[int] = None


class FaultPlan:
    """A deterministic set of :class:`FaultEvent` for an m-agent run."""

    def __init__(self, m: int, events: Sequence[FaultEvent] = ()):
        self.m = int(m)
        evs = sorted(events, key=lambda e: (e.agent, e.kill_at))
        for e in evs:
            if not 0 <= e.agent < self.m:
                raise ValueError(
                    f"fault event agent {e.agent} out of range for m={m}")
            if e.kill_at < 0:
                raise ValueError(f"kill round must be >= 0, got {e.kill_at}")
            if e.rejoin_at is not None and e.rejoin_at <= e.kill_at:
                raise ValueError(
                    f"agent {e.agent}: rejoin round {e.rejoin_at} must be "
                    f"after its kill round {e.kill_at}")
        for a, b in zip(evs, evs[1:]):
            if a.agent == b.agent:
                if a.rejoin_at is None:
                    raise ValueError(
                        f"agent {a.agent}: event after an open-ended kill "
                        f"at round {a.kill_at}")
                if b.kill_at <= a.rejoin_at:
                    raise ValueError(
                        f"agent {a.agent}: kill at round {b.kill_at} "
                        f"overlaps the rejoin at round {a.rejoin_at}")
        self.events: Tuple[FaultEvent, ...] = tuple(evs)

    def __bool__(self) -> bool:
        return bool(self.events)

    def mask(self, t: int) -> np.ndarray:
        """(m,) int8 of DEAD/LIVE/RESYNC at round ``t``."""
        lv = np.full(self.m, LIVE, np.int8)
        for e in self.events:
            if e.rejoin_at is not None and t == e.rejoin_at:
                lv[e.agent] = RESYNC
            elif e.kill_at <= t and (e.rejoin_at is None or t < e.rejoin_at):
                lv[e.agent] = DEAD
        return lv

    def alive(self, t: int) -> np.ndarray:
        """(m,) bool — fully-participating (LIVE) agents at round ``t``."""
        return self.mask(t) == LIVE

    def at(self, t: int) -> Tuple[Tuple[int, str], ...]:
        """The plan's transitions AT round ``t``: (agent, 'kill'|'rejoin')
        tuples in deterministic (agent, kill_at) order — the telemetry
        event log's fault records."""
        out = []
        for e in self.events:
            if e.kill_at == t:
                out.append((e.agent, "kill"))
            if e.rejoin_at is not None and e.rejoin_at == t:
                out.append((e.agent, "rejoin"))
        return tuple(out)

    # ------------------------------------------------------------- text
    @classmethod
    def parse(cls, m: int, spec: str) -> "FaultPlan":
        """``"2@5-9;0@3"`` -> FaultPlan (see module docstring)."""
        events = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            try:
                agent_s, when = part.split("@")
                if "-" in when:
                    kill_s, rejoin_s = when.split("-")
                    rejoin = int(rejoin_s)
                else:
                    kill_s, rejoin = when, None
                agent, kill = int(agent_s), int(kill_s)
            except ValueError:
                raise ValueError(
                    f"bad fault event {part!r} (want AGENT@KILL or "
                    "AGENT@KILL-REJOIN, e.g. '2@5-9;0@3')") from None
            events.append(FaultEvent(agent, kill, rejoin))
        return cls(m, events)

    def __str__(self) -> str:
        """Canonical ``parse`` syntax — stable across sessions, so it can
        sit in a checkpoint fingerprint."""
        return ";".join(
            f"{e.agent}@{e.kill_at}" + (f"-{e.rejoin_at}"
                                        if e.rejoin_at is not None else "")
            for e in self.events)

    def __repr__(self) -> str:
        return f"FaultPlan(m={self.m}, '{self}')"
