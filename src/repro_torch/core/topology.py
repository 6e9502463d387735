"""Mixing-matrix generators for decentralized communication graphs.

All matrices are doubly stochastic (Assumption 1). The paper's primary
topology is "random R": each agent activates an exchange with one random
peer with probability R (R=0.2 in the main experiments); we realise this as
a random partial matching — pairs average 50/50, unmatched agents keep their
parameters (W row = e_k).
"""
from __future__ import annotations

import numpy as np


def identity(m: int) -> np.ndarray:
    return np.eye(m, dtype=np.float64)


def fully_connected(m: int) -> np.ndarray:
    return np.full((m, m), 1.0 / m, dtype=np.float64)


def ring(m: int) -> np.ndarray:
    """Symmetric ring gossip: 1/3 self + 1/3 each neighbour."""
    W = np.zeros((m, m))
    for k in range(m):
        W[k, k] = 1 / 3
        W[k, (k - 1) % m] += 1 / 3
        W[k, (k + 1) % m] += 1 / 3
    return W


def exponential(m: int) -> np.ndarray:
    """One-peer exponential graph (Ying et al. 2021): static average over
    hops 2^0..2^(log2(m)-1), doubly stochastic."""
    hops = []
    h = 1
    while h < m:
        hops.append(h)
        h *= 2
    W = np.zeros((m, m))
    for k in range(m):
        W[k, k] = 1.0 / (len(hops) + 1)
        for h in hops:
            W[k, (k + h) % m] += 1.0 / (len(hops) + 1)
    # symmetrise to keep it doubly stochastic for undirected gossip
    W = 0.5 * (W + W.T)
    return W


def exponential_round(m: int, t: int) -> np.ndarray:
    """One-peer exponential graph, round t. For power-of-two m this is the
    hypercube (butterfly) matching k <-> k XOR 2^(t mod log2 m): a perfect
    matching per round, and log2(m) consecutive rounds realise the EXACT
    global average (used to approximate the final merge, Appendix C.3.4).
    Otherwise falls back to symmetric ring hops of 2^t."""
    n_hops = max(1, int(np.log2(m)))
    h = 2 ** (t % n_hops)
    W = np.zeros((m, m))
    if m & (m - 1) == 0:  # power of two: XOR pairing
        for k in range(m):
            W[k, k] += 0.5
            W[k, k ^ h] += 0.5
        return W
    for k in range(m):
        W[k, (k + h) % m] += 0.5
        W[k, (k - h) % m] += 0.5
    return W


def random_matching(m: int, prob: float, rng: np.random.Generator
                    ) -> np.ndarray:
    """Paper's "R" topology: each agent wants one random peer w.p. ``prob``;
    realised as a random partial matching (pairs average 50/50)."""
    W = np.eye(m)
    active = [k for k in range(m) if rng.random() < prob]
    rng.shuffle(active)
    for i in range(0, len(active) - 1, 2):
        a, b = active[i], active[i + 1]
        W[a, a] = W[b, b] = 0.5
        W[a, b] = W[b, a] = 0.5
    return W


def degrade_to_live(W: np.ndarray, live) -> np.ndarray:
    """Restrict a mixing matrix to the surviving subgraph.

    Dead agents (``live[k] == False``) neither send nor receive: their
    rows AND columns become the identity e_k, and every survivor folds
    the mass it would have exchanged with dead peers back into its own
    self-loop (the lazy-repair rule). For a symmetric W (every topology
    in this module) the result is again doubly stochastic, restricted to
    the live block; for a general row-stochastic W row sums are still
    preserved. ``live`` all-True returns W unchanged (same float64
    array semantics, no fault-path drift)."""
    live = np.asarray(live, bool)
    Wd = np.array(W, np.float64)
    if live.all():
        return Wd
    m = Wd.shape[0]
    dead = ~live
    dropped = Wd[:, dead].sum(axis=1)
    Wd[:, dead] = 0.0
    Wd[dead, :] = 0.0
    idx = np.arange(m)
    Wd[idx, idx] += np.where(live, dropped, 0.0)
    Wd[idx[dead], idx[dead]] = 1.0
    return Wd


def fully_connected_live(live) -> np.ndarray:
    """Global-merge matrix over the live subgraph: every live row is the
    uniform mean over the live agents (a sub-AllReduce), dead rows stay
    the identity e_k — so under a lossy wire codec the dead agents are
    idle rows and their parameters pass through bit-exactly. Doubly
    stochastic for any live mask; all-dead degrades to the identity."""
    live = np.asarray(live, bool)
    m = live.shape[0]
    n = int(live.sum())
    if n == 0:
        return identity(m)
    W = np.zeros((m, m))
    W[np.ix_(live, live)] = 1.0 / n
    idx = np.flatnonzero(~live)
    W[idx, idx] = 1.0
    return W


def make_sampler(kind: str, m: int, prob: float = 0.2):
    """Returns sampler(t, rng) -> W for a named topology family."""
    if kind == "random":
        return lambda t, rng: random_matching(m, prob, rng)
    if kind == "ring":
        return lambda t, rng: ring(m)
    if kind == "exponential":
        return lambda t, rng: exponential_round(m, t)
    if kind == "full":
        return lambda t, rng: fully_connected(m)
    if kind == "none":
        return lambda t, rng: identity(m)
    raise ValueError(kind)
