"""Dirichlet label-skew partitioning (Hsu et al. 2019; paper Appendix C.1).

Each agent k draws a class-mixture q_k ~ Dir(alpha * 1); examples are
assigned to agents proportionally to q_k per class. Small alpha => highly
non-IID (some agents see only a few classes), the regime where the paper's
single-global-merging effect is most dramatic.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, num_agents: int, alpha: float,
                        rng: np.random.Generator, min_per_agent: int = 1):
    """Returns a list of index arrays, one per agent."""
    labels = np.asarray(labels)
    classes = np.unique(labels)
    agent_idx = [[] for _ in range(num_agents)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        # proportions over agents for this class
        props = rng.dirichlet([alpha] * num_agents)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            agent_idx[k].extend(part.tolist())
    out = []
    for k in range(num_agents):
        ids = np.array(sorted(agent_idx[k]), dtype=np.int64)
        if len(ids) < min_per_agent:  # guarantee non-empty agents
            extra = rng.integers(0, len(labels), size=min_per_agent - len(ids))
            ids = np.concatenate([ids, extra])
        out.append(ids)
    return out


def heterogeneity(partitions, labels, num_classes) -> float:
    """Mean total-variation distance between agent label dists and global."""
    labels = np.asarray(labels)
    glob = np.bincount(labels, minlength=num_classes) / len(labels)
    tvs = []
    for ids in partitions:
        if len(ids) == 0:
            continue
        loc = np.bincount(labels[ids], minlength=num_classes) / len(ids)
        tvs.append(0.5 * np.abs(loc - glob).sum())
    return float(np.mean(tvs))
