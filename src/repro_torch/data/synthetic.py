"""Synthetic LM data with controllable heterogeneity (counterpart of the
language-model half of ``repro/data/synthetic.py``).

:class:`SyntheticLM` — per-domain Markov-chain token streams; each agent's
domain mixture is Dirichlet-skewed, giving non-IID next-token statistics.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class SyntheticLM:
    vocab: int = 256
    num_domains: int = 8
    order_skew: float = 4.0
    seed: int = 0
    _trans: Optional[np.ndarray] = field(default=None, repr=False)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # per-domain Markov transition matrices concentrated on a domain-
        # specific token subset => strongly domain-skewed statistics
        self._trans = np.empty((self.num_domains, self.vocab, self.vocab),
                               np.float32)
        for d in range(self.num_domains):
            conc = np.full(self.vocab, 0.05)
            lo = (d * self.vocab) // self.num_domains
            hi = ((d + 1) * self.vocab) // self.num_domains
            conc[lo:hi] = self.order_skew
            self._trans[d] = rng.dirichlet(conc, size=self.vocab)

    def domain_mixtures(self, num_agents: int, alpha: float, seed: int = 0):
        rng = np.random.default_rng(seed)
        return rng.dirichlet([alpha] * self.num_domains, size=num_agents)

    def sample(self, domain_probs, batch: int, seq_len: int,
               rng: np.random.Generator):
        """Sample (batch, seq_len+1) token streams from a domain mixture."""
        doms = rng.choice(self.num_domains, size=batch, p=domain_probs)
        out = np.empty((batch, seq_len + 1), np.int32)
        out[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq_len):
            probs = self._trans[doms, out[:, t]]
            cum = probs.cumsum(axis=1)
            u = rng.random((batch, 1))
            out[:, t + 1] = (u < cum).argmax(axis=1)
        return out


def make_agent_lm_batches(lm: SyntheticLM, mixtures, batch: int,
                          seq_len: int, rng: np.random.Generator):
    toks = np.stack([lm.sample(mix, batch, seq_len, rng) for mix in mixtures])
    return {"tokens": toks[:, :, :-1], "targets": toks[:, :, 1:],
            "mask": np.ones(toks[:, :, 1:].shape, np.float32)}
