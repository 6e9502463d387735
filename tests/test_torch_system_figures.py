"""Three figure families of the paper, the port against
``benchmarks.figures`` on the CPU (split from ``tests/test_torch_system.py``):
the port's initial parameters handed over from the reference
(``make_problem``'s init replaced by the reference's rows); accuracies
within 0.01 and Table 1's ratio within 2 % (80-100 rounds of float32 SGD in
two packages: the rounding of sums in other orders drifts)."""
import itertools

import jax
import numpy as np
import pytest
import torch

import benchmarks.common as ref_common
import benchmarks.figures as ref_figures
import _torch_threads  # noqa: F401
from repro_torch.bench import common, figures
from test_torch_system import M


def _hand_over(monkeypatch, key_rows):
    """Replace the port's make_problem init by the reference's rows:
    ``key_rows`` gives the JAX keys whose inits the port's init_params
    returns in turn (cycling), whatever generator it is handed."""
    real = common.make_problem

    def handed(seed=0, device=None, **kw):
        ds, parts, _, loss_fn, acc = real(seed, device=device, **kw)
        r_init = ref_common.make_problem(seed)[2]
        rows = [{k: torch.as_tensor(np.array(v)) for k, v in
                 r_init(key).items()} for key in key_rows]
        it = itertools.cycle(rows)
        return ds, parts, (lambda gen: next(it)), loss_fn, acc

    monkeypatch.setattr(common, "make_problem", handed)
    monkeypatch.setattr(figures, "make_problem", handed)


def _split(seed):
    return list(jax.random.split(jax.random.PRNGKey(seed), M))


def _accs_close(got, ref, keys):
    for k in keys:
        assert abs(got[k] - ref[k]) <= 0.01, (k, got, ref)


def test_fig1_matches_reference(monkeypatch):
    _hand_over(monkeypatch, _split(0))
    _, ref = ref_figures.fig1_single_global_merging()
    _, got = figures.fig1_single_global_merging(device="cpu")
    _accs_close(got, ref, ("gossip_local_acc", "gossip_merged_acc",
                           "localonly_merged_acc"))


def test_appendix_c34_matches_reference(monkeypatch):
    _hand_over(monkeypatch, _split(0))
    _, ref = ref_figures.appendix_c34_gossip_merge()
    _, got = figures.appendix_c34_gossip_merge(device="cpu")
    _accs_close(got, ref, ("gossip_1r", "gossip_3r", "exact_merge", "local"))
    assert abs(got["gossip_3r"] - got["exact_merge"]) <= 0.01


def test_table1_matches_reference(monkeypatch):
    _hand_over(monkeypatch, [jax.random.PRNGKey(0)])
    _, ref = ref_figures.table1_convergence_rates()
    _, got = figures.table1_convergence_rates(device="cpu")
    assert np.isfinite(got["ratio"])
    assert got["ratio"] == pytest.approx(ref["ratio"], rel=0.02), (got, ref)
