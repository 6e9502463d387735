"""The port's panel engine against the JAX package's, on handed-over
parameters of reduced olmo-1b (4 agents).

The panel layout is held bit for bit (same leaf order and offsets); the
fused ops to 1e-6 (the float32 mix and mean summed in other orders), the
consensus distance to rtol 1e-5 (a sum over all m*D squared deviations)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.core import panel as ref_panel
from repro.core.topology import fully_connected, random_matching
from repro.launch.train import build_cpu_preset as ref_cpu_preset
from repro.models import build_model as ref_build_model
from repro_torch.core import merge, panel
from repro_torch.utils.tree import tree_flatten
from repro_torch.weights import from_reference_params

M = 4


@pytest.fixture(scope="module")
def handed_over():
    cfg = ref_cpu_preset(ref_get_config("olmo-1b"), M)
    init = ref_build_model(cfg).init_params
    stacked = jax.vmap(init)(jax.random.split(jax.random.PRNGKey(0), M))
    ref_spec = ref_panel.make_spec(stacked)
    ref_pan = ref_panel.to_panel(stacked, ref_spec)
    np_tree = jax.tree.map(np.asarray, stacked)
    params, pan, spec = from_reference_params(np_tree, device="cpu")
    return stacked, ref_spec, ref_pan, params, pan, spec


def test_panel_layout_bit_exact(handed_over):
    stacked, ref_spec, ref_pan, params, pan, spec = handed_over
    assert spec.groups == ref_spec.groups and spec.rows == ref_spec.rows
    assert [(ls.offset, ls.size, ls.shape) for ls in spec.leaves] == \
        [(ls.offset, ls.size, ls.shape) for ls in ref_spec.leaves]
    assert sorted(pan) == sorted(ref_pan)
    for k in pan:
        assert pan[k].numpy().tobytes() == np.asarray(ref_pan[k]).tobytes()


def test_round_trip_bit_exact(handed_over):
    stacked, _, _, _, pan, spec = handed_over
    back = panel.from_panel(pan, spec)
    ours, _ = tree_flatten(back)
    for x, r in zip(ours, jax.tree_util.tree_leaves(stacked)):
        assert x.numpy().tobytes() == np.asarray(r).tobytes()
    again = panel.to_panel(back, spec)
    for k in pan:
        assert torch.equal(again[k], pan[k])
    row = panel.agent_params(pan, spec, 2)
    for x, r in zip(tree_flatten(row)[0],
                    jax.tree_util.tree_leaves(stacked)):
        assert x.numpy().tobytes() == np.asarray(r[2]).tobytes()


@pytest.mark.parametrize("topo", ["random", "full", "identity"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_mix_dense_mean_matches(handed_over, topo, use_pallas):
    _, ref_spec, ref_pan, _, pan, _ = handed_over
    W = {"random": random_matching(M, 0.9, np.random.default_rng(1)),
         "full": fully_connected(M), "identity": np.eye(M)}[topo]
    W = W.astype(np.float32)
    ref_mixed, ref_mean, _ = jax.jit(lambda p, w: ref_panel.mix_dense_mean(
        p, w, use_pallas=use_pallas, interpret=True))(ref_pan,
                                                      jnp.asarray(W))
    mixed, mean, err = panel.mix_dense_mean(pan, W)
    assert err is None
    for k in pan:
        np.testing.assert_allclose(mixed[k].numpy(),
                                   np.asarray(ref_mixed[k]), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(mean[k].numpy(), np.asarray(ref_mean[k]),
                                   atol=1e-6, rtol=1e-6)
    plain = panel.mix_dense(pan, W)
    for k in pan:
        assert torch.equal(plain[k], mixed[k])
    xi = panel.consensus_from_mean(mixed, mean)
    ref_xi = ref_panel.consensus_from_mean(ref_mixed, ref_mean)
    np.testing.assert_allclose(float(xi), float(ref_xi), rtol=1e-5)
    if topo == "full":
        assert float(xi) == 0.0


@pytest.mark.parametrize("use_pallas", [False, True])
def test_merged_and_consensus_match(handed_over, use_pallas):
    _, _, ref_pan, _, pan, _ = handed_over
    ref_m = jax.jit(lambda p: ref_panel.merged(
        p, use_pallas=use_pallas, interpret=True))(ref_pan)
    ref_xi = jax.jit(lambda p: ref_panel.consensus_distance(
        p, use_pallas=use_pallas, interpret=True))(ref_pan)
    got = panel.merged(pan)
    for k in pan:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref_m[k]),
                                   atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(panel.consensus_distance(pan)),
                               float(ref_xi), rtol=1e-5)


def test_global_merge_and_norm_match(handed_over):
    _, _, ref_pan, _, pan, _ = handed_over
    ref_g = ref_panel.global_merge(ref_pan)
    got = panel.global_merge(pan)
    for k in pan:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref_g[k]),
                                   atol=1e-6, rtol=1e-6)
    for axis_mean in (False, True):
        np.testing.assert_allclose(
            float(panel.panel_norm(pan, axis_mean=axis_mean)),
            float(ref_panel.panel_norm(ref_pan, axis_mean=axis_mean)),
            rtol=1e-5)


def test_merged_tree_matches(handed_over):
    _, ref_spec, ref_pan, _, pan, spec = handed_over
    ref_tree = ref_panel.merged_tree(ref_pan, ref_spec)
    ours = merge.merged_panel_tree(pan, spec)
    for x, r in zip(tree_flatten(ours)[0],
                    jax.tree_util.tree_leaves(ref_tree)):
        assert tuple(x.shape) == r.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(r), atol=1e-6,
                                   rtol=1e-6)
