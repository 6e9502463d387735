"""The port's dense olmo-1b model against the JAX package's, on handed-over
parameters (reduced olmo-1b: d_model 128, 2 layers, vocab 256).

Tolerances: the layers agree to 1e-5 (float32, the products summed in
other orders); the loss to rtol 1e-5; per-leaf gradients to atol 1e-5 (the
backward pass chains a few dozen float32 products and sums)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.launch.train import build_cpu_preset as ref_cpu_preset
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro_torch.configs import get_config
from repro_torch.core import panel as panel_mod
from repro_torch.launch.train import build_cpu_preset
from repro_torch.models import attention, build_model, layers
from repro_torch.utils.tree import tree_flatten, tree_unflatten
from repro_torch.weights import from_reference_params


def _cfgs():
    return (ref_cpu_preset(ref_get_config("olmo-1b"), 4),
            build_cpu_preset(get_config("olmo-1b"), 4))


def _batch(vocab, b=4, seq=32, seed=0, ragged_mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(b, seq + 1)).astype(np.int32)
    mask = np.ones((b, seq), np.float32)
    if ragged_mask:
        mask[:, seq - 5:] = 0.0
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


def _handover(ref_params):
    stacked = jax.tree.map(lambda x: np.asarray(x)[None], ref_params)
    _, panel, spec = from_reference_params(stacked, device="cpu")
    return panel_mod.agent_params(panel, spec, 0)


@pytest.mark.parametrize("ragged_mask", [False, True])
def test_loss_and_grads_match_reference(ragged_mask):
    ref_cfg, cfg = _cfgs()
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init_params(jax.random.PRNGKey(0))
    batch = _batch(cfg.vocab_size, ragged_mask=ragged_mask)
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        ref_model.loss_fn, has_aux=True))(
            ref_params, jax.tree.map(jnp.asarray, batch), None)

    params = _handover(ref_params)
    leaves, skel = tree_flatten(params)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss, _ = build_model(cfg).loss_fn(
        tree_unflatten(skel, leaves),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)

    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    ref_leaves = jax.tree_util.tree_leaves(ref_grads)
    assert len(ref_leaves) == len(grads)
    for g, rg in zip(grads, ref_leaves):
        assert tuple(g.shape) == rg.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=1e-5)


def test_param_tree_layout_matches_reference():
    ref_cfg, cfg = _cfgs()
    ref_params = ref_build_model(ref_cfg).init_params(jax.random.PRNGKey(1))
    ours = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        "cpu")
    ref_paths = [(jax.tree_util.keystr(p), x.shape) for p, x in
                 jax.tree_util.tree_flatten_with_path(ref_params)[0]]
    leaves, _ = tree_flatten(ours)
    assert [s for _, s in ref_paths] == [tuple(x.shape) for x in leaves]
    assert ours["embed"]["table"].shape == (cfg.padded_vocab, cfg.d_model)


@pytest.mark.parametrize("kind", ["nonparam_ln", "rmsnorm", "layernorm"])
def test_apply_norm_matches(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    p = {} if kind == "nonparam_ln" else {
        "scale": rng.standard_normal(64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    ref = jax.jit(lambda pp, xx: ref_layers.apply_norm(pp, xx, kind))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_apply_rope_half_split_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    ref = jax.jit(ref_layers.apply_rope)(jnp.asarray(x), jnp.asarray(pos))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("window", [None, 8])
def test_gqa_forward_matches(window):
    import dataclasses
    ref_cfg, cfg = _cfgs()
    lspec_ref = dataclasses.replace(ref_cfg.layer_period[0], window=window)
    lspec = dataclasses.replace(cfg.layer_period[0], window=window)
    ref_p = ref_attn.init_gqa(jax.random.PRNGKey(3), ref_cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    ref, _ = jax.jit(lambda p, xx, pp: ref_attn.gqa_forward(
        p, xx, cfg=ref_cfg, lspec=lspec_ref, positions=pp, mode="train"))(
            ref_p, jnp.asarray(x), jnp.asarray(pos))
    got, _ = attention.gqa_forward(
        {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()},
        torch.from_numpy(x), cfg=cfg, lspec=lspec,
        positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_chunked_xent_matches():
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 20, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    t = rng.integers(0, 40, size=(2, 20)).astype(np.int32)
    mask = (rng.random((2, 20)) > 0.2).astype(np.float32)
    ref = jax.jit(lambda *a: ref_layers.chunked_softmax_xent(*a, chunk=8))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(t), jnp.asarray(mask))
    got = layers.chunked_softmax_xent(torch.from_numpy(h), torch.from_numpy(w),
                                      torch.from_numpy(t),
                                      torch.from_numpy(mask), chunk=8)
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
    assert float(got[1]) == float(ref[1])
