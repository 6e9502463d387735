"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's, on handed-over parameters: the router, the capacity-capped and
dropless dispatch, the dense twin ``moe_ref``, and mirrors of
``tests/test_models.py``'s MoE cases.

Configs: arctic-480b (softmax top-2 router, a dense residual MLP) and
deepseek-v3-671b (sigmoid top-2 router after ``reduced()``, a shared
expert), both ``reduced(d_model=64)`` with 4 experts. Tolerances: router
weights within 1e-6 and the selected experts equal; outputs at atol 2e-5
+ rtol 2e-5 (float32 products summed in other orders); the aux loss at
1e-6. The selections' smallest top-k margin is printed by the router test
and asserted above 1e-5 (a margin under float32 noise could flip an
expert between the packages)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.models import moe

ATOL = RTOL = 2e-5


def _cfgs(arch="arctic-480b", E=4, k=2, cap=None):
    ref_cfg = ref_get_config(arch).reduced(d_model=64, experts=E)
    cfg = get_config(arch).reduced(d_model=64, experts=E)
    out = []
    for c in (ref_cfg, cfg):
        kw = {"top_k": k}
        if cap is not None:
            kw["capacity_factor"] = cap
        out.append(c.replace(moe=dataclasses.replace(c.moe, **kw)))
    return out


def _params(ref_cfg, seed=0):
    ref_p = ref_moe.init_moe(jax.random.PRNGKey(seed), ref_cfg)
    return ref_p, jax.tree.map(lambda x: torch.from_numpy(np.array(x)),
                               ref_p)


def _x(shape, d, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape + (d,)).astype(np.float32)


@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v3-671b"])
def test_route_matches_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_p, p = _params(ref_cfg)
    x = _x((64,), cfg.d_model)
    w_r, sel_r, aux_r = jax.jit(lambda pp, xx: ref_moe._route(
        xx, pp, ref_cfg.moe))(ref_p, jnp.asarray(x))
    w, sel, aux = moe._route(torch.from_numpy(x), p, cfg.moe)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(sel_r))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(aux_r), atol=1e-6)
    # the smallest gap between the k-th and the (k+1)-th score
    logits = torch.from_numpy(x) @ p["router"]
    scores = (torch.sigmoid(logits) if cfg.moe.router == "sigmoid"
              else torch.softmax(logits, -1))
    top = torch.topk(scores, cfg.moe.top_k + 1, dim=-1).values
    margin = float(torch.min(top[:, -2] - top[:, -1]))
    print(f"{arch}: smallest top-{cfg.moe.top_k} margin {margin:.3g}")
    assert margin > 1e-5


@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v3-671b"])
@pytest.mark.parametrize("dropless", [False, True])
def test_moe_forward_matches_reference(arch, dropless):
    """cap 0.25 drops assignments in training; dropless (C = T) none. The
    tokens that lost an assignment (their output differs from the dropless
    one) are the same in both packages."""
    ref_cfg, cfg = _cfgs(arch, cap=0.25)
    ref_p, p = _params(ref_cfg)
    x = _x((2, 32), cfg.d_model)

    def ref_fwd(pp, xx, dl):
        return ref_moe.moe_forward(pp, xx, cfg=ref_cfg, act_name="silu",
                                   dropless=dl)

    y_r, aux_r = jax.jit(ref_fwd, static_argnums=2)(ref_p, jnp.asarray(x),
                                                    dropless)
    y, aux = moe.moe_forward(p, torch.from_numpy(x), cfg=cfg,
                             act_name="silu", dropless=dropless)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(aux_r), atol=1e-6)
    if not dropless:
        y_full_r, _ = jax.jit(ref_fwd, static_argnums=2)(
            ref_p, jnp.asarray(x), True)
        y_full, _ = moe.moe_forward(p, torch.from_numpy(x), cfg=cfg,
                                    act_name="silu", dropless=True)
        hit_r = np.any(np.abs(np.asarray(y_r) - np.asarray(y_full_r))
                       > 1e-4, axis=-1)
        hit = np.any(np.abs(y.numpy() - y_full.numpy()) > 1e-4, axis=-1)
        assert hit.any() and not hit.all()
        np.testing.assert_array_equal(hit, hit_r)


def test_capacity_drop_ranks():
    """Ranks within an expert follow the assignments' order; those at or
    past C are clamped to the discarded column C."""
    sel = torch.tensor([[0, 1], [0, 2], [1, 0], [0, 1]])
    flat_e, rank_c, valid = moe.dispatch_ranks(sel, 2)
    assert flat_e.tolist() == [0, 1, 0, 2, 1, 0, 0, 1]
    assert rank_c.tolist() == [0, 0, 1, 0, 1, 2, 2, 2]
    assert valid.tolist() == [True, True, True, True, True, False, False,
                              False]
    assert moe.capacity(32, _cfgs(cap=0.25)[1].moe, False) == 4
    assert moe.capacity(32, _cfgs(cap=0.25)[1].moe, True) == 32


@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v3-671b"])
def test_moe_ref_matches_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_p, p = _params(ref_cfg)
    x = _x((2, 16), cfg.d_model)
    y_r, aux_r = jax.jit(lambda pp, xx: ref_moe.moe_ref(
        pp, xx, cfg=ref_cfg, act_name="silu"))(ref_p, jnp.asarray(x))
    y, aux = moe.moe_ref(p, torch.from_numpy(x), cfg=cfg, act_name="silu")
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(aux_r), atol=1e-6)


def test_moe_matches_dense_twin_no_drops():
    """With a huge capacity factor nothing drops: the dispatch equals the
    compute-everything twin (``tests/test_models.py``'s first MoE case)."""
    _, cfg = _cfgs(cap=100.0)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.from_numpy(_x((2, 16), cfg.d_model))
    y1, aux1 = moe.moe_forward(p, x, cfg=cfg, act_name=cfg.act)
    y2, aux2 = moe.moe_ref(p, x, cfg=cfg, act_name=cfg.act)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(aux1), float(aux2), atol=1e-6)


def test_moe_capacity_drops_reduce_output():
    _, cfg_lo = _cfgs(cap=0.25)
    _, cfg_hi = _cfgs(cap=100.0)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg_hi, device="cpu")
    x = torch.from_numpy(_x((2, 32), cfg_hi.d_model))
    y_lo, _ = moe.moe_forward(p, x, cfg=cfg_lo, act_name="silu")
    y_hi, _ = moe.moe_forward(p, x, cfg=cfg_hi, act_name="silu")
    assert float(torch.mean(torch.abs(y_lo))) < float(
        torch.mean(torch.abs(y_hi)))


def test_sigmoid_router_weights_normalised():
    cfg = get_config("deepseek-v3-671b").reduced()
    assert cfg.moe.router == "sigmoid"
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.from_numpy(_x((8,), cfg.d_model))
    w, sel, aux = moe._route(x, p, cfg.moe)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    assert sel.shape == (8, cfg.moe.top_k) and float(aux) > 0


def test_param_tree_matches_reference():
    ref_cfg, cfg = _cfgs("deepseek-v3-671b")
    ref_p, _ = _params(ref_cfg)
    ours = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref_paths = [(jax.tree_util.keystr(k), x.shape) for k, x in
                 jax.tree_util.tree_flatten_with_path(ref_p)[0]]
    from repro_torch.utils.tree import tree_flatten
    leaves, _ = tree_flatten(ours)
    assert [s for _, s in ref_paths] == [tuple(x.shape) for x in leaves]
    assert ours["router"].dtype == torch.float32
