"""The split route's MoE FFN (``models/moe.py``: ``moe_forward(split=)``)
against the port's whole ``moe_forward``, on gloo ranks
(``tests/_torch_dist.py`` mode ``moe``).

Meshes (1, 1, 1, 2) (the experts and the dense / shared MLP's columns over
2 model ranks) and (1, 1, 2, 2) (and the batch over 2 fsdp ranks: the
capacity, the ranks within each expert and the aux the whole batch's).
Cases at ``reduced(d_model=64)``: arctic-480b (4 experts, the softmax
router, a dense MLP), deepseek-v3-671b's MoE block (4 experts, the sigmoid
router, a shared MLP) and arctic with 3 experts (a bank the model line
does not divide: whole, beside its split dense MLP), a batch of 4 x 8
tokens at capacity factor 0.5 (C = 8 or 11 of 64 assignments: experts
overflow), seeded parameters, input and cotangent (of a mean over the
tokens, as the model's loss):

- each rank's y and gradient of its rows of x, the aux, and each leaf's
  gradient made whole (its part placed, summed over the agent block)
  against the whole forward's at atol 1e-6 + rtol 1e-5;
- the assignments kept: the whole forward drops some, and the ranks' kept
  assignments, put together, are exactly the whole forward's;
- a dropless (serving) forward of each rank's rows against the whole
  dropless forward of those rows.
"""
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_threads  # noqa: F401
from _torch_dist import MOE_B, MOE_CASES, MOE_S, moe_config
from repro_torch.configs import get_config
from repro_torch.models import moe

MESHES = ("1,1,1,2", "1,1,2,2")
ATOL, RTOL = 1e-6, 1e-5


def _flat(tree, at=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{at}{k}/"))
        else:
            out[f"{at}{k}"] = v
    return out


def _whole(case):
    """The seeded inputs and the whole forward's results of ``case``."""
    cfg = moe_config(case, get_config)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(1)
    shape = (MOE_B, MOE_S, cfg.d_model)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    # the cotangent of a mean over the batch's tokens, as the model's loss
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         / (MOE_B * MOE_S))
    flat = _flat(p)
    leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
    params = {k: v for k, v in leaves.items() if "/" not in k}
    for k, v in leaves.items():
        if "/" in k:
            name, leaf = k.split("/")
            params.setdefault(name, {})[leaf] = v
    xg = x.clone().requires_grad_(True)
    valid = []
    orig = moe.dispatch_ranks

    def record(sel, C):
        out = orig(sel, C)
        valid.append(out[2])
        return out
    moe.dispatch_ranks = record
    try:
        y, aux = moe.moe_forward(params, xg, cfg=cfg, act_name=cfg.act)
    finally:
        moe.dispatch_ranks = orig
    keys = sorted(leaves)
    grads = torch.autograd.grad(torch.sum(y * g) + aux,
                                [leaves[k] for k in keys] + [xg])
    return ({"flat": flat, "x": x, "g": g},
            {"y": y.detach(), "aux": aux.detach(), "gx": grads[-1],
             "grads": dict(zip(keys, grads)), "valid": valid[0],
             "params": params, "cfg": cfg, "x": x})


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    inputs, wants = {}, {}
    for case in MOE_CASES:
        inputs[case], wants[case] = _whole(case)
    torch.save(inputs, tmp / "moe_inputs.pt")
    done = {}

    def run(shape):
        if shape not in done:
            d = tmp / shape.replace(",", "_")
            d.mkdir()
            (d / "moe_inputs.pt").symlink_to(tmp / "moe_inputs.pt")
            world = int(np.prod([int(x) for x in shape.split(",")]))
            _torch_dist.spawn(world, "moe", d, args=(shape,), timeout=180)
            done[shape] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                           for r in range(world)]
        return done[shape], wants
    return run


def _close(got, want, what):
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("shape", MESHES)
def test_split_moe_matches_the_whole_forward(worlds, shape, case):
    """y, the gradient of x, the aux and every leaf's gradient."""
    ranks, wants = worlds(shape)
    want = wants[case]
    for r, rec in enumerate(ranks):
        got = rec[case]
        lo, hi = got["rows"]
        _close(got["y"], want["y"][lo:hi], f"{shape} rank {r} y")
        _close(got["gx"], want["gx"][lo:hi], f"{shape} rank {r} dx")
        _close(got["aux"], want["aux"], f"{shape} rank {r} aux")
        assert set(got["grads"]) == set(want["grads"])
        for k, g in got["grads"].items():
            _close(g, want["grads"][k], f"{shape} rank {r} d{k}")


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("shape", MESHES)
def test_split_moe_keeps_the_whole_batch_assignments(worlds, shape, case):
    """The whole forward drops assignments (its experts overflow C); the
    ranks' kept ones (each rank its tokens' assignments to its experts)
    are exactly the whole forward's."""
    ranks, wants = worlds(shape)
    want = wants[case]["valid"]
    assert 0 < int(want.sum()) < want.numel(), "no assignment dropped"
    got = torch.zeros_like(want)
    for rec in ranks:
        lo, hi = rec[case]["rows"]
        k = want.numel() // MOE_B
        got[lo * k:hi * k] |= rec[case]["kept"]
    assert torch.equal(got, want)
    # each kept assignment is kept by its expert's owner alone; a whole
    # bank is every model rank's
    M = int(shape.split(",")[3])
    owners = 1 if MOE_CASES[case][1] % M == 0 else M
    total = sum(int(rec[case]["kept"].sum()) for rec in ranks)
    assert total == owners * int(want.sum())


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("shape", MESHES)
def test_split_moe_serves_each_data_rank_dropless(worlds, shape, case):
    """The dropless forward on a rank's rows (serving: capacity the rows'
    tokens, no fsdp sum) against the whole dropless forward of those
    rows."""
    ranks, wants = worlds(shape)
    want = wants[case]
    cfg = want["cfg"]
    for r, rec in enumerate(ranks):
        lo, hi = rec[case]["rows"]
        with torch.no_grad():
            y, _ = moe.moe_forward(want["params"], want["x"][lo:hi],
                                   cfg=cfg, act_name=cfg.act, dropless=True)
        _close(rec[case]["served"], y, f"{shape} rank {r} served")
