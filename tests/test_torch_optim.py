"""The port's optimizers against the JAX package's, one step on identical
(m, D) panels. Tolerance atol 1e-6: float32 elementwise arithmetic, with
XLA's jitted division and pow rounding an ulp apart from PyTorch's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.optim import optim as ref_optim
from repro_torch.optim import optim


def _panels(seed=0, m=4, D=1000):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((m, D)).astype(np.float32) * s
            for k, s in (("g", 1e-2), ("p", 1.0), ("m", 1e-3), ("v", 1e-5))}


def _ref_step(ref_opt, x, steps=1):
    pan = {"float32": jnp.asarray(x["p"])}
    state = jax.vmap(ref_opt.init)(pan)
    if "m" in state:
        state["m"] = {"float32": jnp.asarray(x["m"])}
        state["v"] = {"float32": jnp.asarray(np.abs(x["v"]))}
    if "mu" in state:
        state["mu"] = {"float32": jnp.asarray(x["m"])}
    upd = jax.jit(jax.vmap(ref_opt.update))
    g = {"float32": jnp.asarray(x["g"])}
    for _ in range(steps):
        pan, state = upd(g, state, pan)
    return np.asarray(pan["float32"]), state


def _port_step(opt, x, steps=1):
    pan = {"float32": torch.from_numpy(x["p"].copy())}
    state = opt.init(pan)
    if "m" in state:
        state["m"] = {"float32": torch.from_numpy(x["m"].copy())}
        state["v"] = {"float32": torch.from_numpy(np.abs(x["v"]))}
    if "mu" in state:
        state["mu"] = {"float32": torch.from_numpy(x["m"].copy())}
    g = {"float32": torch.from_numpy(x["g"])}
    for _ in range(steps):
        pan, state = opt.update(g, state, pan)
    return pan["float32"].numpy(), state


@pytest.mark.parametrize("schedule", ["constant", "cosine", "warmup_cosine"])
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_step_matches(schedule, steps):
    x = _panels()
    ref_opt = ref_optim.make_optimizer("adamw", 3e-3, total_steps=10,
                                       schedule=schedule)
    opt = optim.make_optimizer("adamw", 3e-3, total_steps=10,
                               schedule=schedule)
    rp, rs = _ref_step(ref_opt, x, steps)
    pp, ps = _port_step(opt, x, steps)
    np.testing.assert_allclose(pp, rp, atol=1e-6)
    np.testing.assert_allclose(ps["m"]["float32"].numpy(),
                               np.asarray(rs["m"]["float32"]), atol=1e-6)
    np.testing.assert_allclose(ps["v"]["float32"].numpy(),
                               np.asarray(rs["v"]["float32"]), atol=1e-6)
    assert ps["step_count"] == int(rs["step_count"][0]) == steps


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_step_matches(momentum):
    x = _panels(1)
    ref_opt = ref_optim.make_optimizer("sgd", 0.1, momentum=momentum)
    opt = optim.make_optimizer("sgd", 0.1, momentum=momentum)
    rp, _ = _ref_step(ref_opt, x, 2)
    pp, _ = _port_step(opt, x, 2)
    np.testing.assert_allclose(pp, rp, atol=1e-6)


def test_adamw_core_is_the_update_expression(monkeypatch):
    """update applies exactly ``core``, chunk by chunk: the same numbers as
    core on the whole panel (elementwise, so chunking changes nothing)."""
    monkeypatch.setattr(optim, "_CHUNK", 96)  # 1000 columns: 11 chunks
    x = _panels(2)
    opt = optim.make_optimizer("adamw", 3e-3)
    lr, bc1, bc2 = opt.hyper(1)
    want = opt.core(*(torch.from_numpy(x[k]) for k in ("g", "m")),
                    torch.from_numpy(np.abs(x["v"])),
                    torch.from_numpy(x["p"]), lr=lr, bc1=bc1, bc2=bc2)
    got, _ = _port_step(opt, x)
    assert torch.equal(torch.from_numpy(got), want[0])


@pytest.mark.parametrize("schedule", ["constant", "cosine", "warmup_cosine"])
def test_lr_schedules_match(schedule):
    ref_s = {"constant": ref_optim.constant_schedule(0.01),
             "cosine": ref_optim.cosine_schedule(0.01, 50),
             "warmup_cosine": ref_optim.warmup_cosine(0.01, 500)}[schedule]
    s = {"constant": optim.constant_schedule(0.01),
         "cosine": optim.cosine_schedule(0.01, 50),
         "warmup_cosine": optim.warmup_cosine(0.01, 500)}[schedule]
    for step in (0, 1, 7, 49, 50, 120, 700):
        np.testing.assert_allclose(float(s(step)),
                                   float(ref_s(jnp.asarray(step))),
                                   rtol=1e-6)
