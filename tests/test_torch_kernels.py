"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain versions (kernels/ref.py of the
port); they are held against ``gossip_mix_panel`` / ``panel_mean_consensus``
run in interpret mode, as tests/test_kernels.py runs them, and against the
reference's ``kernels/ref.py`` oracles, over that file's sweep plus the
folded-mean n = m + 1 case. Tolerance 1e-6: the port sums over k in a fixed
order with separately rounded products, XLA's dot and mean in its own.
The CUDA kernels themselves are held against the plain versions by
tests/test_torch_cuda.py, on a GPU host.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.core.topology import random_matching
from repro.kernels.gossip_mix import gossip_mix_panel
from repro.kernels.panel_reduce import panel_mean_consensus as jax_reduce
from repro.kernels.ref import gossip_mix_ref as jax_mix_ref
from repro.kernels.ref import panel_mean_consensus_ref as jax_reduce_ref
from repro_torch.kernels.gossip_mix import gossip_mix
from repro_torch.kernels.panel_reduce import panel_mean_consensus

SWEEP = [(4, 64, 32), (8, 1000, 512), (16, 4096, 512), (8, 333, 128)]
TOL = 1e-6


def _inputs(m, D, fold):
    rng = np.random.default_rng(m * 7919 + D)
    W = random_matching(m, 0.7, rng).astype(np.float32)
    if fold:
        W = np.concatenate([W, np.full((1, m), 1.0 / m, np.float32)])
    theta = rng.standard_normal((m, D)).astype(np.float32)
    return W, theta


@pytest.mark.parametrize("fold", [False, True], ids=["n=m", "n=m+1"])
@pytest.mark.parametrize("m,D,block_d", SWEEP)
def test_gossip_mix_matches_pallas(m, D, block_d, fold):
    W, theta = _inputs(m, D, fold)
    got = gossip_mix(torch.from_numpy(W), torch.from_numpy(theta)).numpy()
    pallas = np.asarray(gossip_mix_panel(jnp.asarray(W), jnp.asarray(theta),
                                         block_d=block_d, interpret=True))
    oracle = np.asarray(jax_mix_ref(jnp.asarray(W), jnp.asarray(theta)))
    assert got.shape == (W.shape[0], D) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, oracle, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("m,D,block_d", SWEEP)
def test_panel_mean_consensus_matches_pallas(m, D, block_d):
    _, theta = _inputs(m, D, False)
    mean, sq = panel_mean_consensus(torch.from_numpy(theta))
    p_mean, p_sq = jax_reduce(jnp.asarray(theta), block_d=block_d,
                              interpret=True)
    o_mean, o_sq = jax_reduce_ref(jnp.asarray(theta))
    assert mean.shape == (D,) and sq.shape == ()
    np.testing.assert_allclose(mean.numpy(), np.asarray(p_mean), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(o_mean), atol=TOL,
                               rtol=TOL)
    # the sum of squares runs over m*D terms in three different orders
    # (float64 here, blockwise and flat float32 in JAX): relative 1e-5
    np.testing.assert_allclose(float(sq), float(p_sq), rtol=1e-5)
    np.testing.assert_allclose(float(sq), float(o_sq), rtol=1e-5)


def test_fully_connected_rows_are_bitwise_equal():
    """Equal weight rows give equal output rows bit for bit (the final
    merge's Xi == 0 rests on it), the folded mean row included."""
    m, D = 8, 777
    _, theta = _inputs(m, D, False)
    W = torch.full((m + 1, m), 1.0 / m)
    out = gossip_mix(W, torch.from_numpy(theta))
    assert torch.equal(out, out[:1].expand_as(out))


def test_wrapper_rejects_other_devices():
    W = torch.eye(2, device="meta")
    with pytest.raises(ValueError):
        gossip_mix(W, torch.zeros((2, 4), device="meta"))
    with pytest.raises(ValueError):
        panel_mean_consensus(torch.zeros((2, 4), device="meta"))
