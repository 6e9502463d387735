"""The port's blockwise attention route (``cfg.dist.attn_block > 0``) and
its flash attention wrappers against the JAX package, on the CPU.

On the CPU the wrappers run their plain versions (``kernels/ref.py`` of
the port: the online-softmax loop over key blocks, differentiated by torch
autograd). They are held against the reference's Pallas
``flash_attention`` run in interpret mode (as tests/test_kernels.py runs
it, at that file's own shapes), its ``attention_ref`` oracle, the jitted
``_sdpa_blockwise`` and ``jax.grad`` of it, ``gqa_forward``, the model's
loss and gradients, and a training segment. Inputs are drawn with numpy
from fixed seeds; parameters are the reference's, handed over.

Tolerances: the attention outputs 2e-5 in float32 and 2e-2 in bfloat16
(the reference kernel test's own); ``_sdpa_blockwise`` 1e-5 and its
gradients 2e-5 (float32, the products summed in other orders);
``gqa_forward`` 1e-5 against the reference and 2e-4 against the port's
dense route (the reference test's bound for that comparison); the model's
loss rtol 1e-5 and per-leaf gradients atol 1e-5 (as test_torch_model.py);
the segment rtol 1e-4 (as test_torch_segment.py), Xi <= 1e-6 and local ==
merged eval to 1e-6 relative after the final merge. The CUDA kernels are
held against the plain versions by tests/test_torch_cuda.py, on a GPU host.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.core import dsgd as ref_dsgd
from repro.core import merge as ref_merge
from repro.core import panel as ref_panel
from repro.kernels.flash_attention import flash_attention_bh as ref_bh
from repro.kernels.ops import flash_attention as ref_flash
from repro.kernels.ref import attention_ref as ref_attention_ref
from repro.launch.train import build_cpu_preset as ref_cpu_preset
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build_model
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch.configs import get_config
from repro_torch.core import dsgd
from repro_torch.core import panel as panel_mod
from repro_torch.core.schedule import make_schedule
from repro_torch.data.synthetic import SyntheticLM, make_agent_lm_batches
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bh,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch import train
from repro_torch.models import attention, build_model
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_flatten, tree_unflatten
from repro_torch.weights import from_reference_params


def _qkv(shape_q, shape_kv, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(dtype),
            rng.standard_normal(shape_kv).astype(dtype),
            rng.standard_normal(shape_kv).astype(dtype))


def _to_jax(xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


def _to_torch(xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


# -- the kernel wrappers (tests/test_kernels.py:15-53, mirrored) ----------

@pytest.mark.parametrize("S,hd,block", [
    (128, 64, 64), (256, 64, 128), (256, 128, 64), (512, 32, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_shapes_dtypes(S, hd, block, dtype):
    x = _qkv((2, S, 2, hd), (2, S, 2, hd), seed=S + hd)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    pallas = ref_flash(*_to_jax(x, jd), causal=True, block_q=block,
                       block_k=block)
    oracle =ref_attention_ref(*[a.astype(jnp.float32)
                                 for a in _to_jax(x, jd)], causal=True)
    got = flash_attention(*_to_torch(x, td), causal=True, block_q=block,
                          block_k=block)
    assert got.dtype == td and tuple(got.shape) == (2, S, 2, hd)
    got = got.to(torch.float32).numpy()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got, np.asarray(pallas.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [32, 64, 128])
def test_flash_attention_sliding_window(window):
    x = _qkv((1, 256, 2, 64), (1, 256, 2, 64), seed=window)
    pallas = ref_flash(*_to_jax(x), causal=True, window=window, block_q=64,
                       block_k=64)
    oracle = ref_attention_ref(*_to_jax(x), causal=True, window=window)
    got = flash_attention(*_to_torch(x), causal=True, window=window,
                          block_q=64, block_k=64).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=2e-5, rtol=2e-5)


def test_flash_attention_gqa_by_index():
    """H = 8 query heads on Kv = 2: the port reads head h // 4's K and V
    where the reference expands them with jnp.repeat."""
    q, k, v = _qkv((2, 128, 8, 32), (2, 128, 2, 32), seed=2)
    pallas = ref_flash(*_to_jax((q, k, v)), causal=True, block_q=64,
                       block_k=64)
    oracle = ref_attention_ref(jnp.asarray(q), jnp.repeat(k, 4, 2),
                               jnp.repeat(v, 4, 2), causal=True)
    got = flash_attention(*_to_torch((q, k, v)), causal=True, block_q=64,
                          block_k=64).numpy()
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_attention_ref_matches(causal, window):
    x = _qkv((2, 96, 2, 32), (2, 96, 2, 32), seed=5)
    ref = ref_attention_ref(*_to_jax(x), causal=causal, window=window)
    got = attention_ref(*_to_torch(x), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_flash_attention_bh_matches():
    x = _qkv((4, 128, 32), (4, 128, 32), seed=6)
    ref = ref_bh(*_to_jax(x), causal=True, block_q=64, block_k=64)
    got = flash_attention_bh(*_to_torch(x), causal=True, block_q=64,
                             block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


# -- _sdpa_blockwise and its gradients -------------------------------------

# (S, H, Kv, hd, block, causal, window): a key tail (100 = 3 x 32 + 4), a
# window, GQA, a block wider than S, no causal mask
BLOCKWISE = [(100, 4, 2, 32, 32, True, None), (64, 4, 4, 16, 16, True, 24),
             (100, 8, 2, 32, 32, True, 40), (40, 2, 1, 32, 64, True, None),
             (48, 4, 2, 16, 16, False, None)]


def _blockwise_case(S, H, Kv, hd, seed):
    q, k, v = _qkv((2, S, H, hd), (2, S, Kv, hd), seed)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    ct = np.random.default_rng(seed + 1).standard_normal(
        (2, S, H, hd)).astype(np.float32)
    return (q, k, v), pos, ct


def _ref_blockwise(block, causal, window, scale):
    def f(q, k, v, pos):
        return ref_attn._sdpa_blockwise(q, k, v, pos, pos, causal=causal,
                                        window=window, scale=scale,
                                        block=block)
    return f


@pytest.mark.parametrize("S,H,Kv,hd,block,causal,window", BLOCKWISE)
def test_sdpa_blockwise_matches_reference(S, H, Kv, hd, block, causal,
                                          window):
    x, pos, _ = _blockwise_case(S, H, Kv, hd, seed=S + H)
    scale = 1.0 / np.sqrt(hd)
    ref = jax.jit(_ref_blockwise(block, causal, window, scale))(
        *_to_jax(x), jnp.asarray(pos))
    p = torch.from_numpy(pos)
    got = attention._sdpa_blockwise(*_to_torch(x), p, p, causal=causal,
                                    window=window, scale=scale, block=block)
    assert tuple(got.shape) == (2, S, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("S,H,Kv,hd,block,causal,window", BLOCKWISE)
def test_sdpa_blockwise_grads_match_jax(S, H, Kv, hd, block, causal, window):
    x, pos, ct = _blockwise_case(S, H, Kv, hd, seed=S + H + 7)
    scale = 1.0 / np.sqrt(hd)
    f = _ref_blockwise(block, causal, window, scale)
    ref = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(f(q, k, v, jnp.asarray(pos)) * ct),
        argnums=(0, 1, 2)))(*_to_jax(x))
    leaves = [t.requires_grad_(True) for t in _to_torch(x)]
    p = torch.from_numpy(pos)
    out = attention._sdpa_blockwise(*leaves, p, p, causal=causal,
                                    window=window, scale=scale, block=block)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=2e-5, err_msg=f"d{name}")


def test_fwd_bwd_wrappers_on_cpu():
    """The forward wrapper's log-sum-exp is that of the materialised scores,
    and the backward wrapper's gradients are those of the dense attention
    (an oracle independent of the online loop); neither counts a launch on
    the CPU."""
    (q, k, v), pos, ct = _blockwise_case(100, 4, 2, 32, seed=11)
    q, k, v = _to_torch((q, k, v))
    p = torch.from_numpy(pos)
    scale = 1.0 / np.sqrt(32)
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v, p, p, causal=True, window=40,
                                   scale=scale)
    ke, ve = (torch.repeat_interleave(t, 2, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, ke) * scale
    i = torch.arange(100)
    ok = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 40)
    want = torch.logsumexp(s.masked_fill(~ok, -1e30), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
    dense = attention_ref(q, ke, ve, causal=True, window=40, scale=scale)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=2e-5,
                               rtol=2e-5)
    got = flash_attention_bwd(q, k, v, out, lse, torch.from_numpy(ct), p, p,
                              causal=True, window=40, scale=scale)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    dense = attention_ref(leaves[0],
                          *(torch.repeat_interleave(t, 2, dim=2)
                            for t in leaves[1:]),
                          causal=True, window=40, scale=scale)
    want = torch.autograd.grad(dense, leaves, torch.from_numpy(ct))
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                   rtol=2e-5, err_msg=f"d{name}")
    counts = launch_counts()
    assert counts["flash_attention_fwd"] == counts["flash_attention_bwd"] == 0


# -- gqa_forward, the model and a segment with attn_block ------------------

def _with_block(cfg, block, **attn):
    if attn:
        cfg = cfg.replace(attn=dataclasses.replace(cfg.attn, **attn))
    return cfg.replace(dist=dataclasses.replace(cfg.dist, attn_block=block))


@pytest.mark.parametrize("window", [None, 48])
def test_gqa_forward_blockwise_matches(window):
    """tests/test_kernels.py:85-104 in the port: the blockwise route (block
    32 over S = 96) against the reference's, and against the port's dense
    route; GQA with 4 query heads on 2 key/value heads."""
    ref_cfg = _with_block(ref_cpu_preset(ref_get_config("olmo-1b"), 4), 32,
                          num_heads=4, num_kv_heads=2)
    cfg = _with_block(train.build_cpu_preset(get_config("olmo-1b"), 4), 32,
                      num_heads=4, num_kv_heads=2)
    lspec_ref = dataclasses.replace(ref_cfg.layer_period[0], window=window)
    lspec = dataclasses.replace(cfg.layer_period[0], window=window)
    ref_p = ref_attn.init_gqa(jax.random.PRNGKey(0), ref_cfg)
    x = np.random.default_rng(1).standard_normal(
        (2, 96, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(96, dtype=np.int32), (2, 96)).copy()
    ref, _ = jax.jit(lambda p, xx, pp: ref_attn.gqa_forward(
        p, xx, cfg=ref_cfg, lspec=lspec_ref, positions=pp, mode="train"))(
            ref_p, jnp.asarray(x), jnp.asarray(pos))
    params = {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}
    got, _ = attention.gqa_forward(params, torch.from_numpy(x), cfg=cfg,
                                   lspec=lspec,
                                   positions=torch.from_numpy(pos))
    dense, _ = attention.gqa_forward(params, torch.from_numpy(x),
                                     cfg=_with_block(cfg, 0), lspec=lspec,
                                     positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("block", [8, 12])
def test_loss_and_grads_match_reference_blockwise(block):
    """The pattern of test_torch_model.py's loss-and-grads test with
    ``attn_block``: block 8 divides seq 32, block 12 leaves a key tail."""
    ref_cfg = _with_block(ref_cpu_preset(ref_get_config("olmo-1b"), 4), block)
    cfg = _with_block(train.build_cpu_preset(get_config("olmo-1b"), 4),
                      block)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(block)
    toks = rng.integers(0, cfg.vocab_size, size=(4, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": np.ones((4, 32), np.float32)}
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        ref_model.loss_fn, has_aux=True))(
            ref_params, jax.tree.map(jnp.asarray, batch), None)

    stacked = jax.tree.map(lambda a: np.asarray(a)[None], ref_params)
    _, panel, spec = from_reference_params(stacked, device="cpu")
    leaves, skel = tree_flatten(panel_mod.agent_params(panel, spec, 0))
    leaves = [a.detach().clone().requires_grad_(True) for a in leaves]
    loss, _ = build_model(cfg).loss_fn(
        tree_unflatten(skel, leaves),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    ref_leaves = jax.tree_util.tree_leaves(ref_grads)
    assert len(ref_leaves) == len(grads)
    for g, rg in zip(grads, ref_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=1e-5)


ROUNDS, M, H, B, SEQ, BLOCK = 4, 4, 2, 2, 64, 16


@pytest.fixture(scope="module")
def segments():
    """The reference's and the port's segment with attn_block 16 at seq 64,
    from one init (handed over), one batch stream and one W stream."""
    ref_cfg = _with_block(ref_cpu_preset(ref_get_config("olmo-1b"), M), BLOCK)
    cfg = _with_block(train.build_cpu_preset(get_config("olmo-1b"), M), BLOCK)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_opt = ref_make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                                 total_steps=ROUNDS * H)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=ROUNDS * H)
    ref_state, ref_spec = ref_dsgd.init_panel_state(
        ref_model.init_params, ref_opt, M, jax.random.PRNGKey(0),
        merger="uniform")
    stacked = jax.tree.map(np.asarray,
                           ref_panel.from_panel(ref_state["panel"], ref_spec))
    params, _, _ = from_reference_params(stacked, device="cpu")
    state, spec = dsgd.panel_state_from_params(params, opt)

    sched = make_schedule("final_merge", M, ROUNDS, prob=0.5, seed=0)
    lm = SyntheticLM(vocab=cfg.vocab_size, num_domains=8, seed=0)
    Ws = np.stack([sched.mixing_matrix(t)
                   for t in range(ROUNDS)]).astype(np.float32)
    batches = train.sample_segment_batches(
        lm, lm.domain_mixtures(M, 0.1, seed=1), ROUNDS, H, B, SEQ,
        np.random.default_rng(2))
    eval_b = {k: v[0] for k, v in make_agent_lm_batches(
        lm, [np.ones(lm.num_domains) / lm.num_domains], 2 * B, SEQ,
        np.random.default_rng(999)).items()}

    ref_seg = ref_dsgd.make_panel_segment(ref_model.loss_fn, ref_opt, H,
                                          ref_spec)
    ref_state, ref_mets = ref_seg(ref_state,
                                  jax.tree.map(jnp.asarray, batches),
                                  jnp.asarray(Ws), jax.random.PRNGKey(1))
    jb = jax.tree.map(jnp.asarray, eval_b)

    def ref_loss(p):
        return ref_model.loss_fn(p, jb, None)[0]

    ref_merged = float(jax.jit(lambda pan: ref_merge.counterfactual_eval_panel(
        ref_loss, pan, ref_spec))(ref_state["panel"]))
    ref_local = float(jax.jit(lambda pan: jnp.mean(jax.vmap(ref_loss)(
        ref_panel.from_panel(pan, ref_spec))))(ref_state["panel"]))

    state, mets = dsgd.make_panel_segment(model.loss_fn, opt, H, spec)(
        state, batches, Ws)
    tb = train.to_device(eval_b, "cpu")
    return {"Ws": Ws,
            "ref": ({k: np.asarray(v) for k, v in ref_mets.items()},
                    ref_merged, ref_local),
            "port": ({k: v.numpy() for k, v in mets.items()},
                     train.eval_merged(model.loss_fn, state["panel"], spec,
                                       tb),
                     train.eval_local(model.loss_fn, state["panel"], spec,
                                      tb))}


@pytest.mark.parametrize("metric", ["loss", "grad_norm", "consensus"])
def test_blockwise_segment_per_round_metrics_match(segments, metric):
    ref, port = segments["ref"][0][metric], segments["port"][0][metric]
    assert port.shape == (ROUNDS,)
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-6)


def test_blockwise_segment_evals_match_and_merge_collapses(segments):
    _, ref_merged, ref_local = segments["ref"]
    mets, merged, local = segments["port"]
    assert not all(np.array_equal(W, np.eye(M)) for W in segments["Ws"])
    assert np.all(segments["Ws"][-1] == np.float32(1.0 / M))
    np.testing.assert_allclose(merged, ref_merged, rtol=1e-4)
    np.testing.assert_allclose(local, ref_local, rtol=1e-4)
    assert mets["consensus"][-1] <= 1e-6
    assert abs(local - merged) <= 1e-6 * abs(merged)
