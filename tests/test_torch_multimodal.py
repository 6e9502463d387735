"""The pieces of the last two families on the port against the JAX
package's: M-RoPE (``models/layers.py:apply_mrope``, qwen2-vl), cross
attention (``models/attention.py:cross_kv``/``cross_forward``) and the
non-causal encoder (seamless-m4t; read through the cross keys and values
its output gives each decoder block in ``prefill``'s caches), and
qwen2-vl trained on tokens alone (its launcher's batches: no patch prefix,
``positions3`` broadcast from the 1-D positions); and chip_smoke's
``float64_model`` on the dense attention route, which holds the qwen2-vl
width cell's decode on the card. Inputs are drawn with numpy from a seed;
parameters are the reference's init handed over.

Tolerances: M-RoPE at atol 1e-5 + rtol 1e-5, ``apply_rope``'s
(``tests/test_torch_model.py``): the angles reach 40 rad, where a float32
ulp is 3.8e-6, and torch's and XLA's pow, cos and sin round differently
(measured 1.73e-6 at hd 128); cross attention and the encoder's output
(LayerNorm'd, O(1)) at atol 2e-5 + rtol 1e-5 (float32 products and
softmax sums in another order); the loss at rtol 1e-5, gradients at atol
2e-5 + rtol 1e-5."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tfm
from repro_torch.configs import get_config
from repro_torch.core import panel as panel_mod
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_mrope, apply_norm, apply_rope
from repro_torch.utils.tree import tree_flatten, tree_unflatten
from repro_torch.weights import from_reference_params

ATOL, RTOL = 2e-5, 1e-5


def _handover(ref_params):
    stacked = jax.tree.map(lambda x: np.asarray(x)[None], ref_params)
    _, panel, spec = from_reference_params(stacked, device="cpu")
    return panel_mod.agent_params(panel, spec, 0)


def _seamless(attn_block=0):
    """(ref cfg, cfg, ref params, params) of seamless-m4t-medium's
    reduced() (2 encoder and 2 decoder layers, 4 heads on 2 x 32)."""
    ref_cfg = ref_get_config("seamless-m4t-medium").reduced()
    cfg = get_config("seamless-m4t-medium").reduced()
    ref_cfg = ref_cfg.replace(dist=dataclasses.replace(
        ref_cfg.dist, attn_block=attn_block))
    cfg = cfg.replace(dist=dataclasses.replace(cfg.dist,
                                               attn_block=attn_block))
    ref_params = ref_build_model(ref_cfg).init_params(jax.random.PRNGKey(4))
    return ref_cfg, cfg, ref_params, _handover(ref_params)


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128),
                                         ((8, 4, 4), 32)])
def test_apply_mrope_matches_reference(sections, hd):
    """Three DIFFERENT t / h / w position rows (with broadcast positions
    M-RoPE is plain RoPE, where a mixed-up section would not show), at
    qwen2-vl-72b's sections and head dim and at its reduced()'s."""
    rng = np.random.default_rng(0)
    B, S, H = 2, 12, 3
    x = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    pos3 = np.stack([np.broadcast_to(np.arange(S), (B, S)),
                     rng.integers(0, 40, (B, S)),
                     rng.integers(0, 40, (B, S))]).astype(np.int32)
    ref = jax.jit(lambda x, p: ref_layers.apply_mrope(
        x, p, sections, 1e6))(jnp.asarray(x), jnp.asarray(pos3))
    out = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), sections,
                      1e6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    # the h and w sections rotate by their own rows: not plain RoPE of t
    rope = apply_rope(torch.from_numpy(x), torch.from_numpy(pos3[0]), 1e6)
    assert float(torch.max(torch.abs(out - rope))) > 1e-2
    # broadcast rows: plain RoPE
    same = apply_mrope(torch.from_numpy(x), torch.from_numpy(
        np.broadcast_to(pos3[:1], pos3.shape).copy()), sections, 1e6)
    np.testing.assert_array_equal(same.numpy(), rope.numpy())


def test_cross_attention_matches_reference():
    """cross_kv of an encoder output (2 rows of 10), and cross_forward
    from 7 decoder states over it and over the same keys padded to 16 slots
    with pos -1 (the engine's capacity; the padding filled with values that
    would change the output were they attended)."""
    ref_cfg, cfg, ref_params, params = _seamless()
    ref_p = jax.tree.map(lambda x: x[0],
                         ref_params["decoder"]["main"]["p0"]["cross"])
    p = tfm._index(params["decoder"]["main"]["p0"]["cross"], 0)
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((2, 10, cfg.d_model), dtype=np.float32)
    x = rng.standard_normal((2, 7, cfg.d_model), dtype=np.float32)
    ref_kv = jax.jit(lambda p, e: ref_attn.cross_kv(p, e, cfg=ref_cfg))(
        ref_p, jnp.asarray(enc))
    kv = attn.cross_kv(p, torch.from_numpy(enc), cfg=cfg)
    assert sorted(kv) == sorted(ref_kv) == ["k", "pos", "v"]
    for k in ("k", "v"):
        np.testing.assert_allclose(kv[k].numpy(), np.asarray(ref_kv[k]),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(kv["pos"].numpy(), np.asarray(
        ref_kv["pos"]))
    assert kv["pos"].dtype == torch.int32

    junk = rng.standard_normal((2, 6) + tuple(kv["k"].shape[2:]),
                               dtype=np.float32) * 10
    padded = {"k": np.concatenate([np.asarray(ref_kv["k"]), junk], 1),
              "v": np.concatenate([np.asarray(ref_kv["v"]), -junk], 1),
              "pos": np.concatenate([np.asarray(ref_kv["pos"]),
                                     np.full((2, 6), -1, np.int32)], 1)}
    fwd = jax.jit(lambda p, x, kv: ref_attn.cross_forward(p, x, kv,
                                                          cfg=ref_cfg))
    for kv_np in (jax.tree.map(np.asarray, ref_kv), padded):
        ref_y = fwd(ref_p, jnp.asarray(x), jax.tree.map(jnp.asarray, kv_np))
        y = attn.cross_forward(p, torch.from_numpy(x), {
            k: torch.from_numpy(np.array(v)) for k, v in kv_np.items()},
            cfg=cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=ATOL,
                                   rtol=RTOL)
    y10 = attn.cross_forward(p, torch.from_numpy(x), {
        k: torch.from_numpy(np.array(v)) for k, v in ref_kv.items()},
        cfg=cfg)
    y16 = attn.cross_forward(p, torch.from_numpy(x), {
        k: torch.from_numpy(v) for k, v in padded.items()}, cfg=cfg)
    np.testing.assert_allclose(y16.numpy(), y10.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("attn_block", [0, 8])
def test_encoder_cross_cache_matches_reference(attn_block):
    """The encoder (non-causal, then enc_norm) on 2 rows of 20 frames, on
    the dense route and on the attn_block route (the reference's
    ``_sdpa_blockwise``; the port's plain twin ``flash_attention_ref`` on
    the CPU, the flash kernels on the card), read through ``prefill``: every
    decoder block's cross keys and values (its projection of the encoder's
    output) and the logits against the reference's prefill. A causal run of
    the same encoder stack gives other cross keys (the encoder's rows see
    their future)."""
    ref_cfg, cfg, ref_params, params = _seamless(attn_block)
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((2, 20, cfg.d_model), dtype=np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    r_logits, r_caches = jax.jit(lambda p, t, f: ref_build_model(
        ref_cfg).prefill(p, {"tokens": t, "frame_embeds": f}))(
            ref_params, jnp.asarray(toks), jnp.asarray(frames))
    model = build_model(cfg)
    with torch.no_grad():
        logits, caches = model.prefill(params, {
            "tokens": torch.from_numpy(toks),
            "frame_embeds": torch.from_numpy(frames)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               atol=ATOL, rtol=RTOL)
    cross, r_cross = caches["main"]["p0"]["cross"], \
        r_caches["main"]["p0"]["cross"]
    assert tuple(cross["k"].shape[:3]) == (cfg.num_layers, 2, 20)
    for k in ("k", "v"):
        np.testing.assert_allclose(cross[k].numpy(), np.asarray(r_cross[k]),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(cross["pos"].numpy(),
                                  np.asarray(r_cross["pos"]))
    enc_cfg = cfg.replace(num_layers=cfg.encoder_layers, dense_ff_first_k=0)
    pos = torch.broadcast_to(torch.arange(20, dtype=torch.int32), (2, 20))
    with torch.no_grad():
        h, _, _ = tfm.apply_stack(params["encoder"], torch.from_numpy(frames),
                                  cfg=enc_cfg, positions=pos)
        causal = attn.cross_kv(
            tfm._index(params["decoder"]["main"]["p0"]["cross"], 0),
            apply_norm(params["enc_norm"], h, cfg.norm), cfg=cfg)
    assert float(torch.max(torch.abs(causal["k"] - cross["k"][0]))) > 1e-2


def test_vlm_trains_on_tokens_alone():
    """qwen2-vl's loss and gradients on a batch without patch_embeds (the
    launchers' batches: positions3 broadcast from the 1-D positions)
    against the reference's, and the loss of a batch with a prefix of
    other numbers than without (the prefix is read)."""
    ref_cfg = ref_get_config("qwen2-vl-72b").reduced()
    cfg = get_config("qwen2-vl-72b").reduced()
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_params = ref_model.init_params(jax.random.PRNGKey(5))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": np.ones((2, 32), np.float32)}
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        ref_model.loss_fn, has_aux=True))(
            ref_params, jax.tree.map(jnp.asarray, batch), None)
    leaves, skel = tree_flatten(_handover(ref_params))
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = model.loss_fn(tree_unflatten(skel, leaves), tb)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    for g, rg in zip(grads, jax.tree_util.tree_leaves(ref_grads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=ATOL,
                                   rtol=RTOL)
    tb["patch_embeds"] = torch.from_numpy(rng.standard_normal(
        (2, cfg.mm_prefix, cfg.d_model), dtype=np.float32))
    with torch.no_grad():
        prefixed, _ = model.loss_fn(tree_unflatten(skel, leaves), tb)
    assert abs(float(prefixed) - float(loss.detach())) > 1e-4


def _chip_smoke():
    """chip_smoke.py as a module (it runs nothing when imported)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_float64_model_on_the_dense_attention_route(monkeypatch, capsys):
    """chip_smoke's ``float64_model`` on an attention stack, which holds the
    qwen2-vl width cell's decode: a qwen2-vl (reduced) model with float64
    parameters computes its prefill and decode logits in float64 (the
    attention module's scores and mask too), they agree with the float32
    model's to float32 rounding, its decode steps with a patch prefix agree
    with their prefills within REC64_ATOL + REC64_RTOL (decode_check),
    and a config on the flash route (attn_block > 0) is refused."""
    from repro_torch.models import attention as attention_mod
    from repro_torch.utils.tree import tree_map
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "card_line", lambda: "cpu")
    monkeypatch.setattr(cs, "MLA_PROMPT", 16)
    monkeypatch.setattr(cs, "MLA_STEPS", 3)
    cfg = get_config("qwen2-vl-72b").reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    p64 = tree_map(lambda t: t.double(), params)
    pe = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, cfg.mm_prefix, cfg.d_model)))
    with torch.no_grad():
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 20)).astype(np.int32))
        l32, _ = model.prefill(params, {"tokens": toks,
                                        "patch_embeds": pe.float()})
        with cs.float64_model(torch, cfg):
            l64, _ = model.prefill(p64, {"tokens": toks, "patch_embeds": pe})
            steps = cs.decode_steps(torch, model, p64, {"patch_embeds": pe})
    assert attention_mod.torch is torch
    assert l32.dtype == torch.float32 and l64.dtype == torch.float64
    np.testing.assert_allclose(l32.numpy(), l64.numpy(), atol=ATOL,
                               rtol=RTOL)
    assert all(t.dtype == torch.float64 for st in steps for t in st)
    cs.decode_check(torch, "qwen2-vl", steps, atol=cs.REC64_ATOL,
                    rtol=cs.REC64_RTOL, what="float64 decode")
    flash = cfg.replace(dist=dataclasses.replace(cfg.dist, attn_block=8))
    with pytest.raises(ValueError, match="dense route"):
        with cs.float64_model(torch, flash):
            pass
