"""Flash attention on bfloat16 and float16 inputs (the plain versions the
16-bit kernels are held against on the card, ``kernels/ref.py``), against
the JAX package, on the CPU.

* ``flash_attention_bwd_ref`` in bfloat16 and float16 (autograd through the
  plain loop, every einsum rounded to the inputs' type, p cast to v's
  type) against the reference's jitted ``jax.vjp`` of ``_sdpa_blockwise``
  on the same 16-bit values, at head dims 32, 64, 128 and 256 with causal,
  windowed, non-causal and GQA / MQA cases: each gradient within a
  relative l2 of REL_TOL[dtype] (two frameworks rounding a 16-bit loop in
  other places: measured at most 3.3e-4 in bfloat16 and 1.5e-4 in
  float16, against distances of 2.9-5.2e-3 and 3.6-6.4e-4 of either from
  the float64 gradient of the same values);
* the gate of ``chip_smoke.py``'s phase 3 (FLASH16_FACTOR), emulated
  for two rounding models: a gradient computed in float32 and rounded
  once to the 16-bit type lies at most 0.6 of the plain 16-bit version's
  distance from the float32 yardstick (measured 0.31-0.57 on these
  inputs); the 16-bit kernels' rounding (P and dS rounded once to the
  16-bit type before their products, S and dP float32) at most
  FLASH16_FACTOR of it (0.46-0.80), for the output and each gradient;
* one bfloat16 training step with ``attn_block`` > 0 (reduced olmo-1b,
  blockwise attention through the plain loop) against the reference's
  functions jitted a step at a time, as ``tests/test_torch_param_dtype.py``
  holds the bfloat16 segment: the losses, the gradient panel's norm and
  the updated panel within SEG_RTOL (bfloat16 in two frameworks; measured
  1.8e-4, 1.7e-4 and 3.3e-3 relative l2: the update flips the bfloat16
  rounding of some parameters);
* the wrappers take float16 (the dtype check) and keep each 16-bit type's
  own launch count beside the total;
* ``bwd_parts`` sizes each library's hd-256 dK/dV grid by its own blocks.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)

JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
REL_TOL = {torch.bfloat16: 2e-3, torch.float16: 1e-3}
# (B, S, H, Kv, hd, window, causal, block)
CASES = [(2, 40, 4, 2, 32, None, True, 16), (1, 48, 4, 1, 64, 12, True, 16),
         (2, 33, 2, 2, 128, None, False, 8), (1, 40, 4, 1, 256, None, True, 16),
         (1, 50, 8, 2, 64, 20, True, 32)]


def _inputs(case, dtype, seed=0):
    B, S, H, Kv, hd = case[:5]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, n, hd)).astype(np.float32)
            for n in (H, Kv, Kv, H)]
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _ref_grads(q, k, v, do, window, causal, block):
    dt = JNP[q.dtype]
    B, S = q.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    scale = 1.0 / np.sqrt(q.shape[-1])
    args = [jnp.asarray(t.float().numpy()).astype(dt) for t in (q, k, v)]

    def f(q_, k_, v_):
        return ref_attn._sdpa_blockwise(q_, k_, v_, pos, pos, causal=causal,
                                        window=window, scale=scale,
                                        block=block)

    def grads(q_, k_, v_, d_):
        _, vjp = jax.vjp(f, q_, k_, v_)
        return vjp(d_)

    out = jax.jit(grads)(*args, jnp.asarray(do.float().numpy()).astype(dt))
    return [torch.from_numpy(np.array(g.astype(jnp.float32))) for g in out]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("case", CASES,
                         ids=[f"hd{c[4]}-S{c[1]}-H{c[2]}on{c[3]}-w{c[5]}-"
                              f"{'causal' if c[6] else 'full'}"
                              for c in CASES])
def test_16bit_backward_matches_reference(case, dtype):
    q, k, v, do = _inputs(case, dtype)
    window, causal, block = case[5:]
    S = q.shape[1]
    pos = torch.arange(S, dtype=torch.int32).expand(q.shape[0], S)
    got = flash_attention_bwd_ref(q, k, v, do, pos, pos, causal=causal,
                                  window=window, block=block)
    want = _ref_grads(q, k, v, do, window, causal, block)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel(g.float(), w) <= REL_TOL[dtype]


def _kernel_rounding(q, k, v, do, pos, causal, window):
    """(out, dq, dk, dv) as the 16-bit kernels round them
    (``csrc/flash_attention16.cu``): S = Q K^T and dP = dO V^T exact
    products of the 16-bit values summed in float32; P (float32, its row
    sums unrounded) rounded once to v's type before P V and dV = P^T dO;
    dS = P (dP - delta) rounded once to the inputs' type before dK and dQ;
    delta from the 16-bit output; each result rounded once. Dense (one
    tile), K and V expanded for GQA and their gradients summed over the
    group in float32."""
    dt = q.dtype
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale = 1.0 / np.sqrt(hd)
    qf, dof = q.float(), do.float()
    kf, vf = (t.float().repeat_interleave(G, 2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    qp, kp = pos[:, None, :, None], pos[:, None, None, :]
    vis = kp >= 0
    if causal:
        vis = vis & (kp <= qp)
    if window is not None:
        vis = vis & (kp > qp - window)
    s = torch.where(vis, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    lse = m + torch.log(p.sum(-1, keepdim=True))
    out = (torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), vf)
           / torch.exp(lse - m).permute(0, 2, 1, 3)).to(dt)
    p = torch.exp(s - lse)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), dof)
    dk, dv = (t.reshape(B, S, H // G, G, hd).sum(3) for t in (dk, dv))
    return tuple(t.to(dt) for t in (out, dq, dk, dv))




def _chip_smoke():
    """chip_smoke.py as a module (it runs nothing when imported)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# chip_smoke.py's phase 3 gate on the 16-bit kernels
FLASH16_FACTOR = _chip_smoke().FLASH16_FACTOR


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("case", CASES[:4],
                         ids=[f"hd{c[4]}" for c in CASES[:4]])
@pytest.mark.parametrize("model", ["rounded_once", "kernels"])
def test_rounded_once_beats_the_plain_version(model, case, dtype):
    """The card's gate, emulated, against the plain 16-bit version, both
    from the float32 yardstick (the plain version on the widened values):
    ``rounded_once``, the float32 gradient rounded once to the 16-bit type,
    within 0.6 of the plain version's distance; ``kernels``, the 16-bit
    kernels' rounding (``_kernel_rounding``: out, dq, dk, dv) within
    FLASH16_FACTOR (measured 0.46-0.80 here; the card 0.5-0.7)."""
    q, k, v, do = _inputs(case, dtype, seed=1)
    window, causal, block = case[5:]
    S = q.shape[1]
    pos = torch.arange(S, dtype=torch.int32).expand(q.shape[0], S)
    kw = dict(causal=causal, window=window, block=block)
    yard = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                   do.float(), pos, pos, **kw)
    plain = flash_attention_bwd_ref(q, k, v, do, pos, pos, **kw)
    if model == "rounded_once":
        for y, p in zip(yard, plain):
            once = y.to(dtype)
            assert _rel(once, y) <= 0.6 * _rel(p, y)
        return
    yard = (flash_attention_ref(q.float(), k.float(), v.float(), pos, pos,
                                **kw),) + tuple(yard)
    plain = (flash_attention_ref(q, k, v, pos, pos, **kw),) + tuple(plain)
    got = _kernel_rounding(q, k, v, do, pos, causal, window)
    for g, y, p in zip(got, yard, plain):
        assert g.dtype == dtype
        assert _rel(g, y) <= FLASH16_FACTOR * _rel(p, y)


def test_wrappers_take_float16_and_count_16bit_launches():
    q = torch.zeros((1, 4, 2, 16), dtype=torch.float16)
    fa._check(q, q[:, :, :1], q[:, :, :1])  # float16 is taken
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        fa._check(q.double(), q.double(), q.double())
    reset_launch_counts()
    counts = launch_counts()
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        assert counts[f"{name}_bf16"] == counts[f"{name}_f16"] == 0
    fn = fa.flash_attention_fwd
    fa._count(fn, torch.bfloat16)
    fa._count(fn, torch.float16)
    fa._count(fn, torch.float32)
    counts = launch_counts()
    assert (counts["flash_attention_fwd"], counts["flash_attention_fwd_bf16"],
            counts["flash_attention_fwd_f16"]) == (3, 1, 1)
    reset_launch_counts()
    assert set(launch_counts().values()) == {0}
    assert set(fa.LIBRARIES.values()) == {
        "flash_attention", "flash_attention_bf16", "flash_attention_f16"}


# ---------------------------------------------- one bfloat16 step, blockwise

M, H_STEPS, B, SEQ, BLOCK = 2, 1, 2, 24, 8
SEG_RTOL = 5e-3


def test_bf16_blockwise_training_step_matches_reference():
    from repro.configs import get_config as ref_get_config
    from repro.core import dsgd as ref_dsgd
    from repro.core import panel as ref_panel
    from repro.models import build_model as ref_build_model
    from repro.optim import make_optimizer as ref_make_optimizer
    from repro_torch.configs import get_config
    from repro_torch.core import dsgd
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.weights import from_reference_params

    def cfg_of(get):
        c = get("olmo-1b").reduced(d_model=64, vocab=64).replace(
            param_dtype="bfloat16")
        return c.replace(dist=dataclasses.replace(c.dist, attn_block=BLOCK))

    ref_cfg, cfg = cfg_of(ref_get_config), cfg_of(get_config)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_opt = ref_make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                                 total_steps=2)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4, total_steps=2)
    ref_state, ref_spec = ref_dsgd.init_panel_state(
        ref_model.init_params, ref_opt, M, jax.random.PRNGKey(0))
    assert ref_spec.groups[0][0] == "bfloat16"
    stacked = jax.tree.map(np.asarray,
                           ref_panel.from_panel(ref_state["panel"], ref_spec))
    params, _, _ = from_reference_params(stacked, device="cpu")
    state, spec = dsgd.panel_state_from_params(params, opt)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 64, (1, H_STEPS, M, B, SEQ + 1)).astype(np.int32)
    batches = {"tokens": toks[..., :-1], "targets": toks[..., 1:],
               "mask": np.ones(toks[..., 1:].shape, np.float32)}
    W = np.eye(M, dtype=np.float32)[None]

    def losses_grads(pan, batch):
        def one(p, b):
            return jax.value_and_grad(
                lambda x: ref_model.loss_fn(x, b, None)[0])(p)
        return jax.vmap(one)(ref_panel.from_panel(pan, ref_spec), batch)

    b0 = {k: jnp.asarray(v[0, 0]) for k, v in batches.items()}
    losses, grads = jax.jit(losses_grads)(ref_state["panel"], b0)
    gpan = ref_panel.to_panel(grads, ref_spec)
    new, _ = jax.jit(jax.vmap(ref_opt.update))(gpan, ref_state["opt"],
                                              ref_state["panel"])
    ref_pan = {k: np.array(v.astype(ref_state["panel"][k].dtype)
                             .astype(jnp.float32)) for k, v in new.items()}
    ref_norm = float(ref_panel.panel_norm(gpan, axis_mean=True))

    seg = dsgd.make_panel_segment(model.loss_fn, opt, H_STEPS, spec)
    state, mets = seg(state, batches, W)
    np.testing.assert_allclose(float(mets["loss"][0]),
                               float(jnp.mean(losses)), rtol=SEG_RTOL)
    np.testing.assert_allclose(float(mets["grad_norm"][0]), ref_norm,
                               rtol=SEG_RTOL)
    got = state["panel"]["bfloat16"]
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(ref_pan["bfloat16"])
    assert _rel(got.float(), want) <= SEG_RTOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("B,Sk,H,Kv", [(2, 2048, 8, 1), (2, 2048, 10, 1),
                                       (1, 300, 8, 1), (4, 4096, 16, 2)])
def test_bwd_parts_gives_its_grid_two_blocks_an_sm(dtype, B, Sk, H, Kv):
    """At hd 256 ``bwd_parts`` is the fewest divisor of the group that
    gives its library's dK/dV grid (float32: key-tile pairs; 16-bit: key
    tiles by two column blocks) two blocks an SM, else the whole group;
    1 up to hd 128."""
    G, tiles = H // Kv, -(-Sk // fa.TILE)
    per_part = B * Kv * (2 * tiles if dtype != torch.float32
                         else (tiles + 1) // 2)
    parts = fa.bwd_parts(B, Sk, H, Kv, 256, dtype)
    assert G % parts == 0
    assert per_part * parts >= 2 * fa.SMS or parts == G
    assert all(G % d or per_part * d < 2 * fa.SMS for d in range(1, parts))
    assert fa.bwd_parts(B, Sk, H, Kv, 128, dtype) == 1
    if (dtype, B, Sk, H, Kv) == (torch.bfloat16, 2, 2048, 8, 1):
        assert parts == 4  # gemma-2b's shape: 32 MiB of workspace, not 64
