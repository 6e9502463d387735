"""The port's int4 and bf16 wire pieces against the JAX package's.

Inputs are made with numpy from a seed and go through both packages:

* the plain versions of the int4 kernels (``kernels/ref.py``: grouped
  scales, quantize with both roundings, dequantize, nibble pack and unpack)
  against the reference's oracles called outside ``jax.jit`` and against its
  Pallas kernels in interpret mode, as ``tests/test_wire_props.py`` runs
  them: bitwise, at its cases (4, 64, group 32), (3, 333, 128),
  (5, 1000, 128) and at D = 1001, with an all-zero row (scale 1/7) and a
  row on exact half steps (ties to even), the reference's uniforms for
  stochastic rounding, and pack -> unpack as an exact inverse;
* the plain version of the mix on a bfloat16 theta against the reference's
  plain path (float32 product of the upcast payload) within 1e-6, and
  against the Pallas mix (which writes the payload dtype) within one bf16
  ulp;
* the byte accounting of the int4 and bf16 wires at olmo-1b's full width;
* the launcher with ``--wire int4_ef`` on the CPU.

Codec, engine and segment parity for these wires are in
``tests/test_torch_wire.py``; the CUDA kernels against the plain versions on
the card in ``tests/test_torch_cuda.py``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.core.topology import random_matching
from repro.kernels import ref as jref
from repro.kernels import wire_quant as jwq
from repro.kernels.gossip_mix import gossip_mix_panel
from repro.wire import codec as ref_codec
from repro_torch import wire
from repro_torch.configs import get_config
from repro_torch.core import panel
from repro_torch.kernels import ref as pref
from repro_torch.kernels import wire_quant as pwq
from repro_torch.kernels.gossip_mix import gossip_mix
from repro_torch.launch import train
from repro_torch.models import build_model

# (m, D, group): tests/test_wire_props.py's int4 cases and an odd width
CASES = [(4, 64, 32), (3, 333, 128), (5, 1000, 128), (8, 1001, 128)]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _inputs(m, D, group, seed=0):
    """x (m, D) with row 1 all zero (scale 1/7) and row 2 on half steps:
    each of its groups has amax 7/64, so its scale is exactly 1/64 and
    x / s = k + 1/2 exactly; the reference's uniforms."""
    rng = np.random.default_rng(seed + 1000 * m + D)
    x = rng.standard_normal((m, D)).astype(np.float32)
    x[1] = 0.0
    x[2] = ((rng.integers(-7, 7, size=D) + 0.5) / 64).astype(np.float32)
    x[2, ::group] = 7 / 64
    u = np.asarray(ref_codec._uniform(jax.random.PRNGKey(m + D), (m, D)))
    return x, u


@pytest.mark.parametrize("m,D,group", CASES)
def test_group_scale_matches_oracle(m, D, group):
    x, _ = _inputs(m, D, group)
    s = pref.int4_group_scale_ref(_t(x), group)
    assert s.shape == (m, -(-D // group)) and s.dtype == torch.float32
    _same_bits(s.numpy(), jref.int4_group_scale_ref(_j(x), group))
    assert torch.all(s[1] == np.float32(1.0) / np.float32(7.0))
    assert torch.all(s[2] == 1 / 64)
    # a partial tail group reduces over its real columns only
    tail = D % group
    if tail:
        want = np.abs(x[:, D - tail:]).max(axis=1)
        want = np.where(want > 0, want, 1.0).astype(np.float32) / \
            np.float32(7)
        _same_bits(s[:, -1].numpy(), want)
    _same_bits(pref.expand_group_scale(s, D, group).numpy(),
               jref.expand_group_scale(_j(s.numpy()), D, group))


@pytest.mark.parametrize("stochastic", [False, True], ids=["rtn", "sr"])
@pytest.mark.parametrize("m,D,group", CASES)
def test_int4_plain_versions_match_oracles_and_pallas(m, D, group,
                                                      stochastic):
    x, u = _inputs(m, D, group)
    s = pref.int4_group_scale_ref(_t(x), group)
    js = _j(s.numpy())
    uu = u if stochastic else None
    ju = None if uu is None else _j(uu)
    q = pwq.quantize_int4(_t(x), s, None if uu is None else _t(uu), group)
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 7
    _same_bits(q.numpy(), jref.quantize_int4_ref(_j(x), js, ju, group))
    pq, _ = jwq.quantize_int4_panel(_j(x), js, ju, group=group, block_d=256,
                                    interpret=True)
    _same_bits(q.numpy(), pq)
    assert np.all(q.numpy()[1] == 0)
    if not stochastic:  # every half step of row 2 went to the even side
        ties = np.ones(D, bool)
        ties[::group] = False
        assert np.all(q.numpy()[2][ties] % 2 == 0)
    p = pwq.pack_int4(q)
    assert p.dtype == torch.uint8 and p.shape == (m, (D + 1) // 2)
    _same_bits(p.numpy(), jref.pack_int4_ref(_j(q.numpy())))
    _same_bits(p.numpy(), jwq.pack_int4_panel(_j(q.numpy()), block_d=256,
                                              interpret=True))
    back = pwq.unpack_int4(p, D)
    _same_bits(back.numpy(), jref.unpack_int4_ref(_j(p.numpy()), D))
    _same_bits(back.numpy(), jwq.unpack_int4_panel(_j(p.numpy()), D,
                                                   block_d=256,
                                                   interpret=True))
    assert torch.equal(back, q)
    y = pwq.dequantize_int4(back, s, group)
    _same_bits(y.numpy(), jref.dequantize_int4_ref(_j(q.numpy()), js, group))
    _same_bits(y.numpy(), jwq.dequantize_int4_panel(
        _j(q.numpy()), js, group=group, block_d=256, interpret=True))


@pytest.mark.parametrize("D", [1, 2, 7, 47, 64])
def test_pack_unpack_every_nibble_and_odd_tails(D):
    """Every value in [-8, 7] survives pack -> unpack; an odd tail packs
    against a zero high nibble, per row (never paired with the next row's
    first column)."""
    q = torch.arange(-8, 8, dtype=torch.int8).repeat(3, D // 16 + 1)[:, :D]
    q = (q + torch.tensor([[0], [3], [-5]], dtype=torch.int8)
         ).clamp(-8, 7).contiguous()
    p = pref.pack_int4_ref(q)
    _same_bits(p.numpy(), jref.pack_int4_ref(_j(q.numpy())))
    assert torch.equal(pref.unpack_int4_ref(p, D), q)
    if D % 2:
        assert torch.all(p[:, -1] >> 4 == 0)
        assert torch.equal(p[:, -1] & 0xF, q[:, -1].view(torch.uint8) & 0xF)


def test_int4_wrappers_reject_other_devices():
    x = torch.zeros((2, 4), device="meta")
    s = torch.ones((2, 1), device="meta")
    q = x.to(torch.int8)
    for fn, args in ((pwq.quantize_int4, (x, s)),
                     (pwq.dequantize_int4, (q, s)),
                     (pwq.pack_int4, (q,)),
                     (pwq.unpack_int4, (q.to(torch.uint8)[:, :2], 4))):
        with pytest.raises(ValueError):
            fn(*args)


@pytest.mark.parametrize("m,D", [(4, 64), (8, 333), (8, 1001)])
def test_bf16_mix_matches_reference(m, D):
    """The plain mix on a bfloat16 theta: float32 rows, the folded mean row
    included, against the reference's plain path (W @ theta.astype(f32))
    within 1e-6 (another summation order) and against the Pallas kernel,
    which writes bf16, within one bf16 ulp."""
    rng = np.random.default_rng(m * 11 + D)
    W = random_matching(m, 0.7, rng).astype(np.float32)
    W = np.concatenate([W, np.full((1, m), 1.0 / m, np.float32)])
    theta = jnp.asarray(rng.standard_normal((m, D)), jnp.bfloat16)
    t16 = torch.from_numpy(np.asarray(theta).view(np.int16).copy()).view(
        torch.bfloat16)
    got = gossip_mix(torch.from_numpy(W), t16)
    assert got.dtype == torch.float32 and got.shape == (m + 1, D)
    plain = np.asarray(jnp.asarray(W) @ theta.astype(jnp.float32))
    np.testing.assert_allclose(got.numpy(), plain, atol=1e-6, rtol=1e-6)
    pallas = np.asarray(gossip_mix_panel(jnp.asarray(W), theta, block_d=128,
                                         interpret=True)).astype(np.float32)
    rounded = got.to(torch.bfloat16).float().numpy()
    _, e = np.frexp(np.abs(pallas))
    assert np.all(np.abs(rounded - pallas) <= np.ldexp(np.float32(1), e - 8))
    # equal weights give bit-identical rows, the mean row among them
    full = torch.full((m + 1, m), 1.0 / m)
    out = gossip_mix(full, t16)
    assert torch.equal(out, out[:1].expand_as(out))


def test_wire_bytes_at_full_width():
    """The byte accounting at olmo-1b's full width cut to 2 layers: D =
    237,502,464 parameters, 1,855,488 scale groups of 128."""
    cfg = get_config("olmo-1b").replace(num_layers=2)
    spec = panel.make_spec(build_model(cfg).init_params(None, "meta"),
                           rows=8)
    assert spec.width == 237502464
    want = {"f32": (950009856, 950009856), "bf16": (475004928, 475004928),
            "int4": (118751232, 126173184), "int4_ef": (118751232,
                                                        126173184)}
    for name, (payload, total) in want.items():
        s = panel.with_wire(spec, name)
        assert (s.wire_payload_bytes, s.wire_total_bytes) == (payload, total)
        ref = ref_codec.CODECS[name]
        assert ref.payload_bytes(1, spec.width, jnp.float32) == payload
        assert ref.total_bytes(1, spec.width, jnp.float32) == total
    assert wire.CODECS["int4"].n_groups(spec.width) == 1855488


def test_dtype_codec_matches_reference():
    assert wire.dtype_codec(None) is wire.CODECS["f32"]
    assert wire.dtype_codec(torch.bfloat16) is wire.CODECS["bf16"]
    assert wire.dtype_codec("bfloat16") is wire.CODECS["bf16"]
    f16 = wire.dtype_codec(torch.float16)
    ref = ref_codec.dtype_codec(jnp.float16)
    assert f16.name == ref.name == "float16"
    assert f16.payload_bytes(3, 10, torch.float32) == \
        ref.payload_bytes(3, 10, jnp.float32) == 60
    x = np.random.default_rng(0).standard_normal((3, 10)).astype(np.float32)
    view, back, err = f16.encode(_t(x))
    r_view, r_back, _ = ref.encode(_j(x))
    _same_bits(view.numpy(), r_view)
    _same_bits(back(view).numpy(), r_back(r_view))
    assert err is None and back(view).dtype == torch.float32


def test_launcher_wire_int4_ef_on_cpu(tmp_path, capsys):
    """The launcher's --wire int4_ef at the verify size: the payload line
    (half a byte per parameter, + 4 bytes per 128-column group), Xi 0 and
    merged == local eval after the final merge, a finite loss."""
    rounds, m = 6, 4
    hist = train.main(["--rounds", str(rounds), "--segment", "3",
                       "--agents", str(m), "--local-steps", "2", "--batch",
                       "4", "--seq", "32", "--wire", "int4_ef", "--device",
                       "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    cfg = train.build_cpu_preset(get_config("olmo-1b"), m)
    D = panel.make_spec(build_model(cfg).init_params(None, "meta"),
                        rows=m).width
    payload, total = (D + 1) // 2, (D + 1) // 2 + 4 * -(-D // 128)
    assert (f"wire codec int4_ef: {payload} B/agent payload ({total} B "
            "with scales/indices) per full-panel exchange") in out
    saved = json.loads((tmp_path / "olmo-1b_final_merge_a0.1.json")
                       .read_text())
    assert saved["history"] == hist and len(hist) == rounds
    assert saved["args"]["wire"] == "int4_ef"
    assert hist[-1]["consensus"] == 0.0
    assert abs(hist[-1]["local_eval"] - hist[-1]["merged_eval"]) <= \
        1e-6 * abs(hist[-1]["merged_eval"])
    assert all(np.isfinite(h["train_loss"]) for h in hist)
