"""The port's recurrent mixers (``repro_torch.models.recurrent``: RG-LRU,
mLSTM, sLSTM) against the JAX package's (``repro.models.recurrent``,
jitted), each at its arch's ``reduced()`` size (d_model 256; RG-LRU width
256, conv 4; m/sLSTM 2 heads, mLSTM chunk 16) from the reference's init,
handed over leaf by leaf:

- the forward in train, prefill and decode modes (y and the new state),
  at sequence lengths that are and are not powers of two (the RG-LRU
  scan's odd levels) and, for the mLSTM, not multiples of the chunk (the
  trailing partial chunk);
- the gradients of every parameter and of the input;
- the mLSTM's chunkwise form against ``tests/test_models.py:_naive_mlstm``
  (the step-by-step recurrence in float64), through ``_mlstm_chunk`` and
  through ``mlstm_forward``'s chunk loop;
- decode continuing prefill: the whole sequence in train mode against a
  prefill of its prefix and one decode step, and against decode from the
  empty state one token at a time, as ``tests/test_models.py`` holds the
  reference;
- the empty states against the reference's, and the scan against
  ``jax.lax.associative_scan``;
- ``model.decode_step`` writing the states through the stacked cache's
  views;
- a closed forget gate: the reference's mLSTM gradients turn NaN (its
  decay is masked after the exp), the port's stay finite and agree with
  float64 (masked before it; equal wherever the reference's are finite).

Tolerances: outputs and states at atol 2e-5 + rtol 1e-5 (the logits
tolerance of ``tests/test_torch_archs.py``: float32 products summed in
other orders); gradients at its gradient atol 1e-5 on each leaf divided by
max(1, its largest |entry|): the gradients of sum(y * w) here reach ~100,
not a loss's ~1e-2, and float32 sums in other orders miss by ~1e-6 of
that scale (measured up to 1.25e-6); the naive
recurrence and decode-vs-scan at the reference tests' atol 1e-4 + rtol
1e-3."""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.models import recurrent as ref_rec
from repro_torch.configs import get_config
from repro_torch.models import recurrent as rec
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten
from test_models import _naive_mlstm

ATOL, RTOL = 2e-5, 1e-5
GRAD_ATOL = 1e-5
ARCH = {"rglru": "recurrentgemma-2b", "mlstm": "xlstm-1.3b",
        "slstm": "xlstm-1.3b"}
B = 2


def _mixer(kind):
    """(ref cfg, port cfg, ref params, port params, ref fwd, port fwd)."""
    ref_cfg = ref_get_config(ARCH[kind]).reduced()
    cfg = get_config(ARCH[kind]).reduced()
    ref_p = getattr(ref_rec, f"init_{kind}")(jax.random.PRNGKey(0), ref_cfg)
    p = tree_map(lambda a: torch.from_numpy(np.array(a)),
                 jax.tree.map(np.asarray, ref_p))
    return (ref_cfg, cfg, ref_p, p, getattr(ref_rec, f"{kind}_forward"),
            getattr(rec, f"{kind}_forward"))


def _x(S, seed, d=256):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


def _ref_call(fwd, cfg, mode):
    return jax.jit(functools.partial(fwd, cfg=cfg, mode=mode))


def _close(a, b, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=atol,
                               rtol=rtol, err_msg=what)


def _states_close(st, ref_st):
    assert sorted(st) == sorted(ref_st)
    for k in st:
        assert tuple(st[k].shape) == ref_st[k].shape, k
        _close(st[k], ref_st[k], what=k)


SEQS = {"rglru": [1, 7, 16, 33], "mlstm": [16, 40, 9], "slstm": [12]}


@pytest.mark.parametrize("kind,S", [(k, s) for k in SEQS for s in SEQS[k]])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_matches_reference(kind, S, mode):
    ref_cfg, cfg, ref_p, p, ref_fwd, fwd = _mixer(kind)
    x = _x(S, 1)
    ref_y, ref_st = _ref_call(ref_fwd, ref_cfg, mode)(ref_p, jnp.asarray(x))
    y, st = fwd(p, torch.from_numpy(x), cfg=cfg, mode=mode)
    assert tuple(y.shape) == ref_y.shape
    _close(y, ref_y, what="y")
    if mode == "train":
        assert st is None and ref_st is None
    else:
        _states_close(st, ref_st)


@pytest.mark.parametrize("kind", sorted(SEQS))
def test_decode_step_matches_reference(kind):
    """A prefill of 20 tokens (the reference's state handed over) and 4
    decode steps of one token, each step's y and state."""
    ref_cfg, cfg, ref_p, p, ref_fwd, fwd = _mixer(kind)
    x = _x(24, 2)
    _, ref_st = _ref_call(ref_fwd, ref_cfg, "prefill")(ref_p,
                                                       jnp.asarray(x[:, :20]))
    st = {k: torch.from_numpy(np.array(v)) for k, v in ref_st.items()}
    dec = jax.jit(functools.partial(ref_fwd, cfg=ref_cfg, mode="decode"))
    for t in range(20, 24):
        ref_y, ref_st = dec(ref_p, jnp.asarray(x[:, t:t + 1]), state=ref_st)
        y, st = fwd(p, torch.from_numpy(x[:, t:t + 1]), cfg=cfg,
                    mode="decode", state=st)
        _close(y, ref_y, what=f"y at {t}")
        _states_close(st, ref_st)


@pytest.mark.parametrize("kind,S", [("rglru", 33), ("mlstm", 40),
                                    ("slstm", 12)])
def test_grads_match_reference(kind, S):
    """d/d(params, x) of sum(y * w) for a fixed random w."""
    ref_cfg, cfg, ref_p, p, ref_fwd, fwd = _mixer(kind)
    x = _x(S, 3)
    w = _x(S, 4)

    def ref_loss(params, xx):
        return jnp.sum(ref_fwd(params, xx, cfg=ref_cfg, mode="train")[0] * w)

    ref_gp, ref_gx = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        ref_p, jnp.asarray(x))
    leaves, skel = tree_flatten(p)
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = fwd(tree_unflatten(skel, leaves), xt, cfg=cfg, mode="train")
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(w)),
                                leaves + [xt])
    ref_leaves = jax.tree_util.tree_leaves(ref_gp) + [ref_gx]
    assert len(grads) == len(ref_leaves)
    for g, rg in zip(grads, ref_leaves):
        assert tuple(g.shape) == rg.shape
        assert bool(torch.all(torch.isfinite(g)))
        rg = np.asarray(rg)
        scale = max(1.0, float(np.max(np.abs(rg))))
        np.testing.assert_allclose(g.numpy() / scale, rg / scale,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 16), (48, 16)])
def test_mlstm_chunkwise_matches_naive(S, chunk):
    """``_mlstm_chunk`` chunk after chunk against the float64 recurrence
    (``tests/test_models.py``'s inputs, drawn with numpy)."""
    Bq, H, dh = 2, 2, 8
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(Bq, H, S, dh)).astype(np.float32)
               for _ in range(3))
    logi = rng.normal(size=(Bq, H, S)).astype(np.float32)
    logf = np.asarray(jax.nn.log_sigmoid(
        rng.normal(size=(Bq, H, S)).astype(np.float32) + 2.0))
    state = (torch.zeros((Bq, H, dh, dh)), torch.zeros((Bq, H, dh)),
             torch.full((Bq, H), -1e30))
    outs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        h, state = rec._mlstm_chunk(
            *(torch.from_numpy(np.ascontiguousarray(t[:, :, sl]))
              for t in (q, k, v, logf, logi)), state)
        outs.append(h)
    got = torch.cat(outs, dim=2).numpy()
    np.testing.assert_allclose(got, _naive_mlstm(q, k, v, logf, logi),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("S", [40, 9])
def test_mlstm_forward_matches_naive(S):
    """``mlstm_forward``'s chunk loop (S = 40: two chunks of 16 and a
    trailing 8; S = 9: one partial chunk) against the recurrence on its
    own projections, before the group norm: the per-head normalised h
    agrees with the recurrence's h normalised the same way."""
    _, cfg, _, p, _, _ = _mixer("mlstm")
    H = cfg.recurrent.num_heads
    x = torch.from_numpy(_x(S, 5))
    dh = cfg.d_model // H
    q = rec._headify(x @ p["wq"], H) * (1.0 / np.sqrt(dh))
    k = rec._headify(x @ p["wk"], H) * (1.0 / np.sqrt(dh))
    v = rec._headify(x @ p["wv"], H)
    gates = x @ p["w_if"] + p["b_if"]
    logi = gates[..., :H].transpose(1, 2)
    logf = torch.nn.functional.logsigmoid(gates[..., H:]).transpose(1, 2)
    want = _naive_mlstm(q.numpy(), k.numpy(), v.numpy(), logf.numpy(),
                        logi.numpy()).transpose(0, 2, 1, 3)
    mu = want.mean(-1, keepdims=True)
    var = ((want - mu) ** 2).mean(-1, keepdims=True)
    want = ((want - mu) / np.sqrt(var + 1e-6)).reshape(B, S, -1)
    want = want * p["gn_scale"].numpy()
    og = torch.sigmoid(x @ p["w_og"])
    want = (og * torch.from_numpy(want.astype(np.float32))) @ p["w_out"]
    y, _ = rec.mlstm_forward(p, x, cfg=cfg, mode="train")
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("kind", sorted(SEQS))
def test_decode_continues_prefill(kind):
    """The whole sequence in train mode against a prefill of all but its
    last token and one decode step (the port alone)."""
    _, cfg, _, p, _, fwd = _mixer(kind)
    x = torch.from_numpy(_x(32, 6))
    full, _ = fwd(p, x, cfg=cfg, mode="train")
    _, st = fwd(p, x[:, :-1], cfg=cfg, mode="prefill")
    y, _ = fwd(p, x[:, -1:], cfg=cfg, mode="decode", state=st)
    np.testing.assert_allclose(y[:, 0].numpy(), full[:, -1].numpy(),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("kind", ["rglru", "slstm", "mlstm"])
def test_decode_from_empty_state_matches_scan(kind):
    """Decode one token at a time from ``init_<kind>_state`` against the
    whole sequence's train-mode forward (``tests/test_models.py``'s
    check of the reference)."""
    _, cfg, _, p, _, fwd = _mixer(kind)
    S = 16
    x = torch.from_numpy(_x(S, 7))
    full, _ = fwd(p, x, cfg=cfg, mode="train")
    init = getattr(rec, f"init_{kind}_state")
    st = init(cfg, B, device="cpu")
    outs = []
    for t in range(S):
        y, st = fwd(p, x[:, t:t + 1], cfg=cfg, mode="decode", state=st)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("kind", sorted(SEQS))
def test_state_init_matches_reference(kind):
    ref_cfg, cfg = (ref_get_config(ARCH[kind]).reduced(),
                    get_config(ARCH[kind]).reduced())
    ref_init = getattr(ref_rec, f"init_{kind}_state")
    ref_st = ref_init(ref_cfg, 3)
    st = getattr(rec, f"init_{kind}_state")(cfg, 3, device="cpu")
    assert sorted(st) == sorted(ref_st)
    for k in st:
        assert tuple(st[k].shape) == ref_st[k].shape
        assert str(st[k].dtype).replace("torch.", "") == str(
            ref_st[k].dtype)
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(ref_st[k]))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 64])
def test_associative_scan_matches_jax(n):
    """``_associative_scan`` against ``jax.lax.associative_scan`` with the
    reference's combine on the same float32 inputs: the running products
    bit for bit (the same products in the same order), h within 1e-6 (the
    compiled reference may fuse a2 b1 + b2 into one multiply-add); and
    against the sequential recurrence at 1e-5."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, size=(n, 3, 5)).astype(np.float32)
    b = rng.normal(size=(n, 3, 5)).astype(np.float32)

    def comb(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    ref_a, ref_h = jax.jit(lambda a, b: jax.lax.associative_scan(
        comb, (a, b)))(a, b)
    got_a, got_h = rec._associative_scan(torch.from_numpy(a),
                                         torch.from_numpy(b), 0)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(ref_a))
    h, seq = np.zeros((3, 5), np.float32), []
    for t in range(n):
        h = a[t] * h + b[t]
        seq.append(h)
    np.testing.assert_allclose(got_h.numpy(), np.stack(seq), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-1.3b"])
def test_model_decode_writes_the_stacked_state(arch):
    """``model.decode_step`` writes every layer's recurrent state through
    the views of the stacked cache (each leaf keeps its storage; the
    serving engine's slots advance only so): after a prefill of 20 tokens
    and 3 decode steps the states equal a prefill of the 23 tokens' at
    the reference tests' atol 1e-4 + rtol 1e-3."""
    import dataclasses

    from repro_torch.models import build_model
    cfg = get_config(arch).reduced(layers=3)
    if arch == "xlstm-1.3b":
        m = cfg.layer_period[0]
        cfg = cfg.replace(layer_period=(m, dataclasses.replace(
            m, mixer="slstm")), num_layers=2)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, 23)).astype(np.int32))
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": toks[:, :20]},
                                  max_len=32)
        leaves = tree_flatten(caches)[0]
        ptrs = [t.data_ptr() for t in leaves]
        before = [t.clone() for t in leaves]
        for i in range(20, 23):
            _, out = model.decode_step(params, caches, toks[:, i:i + 1], i)
            assert out is caches
        _, ref = model.prefill(params, {"tokens": toks}, max_len=32)
    after = tree_flatten(caches)[0]
    assert [t.data_ptr() for t in after] == ptrs
    states = [c["mixer"] for seg in caches.values() for c in seg.values()
              if "pos" not in c["mixer"]]
    assert len(states) == 2  # two recurrent layers in either stack
    for a, b, r in zip(after, before, tree_flatten(ref)[0]):
        assert not torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-4,
                                   rtol=1e-3)


def test_mlstm_closed_forget_gate_keeps_gradients_finite():
    """A forget gate closed over a chunk (log f = -10 a step: u_s - M_t
    reaches ~150 above the diagonal, past float32's exp range). The
    reference masks the decay after its exp, so its gradients are NaN
    (the masked inf times the mask's zero); the port masks the exponent
    first: the same h (the reference's forward is finite), gradients
    finite and within 1e-4 (relative to max(1, the largest entry)) of the
    same chunk in float64, where nothing overflows."""
    Bq, H, c, dh = 2, 2, 16, 8
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(Bq, H, c, dh)).astype(np.float32)
               for _ in range(3))
    logi = rng.normal(size=(Bq, H, c)).astype(np.float32)
    logf = np.full((Bq, H, c), -10.0, np.float32)
    w = rng.normal(size=(Bq, H, c, dh)).astype(np.float32)
    st = (np.zeros((Bq, H, dh, dh), np.float32),
          np.zeros((Bq, H, dh), np.float32), np.full((Bq, H), -1e30,
                                                     np.float32))

    def ref_loss(q, k, v, logf, logi):
        h, _ = ref_rec._mlstm_chunk(q, k, v, logf, logi,
                                    tuple(map(jnp.asarray, st)))
        return jnp.sum(h * w), h

    (_, ref_h), ref_g = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(q, k, v, logf,
                                                           logi)
    assert any(np.isnan(np.asarray(g)).any() for g in ref_g)

    grads = {}
    for dt in (torch.float32, torch.float64):
        ins = [torch.from_numpy(t).to(dt).requires_grad_(True)
               for t in (q, k, v, logf, logi)]
        h, _ = rec._mlstm_chunk(*ins, tuple(torch.from_numpy(t).to(dt)
                                            for t in st))
        grads[dt] = torch.autograd.grad(torch.sum(
            h * torch.from_numpy(w).to(dt)), ins)
        if dt == torch.float32:
            _close(h, ref_h, what="h")
    for g, g64 in zip(grads[torch.float32], grads[torch.float64]):
        assert bool(torch.all(torch.isfinite(g)))
        scale = max(1.0, float(g64.abs().max()))
        np.testing.assert_allclose(g.numpy() / scale,
                                   g64.numpy() / scale, atol=1e-4)


def _chip_smoke():
    """chip_smoke.py as a module (it runs nothing when imported)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_float64_model():
    """chip_smoke's ``float64_model``: inside it a float64 model's logits
    are float64 and agree with the float32 model's to float32 rounding (at
    the reference's recurrent-decode tolerance), outside it the model
    modules read float32 again; a stack whose attention takes the flash
    route (attn_block > 0) is refused, the same stack on the dense route
    is not."""
    from repro_torch.models import build_model
    from repro_torch.models import layers
    from repro_torch.utils.tree import tree_map
    cs = _chip_smoke()
    cfg = get_config("xlstm-1.3b").reduced(layers=2)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, 20)).astype(np.int32))
    with torch.no_grad():
        l32, _ = model.prefill(params, {"tokens": toks})
        with cs.float64_model(torch, cfg):
            l64, _ = model.prefill(tree_map(lambda t: t.double(), params),
                                   {"tokens": toks})
    assert l32.dtype == torch.float32 and l64.dtype == torch.float64
    assert layers.torch is torch
    np.testing.assert_allclose(l32.numpy(), l64.numpy(), atol=cs.REC_ATOL,
                               rtol=cs.REC_RTOL)
    hybrid = get_config("recurrentgemma-2b").reduced(layers=3)
    with cs.float64_model(torch, hybrid):
        assert layers.torch is not torch
    with pytest.raises(ValueError, match="dense route"):
        with cs.float64_model(torch, hybrid.replace(dist=dataclasses.replace(
                hybrid.dist, attn_block=8))):
            pass


def test_float64_decode_check_catches_a_dropped_state_term(monkeypatch,
                                                           capsys):
    """chip_smoke's full-depth decode check for a stack without attention,
    at the reduced xlstm with an sLSTM (8 layers): decode_steps inside
    float64_model agree with their prefills within REC64_ATOL +
    REC64_RTOL. A decode that leaves the mLSTM's normaliser n where it was
    (the state's other terms advance) is caught at that tolerance; its
    share of the literal REC_ATOL + REC_RTOL is printed."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_map
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "card_line", lambda: "cpu")
    cfg = get_config("xlstm-1.3b").reduced(layers=8)
    assert [s.mixer for s in cfg.layer_specs()] == ["mlstm"] * 7 + ["slstm"]
    model = build_model(cfg)
    p64 = tree_map(lambda t: t.double(), model.init_params(
        torch.Generator().manual_seed(0), "cpu"))

    def steps():
        with cs.float64_model(torch, cfg):
            return cs.decode_steps(torch, model, p64)

    sound = steps()
    assert all(t.dtype == torch.float64 for st in sound for t in st)
    cs.decode_check(torch, "sound", sound, atol=cs.REC64_ATOL,
                    rtol=cs.REC64_RTOL, what="float64 decode")
    forward = tfm._RECURRENT["mlstm"]

    def stale_n(params, x, *, cfg, mode, state=None):
        y, new = forward(params, x, cfg=cfg, mode=mode, state=state)
        if mode == "decode":
            new = dict(new, n=state["n"].clone())
        return y, new

    monkeypatch.setitem(tfm._RECURRENT, "mlstm", stale_n)
    faulty = steps()
    _, literal = cs.decode_share(torch, "n stale", faulty, cs.REC_ATOL,
                                 cs.REC_RTOL, "float64 decode")
    with capsys.disabled():
        print(f"\na decode with a stale mLSTM n: {literal!r} of the "
              f"literal tolerance")
    with pytest.raises(AssertionError, match="decode differs"):
        cs.decode_check(torch, "n stale", faulty, atol=cs.REC64_ATOL,
                        rtol=cs.REC64_RTOL, what="float64 decode")