"""The port's serving path against the JAX package's, on handed-over
parameters (olmo-1b reduced to d_model 64, 2 layers, vocab 64 unless a test
says otherwise): the model's prefill and decode modes, greedy ``generate``,
and mirrors of ``tests/test_serving.py``'s engine tests (OOV-safe
sampling, the persistent cache written in place, continuous batching equal
to sequential generate, slot insert/evict/reuse, EOS retirement, oversized
requests, the merged checkpoint served), the patch-prefix and
encoder-decoder families' serving (``tests/test_serving.py:68, 170-198,
201-219``: the reference's tokens the oracle, the extras handed over as
numpy), then ``launch/train.py --save-merged`` -> ``launch/serve.py
--restore`` on the CPU.

Tolerances: prefill and decode logits against the reference's at atol 2e-5
+ rtol 1e-5 (float32; the products and softmax sums run in another order;
measured ≤ 4e-6 on logits of magnitude ~1); the caches' k and v at 1e-5,
their positions exactly. Greedy tokens and everything inside the port are
compared exactly. Temperature sampling draws from a ``torch.Generator``
(``jax.random``'s bits cannot be reproduced), so it is held statistically:
no OOV id, and other seeds give other tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.serving import generate as ref_generate
from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_config
from repro_torch.core import dsgd
from repro_torch.core import merge as merge_mod
from repro_torch.core import panel as panel_mod
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model, extra_inputs
from repro_torch.optim import make_optimizer
from repro_torch.serving import (Request, ServingEngine, generate,
                                 make_decode_fn, make_prefill_fn, mask_oov,
                                 sample_token)
from repro_torch.weights import from_reference_params

pytestmark = pytest.mark.serve

ATOL, RTOL = 2e-5, 1e-5


def _cfgs(d=64, vocab=64, attn_block=0):
    ref_cfg = ref_get_config("olmo-1b").reduced(d_model=d, vocab=vocab)
    cfg = get_config("olmo-1b").reduced(d_model=d, vocab=vocab)
    if attn_block:
        ref_cfg = ref_cfg.replace(dist=dataclasses.replace(
            ref_cfg.dist, attn_block=attn_block))
        cfg = cfg.replace(dist=dataclasses.replace(cfg.dist,
                                                   attn_block=attn_block))
    return ref_cfg, cfg


def _handover(ref_params):
    stacked = jax.tree.map(lambda x: np.asarray(x)[None], ref_params)
    _, panel, spec = from_reference_params(stacked, device="cpu")
    return panel_mod.agent_params(panel, spec, 0)


_REF = {}


def _pair(d=64, vocab=64, attn_block=0):
    """(ref_model, ref_params, model, params), the port's params handed
    over from the reference's init (cached per size)."""
    key = (d, vocab, attn_block)
    if key not in _REF:
        ref_cfg, cfg = _cfgs(d, vocab, attn_block)
        ref_model = ref_build_model(ref_cfg)
        ref_params = ref_model.init_params(jax.random.PRNGKey(0))
        _REF[key] = (ref_model, ref_params, build_model(cfg),
                     _handover(ref_params))
    return _REF[key]


def _tiny(vocab=64):
    _, _, model, params = _pair(vocab=vocab)
    return model.cfg, model, params


def _prompt(i, S, vocab):
    return np.random.default_rng((1, i)).integers(0, vocab, S).astype(
        np.int32)


def _batch_of(req):
    return {"tokens": torch.from_numpy(np.asarray(req.tokens)[None])}


def _cache_leaves(caches):
    return [caches["main"]["p0"]["mixer"][k] for k in ("k", "pos", "v")]


# -------------------------------------------------- the model's cache modes


@pytest.mark.parametrize("attn_block,S", [(0, 11), (8, 11), (8, 16)],
                         ids=["dense", "blockwise-ragged", "blockwise"])
def test_prefill_and_decode_match_reference(attn_block, S):
    """prefill's logits and caches, then eight decode steps with every row
    at its own position (a (B,) index vector; row 1 three positions ahead,
    so the rows write different slots and row 1 leaves three empty ones),
    against the reference's, each step fed the reference's greedy
    token."""
    ref_model, ref_params, model, params = _pair(attn_block=attn_block)
    B, max_len = 2, S + 11
    toks = np.random.default_rng(0).integers(0, 64, (B, S)).astype(np.int32)
    rl, rc = jax.jit(lambda p, b: ref_model.prefill(p, b, max_len=max_len))(
        ref_params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": torch.from_numpy(
            toks)}, max_len=max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rl), rtol=RTOL,
                               atol=ATOL)
    _check_caches(caches, rc)
    ref_dec = jax.jit(ref_model.decode_step)
    pos = np.array([S, S + 3], np.int32)
    for _ in range(8):
        tok = np.argmax(np.asarray(rl), -1).astype(np.int32)[:, None]
        rl, rc = ref_dec(ref_params, rc, jnp.asarray(tok), jnp.asarray(pos))
        with torch.no_grad():
            logits, caches = model.decode_step(params, caches,
                                               torch.from_numpy(tok),
                                               torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(rl),
                                   rtol=RTOL, atol=ATOL)
        pos = pos + 1
    _check_caches(caches, rc)


def _check_caches(caches, ref_caches):
    """The port's cache tree against the reference's: the same keys and
    shapes, positions exactly, k and v within 1e-5."""
    ref = ref_caches["main"]["p0"]["mixer"]
    assert list(caches) == ["main"] and list(caches["main"]) == ["p0"]
    assert sorted(caches["main"]["p0"]["mixer"]) == sorted(ref)
    for got, name in zip(_cache_leaves(caches), ("k", "pos", "v")):
        want = np.asarray(ref[name])
        assert tuple(got.shape) == want.shape
        if name == "pos":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_prefill_window_ring_layout_matches_reference():
    """A window shorter than the prompt: the cache keeps the trailing
    window laid out slot = pos mod W, as the reference's."""
    from repro.models import attention as ref_attn
    from repro_torch.models import attention
    ref_cfg, cfg = _cfgs()
    lspec = dataclasses.replace(cfg.layer_period[0], window=5)
    ref_lspec = dataclasses.replace(ref_cfg.layer_period[0], window=5)
    rng = np.random.default_rng(3)
    k = rng.normal(size=(2, 12, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 12, 2, 32)).astype(np.float32)
    pos = np.arange(12, dtype=np.int32)[None]
    ref = ref_attn._prefill_cache(ref_cfg, ref_lspec, jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(pos), 2, 12, 20)
    got = attention._prefill_cache(lspec, torch.from_numpy(k),
                                   torch.from_numpy(v), torch.from_numpy(pos),
                                   2, 12, 20)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(ref[name]))
    empty = attention.init_gqa_cache(cfg, lspec, 3, 20, device="cpu")
    assert tuple(empty["k"].shape) == (3, 5, 2, 32)
    assert (empty["pos"] == -1).all() and empty["pos"].dtype == torch.int32


@pytest.mark.parametrize("max_len", [None, 40])
def test_greedy_generate_matches_reference(max_len):
    ref_model, ref_params, model, params = _pair()
    toks = np.random.default_rng(5).integers(0, 64, (3, 9)).astype(np.int32)
    ref = ref_generate(ref_model, ref_params, {"tokens": jnp.asarray(toks)},
                       7, max_len=max_len)
    got = generate(model, params, {"tokens": torch.from_numpy(toks)}, 7,
                   max_len=max_len)
    assert got.dtype == np.int32 and got.shape == (3, 7)
    np.testing.assert_array_equal(got, ref)


# -------------------------------------------------------- sampling, OOV mask


def test_generate_temperature_sampling_varies_with_the_seed():
    cfg, model, params = _tiny()
    batch = {"tokens": torch.from_numpy(_prompt(0, 8, 64)[None].repeat(2, 0))}
    a = generate(model, params, batch, 8, temperature=2.0,
                 rng=torch.Generator().manual_seed(2))
    b = generate(model, params, batch, 8, temperature=2.0,
                 rng=torch.Generator().manual_seed(3))
    again = generate(model, params, batch, 8, temperature=2.0,
                     rng=torch.Generator().manual_seed(2))
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, again)


def test_sample_token_masks_padded_vocab_tail():
    logits = torch.zeros((2, 16))
    logits[:, 13] = 100.0
    logits[0, 3] = 1.0
    tok = sample_token(logits, None, 0.0, vocab_size=10)
    np.testing.assert_array_equal(tok.numpy(), [3, 0])
    for s in range(8):
        tok = sample_token(logits, torch.Generator().manual_seed(s), 1.0,
                           vocab_size=10)
        assert (tok < 10).all()
    assert (torch.argmax(logits, -1) == 13).all()  # unmasked, the tail wins
    assert torch.isneginf(mask_oov(logits, 10)[:, 10:]).all()


def test_generate_and_engine_never_emit_oov_ids():
    """padded_vocab (256) > vocab_size (250): the head's padding columns
    are never sampled, greedy or tempered, by generate or the engine."""
    cfg, model, params = _tiny(vocab=250)
    assert cfg.padded_vocab > cfg.vocab_size
    batch = {"tokens": torch.from_numpy(np.stack(
        [_prompt(i, 8, 250) for i in range(4)]))}
    greedy = generate(model, params, batch, 8)
    temped = generate(model, params, batch, 8, temperature=1.5,
                      rng=torch.Generator().manual_seed(2))
    eng = ServingEngine(model, params, max_concurrency=2, max_len=24,
                        temperature=1.5, rng=torch.Generator().manual_seed(3))
    out = eng.serve([Request(rid=i, tokens=_prompt(i, 8, 250), max_new=8)
                     for i in range(3)])
    for v in [greedy, temped] + list(out.values()):
        assert (v < cfg.vocab_size).all() and (v >= 0).all()


# --------------------------------------------- the cache, written in place


def test_decode_fn_writes_the_cache_in_place():
    cfg, model, params = _tiny()
    logits, caches = make_prefill_fn(model, max_len=32)(
        params, {"tokens": torch.from_numpy(_prompt(0, 8, 64)[None])})
    before = [x.data_ptr() for x in _cache_leaves(caches)]
    pos_before = caches["main"]["p0"]["mixer"]["pos"].clone()
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    _, new = make_decode_fn(model)(params, caches, tok, 8)
    assert [x.data_ptr() for x in _cache_leaves(new)] == before
    assert new is caches
    changed = caches["main"]["p0"]["mixer"]["pos"] != pos_before
    assert changed.sum() == 2  # slot 8 of the one row, in both layers
    assert (caches["main"]["p0"]["mixer"]["pos"][:, 0, 8] == 8).all()


def test_engine_cache_persists_across_ticks():
    cfg, model, params = _tiny()
    eng = ServingEngine(model, params, max_concurrency=2, max_len=32)
    eng.submit(Request(rid=0, tokens=_prompt(0, 8, 64), max_new=6))
    eng.admit()
    ptrs = [x.data_ptr() for x in _cache_leaves(eng.caches)]
    for _ in range(4):
        eng.step()
    assert [x.data_ptr() for x in _cache_leaves(eng.caches)] == ptrs
    eng.submit(Request(rid=1, tokens=_prompt(1, 8, 64), max_new=4))
    eng.admit()  # insert writes the same tensors
    assert [x.data_ptr() for x in _cache_leaves(eng.caches)] == ptrs


# ------------------------------------------------------ continuous batching


def test_continuous_batching_identical_to_sequential_generate():
    """Five heterogeneous requests (prompts of 8 and 12, max_new 4-6)
    through three slots give the tokens of five single-request generate
    calls (temperature 0)."""
    cfg, model, params = _tiny()
    max_len = 48
    eng = ServingEngine(model, params, max_concurrency=3, max_len=max_len)
    reqs = [Request(rid=i, tokens=_prompt(i, [8, 12][i % 2], 64),
                    max_new=4 + (i % 3)) for i in range(5)]
    out = eng.serve(reqs)
    assert eng.stats["admitted"] == 5 and eng.stats["retired"] == 5
    assert 0.0 < eng.occupancy <= 1.0
    for r in reqs:
        ref = generate(model, params, _batch_of(r), r.max_new,
                       max_len=max_len)[0]
        np.testing.assert_array_equal(out[r.rid], ref)


def test_slot_insert_evict_reuse():
    cfg, model, params = _tiny()
    eng = ServingEngine(model, params, max_concurrency=2, max_len=32)
    r0 = Request(rid="a", tokens=_prompt(0, 8, 64), max_new=12)
    r1 = Request(rid="b", tokens=_prompt(1, 8, 64), max_new=12)
    eng.submit(r0)
    eng.submit(r1)
    eng.admit()
    assert eng.free_slots() == [] and eng.live_slots() == [0, 1]
    eng.step()
    eng.evict(0)  # mid-flight: the slot frees, the survivor is unperturbed
    assert eng.free_slots() == [0]
    assert (eng.caches["main"]["p0"]["mixer"]["pos"][:, 0] == -1).all()
    out = eng.serve([])
    ref1 = generate(model, params, _batch_of(r1), r1.max_new, max_len=32)[0]
    np.testing.assert_array_equal(out["b"], ref1)
    r2 = Request(rid="c", tokens=_prompt(2, 8, 64), max_new=6)
    out = eng.serve([r2])
    assert eng.stats["admitted"] == 3
    ref2 = generate(model, params, _batch_of(r2), r2.max_new, max_len=32)[0]
    np.testing.assert_array_equal(out["c"], ref2)


def test_eos_retires_slot_and_stops_generate():
    cfg, model, params = _tiny()
    req = Request(rid=0, tokens=_prompt(3, 8, 64), max_new=10)
    free = generate(model, params, _batch_of(req), 10, max_len=32)[0]
    eos = int(free[2])
    j = int(np.argmax(free == eos))
    out = generate(model, params, _batch_of(req), 10, max_len=32,
                   eos_id=eos)[0]
    np.testing.assert_array_equal(out[:j + 1], free[:j + 1])
    assert (out[j:] == eos).all()
    eng = ServingEngine(model, params, max_concurrency=1, max_len=32,
                        eos_id=eos)
    nxt = Request(rid=1, tokens=_prompt(1, 8, 64), max_new=4)
    served = eng.serve([req, nxt])
    assert list(served[0]) == list(free[:j + 1])
    assert served[0][-1] == eos
    assert eng.stats["admitted"] == 2 and eng.stats["retired"] == 2
    assert len(served[1]) == 4


def test_engine_rejects_oversized_request():
    cfg, model, params = _tiny()
    eng = ServingEngine(model, params, max_concurrency=1, max_len=16)
    eng.submit(Request(rid=0, tokens=_prompt(0, 12, 64), max_new=8))
    with pytest.raises(ValueError, match="max_len"):
        eng.admit()


# ------------------------------------ the patch-prefix and encoder families


_FAMILY = {}


def _family(arch, d=64, vocab=64):
    """(ref_model, ref_params, model, params) of ``arch`` reduced to
    d_model ``d`` and ``vocab`` (the reference tests' ``_tiny``), the
    port's parameters handed over from the reference's seed-0 init."""
    key = (arch, d, vocab)
    if key not in _FAMILY:
        ref_model = ref_build_model(ref_get_config(arch).reduced(
            d_model=d, vocab=vocab))
        ref_params = ref_model.init_params(jax.random.PRNGKey(0))
        model = build_model(get_config(arch).reduced(d_model=d, vocab=vocab))
        _FAMILY[key] = (ref_model, ref_params, model, _handover(ref_params))
    return _FAMILY[key]


def _extra(cfg, name, i, rows):
    """Request ``i``'s patch prefix or frames: (rows, d) float32 standard
    normals from the numpy generator seeded (3, i)."""
    return np.random.default_rng((3, i)).standard_normal(
        (rows, cfg.d_model), dtype=np.float32)


def _batches_of(req):
    """The request as a batch of one row: (the reference's, the port's)."""
    b = {"tokens": np.asarray(req.tokens)[None],
         **{k: np.asarray(v)[None] for k, v in req.extras.items()}}
    return (jax.tree.map(jnp.asarray, b),
            {k: torch.from_numpy(v) for k, v in b.items()})


def _serve_both(arch, reqs, max_len, C=3):
    """The requests through the port's engine and the reference's (C
    slots); asserts their tokens equal, request by request, and equal to
    the port's generate of each alone. Returns the port's engine."""
    from repro.serving import Request as RefRequest
    from repro.serving import ServingEngine as RefEngine
    ref_model, ref_params, model, params = _family(arch)
    eng = ServingEngine(model, params, max_concurrency=C, max_len=max_len)
    out = eng.serve(reqs)
    ref_out = RefEngine(ref_model, ref_params, max_concurrency=C,
                        max_len=max_len).serve([
        RefRequest(rid=r.rid, tokens=r.tokens, max_new=r.max_new,
                   extras=r.extras) for r in reqs])
    assert eng.stats["admitted"] == eng.stats["retired"] == len(reqs)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], ref_out[r.rid])
        alone = generate(model, params, _batches_of(r)[1], r.max_new,
                         max_len=max_len)[0]
        np.testing.assert_array_equal(out[r.rid], alone)
    return eng


def test_generate_vlm_with_prefix_matches_reference():
    """tests/test_serving.py:68: qwen2-vl (d_model 128, vocab 128) with an
    8-row patch prefix before 8 prompt tokens; the greedy tokens equal the
    reference's (its decode positions start after the prefix)."""
    ref_model, ref_params, model, params = _family("qwen2-vl-72b", 128, 128)
    cfg = model.cfg
    toks = np.stack([_prompt(i, 8, cfg.vocab_size) for i in range(2)])
    pe = np.stack([_extra(cfg, "patch_embeds", i, cfg.mm_prefix)
                   for i in range(2)])
    out = generate(model, params, {"tokens": torch.from_numpy(toks),
                                   "patch_embeds": torch.from_numpy(pe)}, 4)
    ref = ref_generate(ref_model, ref_params, {
        "tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(pe)}, 4)
    assert out.shape == (2, 4)
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_continuous_batching_encdec_padded_cross_kv():
    """tests/test_serving.py:170-198 on seamless-m4t: five requests of 8
    or 12 prompt tokens, each with as many frames, through 3 slots whose
    cross keys and values hold max_len 48 rows (a request's rows padded at
    pos -1): tokens equal to the reference engine's and to each request
    generated alone."""
    cfg = _family("seamless-m4t-medium")[2].cfg
    reqs = []
    for i in range(5):
        S = [8, 12][i % 2]
        reqs.append(Request(rid=i, tokens=_prompt(i, S, cfg.vocab_size),
                            max_new=4 + (i % 3), extras={
                                "frame_embeds": _extra(cfg, "frame_embeds",
                                                       i, S)}))
    eng = _serve_both("seamless-m4t-medium", reqs, 48)
    pos = eng.caches["main"]["p0"]["cross"]["pos"]
    assert tuple(pos.shape) == (cfg.num_layers, 3, 48)
    # each slot's last request: its own frames' rows, then padding at -1
    for slot in range(3):
        S = int((pos[0, slot] >= 0).sum())
        assert S in (8, 12)
        assert bool(torch.all(pos[:, slot, :S] == torch.arange(S)))
        assert bool(torch.all(pos[:, slot, S:] == -1))
    with pytest.raises(ValueError, match="encoder rows"):
        eng.serve([Request(rid=9, tokens=_prompt(9, 4, cfg.vocab_size),
                           extras={"frame_embeds": _extra(
                               cfg, "frame_embeds", 9, 49)})])


def test_mixed_batch_multimodal_prefix_parity():
    """tests/test_serving.py:201-219: qwen2-vl requests with and without a
    patch prefix share 3 slots; tokens equal to the reference engine's and
    to each request generated alone."""
    cfg = _family("qwen2-vl-72b")[2].cfg
    reqs = []
    for i in range(4):
        extras = ({"patch_embeds": _extra(cfg, "patch_embeds", i,
                                          cfg.mm_prefix)}
                  if i % 2 == 0 else {})
        reqs.append(Request(rid=i, tokens=_prompt(i, 8, cfg.vocab_size),
                            max_new=5, extras=extras))
    _serve_both("qwen2-vl-72b", reqs, 48)


@pytest.mark.parametrize("arch,extra", [("olmo-1b", "patch_embeds"),
                                        ("qwen2-vl-72b", "frame_embeds"),
                                        ("seamless-m4t-medium",
                                         "patch_embeds")])
def test_inputs_the_model_does_not_read_are_refused(arch, extra):
    """A patch prefix sent to a model without one would be ignored by its
    prefill while it shifted the decode positions, and frames sent to a
    decoder would be dropped: generate and the engine's admit refuse an
    input the model does not read, by name (beside the inputs it does
    read, which pass)."""
    model, params = _family(arch)[2:]
    cfg = model.cfg
    extras = {name: _extra(cfg, name, 0, shape[0])
              for name, shape in extra_inputs(cfg, 8).items()}
    toks = _prompt(0, 8, cfg.vocab_size)
    out = generate(model, params, {
        "tokens": torch.from_numpy(toks[None]),
        **{k: torch.from_numpy(v[None]) for k, v in extras.items()}}, 2)
    assert out.shape == (1, 2)
    extras[extra] = _extra(cfg, extra, 0, 4)
    with pytest.raises(ValueError, match=extra):
        generate(model, params, {
            "tokens": torch.from_numpy(toks[None]),
            **{k: torch.from_numpy(v[None]) for k, v in extras.items()}}, 2)
    eng = ServingEngine(model, params, max_concurrency=1, max_len=32)
    eng.submit(Request(rid=0, tokens=toks, max_new=2, extras=extras))
    with pytest.raises(ValueError, match=f"request 0: extras.*{extra}"):
        eng.admit()


def test_engine_events_snapshot_and_reset():
    from repro_torch.telemetry import EventLog
    cfg, model, params = _tiny()
    log = EventLog(None)
    seen = []
    log.sink = seen.append
    eng = ServingEngine(model, params, max_concurrency=2, max_len=32,
                        events=log)
    eng.serve([Request(rid=i, tokens=_prompt(i, 8, 64), max_new=3)
               for i in range(3)])
    kinds = [e["type"] for e in seen]
    assert kinds.count("request_submit") == kinds.count(
        "request_admit") == kinds.count("request_retire") == 3
    snap = eng.snapshot()
    assert snap["latency"]["decode_step_s"]["count"] == snap["ticks"] > 0
    assert snap["latency"]["ttft_s"]["count"] == 3
    eng.reset()
    assert eng.snapshot()["ticks"] == 0 and eng.occupancy == 0.0


# ------------------------------------ train -> merge -> save -> serve


def test_merged_checkpoint_roundtrip_through_engine(tmp_path):
    """The port's panel run, merged and saved, restored into a DIFFERENT
    init, serves the tokens of the in-memory merged model."""
    cfg, model, _ = _tiny()
    m = 2
    opt = make_optimizer("adamw", 1e-3)
    state, spec = dsgd.init_panel_state(
        model.init_params, opt, m, torch.Generator().manual_seed(0),
        device="cpu")
    seg = dsgd.make_panel_segment(model.loss_fn, opt, 1, spec)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 64, (1, 1, m, 2, 17)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "targets": toks[..., 1:],
             "mask": np.ones((1, 1, m, 2, 16), np.float32)}
    state, _ = seg(state, batch, np.full((1, m, m), 0.5, np.float32),
                   torch.Generator().manual_seed(3))
    merged = merge_mod.merged_panel_tree(state["panel"], spec)
    path = str(tmp_path / "merged.ckpt")
    save(path, merged)
    template = model.init_params(torch.Generator().manual_seed(9), "cpu")
    restored = restore(path, template)
    req = Request(rid=0, tokens=_prompt(0, 8, 64), max_new=6)
    eng = ServingEngine(model, restored, max_concurrency=2, max_len=32)
    out = eng.serve([req])
    ref = generate(model, merged, _batch_of(req), 6, max_len=32)[0]
    np.testing.assert_array_equal(out[0], ref)


def test_launchers_save_merged_then_serve_restore(tmp_path, capsys):
    """``launch.train --save-merged P --device cpu`` then ``launch.serve
    --restore P --device cpu``: the serve launcher prints ``restored P``,
    the serve_end line with occupancy 1.00 (requests >= slots, uniform
    max_new) and the latency summary; the JAX package's serve launcher
    restores the same blob."""
    path = str(tmp_path / "merged.ckpt")
    train_launch.main(["--rounds", "2", "--segment", "2", "--agents", "2",
                       "--local-steps", "1", "--batch", "2", "--seq", "16",
                       "--device", "cpu", "--out", str(tmp_path / "res"),
                       "--save-merged", path])
    assert f"saved uniform-merged model to {path}" in capsys.readouterr().out
    out = serve_launch.main(["--restore", path, "--device", "cpu",
                             "--concurrency", "2", "--requests", "4",
                             "--prompt-len", "8", "--max-new", "3",
                             "--events", str(tmp_path / "ev.jsonl")])
    text = capsys.readouterr().out
    assert f"restored {path}" in text
    assert "serve end: 4 requests / 12 tokens" in text
    assert "occupancy 1.00" in text and "tok/s | ttft p50/p99" in text
    assert sorted(out) == [0, 1, 2, 3]
    from repro_torch.telemetry import validate_stream
    assert validate_stream(str(tmp_path / "ev.jsonl")) == []
    ref_cfg = ref_get_config("olmo-1b").reduced(d_model=128, layers=2,
                                                vocab=256)
    from repro.checkpoint import restore as ref_restore
    ref_params = ref_restore(path, ref_build_model(ref_cfg).init_params(
        jax.random.PRNGKey(1)))
    assert ref_params["embed"]["table"].shape == (256, 128)


def test_serve_launcher_one_shot_and_refusals(capsys, monkeypatch):
    out = serve_launch.main(["--one-shot", "--device", "cpu", "--requests",
                             "2", "--prompt-len", "6", "--max-new", "3"])
    assert out.shape == (2, 3)
    assert "generated (2, 3)" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_launch.main(["--requests", "1"])
