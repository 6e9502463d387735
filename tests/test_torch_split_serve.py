"""The serve shapes split over the serve mesh (``tensor_parallel``'s serve
route: the reference's ``build_serve`` layout) for the GQA decoders (the
dense ones, arctic-480b's experts over the model line, qwen2-vl-72b's
patch prefix and M-RoPE), on gloo ranks (``tests/_torch_dist.py`` mode
``serve``), against the JAX package's jitted ``prefill`` /
``decode_step`` and the port's one process.

Meshes (1, 1, 1, 2) (heads, d_ff and the head's vocabulary or the tied
table's d_model columns over 2 model ranks), (1, 1, 2, 2) (and the batch
over 2 data ranks; yi-34b, ``big``, holds its weights' fsdp dim over them
too) and (1, 1, 1, 4) (a kv head shared by two ranks' query heads), for
olmo-1b, phi3-mini-3.8b, yi-34b, gemma-2b (one kv head, whole on every
model rank), gemma-2b-sw (prompts past its window: the ring), arctic-480b
(4 experts, dropless on each data rank's rows) and qwen2-vl-72b (an
8-row seeded patch prefix before each prompt) at ``reduced()``, the
reference's inits handed over, olmo, the gemmas and qwen2-vl through the
blockwise prefill (``attn_block`` 16), 4 prompts of 80 tokens and 6
decode steps fed fixed tokens:

- every rank's float32 logits of its data rows, the prefill's and each
  step's, against the reference's at atol 2e-5 + rtol 1e-5 (the serving
  tests' tolerance), the model ranks of a data rank bit for bit;
- each rank's cache block (its rows, its kv heads where the model line
  divides Kv) against its slice of the one-process cache: positions
  exactly, k and v within 1e-5 (the ranks' partial sums of the layer
  before in another order);
- the pieces' shapes as ``serve_rules`` resolves ``param_spec`` (arctic's
  banks: the rank's experts, fsdp over the data line); the banks' serve
  leaves at the published widths keep their experts over model and
  gather over the data line only; any other family refused by name
  (ROADMAP A16d's second item);
- qwen2-vl's requests, each with its prefix, through each data rank's
  engine: the tokens of one process's engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_threads  # noqa: F401
from _torch_dist import (SERVE_B, SERVE_CASES, SERVE_S, SERVE_STEPS,
                         serve_config)
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.launch.mesh import mesh_of_shape
from repro_torch.models import build_model
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.sharding import resolve, serve_rules
from repro_torch.weights import from_reference_params
from repro_torch.core import panel as panel_mod

MESHES = ("1,1,1,2", "1,1,2,2", "1,1,1,4")
ATOL, RTOL = 2e-5, 1e-5


def _reference(case):
    """The handed-over weights, prompts (qwen2-vl's with a seeded patch
    prefix) and decode tokens, and the reference's logits (prefill, then
    each step, at positions past the prefix) of one case."""
    ref_cfg = serve_config(case, ref_get_config)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init_params(jax.random.PRNGKey(3))
    stacked = jax.tree.map(lambda x: np.asarray(x)[None], ref_params)
    _, pan, spec = from_reference_params(stacked, device="cpu")
    params = panel_mod.agent_params(pan, spec, 0)
    rng = np.random.default_rng(7)
    V = ref_cfg.vocab_size
    P = ref_cfg.mm_prefix
    tokens = rng.integers(0, V, (SERVE_B, SERVE_S)).astype(np.int32)
    extras = ({"patch_embeds": rng.standard_normal(
        (SERVE_B, P, ref_cfg.d_model)).astype(np.float32)} if P else {})
    steps = [(rng.integers(0, V, (SERVE_B, 1)).astype(np.int32),
              np.full((SERVE_B,), P + SERVE_S + i, np.int32))
             for i in range(SERVE_STEPS)]
    max_len = P + SERVE_S + SERVE_STEPS
    rl, rc = jax.jit(lambda p, b: ref_model.prefill(p, b, max_len=max_len))(
        ref_params, {"tokens": jnp.asarray(tokens),
                     **{k: jnp.asarray(v) for k, v in extras.items()}})
    dec = jax.jit(ref_model.decode_step)
    logits = [np.asarray(rl)]
    for tok, pos in steps:
        rl, rc = dec(ref_params, rc, jnp.asarray(tok), jnp.asarray(pos))
        logits.append(np.asarray(rl))
    return ({"params": params, "tokens": tokens, "steps": steps,
             "extras": extras, "max_len": max_len}, np.stack(logits))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_inputs")
    inputs, refs = {}, {}
    for case in SERVE_CASES:
        inputs[case[0]], refs[case[0]] = _reference(case)
    torch.save(inputs, tmp / "serve_inputs.pt")
    return tmp, refs


@pytest.fixture(scope="module")
def worlds(cases):
    tmp, refs = cases
    out = {}

    def run(shape):
        if shape not in out:
            d = tmp / shape.replace(",", "_")
            d.mkdir()
            (d / "serve_inputs.pt").symlink_to(tmp / "serve_inputs.pt")
            world = int(np.prod([int(x) for x in shape.split(",")]))
            _torch_dist.spawn(world, "serve", d, args=(shape,), timeout=300)
            out[shape] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                          for r in range(world)]
        return out[shape], refs
    return run


def _leaves(tree, at=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], at + (k,))
    else:
        yield at, tree


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", [c[0] for c in SERVE_CASES])
def test_split_logits_match_reference(worlds, shape, case):
    ranks, refs = worlds(shape)
    want = refs[case]
    by_rows = {}
    for rec in ranks:
        r = rec[case]
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["logits"].numpy(), want[:, lo:hi],
                                   atol=ATOL, rtol=RTOL)
        first = by_rows.setdefault((lo, hi), r["logits"])
        assert torch.equal(first, r["logits"]), "model ranks disagree"
    # every row served by some data rank
    assert sorted(i for lo, hi in by_rows for i in range(lo, hi)) == \
        list(range(SERVE_B))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", [c[0] for c in SERVE_CASES])
def test_split_cache_blocks_match_one_process(worlds, shape, case):
    ranks, _ = worlds(shape)
    one_logits, one_caches = ranks[0][case]["one"]
    M = int(shape.split(",")[3])
    cfg = serve_config(next(c for c in SERVE_CASES if c[0] == case),
                       get_config)
    Kv = cfg.attn.num_kv_heads
    for rec in ranks:
        r = rec[case]
        lo, hi = r["rows"]
        j = r["coord"]["model"]
        for path, got in _leaves(r["caches"]):
            want = dict(_leaves(one_caches))[path][:, lo:hi]
            if path[-1] in ("k", "v") and Kv % M == 0 and M > 1:
                n = Kv // M
                want = want[:, :, :, j * n:(j + 1) * n]
            assert got.shape == want.shape, path
            if path[-1] == "pos":
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES)
def test_split_pieces_are_the_resolved_blocks(worlds, shape):
    """A rank's attention pieces hold the blocks ``serve_rules`` resolves
    (yi's fsdp dim over the data line: big)."""
    ranks, _ = worlds(shape)
    dims = tuple(int(x) for x in shape.split(","))
    mesh = mesh_of_shape(dims)
    for case in SERVE_CASES:
        cfg = serve_config(case, get_config)
        model = build_model(cfg)
        meta = model.init_params(None, torch.device("meta"))
        ps = resolve(model.param_spec(), meta, mesh,
                     serve_rules(mesh, tp.serve_big(cfg)))
        mixer = meta["decoder"]["main"]["p0"]["mixer"]
        for name, shape_ in ranks[0][case[0]]["pieces"].items():
            entry = ps["decoder"]["main"]["p0"]["mixer"][name]
            want = tuple(n // (mesh.axis_size(e) if e else 1)
                         for n, e in zip(mixer[name].shape, entry))
            assert shape_ == want, (case, name)
    assert tp.serve_big(serve_config(("yi-34b", 0), get_config))


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "xlstm-1.3b",
                                  "deepseek-v3-671b"])
def test_other_families_refused_by_name(arch):
    mesh = mesh_of_shape((1, 1, 1, 2))
    with pytest.raises(NotImplementedError, match=f"{arch}.*A16d.*second"):
        build_model(get_config(arch).reduced(), split=tp.Split(mesh))


@pytest.mark.parametrize("shape", MESHES)
def test_split_engine_serves_prefix_requests(worlds, shape):
    """qwen2-vl's requests, each a prompt and its patch prefix, through
    each data rank's engine on its rows: the tokens one process's engine
    gives them."""
    ranks, _ = worlds(shape)
    want = ranks[0]["qwen2-vl-72b"]["one_engine"]
    served = {}
    for rec in ranks:
        r = rec["qwen2-vl-72b"]
        lo, hi = r["rows"]
        assert sorted(r["engine"]) == list(range(lo, hi))
        for rid, toks in r["engine"].items():
            assert toks == want[rid], (shape, rid)
            served[rid] = toks
    assert sorted(served) == list(range(SERVE_B))


@pytest.mark.parametrize("shape", MESHES)
def test_split_expert_pieces_are_the_rank_experts(worlds, shape):
    """arctic's bank pieces: the rank's E / M experts (every expert where
    M does not divide E), its fsdp dim over the data line (big); its dense
    MLP's columns over model."""
    ranks, _ = worlds(shape)
    dims = tuple(int(x) for x in shape.split(","))
    D, M = dims[2], dims[3]
    cfg = serve_config(("arctic-480b", 0), get_config)
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_ff
    e = E // M if E % M == 0 else E
    L = cfg.num_layers  # the stacked layer axis first
    for rec in ranks:
        ffn = rec["arctic-480b"]["ffn"]
        assert ffn["w_in"] == (L, e, d // D, f)
        assert ffn["w_out"] == (L, e, f, d // D)
        assert ffn["router"] == (L, d, E)


@pytest.mark.parametrize("arch,M", [("arctic-480b", 16), ("arctic-480b", 2),
                                    ("qwen2-vl-72b", 16)])
def test_bank_serve_leaf_keeps_experts_over_model(arch, M):
    """At the published widths on the serve mesh (16 data x M model):
    arctic's banks held by experts over model and never gathered over it
    (only their fsdp dim, over the data line: big), its router whole, its
    dense MLP's columns kept over model; qwen2-vl's MLP and heads kept
    over model, its one kv head a rank gathered."""
    cfg = get_config(arch).replace(param_dtype="bfloat16")
    mesh = mesh_of_shape((1, 1, 16, M))
    split = tp.Split(mesh)
    plan = tp.serve_plan(cfg, split, tp.serve_shardings(build_model(cfg),
                                                        mesh))
    blk = plan["decoder"]["main"]["p0"]
    if arch == "arctic-480b":
        for k, fs in (("w_in", -2), ("w_gate", -2), ("w_out", -1)):
            leaf = blk["ffn"][k]
            assert leaf.entry[-3] == "model", leaf
            assert leaf.gathers == (("fsdp", fs),), leaf
        assert blk["ffn"]["router"].gathers == ()
        assert blk["ffn"]["dense"]["w_in"].gathers == (("fsdp", -2),)
        assert blk["ffn"]["dense"]["w_out"].gathers == (("fsdp", -1),)
        # 56 heads: the attention gathered whole at M 16, split at M 2
        assert (("model", -1) in blk["mixer"]["wq"].gathers) == (M == 16)
    else:
        assert blk["ffn"]["w_in"].gathers == (("fsdp", -2),)
        assert blk["mixer"]["wq"].gathers == (("fsdp", -2),)
        assert blk["mixer"]["wk"].gathers == (("fsdp", -2), ("model", -1))


def test_data_rows_are_the_data_rank_block():
    # a data rank serves the requests of its rows (the engine's caller cuts
    # them); the model ranks of one data rank share them
    reqs = list(range(8))
    shares = [reqs[tp.Split(mesh_of_shape((1, 1, 4, 2), rank)).data_rows(8)]
              for rank in range(8)]
    assert shares[0] == shares[1] == [0, 1] and shares[6] == [6, 7]
    assert sum(shares[::2], []) == reqs
    assert tp.Split(mesh_of_shape((1, 1, 4, 2), 5)).data_rows(3) == slice(0, 3)
