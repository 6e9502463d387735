"""The port's launchers on the recurrent decoders against the JAX
package's: ``launch.train --arch xlstm-1.3b`` and ``--arch
recurrentgemma-2b`` at the CPU preset (d_model 128, 2 layers, vocab 256:
two mLSTM, two RG-LRU layers), the port's from the reference launcher's
init handed over, with ``--save-merged``. Held:

- the per-round history (train loss, Xi, grad norm, merged and local
  eval, communication) at the launchers' tolerance, rtol 1e-4 / atol 1e-6
  (``tests/test_torch_launcher.py``'s), but xlstm's grad norm (see
  GRAD_NORM_RTOL); the last round's Xi 0.0 and merged == local;
- the port's merged-model blob byte for byte the reference's
  ``checkpoint.save`` of the same numbers, and it restores in the
  reference into the recurrent model's tree, bit for bit (the two
  launchers' merged models differ by the trajectories' drift, ~4e-5 a
  coordinate after 8 AdamW steps; their evals are the history's);
- the port's serve launcher restores the blob and serves it;
- the float32 conditioning behind GRAD_NORM_RTOL: how far ~1-ulp
  perturbations of the parameters move an agent's gradient norm at the
  preset (``test_grad_norm_conditioning``).
"""
import json
import sys

import jax
import numpy as np
import pytest

import _torch_threads  # noqa: F401
from repro import checkpoint as ref_checkpoint
from repro.configs import get_config as ref_get_config
from repro.core import dsgd as ref_dsgd
from repro.core import panel as ref_panel
from repro.launch import train as ref_train
from repro.models import build_model as ref_build_model
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.core import dsgd
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.utils.tree import tree_map
from repro_torch.weights import from_reference_params

ROUNDS, AGENTS, H = 4, 4, 2
ARGS = ["--rounds", str(ROUNDS), "--segment", "2", "--agents", str(AGENTS),
        "--local-steps", str(H), "--batch", "4", "--seq", "32"]
RTOL, ATOL = 1e-4, 1e-6
ARCHS = ["recurrentgemma-2b", "xlstm-1.3b"]
# The mLSTM's float32 gradient is ill-conditioned (h divides by
# max(|n.q|, exp(-m)), and |n.q| passes near 0): at the CPU preset an
# agent's gradient norm moves by up to 4.3e-4 relative when the parameters
# move by ~1 ulp, recurrentgemma's and olmo-1b's by under 1.5e-7
# (test_grad_norm_conditioning's readings).
# This test's xlstm grad norms read 4.2e-5 relative apart in round 0 (the
# same parameters), 1.4e-3 in round 1 and 1.06e-2 in round 3, while the
# losses and evals stay within 1.5e-5
GRAD_NORM_RTOL = {"xlstm-1.3b": 5e-2}


def _handover(arch):
    """init_panel_state for the port's launcher that hands the reference
    launcher's init (its seed-0 key) over."""
    ref_model = ref_build_model(ref_train.build_cpu_preset(
        ref_get_config(arch), AGENTS))
    ref_opt = ref_make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                                 total_steps=ROUNDS * H)

    def init(init_params, opt, m, gen, *, device, merger, wire, residency):
        rs, rspec = ref_dsgd.init_panel_state(
            ref_model.init_params, ref_opt, m, jax.random.PRNGKey(0),
            merger=merger, wire=wire, residency=residency)
        params, _, _ = from_reference_params(jax.tree.map(
            np.asarray, ref_panel.from_panel(rs["panel"], rspec)),
            device=device)
        return dsgd.panel_state_from_params(params, opt, wire=wire,
                                            merger=merger,
                                            residency=residency)
    return init


@pytest.fixture(scope="module", params=ARCHS)
def runs(request, tmp_path_factory):
    """(arch, {'ref': dir, 'port': dir}, the port's history): each dir holds
    the launcher's history JSON and merged.ckpt."""
    arch = request.param
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("ref", "port"):
            d = tmp_path_factory.mktemp(f"{name}_{arch}")
            out[name] = d
            flags = ARGS + ["--arch", arch, "--out", str(d),
                            "--save-merged", str(d / "merged.ckpt")]
            if name == "ref":
                mp.setattr(sys, "argv", ["train"] + flags)
                ref_train.main()
            else:
                mp.setattr(train.dsgd, "init_panel_state", _handover(arch))
                hist = train.main(flags + ["--device", "cpu"])
    return arch, out, hist


def _history(d, arch):
    with open(d / f"{arch}_final_merge_a0.1.json") as f:
        return json.load(f)["history"]


def test_history_matches_reference(runs):
    arch, dirs, hist = runs
    ref, port = _history(dirs["ref"], arch), _history(dirs["port"], arch)
    assert port == hist and len(port) == len(ref) == ROUNDS
    for r, p in zip(ref, port):
        assert sorted(r) == sorted(p)
        for k in r:
            if r[k] is None or isinstance(r[k], int):
                assert p[k] == r[k], k
            else:
                rtol = (GRAD_NORM_RTOL.get(arch, RTOL) if k == "grad_norm"
                        else RTOL)
                np.testing.assert_allclose(p[k], r[k], rtol=rtol, atol=ATOL,
                                           err_msg=f"round {r['round']} {k}")
    last = port[-1]
    assert last["consensus"] == 0.0
    assert abs(last["merged_eval"] - last["local_eval"]) <= 1e-6 * abs(
        last["merged_eval"])


def test_merged_blob_is_the_references_format(runs, tmp_path):
    arch, dirs, _ = runs
    cfg = train.build_cpu_preset(get_config(arch), AGENTS)
    like = build_model(cfg).init_params(None, "cpu")
    port_path = dirs["port"] / "merged.ckpt"
    merged = checkpoint.restore(str(port_path), like)
    as_np = tree_map(lambda t: t.numpy(), merged)
    ref_path = tmp_path / "ref_save.ckpt"
    ref_checkpoint.save(str(ref_path), as_np)
    assert port_path.read_bytes() == ref_path.read_bytes()

    ref_cfg = ref_train.build_cpu_preset(ref_get_config(arch), AGENTS)
    ref_like = ref_build_model(ref_cfg).init_params(jax.random.PRNGKey(1))
    in_ref = ref_checkpoint.restore(str(port_path), ref_like)
    leaves = jax.tree_util.tree_leaves(as_np)
    ref_leaves = jax.tree_util.tree_leaves(in_ref)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_serve_launcher_restores_the_blob(runs, capsys):
    arch, dirs, _ = runs
    path = str(dirs["port"] / "merged.ckpt")
    capsys.readouterr()
    out = serve_launch.main(["--arch", arch, "--restore", path, "--device",
                             "cpu", "--concurrency", "2", "--requests", "3",
                             "--prompt-len", "8", "--max-new", "3"])
    text = capsys.readouterr().out
    assert f"restored {path}" in text
    assert "serve end: 3 requests / 9 tokens" in text
    assert sorted(out) == [0, 1, 2]


@pytest.mark.parametrize("arch", ARCHS + ["olmo-1b"])
def test_grad_norm_conditioning(arch, capsys):
    """At the launcher's CPU preset (4 agents, batch 4 x 32) at init, each
    agent's first gradient norm, and how far 2 perturbations of the
    parameters by about one ulp (x (1 + 2e-7 N(0, 1))) move it, relative:
    within the tolerance this file holds the arch's grad norm to
    (GRAD_NORM_RTOL, else RTOL). The readings are printed."""
    import torch

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    cfg = train.build_cpu_preset(get_config(arch), AGENTS)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    lm = SyntheticLM(vocab=cfg.vocab_size, num_domains=8, seed=0)
    batches = train.sample_segment_batches(
        lm, lm.domain_mixtures(AGENTS, 0.1, seed=1), 1, 1, 4, 32,
        np.random.default_rng(2))
    leaves, skel = tree_flatten(params)
    gen = torch.Generator().manual_seed(5)

    def norm(ls, b):
        ls = [x.detach().clone().requires_grad_(True) for x in ls]
        loss, _ = model.loss_fn(tree_unflatten(skel, ls), b)
        g = torch.autograd.grad(loss, ls)
        return float(torch.sqrt(sum(torch.sum(x.double() ** 2) for x in g)))

    moved = []
    for a in range(AGENTS):
        b = {k: torch.from_numpy(np.asarray(v[0, 0, a]))
             for k, v in batches.items()}
        base = norm(leaves, b)
        assert np.isfinite(base) and base > 0
        moved += [abs(norm([x * (1 + 2e-7 * torch.randn(x.shape,
                                                         generator=gen))
                            for x in leaves], b) - base) / base
                  for _ in range(2)]
    with capsys.disabled():
        print(f"\n{arch}: grad norm's relative change under ~1 ulp, the "
              f"largest of {len(moved)}: {max(moved)!r}")
    assert max(moved) <= GRAD_NORM_RTOL.get(arch, RTOL)
