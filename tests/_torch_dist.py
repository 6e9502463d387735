"""Multi-rank runs of the port on the CPU for ``tests/test_torch_sharded.py``.

:func:`spawn` starts ``world`` processes of this file (gloo, a ``file://``
rendezvous in the test's tmp dir, so xdist workers cannot collide on a TCP
port), each with one intra-op thread, and waits for them with a timeout.
Each rank runs one mode and, where it has something to report, writes
``rank<r>.pt`` (a torch.save of a dict of tensors) into the tmp dir.
Rank 0 also runs the single-process counterpart of the same computation
in its own process (the same thread count and allocator), so a
comparison bit for bit is a comparison of two routes, not of two
processes. Imports no JAX.

Modes:
  ops      -- a seeded mixed-dtype panel (float32 2 x 3 x 17 = 102 columns,
              bfloat16 33: odd, so it stays whole on a 2-way fsdp axis) on
              the (1, 2, 2, 1) mesh: the sharded mix, mix with the folded
              mean, Xi from it, merged, consensus_distance, global_merge and
              global_merge_allreduce, gathered; rank 0 adds the
              single-process results;
  segment  -- a reduced() olmo-1b segment (4 agents, 3 rounds: a gossip
              round, an idle round, the final merge) with an extra unused
              bf16 leaf of 5 columns, sharded and on one process;
  launch   -- launch/train.py with the remaining arguments (every rank;
              the mesh comes from --mesh).
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def spawn(world, mode, tmp, args=(), timeout=120, check=True):
    """Run ``mode`` on ``world`` ranks; returns the CompletedProcess of
    each rank (stdout and stderr captured)."""
    os.makedirs(tmp, exist_ok=True)
    env = dict(os.environ)
    env.update({"WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
                "REPRO_TORCH_INIT_METHOD": f"file://{tmp}/rendezvous",
                "PYTHONPATH": SRC + os.pathsep + env.get("PYTHONPATH", ""),
                "OMP_NUM_THREADS": "1"})
    procs = []
    for r in range(world):
        e = dict(env, RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(tmp),
             *args], env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            out.append(subprocess.CompletedProcess(p.args, p.returncode, so,
                                                   se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if check:
        for r, p in enumerate(out):
            assert p.returncode == 0, f"rank {r}:\n{p.stdout}\n{p.stderr}"
    return out


def _mixed_panel(m=4, seed=0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    tree = {"w": torch.from_numpy(rng.standard_normal((m, 2, 3, 17))
                                  .astype(np.float32)),
            "emb": torch.from_numpy(rng.standard_normal((m, 33))
                                    .astype(np.float32)).to(torch.bfloat16)}
    return tree


def mode_ops(tmp):
    import numpy as np
    import torch
    from repro_torch.core import gossip, panel
    from repro_torch.core.topology import random_matching
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(agents=2, fsdp=2, model=1, device="cpu")
    tree = _mixed_panel()
    full_spec = panel.make_spec(tree)
    full = panel.to_panel(tree, full_spec)
    spec = panel.shard_spec(full_spec, mesh)
    local = panel.shard_panel(full, spec)
    W = random_matching(4, 0.9, np.random.default_rng(1)).astype(np.float32)
    out = {}

    def put(name, pan):
        for k, v in panel.gather_panel(pan, spec).items():
            out[f"{name}.{k}"] = v

    put("mix", panel.mix_dense(local, W, spec=spec))
    mixed, mean, _ = panel.mix_dense_mean(local, W, spec=spec)
    put("mixm", mixed)
    for k, v in mean.items():
        out[f"mean.{k}"] = panel.gather_cols(v, spec, k)
    out["xi_mean"] = panel.consensus_from_mean(mixed, mean, spec=spec)
    for k, v in panel.merged(local, spec=spec).items():
        out[f"merged.{k}"] = panel.gather_cols(v, spec, k)
    out["xi"] = panel.consensus_distance(local, spec=spec)
    put("gm", panel.global_merge(local, spec=spec))
    put("gm_bf16", panel.global_merge(local, spec=spec, wire_dtype="bfloat16"))
    put("mix_bf16", panel.mix_dense(local, W, spec=spec,
                                    wire_dtype="bfloat16"))
    out["spec"] = torch.tensor([list(spec.row_range(k)) + list(
        spec.col_range(k)) for k, _ in spec.groups])
    lo, hi = spec.row_range("float32")
    rows = {k: v[lo:hi] for k, v in tree.items()}
    for k, v in gossip.global_merge_allreduce(rows, mesh).items():
        out[f"gmar.{k}"] = v
    if mesh.rank == 0:
        out["single.mix"] = panel.mix_dense(full, W)
        m1, mu1, _ = panel.mix_dense_mean(full, W)
        out["single.mixm"], out["single.mean"] = m1, mu1
        out["single.xi_mean"] = panel.consensus_from_mean(m1, mu1)
        out["single.merged"] = panel.merged(full)
        out["single.xi"] = panel.consensus_distance(full)
        out["single.gm"] = panel.global_merge(full)
        out["single.gm_bf16"] = panel.global_merge(full,
                                                   wire_dtype="bfloat16")
        out["single.mix_bf16"] = panel.mix_dense(full, W,
                                                 wire_dtype="bfloat16")
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))


SEG_M, SEG_ROUNDS, SEG_H = 4, 3, 2


def _segment_parts():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.topology import random_matching
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import build_model
    cfg = get_config("olmo-1b").reduced()
    model = build_model(cfg)

    def init_params(gen, device):
        p = model.init_params(gen, device)
        p["aux"] = torch.randn(5, generator=gen, device=device).to(
            torch.bfloat16)
        return p

    def loss_fn(params, batch, rng):
        return model.loss_fn({k: v for k, v in params.items()
                              if k != "aux"}, batch, rng)

    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    batches = train.sample_segment_batches(
        lm, lm.domain_mixtures(SEG_M, 0.1, seed=1), SEG_ROUNDS, SEG_H, 2, 16,
        np.random.default_rng(2))
    Ws = np.stack([random_matching(SEG_M, 0.9, np.random.default_rng(0)),
                   np.eye(SEG_M), np.full((SEG_M, SEG_M), 1.0 / SEG_M)]
                  ).astype(np.float32)
    return cfg, init_params, loss_fn, batches, Ws


def mode_segment(tmp):
    import torch
    from repro_torch.core import dsgd, panel
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import make_optimizer
    mesh = make_debug_mesh(agents=2, fsdp=2, model=1, device="cpu")
    cfg, init_params, loss_fn, batches, Ws = _segment_parts()
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=SEG_ROUNDS * SEG_H)
    state, spec = dsgd.init_panel_state(init_params, opt, SEG_M, 0,
                                        mesh=mesh)
    seg = dsgd.make_panel_segment(loss_fn, opt, SEG_H, spec)
    state, mets = seg(state, batches, Ws)
    out = {f"met.{k}": v for k, v in mets.items()}
    for name, pan in (("panel", state["panel"]), ("m", state["opt"]["m"]),
                      ("v", state["opt"]["v"])):
        for k, v in panel.gather_panel(pan, spec).items():
            out[f"{name}.{k}"] = v
    out["pspecs"] = repr(spec.pspecs)
    if mesh.rank == 0:
        st1, spec1 = dsgd.init_panel_state(init_params, opt, SEG_M, 0,
                                           device="cpu")
        st1, mets1 = dsgd.make_panel_segment(loss_fn, opt, SEG_H, spec1)(
            st1, batches, Ws)
        out.update({f"single.met.{k}": v for k, v in mets1.items()})
        for name, pan in (("panel", st1["panel"]), ("m", st1["opt"]["m"]),
                          ("v", st1["opt"]["v"])):
            for k, v in pan.items():
                out[f"single.{name}.{k}"] = v
    torch.save(out, os.path.join(tmp, f"rank{mesh.rank}.pt"))


def mode_launch(tmp, *argv):
    from repro_torch.launch import train
    train.main(list(argv))


if __name__ == "__main__":
    import torch
    torch.set_num_threads(1)
    mode, tmp, rest = sys.argv[1], sys.argv[2], sys.argv[3:]
    {"ops": mode_ops, "segment": mode_segment,
     "launch": mode_launch}[mode](tmp, *rest)
