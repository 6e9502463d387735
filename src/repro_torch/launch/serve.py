"""Serve a (merged) model through the continuous-batching engine
(counterpart of ``repro/launch/serve.py``).

Heterogeneous-length requests streaming through slotted decode, on the CUDA
card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.serve --preset cpu \\
        --concurrency 4 --requests 8 --max-new 16 --device cpu [--stream]

optionally restoring the artifact produced by ``repro_torch.launch.train
--save-merged`` (or by the JAX package's launcher: the blob format is the
same) via ``--restore``. ``--one-shot`` runs the plain static batched
:func:`repro_torch.serving.generate` path instead.

The demo prompts are drawn with numpy from ``--seed`` (request i from the
generator seeded ``(seed, i)``), and so are the model's other inputs (the
vlm's patch prefix, the encoder-decoder's frames: ``request_inputs``):
``jax.random``'s bits, which the reference launcher draws them from,
cannot be reproduced, so the two launchers serve other inputs for the same
seed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.checkpoint import restore
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model, extra_inputs
from repro_torch.serving import Request, ServingEngine, generate


def request_tokens(cfg, seed: int, i: int, S: int) -> np.ndarray:
    """Demo request ``i``'s prompt: S ids in [0, vocab_size), from the numpy
    generator seeded (seed, i)."""
    rng = np.random.default_rng((seed, i))
    return rng.integers(0, cfg.vocab_size, size=S).astype(np.int32)


def request_inputs(cfg, seed: int, i: int, S: int):
    """Demo request ``i``'s prompt (``request_tokens``) and the model's
    other inputs (``extra_inputs``: the vlm's patch prefix, the
    encoder-decoder's S frames), float32 standard normals drawn in that
    order from the numpy generator seeded (seed, i, 1). Returns (tokens,
    extras)."""
    rng = np.random.default_rng((seed, i, 1))
    extras = {name: rng.standard_normal(shape, dtype=np.float32)
              for name, shape in extra_inputs(cfg, S).items()}
    return request_tokens(cfg, seed, i, S), extras


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="cpu", choices=["cpu", "pod"])
    ap.add_argument("--concurrency", type=int, default=4,
                    help="decode slots held live at once")
    ap.add_argument("--requests", type=int, default=8,
                    help="demo requests fed through the engine")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="longest demo prompt (half of them use len//2)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0,
                    help="slot length; 0 = prompt+mm_prefix+max_new")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop token (>=0 enables early slot retirement)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as slots emit them")
    ap.add_argument("--one-shot", action="store_true",
                    help="legacy path: one static generate() batch")
    ap.add_argument("--restore", default="",
                    help="checkpoint of the model's parameters (the "
                         "--save-merged artifact of either package's "
                         "train launcher)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the init, the prompts (numpy, per request; "
                         "not the reference's jax.random prompts) and the "
                         "sampling generator")
    ap.add_argument("--events", default="",
                    help="typed request-lifecycle JSONL event stream "
                         "(submit/admit/retire + serve_start/serve_end), "
                         "schema-validated at emit time")
    ap.add_argument("--profile", default="",
                    help="capture a torch.profiler trace of the serving "
                         "loop into this logdir (trace.json)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to "
                         "run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.preset == "cpu":
        cfg = cfg.reduced(d_model=128, layers=2, vocab=256)
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init_params(gen, device)
    if args.restore:
        params = restore(args.restore, params)
        print("restored", args.restore)
    sample_gen = torch.Generator(device=device).manual_seed(args.seed + 4)
    eos_id = args.eos_id if args.eos_id >= 0 else None

    if args.one_shot:
        B, S = args.requests, args.prompt_len
        inputs = [request_inputs(cfg, args.seed, i, S) for i in range(B)]
        batch = {"tokens": np.stack([t for t, _ in inputs])}
        for key in inputs[0][1]:
            batch[key] = np.stack([x[key] for _, x in inputs])
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        t0 = time.time()
        out = generate(model, params, batch, args.max_new,
                       temperature=args.temperature, rng=sample_gen,
                       eos_id=eos_id)
        dt = time.time() - t0
        print(f"generated {out.shape} in {dt:.2f}s "
              f"({B * args.max_new / dt:.1f} tok/s)")
        print(out[:2])
        return out

    # two prompt-length buckets
    lengths = [args.prompt_len, max(1, args.prompt_len // 2)]
    max_len = args.max_len or (args.prompt_len + max(0, cfg.mm_prefix)
                               + args.max_new)
    serve_cfg = {k: vars(args)[k] for k in (
        "arch", "preset", "concurrency", "requests", "prompt_len",
        "max_new", "temperature", "eos_id", "seed")}
    log = telemetry.EventLog(args.events or None,
                             run_id=telemetry.make_run_id(serve_cfg))
    log.emit("serve_start", run_id=log.run_id,
             schema=telemetry.SCHEMA_VERSION, config=serve_cfg)
    engine = ServingEngine(model, params, max_concurrency=args.concurrency,
                           max_len=max_len, eos_id=eos_id,
                           temperature=args.temperature, rng=sample_gen,
                           events=log)
    reqs = []
    for i in range(args.requests):
        toks, extras = request_inputs(cfg, args.seed, i,
                                      lengths[i % len(lengths)])
        reqs.append(Request(rid=i, tokens=toks, max_new=args.max_new,
                            extras=extras))
    stream_cb = ((lambda rid, t: print(f"  req {rid}: {t}"))
                 if args.stream else None)
    prof = telemetry.profile_trace(args.profile,
                                   enabled=bool(args.profile)).start()
    t0 = time.time()
    out = engine.serve(reqs, stream=stream_cb)
    dt = time.time() - t0
    prof.stop()
    n_tok = sum(len(v) for v in out.values())
    snap = engine.snapshot()
    print(telemetry.format_event(log.emit(
        "serve_end", requests=len(out), tokens=n_tok,
        ticks=snap["ticks"], occupancy=snap["occupancy"])), flush=True)
    lat = snap["latency"]
    print(f"  {n_tok / dt:.1f} tok/s | "
          f"ttft p50/p99 {lat['ttft_s']['p50_s'] * 1e3:.1f}/"
          f"{lat['ttft_s']['p99_s'] * 1e3:.1f} ms | queue p50 "
          f"{lat['queue_wait_s']['p50_s'] * 1e3:.1f} ms | decode step "
          f"p50 {lat['decode_step_s']['p50_s'] * 1e3:.1f} ms | per-token "
          f"p50 {lat['per_token_s']['p50_s'] * 1e3:.1f} ms")
    log.emit_op("serve_latency", **{k: lat[k] for k in lat})
    log.close()
    for rid in sorted(out)[:2]:
        print(f"req {rid}:", out[rid])
    if args.events:
        print(f"events: {args.events}")
    return out


if __name__ == "__main__":
    main()
