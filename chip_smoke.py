#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each printing its lines:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel of the port from the sources in this checkout
     (one nvcc per source, all started together);
  3. hold each kernel against its plain PyTorch version on the card, at odd
     widths and at the main path's own shapes, and time kernel, plain
     version, byte bound and the one PyTorch call that computes the same
     function where there is one (torch.matmul for the mix, on float32 and
     on bf16 operands, torch.quantize_per_channel and dequantize() for
     round-to-nearest int8; none for grouped int4, nibble packing or the
     merge operators' column merges); the TIES thresholds computed on the
     card equal the CPU's bit for bit; the residency kernels (grouped int8
     quantize and dequantize, the fused AdamW step on grouped-int8 moments,
     library torch.quantize_per_channel on the (m G, 128) view for the
     round-to-nearest pair); flash attention forward (float32, bfloat16)
     and backward at odd sizes, at the attn_block path's shape and at a GQA
     shape (library torch's scaled_dot_product_attention, is_causal; the
     bound of the kernels' split-TF32 tensor-core route, and the float32
     CUDA cores' figure in the text; each kernel's registers, local (spill)
     bytes and blocks per SM, checked for no spills and 8 warps an SM); the
     on-chip-seeded int8 quantize: its Philox4x32-10 against the toolkit's
     curand_Philox4x32_10 and the plain twin, the kernel bit for bit against
     its plain twin at odd widths and at the main shape, the mean of q s - x
     within 4 standard errors of 0, timed beside the pair it replaces
     (torch.rand of the uniform panel and the supplied-uniform quantize; no
     library call);
  4. a small run of the training segment on the card against the same run
     on the CPU (plain versions), from one init, one batch stream, one W
     stream: on the f32 wire, with topk, bf16 and a round-to-nearest int8_ef
     and int4_ef (the card's and the CPU's generators give other uniforms),
     under the weighted, var, fisher, ties and swa merge operators (ties
     also over the round-to-nearest int8_ef), and under residency policies
     (int8 moments fused and unfused, bf16, int8g, int8r statistics, an
     int8 error-feedback panel), with attn_block 8 (the blockwise
     attention route), and, at 8 agents and 4 rounds, under the fault plan
     FAULTS on the f32 wire, with --merge ties and with int8 moments fused
     and unfused (the dead rows bit for bit on each device);
  5. the main path: olmo-1b at full width cut to 2 layers, 8 agents, the
     final-merge schedule, through init_panel_state -> make_panel_segment
     -> merged and local eval on the f32 wire; then, on the trained state,
     each piece of a round timed on its own (the breakdown line);
  6. the elastic path: the main path's cell under the fault plan FAULTS
     (agent 2 dead in round 1 and rejoining in round 2, agent 5 dead from
     round 2: the final merge is over 7 agents), its dead row bit for bit,
     the live rows identical, the live Xi 0 and merged == live local eval;
     the wire paths: the same cell with --wire int8_ef, then int8_ef with
     the kernel's draws (an Int8Codec(draws="kernel") instance: the
     on-chip-seeded quantize, no uniform panel; its rounds and peak printed
     beside int8_ef's), int4_ef
     (stochastic rounding, error feedback), topk and bf16; then the merge
     paths: the same cell on the f32 wire with --merge var and --merge
     ties; then the residency paths: --residency moments=int8 with the
     fused moment update and with the unfused one, which must agree bit for
     bit, the fused one's peak at least 8 GB under the f32 path's (both
     count, after each local step, the entries whose decoded second moment
     is 0 under a nonzero first moment); then the attn_block 512 path: the
     f32 wire with cfg.dist.attn_block = 512 at batch 2, seq 2048 (the
     flash attention kernels, forward and backward, in every local step),
     and one agent's gradient through it against the dense route's;
  7. the tree path: the main path's cell (same init, batch stream and W
     stack) through the tree-state driver (dsgd.init_state ->
     make_dsgd_round, the per-leaf tensordot mix), each round's loss and
     grad norm against the main path's within TREE_RTOL; after the final
     merge consensus.consensus_distance (the reduce kernel) < 1e-3 and the
     merged eval (gossip.merged_model) within 1e-5 of the local eval; the
     state before the final merge merged by gossip_merge_rounds (3 rounds
     of the exponential graph: exactly 3 gossip_mix launches) within 1e-4
     of its max |theta| of gossip.merged_model of that state; its rounds
     and peak printed;
  each path of 5, 6 and 7 with the launch counts set to 0 just before it
  and read just after, and its peak device memory;
  8. the figure harness (repro_torch.bench.figures): its 8 functions on the
     card, their CSV lines, the reference tests' claims (Fig. 1's merge gain
     and local-only merge, Fig. 2c's gaps, App. C.3.4's 3-round gossip
     merge, Cor. D.2's bound, Table 1's finite ratio), and Fig. 1 on the
     CPU from the same init within 0.01 of the card's accuracies;
then the script's total time, a JSON line of per-kernel numbers, the
card's line again and, last, the result line. It fails (non-zero exit, no
result line) if there is no card, if the port's package is not beside it,
if a kernel does not build, launch or agree, or if any check fails.
Imports torch, numpy and the port only.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM published peaks (data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_SPLIT_FLOPS = 495e12 / 3  # TF32 tensor cores, 3 products a float32 one

M = 8                 # agents
ROUNDS, H = 4, 2      # rounds, local steps per round
BATCH, SEQ = 4, 512
DATA_VOCAB = 1024     # token ids the synthetic streams draw (of 50304)
REPS = 20             # timed launches per measurement
# the attn_block path's input: olmo-1b's context length, blocks of 512 keys
# (the dry-run's flashxla value: 4 key blocks a row)
ATTN_BLOCK, ATTN_BATCH, ATTN_SEQ = 512, 2, 2048

# the paths driven at full width (f32 is the main path) and the kernels
# each must launch; a path is a wire codec, "merge <operator>" on the f32
# wire, "residency int8" (--residency moments=int8 on the f32 wire, the
# fused moment update; "unfused" forces the read -> AdamW -> write path),
# "attn_block <n>" (the f32 wire with cfg.dist.attn_block = n: the
# blockwise attention route, at batch ATTN_BATCH and seq ATTN_SEQ),
# "faults" (the f32 wire under the fault plan FAULTS) or "int8_ef native"
# (int8_ef with the kernel's draws)
# the elastic path's fault plan (core.faults syntax, as --faults takes it)
FAULTS = "2@1-2;5@2"
# the tree path (the tree-state driver on the main path's cell) against the
# main path, round by round: the per-leaf sums of the grad norm run in
# another order than the panel's (loss and grad norm, relative)
TREE_RTOL = 1e-5

PATH_KERNELS = {"f32": ("gossip_mix", "panel_mean_consensus"),
                "faults": ("gossip_mix", "panel_mean_consensus"),
                "int8_ef": ("quantize_int8", "dequantize_int8", "gossip_mix"),
                "int8_ef native": ("quantize_int8_native", "dequantize_int8",
                                   "gossip_mix"),
                "topk": ("sparsify_topk", "gossip_mix",
                         "panel_mean_consensus"),
                "int4_ef": ("quantize_int4", "pack_int4", "unpack_int4",
                            "dequantize_int4", "gossip_mix"),
                "bf16": ("gossip_mix_bf16", "panel_mean_consensus"),
                "merge var": ("gossip_mix", "weighted_colmerge"),
                "merge ties": ("gossip_mix", "panel_mean_consensus",
                               "ties_colmerge"),
                "residency int8": ("adamw_fused_int8", "gossip_mix",
                                   "panel_mean_consensus"),
                "residency int8 unfused": ("dequantize_int8_grouped",
                                           "quantize_int8_grouped",
                                           "gossip_mix",
                                           "panel_mean_consensus"),
                f"attn_block {ATTN_BLOCK}": ("flash_attention_fwd",
                                             "flash_attention_bwd",
                                             "gossip_mix",
                                             "panel_mean_consensus"),
                # the tree-state driver: its rounds mix per leaf (no
                # kernel); the consensus and merged model after the merge
                # and the gossip merge of the pre-merge state launch these
                "tree": ("gossip_mix", "panel_mean_consensus")}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=REPS, warmup=3):
    """Median device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def kernel_checks(torch, D_main):
    """Phase 3, main-path kernels: the mix and the reduce against their
    plain versions; returns the per-kernel measurements at the main path's
    shapes."""
    import numpy as np
    from repro_torch.core.topology import random_matching
    from repro_torch.kernels.gossip_mix import gossip_mix
    from repro_torch.kernels.panel_reduce import panel_mean_consensus
    from repro_torch.kernels.ref import (gossip_mix_ref,
                                         panel_mean_consensus_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    err = {"gossip_mix": 0.0, "gossip_mix_bf16": 0.0,
           "panel_mean_consensus": 0.0}
    sq_rel = 0.0
    out = {}
    for D in (333, 1000, 1001, D_main):
        theta = torch.randn((M, D), generator=gen, device=dev)
        theta16 = theta.to(torch.bfloat16)
        W = torch.as_tensor(random_matching(M, 0.7, rng), dtype=torch.float32)
        Wm = torch.cat([W, torch.full((1, M), 1.0 / M)]).to(dev)
        for Wk in (W.to(dev), Wm):
            for name, t in (("gossip_mix", theta),
                            ("gossip_mix_bf16", theta16)):
                got, ref = gossip_mix(Wk, t), gossip_mix_ref(Wk, t)
                torch.cuda.synchronize()
                e = float(torch.max(torch.abs(got - ref)))
                check(got.dtype == torch.float32 and torch.equal(got, ref),
                      f"{name} disagrees at n={Wk.shape[0]}, D={D}: {e}")
                err[name] = max(err[name], e)
                del got, ref
        mean, sq = panel_mean_consensus(theta)
        rmean, rsq = panel_mean_consensus_ref(theta)
        torch.cuda.synchronize()
        e = float(torch.max(torch.abs(mean - rmean)))
        r = abs(float(sq) - float(rsq)) / abs(float(rsq))
        check(torch.allclose(mean, rmean, atol=1e-6, rtol=1e-6),
              f"panel_mean_consensus mean disagrees at D={D}: {e}")
        check(r <= 1e-5, f"panel_mean_consensus sq disagrees at D={D}: "
                         f"rel {r}")
        err["panel_mean_consensus"] = max(
            err["panel_mean_consensus"], e, abs(float(sq) - float(rsq)))
        sq_rel = max(sq_rel, r)
        print(f"check D={D}: gossip_mix max|err| {err['gossip_mix']:.3g} "
              f"(bf16 theta {err['gossip_mix_bf16']:.3g}), "
              f"panel_mean_consensus mean max|err| {e:.3g} sq rel {r:.3g}",
              flush=True)
        if D != D_main:
            continue
        # timings at the main path's shapes: the (m+1)-row folded mix of
        # a communicating round, the reduce of an idle round / the merge
        n = M + 1
        mix_bytes = 4 * (n * M + M * D + n * D)
        mix_ops = 2 * n * M * D
        red_bytes = 4 * (M * D + D + 1)
        red_ops = 5 * M * D
        ms = time_ms(torch, lambda: gossip_mix(Wm, theta))
        plain = time_ms(torch, lambda: gossip_mix_ref(Wm, theta))
        lib = time_ms(torch, lambda: torch.matmul(Wm, theta))
        b_ms, b_by = bound(mix_bytes, mix_ops)
        out["gossip_mix"] = {
            "ms": ms, "plain_ms": plain, "library_ms": lib,
            "bytes": mix_bytes, "ops": mix_ops, "bound_ms": b_ms,
            "bound_by": b_by}
        # the bf16 wire's mix: a bf16 theta, float32 rows out
        mix16_bytes = 2 * M * D + 4 * (n * M + n * D)
        b_ms, b_by = bound(mix16_bytes, mix_ops)
        Wm16 = Wm.to(torch.bfloat16)
        out["gossip_mix_bf16"] = {
            "ms": time_ms(torch, lambda: gossip_mix(Wm, theta16)),
            "plain_ms": time_ms(torch, lambda: gossip_mix_ref(Wm, theta16)),
            "library_ms": time_ms(torch, lambda: torch.matmul(Wm16,
                                                              theta16)),
            "bytes": mix16_bytes, "ops": mix_ops, "bound_ms": b_ms,
            "bound_by": b_by}
        ms = time_ms(torch, lambda: panel_mean_consensus(theta))
        plain = time_ms(torch, lambda: panel_mean_consensus_ref(theta))
        b_ms, b_by = bound(red_bytes, red_ops)
        out["panel_mean_consensus"] = {
            "ms": ms, "plain_ms": plain, "library_ms": None,
            "bytes": red_bytes, "ops": red_ops, "bound_ms": b_ms,
            "bound_by": b_by}
        for name, r_ in out.items():
            print(f"time {name} (m={M}, D={D}): kernel {r_['ms']:.4f} ms, "
                  f"plain {r_['plain_ms']:.4f} ms, library "
                  f"{r_['library_ms']} ms, bound {r_['bound_ms']:.4f} ms "
                  f"({r_['bytes']} bytes), {100 * r_['bound_ms'] / r_['ms']:.1f}"
                  f"% of the bound", flush=True)
        del theta, theta16
    out["gossip_mix"]["max_abs_err"] = err["gossip_mix"]
    out["gossip_mix_bf16"]["max_abs_err"] = err["gossip_mix_bf16"]
    out["panel_mean_consensus"]["max_abs_err"] = err["panel_mean_consensus"]
    out["panel_mean_consensus"]["sq_rel_err"] = sq_rel
    torch.cuda.empty_cache()
    return out


def bound(nbytes, ops, flops=FP32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak ``flops`` of the unit that runs them (the
    float32 CUDA cores unless said)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def wire_panel(torch, D, gen):
    """(x, u): an (M, D) float32 panel with an all-zero row (scale 1/127)
    and a row on exact half steps (amax 127/64, so its scale is 1/64 and
    x / s = k + 1/2: ties to even), and uniforms in [0, 1)."""
    dev = torch.device("cuda")
    x = torch.randn((M, D), generator=gen, device=dev)
    x[1] = 0.0
    k = torch.randint(-127, 127, (D,), generator=gen, device=dev)
    x[2] = (k.to(torch.float32) + 0.5) / 64
    x[2, 0] = 127 / 64
    return x, torch.rand((M, D), generator=gen, device=dev)


def library_quantize(torch, x, s):
    """torch.quantize_per_channel on the card (round to nearest against the
    per-row scale) -> (qtensor, None), or (None, reason) if it does not run
    there."""
    try:
        zp = torch.zeros((x.shape[0],), dtype=torch.int64, device=x.device)
        qt = torch.quantize_per_channel(x, s[:, 0], zp, 0, torch.qint8)
        qt.dequantize()
        torch.cuda.synchronize()
        return qt, None
    except (RuntimeError, NotImplementedError) as exc:
        return None, f"{type(exc).__name__}: {str(exc).splitlines()[0]}"


def wire_checks(torch, D_main):
    """Phase 3, wire kernels: quantize (stochastic and round to nearest),
    dequantize and sparsify against their plain versions (max |err| must
    be 0); times at the main path's shape m = 8, D = D_main."""
    from repro_torch.kernels.ref import (dequantize_int8_ref, int8_scale_ref,
                                         quantize_int8_ref, sparsify_topk_ref,
                                         topk_threshold_ref)
    from repro_torch.kernels.wire_quant import (dequantize_int8,
                                                quantize_int8, sparsify_topk)
    from repro_torch.wire import CODECS
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for D in (333, 1000, 1001, D_main):
        x, u = wire_panel(torch, D, gen)
        s = int8_scale_ref(x)
        check(float(s[1, 0]) == float(torch.tensor(1.0) / 127.0)
              and float(s[2, 0]) == 1 / 64, "wire test panel scales")
        q = {}
        for name, uu in (("sr", u), ("rtn", None)):
            q[name] = quantize_int8(x, s, uu)
            ref = quantize_int8_ref(x, s, uu)
            torch.cuda.synchronize()
            check(torch.equal(q[name], ref),
                  f"quantize_int8 ({name}) disagrees at D={D}: max|err| "
                  f"{int(torch.max(torch.abs(q[name].int() - ref.int())))}")
            del ref
        check(bool(torch.all(q["rtn"][2, 1:] % 2 == 0)),
              "round to nearest did not take the half steps to even")
        y, ref = dequantize_int8(q["sr"], s), dequantize_int8_ref(q["sr"], s)
        torch.cuda.synchronize()
        check(torch.equal(y, ref), f"dequantize_int8 disagrees at D={D}")
        del y, ref
        t = (CODECS["topk"]._threshold(x) if D == D_main
             else topk_threshold_ref(x, max(1, D // 8)))
        y, ref = sparsify_topk(x, t), sparsify_topk_ref(x, t)
        torch.cuda.synchronize()
        check(torch.equal(y, ref), f"sparsify_topk disagrees at D={D}")
        del y, ref
        print(f"check D={D}: quantize_int8 (stochastic, round to nearest), "
              f"dequantize_int8, sparsify_topk max|err| 0", flush=True)
        if D != D_main:
            continue
        n, m4 = M * D, 4 * M  # elements; bytes of the (m, 1) scale column
        cases = {
            "quantize_int8": (lambda: quantize_int8(x, s, u),
                              lambda: quantize_int8_ref(x, s, u),
                              9 * n + m4, 5 * n),
            "quantize_int8_rtn": (lambda: quantize_int8(x, s),
                                  lambda: quantize_int8_ref(x, s),
                                  5 * n + m4, 4 * n),
            "dequantize_int8": (lambda: dequantize_int8(q["sr"], s),
                                lambda: dequantize_int8_ref(q["sr"], s),
                                5 * n + m4, 2 * n),
            "sparsify_topk": (lambda: sparsify_topk(x, t),
                              lambda: sparsify_topk_ref(x, t),
                              8 * n + m4, 2 * n)}
        for name, (fn, plain, nbytes, ops) in cases.items():
            b_ms, b_by = bound(nbytes, ops)
            out[name] = {"ms": time_ms(torch, fn),
                         "plain_ms": time_ms(torch, plain),
                         "library_ms": None, "bytes": nbytes, "ops": ops,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "max_abs_err": 0.0}
            torch.cuda.empty_cache()
        qt, why = library_quantize(torch, x, s)
        if qt is None:
            print(f"library: torch.quantize_per_channel does not run on the "
                  f"card ({why}); library_ms null for quantize_int8_rtn "
                  f"and dequantize_int8", flush=True)
        else:
            out["quantize_int8_rtn"]["library_ms"] = time_ms(
                torch, lambda: torch.quantize_per_channel(
                    x, s[:, 0], torch.zeros((M,), dtype=torch.int64,
                                            device=x.device), 0,
                    torch.qint8))
            out["dequantize_int8"]["library_ms"] = time_ms(
                torch, lambda: qt.dequantize())
        del qt
        for name, r_ in out.items():
            print(f"time {name} (m={M}, D={D}): kernel {r_['ms']:.4f} ms, "
                  f"plain {r_['plain_ms']:.4f} ms, library "
                  f"{r_['library_ms']} ms, bound {r_['bound_ms']:.4f} ms "
                  f"({r_['bytes']} bytes), "
                  f"{100 * r_['bound_ms'] / r_['ms']:.1f}% of the bound",
                  flush=True)
        del x, u, q, s, t
    torch.cuda.empty_cache()
    return out


# Random123 kat_vectors, philox4x32 10: (counter, key, output words)
PHILOX_KAT = [((0, 0, 0, 0), (0, 0),
               (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
              ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
               (0xa4093822, 0x299f31d0),
               (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]


def philox_checks(torch, gen):
    """The native quantize's Philox4x32-10 (wire_native.cu) against the CUDA
    toolkit's curand_Philox4x32_10 (csrc/philox_check.cu) and the plain
    twin, on the known-answer pairs and 4096 random pairs, bit for bit."""
    import ctypes

    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import philox4x32_ref
    from repro_torch.kernels.wire_quant import philox4x32
    dev = torch.device("cuda")
    n = 4096
    ctr = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 4), generator=gen,
                        dtype=torch.int32, device=dev)
    key = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 2), generator=gen,
                        dtype=torch.int32, device=dev)
    for i, (c, k, _) in enumerate(PHILOX_KAT):
        ctr[i] = torch.from_numpy(np.array(c, np.uint32).view(np.int32))
        key[i] = torch.from_numpy(np.array(k, np.uint32).view(np.int32))
    ours = philox4x32(ctr, key)
    lib = build.load("philox_check", {"curand_philox4x32_10_u32": (
        ctypes.c_int, [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                               ctypes.c_void_p])})
    theirs = torch.empty_like(ours)
    rc = lib.curand_philox4x32_10_u32(
        ctr.data_ptr(), key.data_ptr(), theirs.data_ptr(), n,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    check(rc == 0, f"curand_Philox4x32_10 launch failed: CUDA error {rc}")
    c64, k64 = (t.cpu().long() & 0xFFFFFFFF for t in (ctr, key))
    plain = torch.stack(philox4x32_ref((k64[:, 0], k64[:, 1]), tuple(
        c64[:, j] for j in range(4))), 1)
    words = [[int(w) & 0xFFFFFFFF for w in theirs[i].tolist()]
             for i in range(len(PHILOX_KAT))]
    print(f"philox: the kernel's Philox4x32-10 == curand_Philox4x32_10 on "
          f"{n} pairs: {torch.equal(ours, theirs)}; == the plain twin: "
          f"{torch.equal(plain, ours.cpu().long() & 0xFFFFFFFF)}; toolkit on "
          f"the known-answer pairs {[[hex(w) for w in r] for r in words]}",
          flush=True)
    check(torch.equal(ours, theirs),
          "the kernel's Philox4x32-10 disagrees with curand_Philox4x32_10")
    check(torch.equal(plain, ours.cpu().long() & 0xFFFFFFFF),
          "the kernel's Philox4x32-10 disagrees with its plain twin")
    check(words == [list(o) for _, _, o in PHILOX_KAT],
          "the toolkit's Philox4x32-10 disagrees with the known answers")


def native_checks(torch, D_main):
    """Phase 3, the on-chip-seeded int8 quantize: the generator
    (philox_checks), the kernel bit for bit against its plain twin at odd
    widths (several seeds) and at the main path's shape, the mean of
    q s - x over the full panel within 4 standard errors of 0; times at
    m = 8, D = D_main: the kernel, its plain twin (median of 3), and the
    pair it replaces, torch.rand of the (m, D) uniforms plus the
    supplied-uniform quantize (and torch.rand alone). No PyTorch call
    quantizes with in-kernel draws: library_ms null."""
    from repro_torch.kernels.ref import (int8_scale_ref,
                                         quantize_int8_native_ref)
    from repro_torch.kernels.wire_quant import (quantize_int8,
                                                quantize_int8_native)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    philox_checks(torch, gen)
    out = {}
    for D in (1, 3, 511, 513, 4097, D_main):
        x, _ = wire_panel(torch, D, gen)
        s = int8_scale_ref(x)
        seeds = (0, -1, 2 ** 31 - 1, 12345) if D != D_main else (987654321,)
        for sd in seeds:
            seed = torch.tensor([sd], dtype=torch.int32, device=dev)
            q = quantize_int8_native(x, s, seed)
            ref = quantize_int8_native_ref(x, s, seed)
            torch.cuda.synchronize()
            check(torch.equal(q, ref),
                  f"quantize_int8_native disagrees at D={D}, seed {sd}: "
                  f"max|err| {int(torch.max(torch.abs(q.int() - ref.int())))}")
            del ref
        print(f"check D={D}: quantize_int8_native max|err| 0 (seeds "
              f"{list(seeds)})", flush=True)
        if D != D_main:
            continue
        # E[q s] = x: the rounding error's mean over the panel, against its
        # standard error (float64 sums a row at a time)
        tot = sq = 0.0
        for r in range(M):
            e = (q[r].double() * s[r].double() - x[r].double())
            tot += float(e.sum())
            sq += float((e * e).sum())
            del e
        n = M * D
        mean = tot / n
        se = math.sqrt(max(sq / n - mean * mean, 0.0) / n)
        print(f"quantize_int8_native unbiased (m={M}, D={D}): mean of q s - x "
              f"{mean:.3e}, standard error {se:.3e}, "
              f"{abs(mean) / se:.2f} of them", flush=True)
        check(abs(mean) <= 4 * se, f"quantize_int8_native is biased: mean "
                                   f"{mean} over a standard error {se}")
        quads = -(-D // 4)
        nbytes = 5 * n + 4 * M + 4  # x in, q out, the scales, the seed
        ops = 8 * n + 98 * M * quads  # quantize + u; Philox per 4 columns
        b_ms, b_by = bound(nbytes, ops)
        out["quantize_int8_native"] = {
            "ms": time_ms(torch, lambda: quantize_int8_native(x, s, seed)),
            "plain_ms": time_ms(torch, lambda: quantize_int8_native_ref(
                x, s, seed), reps=3, warmup=1),
            "library_ms": None, "bytes": nbytes, "ops": ops,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0}
        out["quantize_int8_native"]["supplied"] = {
            "rand_and_quantize_ms": time_ms(torch, lambda: quantize_int8(
                x, s, torch.rand((M, D), generator=gen, device=dev))),
            "rand_ms": time_ms(torch, lambda: torch.rand(
                (M, D), generator=gen, device=dev))}
        r_ = out["quantize_int8_native"]
        print(f"time quantize_int8_native (m={M}, D={D}): kernel "
              f"{r_['ms']:.4f} ms, plain {r_['plain_ms']:.4f} ms, library "
              f"None, bound {r_['bound_ms']:.4f} ms ({nbytes} bytes, {ops} "
              f"operations), {100 * r_['bound_ms'] / r_['ms']:.1f}% of the "
              f"bound; the pair it replaces: torch.rand + quantize_int8 "
              f"{r_['supplied']['rand_and_quantize_ms']:.4f} ms (torch.rand "
              f"alone {r_['supplied']['rand_ms']:.4f} ms)", flush=True)
        del x, q, s
    torch.cuda.empty_cache()
    return out


def int4_panel(torch, D, gen, group=128):
    """(x, u): an (M, D) float32 panel with an all-zero row (scale 1/7)
    and a row on exact half steps (every group's amax is 7/64, so its scale
    is 1/64 and x / s = k + 1/2: ties to even), and uniforms in [0, 1)."""
    dev = torch.device("cuda")
    x = torch.randn((M, D), generator=gen, device=dev)
    x[1] = 0.0
    k = torch.randint(-7, 7, (D,), generator=gen, device=dev)
    x[2] = (k.to(torch.float32) + 0.5) / 64
    x[2, ::group] = 7 / 64
    return x, torch.rand((M, D), generator=gen, device=dev)


def int4_checks(torch, D_main):
    """Phase 3, int4 kernels: quantize (stochastic and round to nearest),
    pack, unpack and dequantize against their plain versions (max |err|
    must be 0), unpack(pack(q)) == q; times at m = 8, D = D_main. No single
    PyTorch call computes grouped int4 or packs nibbles: library_ms null."""
    from repro_torch.kernels.ref import (div_exact, dequantize_int4_ref,
                                         int4_group_scale_ref, pack_int4_ref,
                                         quantize_int4_ref, unpack_int4_ref)
    from repro_torch.kernels.wire_quant import (dequantize_int4, pack_int4,
                                                quantize_int4, unpack_int4)
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for D in (333, 1000, 1001, D_main):
        x, u = int4_panel(torch, D, gen)
        s = int4_group_scale_ref(x)
        G = s.shape[1]
        check(G == -(-D // 128) and bool(torch.all(s[1] == s[1, 0]))
              and float(s[1, 0]) == float(torch.tensor(1.0) / 7.0)
              and bool(torch.all(s[2] == 1 / 64)), "int4 test panel scales")
        q = {}
        for name, uu in (("sr", u), ("rtn", None)):
            q[name] = quantize_int4(x, s, uu)
            ref = quantize_int4_ref(x, s, uu)
            torch.cuda.synchronize()
            check(torch.equal(q[name], ref),
                  f"quantize_int4 ({name}) disagrees at D={D}: max|err| "
                  f"{int(torch.max(torch.abs(q[name].int() - ref.int())))}")
            del ref
        ties = torch.ones(D, dtype=torch.bool, device=x.device)
        ties[::128] = False
        check(bool(torch.all(q["rtn"][2][ties] % 2 == 0))
              and bool(torch.all(q["rtn"][1] == 0)),
              "round to nearest did not take the half steps to even")
        p = pack_int4(q["sr"])
        check(p.shape == (M, (D + 1) // 2)
              and torch.equal(p, pack_int4_ref(q["sr"])),
              f"pack_int4 disagrees at D={D}")
        back = unpack_int4(p, D)
        check(torch.equal(back, unpack_int4_ref(p, D)),
              f"unpack_int4 disagrees at D={D}")
        check(torch.equal(back, q["sr"]), f"unpack(pack(q)) != q at D={D}")
        y = dequantize_int4(back, s)
        check(torch.equal(y, dequantize_int4_ref(back, s)),
              f"dequantize_int4 disagrees at D={D}")
        torch.cuda.synchronize()
        del back, y
        print(f"check D={D}: quantize_int4 (stochastic, round to nearest), "
              f"pack_int4, unpack_int4, dequantize_int4 max|err| 0; "
              f"unpack(pack(q)) == q", flush=True)
        if D != D_main:
            continue
        # the scales on the card equal the CPU's bit for bit: PyTorch's CUDA
        # division by a Python scalar multiplies by the reciprocal instead
        check(torch.equal(s.cpu(), int4_group_scale_ref(x.cpu())),
              "int4 group scales on the card differ from the CPU's")
        amax = torch.linalg.vector_norm(x.view(M, G, 128), ord=float("inf"),
                                        dim=2)
        off = int(torch.sum(amax / 7.0 != div_exact(amax, 7.0)))
        print(f"scales: card == CPU; dividing the {amax.numel()} group "
              f"maxima by the Python scalar 7.0 instead would put {off} an "
              f"ulp off", flush=True)
        del amax
        n, sb = M * D, 4 * M * G  # elements; bytes of the grouped scales
        qs = q["sr"]
        cases = {
            "quantize_int4": (lambda: quantize_int4(x, s, u),
                              lambda: quantize_int4_ref(x, s, u),
                              9 * n + sb, 5 * n),
            "quantize_int4_rtn": (lambda: quantize_int4(x, s),
                                  lambda: quantize_int4_ref(x, s),
                                  5 * n + sb, 4 * n),
            "dequantize_int4": (lambda: dequantize_int4(qs, s),
                                lambda: dequantize_int4_ref(qs, s),
                                5 * n + sb, 2 * n),
            "pack_int4": (lambda: pack_int4(qs), lambda: pack_int4_ref(qs),
                          n + M * ((D + 1) // 2), 3 * n),
            "unpack_int4": (lambda: unpack_int4(p, D),
                            lambda: unpack_int4_ref(p, D),
                            n + M * ((D + 1) // 2), 3 * n)}
        for name, (fn, plain, nbytes, ops) in cases.items():
            b_ms, b_by = bound(nbytes, ops)
            out[name] = {"ms": time_ms(torch, fn),
                         "plain_ms": time_ms(torch, plain),
                         "library_ms": None, "bytes": nbytes, "ops": ops,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "max_abs_err": 0.0}
            torch.cuda.empty_cache()
            r_ = out[name]
            print(f"time {name} (m={M}, D={D}): kernel {r_['ms']:.4f} ms, "
                  f"plain {r_['plain_ms']:.4f} ms, library none, bound "
                  f"{r_['bound_ms']:.4f} ms ({nbytes} bytes), "
                  f"{100 * r_['bound_ms'] / r_['ms']:.1f}% of the bound",
                  flush=True)
        del qs, cases
        del x, u, q, s, p
    torch.cuda.empty_cache()
    return out


def merge_checks(torch, D_main):
    """Phase 3, merge kernels: the weighted and the TIES column merge
    (trim 0.2 and 1.0) against their plain versions (max |err| must be 0),
    the TIES thresholds on the card against the CPU's (bit for bit); times
    at m = 8, D = D_main. No single PyTorch call computes either column
    merge: library_ms null."""
    from repro_torch.kernels.merge_ops import ties_colmerge, weighted_colmerge
    from repro_torch.kernels.ref import (ties_colmerge_ref, ties_thresh_ref,
                                         weighted_colmerge_ref)
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for D in (333, 1000, 1001, D_main):
        x = torch.randn((M, D), generator=gen, device="cuda")
        w = torch.rand((M, D), generator=gen, device="cuda").add_(1e-3)
        got = weighted_colmerge(x, w)
        check(torch.equal(got, weighted_colmerge_ref(x, w)),
              f"weighted_colmerge disagrees at D={D}")
        del got
        if D == D_main:
            nbytes, ops = 4 * (2 * M * D + D), 3 * M * D
            b_ms, b_by = bound(nbytes, ops)
            out["weighted_colmerge"] = {
                "ms": time_ms(torch, lambda: weighted_colmerge(x, w)),
                "plain_ms": time_ms(torch,
                                    lambda: weighted_colmerge_ref(x, w)),
                "library_ms": None, "bytes": nbytes, "ops": ops,
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0}
        del w
        tau = x - torch.mean(x, dim=0)
        del x
        secs = {}
        for trim in (0.2, 1.0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            th = ties_thresh_ref(tau, trim)
            torch.cuda.synchronize()
            secs[trim] = time.perf_counter() - t0
            check(torch.equal(th.cpu(), ties_thresh_ref(tau.cpu(), trim)),
                  f"TIES thresholds (trim {trim}) on the card differ from "
                  f"the CPU's at D={D}")
            got = ties_colmerge(tau, th)
            check(torch.equal(got, ties_colmerge_ref(tau, th)),
                  f"ties_colmerge (trim {trim}) disagrees at D={D}")
            del got
        print(f"check D={D}: weighted_colmerge, ties_colmerge (trim 0.2, "
              f"1.0) max|err| 0; TIES thresholds card == CPU, "
              f"{secs[0.2]:.3f} s / {secs[1.0]:.3f} s on the card for "
              f"{M} rows", flush=True)
        if D == D_main:
            # why the thresholds sort on the card: one row's order
            # statistic by torch.kthvalue against one torch.sort
            mag = torch.abs(tau[0])
            sel = {}
            for name, fn in (("kthvalue", lambda: torch.kthvalue(
                    mag, int(0.8 * D)).values),
                             ("sort", lambda: torch.sort(mag).values)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                sel[name] = time.perf_counter() - t0
            del mag
            print(f"one row of |tau| (D={D}): torch.kthvalue "
                  f"{sel['kthvalue']:.3f} s, torch.sort {sel['sort']:.3f} s "
                  f"on the card", flush=True)
            th = ties_thresh_ref(tau, 0.2)
            nbytes, ops = 4 * (M * D + M + D), 8 * M * D
            b_ms, b_by = bound(nbytes, ops)
            out["ties_colmerge"] = {
                "ms": time_ms(torch, lambda: ties_colmerge(tau, th)),
                "plain_ms": time_ms(torch,
                                    lambda: ties_colmerge_ref(tau, th)),
                "library_ms": None, "bytes": nbytes, "ops": ops,
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0,
                "thresholds_s": secs[0.2]}
            for name in ("weighted_colmerge", "ties_colmerge"):
                r_ = out[name]
                print(f"time {name} (m={M}, D={D}): kernel {r_['ms']:.4f} "
                      f"ms, plain {r_['plain_ms']:.4f} ms, library none, "
                      f"bound {r_['bound_ms']:.4f} ms ({r_['bytes']} "
                      f"bytes), {100 * r_['bound_ms'] / r_['ms']:.1f}% of "
                      f"the bound", flush=True)
        del tau
    torch.cuda.empty_cache()
    return out


def residency_panel(torch, m, D, group, gen):
    """(x, u): an (m, D) float32 panel whose row 1 starts with an all-zero
    group (scale 1/127) and whose row 2 lies on exact half steps (every
    group's amax is 127/64, so its scale is 1/64 and x / s = k + 1/2: ties
    to even), and uniforms in [0, 1)."""
    x = torch.randn((m, D), generator=gen, device="cuda")
    if m > 1:
        x[1, :group] = 0.0
    if m > 2:
        k = torch.randint(-127, 127, (D,), generator=gen, device="cuda")
        x[2] = (k.to(torch.float32) + 0.5) / 64
        x[2, ::group] = 127 / 64
    return x, torch.rand((m, D), generator=gen, device="cuda")


def fused_inputs(torch, m, D, group, gen):
    """The fused step's inputs: gradients, parameters, companded grouped
    int8 moments (m of both signs, v positive; row 1's first group of m and
    of the gradient all zero, so its new m is a zero group), uniforms, and
    per-agent lr / bc1 / bc2 columns (rows at different step counts)."""
    from repro_torch.residency import Int8Storage
    st = Int8Storage("check", group=group, transform="sqrt")
    dev = "cuda"
    g = torch.randn((m, D), generator=gen, device=dev).mul_(0.1)
    p = torch.randn((m, D), generator=gen, device=dev)
    x = torch.randn((m, D), generator=gen, device=dev).mul_(1e-2)
    if m > 1:
        x[1, :group] = 0.0
        g[1, :group] = 0.0
    mom = st.init(x)
    torch.square(torch.randn((m, D), generator=gen, device=dev), out=x)
    vel = st.init(x.mul_(1e-4))
    del x
    um = torch.rand((m, D), generator=gen, device=dev)
    uv = torch.rand((m, D), generator=gen, device=dev)
    c = torch.arange(1, m + 1, dtype=torch.float32, device=dev)[:, None]
    cols = (torch.full((m, 1), 3e-3, device=dev),
            1 - torch.pow(torch.tensor(0.9, device=dev), c),
            1 - torch.pow(torch.tensor(0.999, device=dev), c))
    return (g, p, mom["q"], mom["scale"], vel["q"], vel["scale"], um, uv,
            *cols)


def residency_checks(torch, D_main):
    """Phase 3, residency kernels: the grouped int8 quantize (stochastic
    and round to nearest) and dequantize, and the fused AdamW step, against
    their plain versions (max |err| 0; for the fused step p, both q and
    both scales equal) at D = 333, 1000, 1001 and D_main, groups 128 and
    32, m = 8 (and m = 1, 16 at D = 1001), with an all-zero group and a
    slab launched in place; card scales == CPU scales. At D_main the fused
    step is held against its plain version a slab of 2^22 columns at a
    time. Times at m = 8, D = D_main, group 128 (the int8 storage's):
    library torch.quantize_per_channel on the (m G, 128) view and its
    dequantize() for the round-to-nearest pair, none for the stochastic
    quantize or the fused step."""
    from repro_torch.kernels.ref import (dequantize_int8_grouped_ref,
                                         int8_group_scale_ref,
                                         quantize_int8_grouped_ref)
    from repro_torch.kernels.wire_quant import (dequantize_int8_grouped,
                                                quantize_int8_grouped)
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    cases = [(M, 333), (M, 1000), (M, 1001), (1, 1001), (16, 1001),
             (M, D_main)]
    for group in (128, 32):
        for m, D in cases:
            x, u = residency_panel(torch, m, D, group, gen)
            s = int8_group_scale_ref(x, group)
            if D != D_main or group == 128:
                check(torch.equal(s.cpu(), int8_group_scale_ref(x.cpu(),
                                                                group)),
                      f"int8 group scales on the card differ from the "
                      f"CPU's at m={m}, D={D}, group {group}")
            check(m < 2 or float(s[1, 0]) == float(torch.tensor(1.0)
                                                   / 127.0),
                  "the all-zero group's scale is not 1/127")
            q = {}
            for name, uu in (("sr", u), ("rtn", None)):
                q[name] = quantize_int8_grouped(x, s, uu, group)
                ref = quantize_int8_grouped_ref(x, s, uu, group)
                torch.cuda.synchronize()
                check(torch.equal(q[name], ref),
                      f"quantize_int8_grouped ({name}) disagrees at m={m}, "
                      f"D={D}, group {group}")
                del ref
            if m > 2:
                ties = torch.ones(D, dtype=torch.bool, device="cuda")
                ties[::group] = False
                check(bool(torch.all(q["rtn"][2][ties] % 2 == 0)),
                      "round to nearest did not take the half steps to even")
            y = dequantize_int8_grouped(q["sr"], s, group)
            check(torch.equal(y, dequantize_int8_grouped_ref(q["sr"], s,
                                                             group)),
                  f"dequantize_int8_grouped disagrees at m={m}, D={D}, "
                  f"group {group}")
            del y
            if D < D_main:  # a slab of a wider panel, launched in place
                lo = group
                qs = torch.zeros_like(q["sr"])
                quantize_int8_grouped(x[:, lo:], s[:, 1:], u[:, lo:], group,
                                      out=qs[:, lo:])
                ys = torch.zeros_like(x)
                dequantize_int8_grouped(q["sr"][:, lo:], s[:, 1:], group,
                                        out=ys[:, lo:])
                torch.cuda.synchronize()
                check(torch.equal(qs[:, lo:], q["sr"][:, lo:])
                      and torch.equal(ys[:, lo:], dequantize_int8_grouped_ref(
                          q["sr"], s, group)[:, lo:]),
                      f"a slab launched in place disagrees at D={D}")
            if D == D_main and group == 128:
                n, sb = m * D, 4 * m * s.shape[1]
                qsr = q["sr"]
                timed = {
                    "quantize_int8_grouped": (
                        lambda: quantize_int8_grouped(x, s, u),
                        lambda: quantize_int8_grouped_ref(x, s, u),
                        9 * n + sb, 5 * n),
                    "quantize_int8_grouped_rtn": (
                        lambda: quantize_int8_grouped(x, s),
                        lambda: quantize_int8_grouped_ref(x, s),
                        5 * n + sb, 4 * n),
                    "dequantize_int8_grouped": (
                        lambda: dequantize_int8_grouped(qsr, s),
                        lambda: dequantize_int8_grouped_ref(qsr, s),
                        5 * n + sb, 2 * n)}
                for name, (fn, plain, nbytes, ops) in timed.items():
                    b_ms, b_by = bound(nbytes, ops)
                    out[name] = {"ms": time_ms(torch, fn),
                                 "plain_ms": time_ms(torch, plain),
                                 "library_ms": None, "bytes": nbytes,
                                 "ops": ops, "bound_ms": b_ms,
                                 "bound_by": b_by, "max_abs_err": 0.0}
                    torch.cuda.empty_cache()
                # the library yardstick: one scale per 128-column row of the
                # (m G, 128) view (D is a whole number of groups here)
                check(D % 128 == 0, f"D={D} is not a whole number of groups")
                xv = x.view(-1, 128)
                zp = torch.zeros((xv.shape[0],), dtype=torch.int64,
                                 device="cuda")
                qt, why = library_quantize(torch, xv, s.reshape(-1, 1))
                if qt is None:
                    print(f"library: torch.quantize_per_channel does not "
                          f"run on the card ({why})", flush=True)
                else:
                    out["quantize_int8_grouped_rtn"]["library_ms"] = time_ms(
                        torch, lambda: torch.quantize_per_channel(
                            xv, s.reshape(-1), zp, 0, torch.qint8))
                    out["dequantize_int8_grouped"]["library_ms"] = time_ms(
                        torch, lambda: qt.dequantize())
                del qt, xv, zp, qsr, timed
            del x, u, q, s
            torch.cuda.empty_cache()
            fused_check(torch, m, D, group, gen, D_main, out)
            print(f"check m={m} D={D} group {group}: quantize_int8_grouped "
                  f"(stochastic, round to nearest), dequantize_int8_grouped, "
                  f"adamw_fused_int8 max|err| 0", flush=True)
    for name, r_ in out.items():
        print(f"time {name} (m={M}, D={D_main}, group 128): kernel "
              f"{r_['ms']:.4f} ms, plain {r_['plain_ms']:.4f} ms, library "
              f"{r_['library_ms']} ms, bound {r_['bound_ms']:.4f} ms "
              f"({r_['bytes']} bytes), "
              f"{100 * r_['bound_ms'] / r_['ms']:.1f}% of the bound",
              flush=True)
    torch.cuda.empty_cache()
    return out


def fused_check(torch, m, D, group, gen, D_main, out):
    """The fused step on the card against its plain version: one launch
    over the whole panel (on copies: the kernel works in place), then the
    plain version a slab at a time (all of D at once would need some 26 GB
    more); below D_main also a slab launched in place. At D_main, group
    128, times it (the plain version over its slabs, median of 5)."""
    from repro_torch.kernels.opt_fused import adamw_fused_int8 as kernel
    from repro_torch.kernels.ref import adamw_fused_int8_ref as plain
    from repro_torch.optim import make_optimizer
    from repro_torch.residency import SLAB as slab
    hp = make_optimizer("adamw", 3e-3, weight_decay=5e-4).hparams
    args = fused_inputs(torch, m, D, group, gen)
    g, p, qm, sm, qv, sv, um, uv, lr, bc1, bc2 = args
    kw = dict(group=group, transform="sqrt", **hp)
    got = [t.clone() for t in (p, qm, sm, qv, sv)]
    kernel(g, got[0], got[1], got[2], got[3], got[4], um, uv, lr, bc1, bc2,
           **kw)
    torch.cuda.synchronize()
    step = slab if D == D_main else max(group, (D // 3) // group * group)
    for lo in range(0, D, step):
        cs = slice(lo, min(lo + step, D))
        gs = slice(lo // group, -(-cs.stop // group))
        want = plain(g[:, cs], p[:, cs], qm[:, cs], sm[:, gs], qv[:, cs],
                     sv[:, gs], um[:, cs], uv[:, cs], lr, bc1, bc2, **kw)
        for a, b, sl in zip(got, want, (cs, cs, gs, cs, gs)):
            check(torch.equal(a[:, sl], b),
                  f"adamw_fused_int8 disagrees at m={m}, D={D}, group "
                  f"{group}, columns {lo}:{cs.stop}")
        if m > 1 and lo == 0:
            check(float(want[2][1, 0]) == float(torch.tensor(1.0) / 127.0),
                  "the fused step's all-zero group is not at scale 1/127")
        del want
    if D < D_main:  # the slab from the second group on, in place
        ins = [t.clone() for t in (p, qm, sm, qv, sv)]
        ins_s = [ins[0][:, group:], ins[1][:, group:], ins[2][:, 1:],
                 ins[3][:, group:], ins[4][:, 1:]]
        kernel(g[:, group:], *ins_s[:2], ins_s[2], ins_s[3], ins_s[4],
               um[:, group:], uv[:, group:], lr, bc1, bc2, **kw)
        want = plain(g[:, group:], p[:, group:], qm[:, group:], sm[:, 1:],
                     qv[:, group:], sv[:, 1:], um[:, group:], uv[:, group:],
                     lr, bc1, bc2, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(ins_s, want))
              and torch.equal(ins[0][:, :group], p[:, :group]),
              f"the fused step on a slab disagrees at m={m}, D={D}")
    if D == D_main and group == 128:
        n, G = m * D, sm.shape[1]
        nbytes, ops = 24 * n + 16 * m * G, 38 * n
        b_ms, b_by = bound(nbytes, ops)

        def plain_all():
            for lo in range(0, D, slab):
                cs = slice(lo, min(lo + slab, D))
                gs = slice(lo // group, -(-cs.stop // group))
                plain(g[:, cs], p[:, cs], qm[:, cs], sm[:, gs], qv[:, cs],
                      sv[:, gs], um[:, cs], uv[:, cs], lr, bc1, bc2, **kw)

        out["adamw_fused_int8"] = {
            "ms": time_ms(torch, lambda: kernel(
                g, got[0], got[1], got[2], got[3], got[4], um, uv, lr, bc1,
                bc2, **kw)),
            "plain_ms": time_ms(torch, plain_all, reps=5, warmup=1),
            "library_ms": None, "bytes": nbytes, "ops": ops,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0}
    del args, g, p, qm, sm, qv, sv, um, uv, got
    torch.cuda.empty_cache()


def visible_pairs(S, causal, window):
    """The (query, key) pairs a causal and/or windowed mask lets through
    over positions 0 .. S-1: what the attention kernels' work is counted
    on."""
    n = 0
    for i in range(S):
        lo = 0 if window is None else max(0, i - window + 1)
        n += (i if causal else S - 1) - lo + 1
    return n


def flash_checks(torch):
    """Phase 3, flash attention: first each kernel's resources at hd 128
    (registers and local (spill) bytes from the runtime's function
    attributes, blocks per SM from its occupancy calculator), which must
    show no local memory and at least 8 warps an SM; then the forward kernel (float32 and bfloat16)
    and the backward kernels against their plain versions (the online loop,
    and torch autograd through it) at odd sizes (S = 100, hd 64 and 128, a
    window, GQA) and at the attn_block path's shape (B 2, S 2048, H 16, hd
    128) and a GQA one (H 32 on Kv 8). Tolerances: float32 output and lse
    2e-5, gradients 1e-4, bfloat16 output 2e-2 (other summation orders).
    Times at the path's shape: kernel, plain version, the bound on the
    kernels' split-TF32 route (three TF32 products a float32 operation over
    the visible pairs at the tensor cores' 495 TFLOP/s, or the bytes if
    larger; the share printed is of it; beside it, for continuity, the
    float32 operations at the CUDA cores' 67 TFLOP/s) and torch's scaled_dot_product_attention(is_causal=True) on the same
    float32 tensors, forward, and its backward on a retained graph."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd,
                                                     occupancy)
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_fwd_ref)
    F = torch.nn.functional
    for name, r in occupancy(128, ATTN_SEQ).items():
        print(f"flash attention {name} at hd 128: {r['registers']} "
              f"registers, {r['local_bytes']} B local (spills) a thread, "
              f"{r['blocks_per_sm']} blocks ({4 * r['blocks_per_sm']} warps) "
              f"per SM, {r['smem']} B shared memory", flush=True)
        check(r["registers"] > 0 and r["local_bytes"] == 0
              and 4 * r["blocks_per_sm"] >= 8,
              f"flash attention {name} at hd 128 spills or runs under 8 "
              f"warps an SM: {r}")
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(6)
    err = {"fwd": 0.0, "fwd_bf16": 0.0, "bwd": 0.0}
    out = {}
    # (B, S, H, Kv, hd, window, dtype)
    cases = [(2, 100, 4, 2, 64, None, torch.float32),
             (1, 100, 2, 2, 128, 48, torch.float32),
             (2, 100, 4, 2, 64, None, torch.bfloat16),
             (1, 100, 2, 1, 128, 48, torch.bfloat16),
             (ATTN_BATCH, ATTN_SEQ, 16, 16, 128, None, torch.float32),
             (ATTN_BATCH, ATTN_SEQ, 32, 8, 128, None, torch.float32)]
    for B, S, Hq, Kv, hd, window, dtype in cases:
        q = torch.randn((B, S, Hq, hd), generator=gen, device=dev)
        k = torch.randn((B, S, Kv, hd), generator=gen, device=dev)
        v = torch.randn((B, S, Kv, hd), generator=gen, device=dev)
        do = torch.randn((B, S, Hq, hd), generator=gen, device=dev)
        pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        kw = dict(causal=True, window=window)
        bf16 = dtype == torch.bfloat16
        qc, kc, vc = (t.to(dtype) for t in (q, k, v))
        o, lse = flash_attention_fwd(qc, kc, vc, pos, pos, **kw)
        ro, rlse = flash_attention_fwd_ref(qc, kc, vc, pos, pos, **kw)
        torch.cuda.synchronize()
        tol = 2e-2 if bf16 else 2e-5
        e = float(torch.max(torch.abs(o.float() - ro.float())))
        el = float(torch.max(torch.abs(lse - rlse)))
        label = (f"B={B} S={S} H={Hq} Kv={Kv} hd={hd} window={window} "
                 f"{str(dtype)[6:]}")
        check(o.dtype == dtype
              and torch.allclose(o.float(), ro.float(), atol=tol, rtol=tol)
              and torch.allclose(lse, rlse, atol=tol, rtol=tol),
              f"flash_attention_fwd disagrees at {label}: {e}, lse {el}")
        key = "fwd_bf16" if bf16 else "fwd"
        err[key] = max(err[key], e)
        line = (f"check flash attention {label}: forward max|err| {e:.3g} "
                f"(lse {el:.3g})")
        del ro, rlse
        if not bf16:
            g = flash_attention_bwd(q, k, v, o, lse, do, pos, pos, **kw)
            rg = flash_attention_bwd_ref(q, k, v, do, pos, pos, **kw)
            torch.cuda.synchronize()
            eb = max(float(torch.max(torch.abs(a - b)))
                     for a, b in zip(g, rg))
            rel = max(float(torch.linalg.vector_norm(a - b)
                            / torch.linalg.vector_norm(b))
                      for a, b in zip(g, rg))
            check(all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                      for a, b in zip(g, rg)),
                  f"flash_attention_bwd disagrees at {label}: {eb}")
            err["bwd"] = max(err["bwd"], eb)
            line += f"; backward max|err| {eb:.3g} (rel l2 {rel:.3g})"
            del g, rg
        print(line, flush=True)
        if S == ATTN_SEQ and Hq == 16:
            pairs = visible_pairs(S, True, window)
            n_q, n_kv, rows = B * S * Hq * hd, B * S * Kv * hd, B * Hq * S
            cost = {"flash_attention_fwd": (
                        4 * (2 * n_q + 2 * n_kv + rows) + 8 * B * S,
                        4 * hd * pairs * B * Hq),
                    "flash_attention_bwd": (
                        4 * (4 * n_q + 4 * n_kv + rows) + 8 * B * S,
                        10 * hd * pairs * B * Hq)}
            timed = {"flash_attention_fwd": (
                         lambda: flash_attention_fwd(q, k, v, pos, pos),
                         lambda: flash_attention_fwd_ref(q, k, v, pos, pos)),
                     "flash_attention_bwd": (
                         lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                     pos, pos),
                         lambda: flash_attention_bwd_ref(q, k, v, do, pos,
                                                         pos))}
            for name, (fn, plain) in timed.items():
                nbytes, ops = cost[name]
                b_ms, b_by = bound(nbytes, ops, TF32_SPLIT_FLOPS)
                out[name] = {"ms": time_ms(torch, fn),
                             "plain_ms": time_ms(torch, plain, reps=5,
                                                 warmup=1),
                             "library_ms": None, "bytes": nbytes, "ops": ops,
                             "bound_ms": b_ms, "bound_by": b_by}
            # the library yardstick, in its (B, H, S, hd) layout
            ql, kl, vl = (t.transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            dol = do.transpose(1, 2).contiguous()
            try:
                lo = F.scaled_dot_product_attention(ql, kl, vl,
                                                    is_causal=True)
                out["flash_attention_fwd"]["library_ms"] = time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        ql, kl, vl, is_causal=True))
                out["flash_attention_bwd"]["library_ms"] = time_ms(
                    torch, lambda: torch.autograd.grad(
                        lo, (ql, kl, vl), dol, retain_graph=True))
                del lo
            except (RuntimeError, NotImplementedError) as exc:
                print(f"library: scaled_dot_product_attention does not run "
                      f"on float32 here ({type(exc).__name__}: "
                      f"{str(exc).splitlines()[0]})", flush=True)
            del ql, kl, vl, dol
            for name, r_ in out.items():
                print(f"time {name} (B={B}, S={S}, H={Hq}, hd={hd}, causal): "
                      f"kernel {r_['ms']:.4f} ms, plain {r_['plain_ms']:.4f} "
                      f"ms, library {r_['library_ms']} ms; bound "
                      f"{r_['bound_ms']:.4f} ms ({r_['bound_by']}: 3 TF32 "
                      f"products for each of {r_['ops']} float32 operations "
                      f"at 495 TFLOP/s), {100 * r_['bound_ms'] / r_['ms']:.1f}"
                      f"% of it; on the float32 CUDA cores (67 TFLOP/s) "
                      f"{1e3 * r_['ops'] / FP32_FLOPS:.4f} ms", flush=True)
        del q, k, v, do, qc, kc, vc, o, lse
        torch.cuda.empty_cache()
    out["flash_attention_fwd"]["max_abs_err"] = err["fwd"]
    out["flash_attention_fwd"]["max_abs_err_bf16"] = err["fwd_bf16"]
    out["flash_attention_bwd"]["max_abs_err"] = err["bwd"]
    return out


def segment_inputs(cfg, m, rounds, seed=0, data_vocab=None, batch=BATCH,
                   seq=SEQ, faults=None):
    """(W, batches, global, live) per round as the launcher draws them
    (schedule first; ``global`` is the schedule's own mark of a global
    round; under the fault plan ``faults`` W is degraded and ``live`` the
    round's (1, m) trits, else None)."""
    import numpy as np
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.schedule import make_schedule
    from repro_torch.data.synthetic import SyntheticLM, make_agent_lm_batches
    from repro_torch.launch.train import sample_segment_batches
    kw = {} if faults is None else {"faults": FaultPlan.parse(m, faults)}
    sched = make_schedule("final_merge", m, rounds, prob=0.2, seed=seed,
                          **kw)
    lm = SyntheticLM(vocab=data_vocab or cfg.vocab_size, num_domains=8,
                     seed=seed)
    mixtures = lm.domain_mixtures(m, 0.1, seed=seed + 1)
    rng_np = np.random.default_rng(seed + 2)
    per_round = []
    for t in range(rounds):
        W = np.asarray(sched.mixing_matrix(t), np.float32)[None]
        glob = np.asarray([sched.last_kind == "global"])
        live = (None if sched.last_live is None
                else np.asarray(sched.last_live)[None])
        per_round.append((W, sample_segment_batches(
            lm, mixtures, 1, H, batch, seq, rng_np), glob, live))
    glob_mix = np.ones(lm.num_domains) / lm.num_domains
    eval_batch = {k: v[0] for k, v in make_agent_lm_batches(
        lm, [glob_mix], 2 * batch, seq, np.random.default_rng(999)).items()}
    return per_round, eval_batch


def small_parity(torch):
    """Phase 4: the reduced olmo-1b segment on the card (kernels) against
    the same segment on the CPU (plain versions), on the f32 wire, with
    topk, bf16 and a round-to-nearest int8_ef and int4_ef, under every
    non-uniform merge operator (ties also over the round-to-nearest
    int8_ef), under residency policies: int8 moments fused and unfused,
    bf16 and int8g moments, int8r statistics under var, an int8
    error-feedback panel under the round-to-nearest int8_ef; and with
    attn_block 8 (the flash attention kernels on the card, the plain online
    loop on the CPU)."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import dsgd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import build_cpu_preset
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.wire import Int4Codec, Int8Codec
    cfg = build_cpu_preset(get_config("olmo-1b"), 4)
    per_round, _ = segment_inputs(cfg, 4, 3, batch=4, seq=32)
    int8_rtn = {"float32": Int8Codec("int8_ef", stochastic=False,
                                     error_feedback=True)}
    # label: (wire, merge operator)
    cases = {"f32": (None, None), "topk": ("topk", None),
             "bf16": ("bf16", None),
             "int8_ef round to nearest": (int8_rtn, None),
             "int4_ef round to nearest": ({"float32": Int4Codec(
                 "int4_ef", stochastic=False, error_feedback=True)}, None),
             "merge weighted": (None, "weighted"),
             "merge var": (None, "var"), "merge fisher": (None, "fisher"),
             "merge ties": (None, "ties"), "merge swa": (None, "swa"),
             "merge ties, int8_ef round to nearest": (int8_rtn, "ties")}
    # label: (wire, merge operator, residency policy, fused); the card's
    # and the CPU's generators give the stochastic storages other uniforms
    cases = {k: v + (None, None) for k, v in cases.items()}
    cases.update({
        "residency moments=int8 fused": (None, None, "moments=int8", True),
        "residency moments=int8 unfused": (None, None, "moments=int8",
                                           False),
        "residency moments=bf16": (None, None, "moments=bf16", None),
        "residency moments=int8g": (None, None, "moments=int8g", None),
        "residency stats=int8r, merge var": (None, "var", "stats=int8r",
                                             None),
        "residency wire_err=int8, int8_ef round to nearest": (
            int8_rtn, None, "wire_err=int8", None)})
    # label: (..., attn_block, fault plan); the elastic cases at 8 agents
    # and 4 rounds (the plan names agent 5)
    cases = {k: v + (0, None) for k, v in cases.items()}
    cases["attn_block 8"] = (None, None, None, None, 8, None)
    cases.update({
        f"faults {FAULTS}": (None, None, None, None, 0, FAULTS),
        f"faults {FAULTS}, merge ties": (None, "ties", None, None, 0, FAULTS),
        f"faults {FAULTS}, residency moments=int8 fused": (
            None, None, "moments=int8", True, 0, FAULTS),
        f"faults {FAULTS}, residency moments=int8 unfused": (
            None, None, "moments=int8", False, 0, FAULTS)})
    cfg8 = build_cpu_preset(get_config("olmo-1b"), M)
    per_round8, _ = segment_inputs(cfg8, M, ROUNDS, batch=4, seq=32,
                                   faults=FAULTS)
    for label, (wire, merger, res, fused, block, plan) in cases.items():
        m, c, rounds = (4, cfg, per_round) if plan is None else (
            M, cfg8, per_round8)
        model = build_model(c.replace(dist=dataclasses.replace(
            c.dist, attn_block=block)))
        runs, same = {}, {}
        reset_launch_counts()
        for dev in ("cpu", "cuda"):
            opt = make_optimizer("adamw", 3e-3, total_steps=3 * H)
            state, spec = dsgd.init_panel_state(model.init_params, opt, m, 0,
                                                device="cpu", wire=wire,
                                                merger=merger, residency=res)
            state = {k: tree_to(v, dev) for k, v in state.items()}
            seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec,
                                          fused=fused)
            rows, before = [], []
            for W, b, glob, live in rounds:
                before.append(agent_rows(state))
                state, mets = seg(state, b, W, 0, global_rounds=glob,
                                  live=live)
                rows.append([float(mets["loss"][0]),
                             float(mets["consensus"][0])])
            runs[dev] = np.asarray(rows)
            alive = None if plan is None else rounds[-1][3][0] == 1
            same[dev] = rows_identical(torch, state["panel"], alive)
            if plan is not None:
                # agent 2 dead in round 1, agent 5 from round 2 on
                after = agent_rows(state)
                check(tree_equal(torch, agent_rows_of(before[2], 2),
                                 agent_rows_of(before[1], 2))
                      and tree_equal(torch, agent_rows_of(after, 5),
                                     agent_rows_of(before[2], 5)),
                      f"{label} on {dev}: a dead agent's rows changed")
        # rtol 1e-3: cuBLAS and the CPU's GEMMs sum in other orders, and six
        # AdamW steps amplify float32 rounding (elements with |g| near eps)
        ok = np.allclose(runs["cuda"], runs["cpu"], rtol=1e-3, atol=1e-5)
        print(f"small parity {label} (reduced olmo-1b, {m} agents, "
              f"{len(rounds)} rounds): "
              f"cuda {runs['cuda'].tolist()} cpu {runs['cpu'].tolist()}; "
              f"rows identical after the final merge: {same}", flush=True)
        check(ok, f"the {label} segment on the card disagrees with the CPU")
        check(not block or min(launch_counts()["flash_attention_fwd"],
                               launch_counts()["flash_attention_bwd"]) > 0,
              f"the {label} segment on the card ran no flash attention "
              f"kernel: {launch_counts()}")
        # bf16 rounds the merged rows through bf16 while the folded mean
        # stays float32 (the reference's rule): its Xi reports that rounding
        check(all(same.values()) and (label == "bf16"
                                      or runs["cuda"][-1, 1] == 0.0),
              f"{label}: Xi after the final merge is not 0")


def agent_rows(state):
    """Copies of every agent's parameter and moment rows (stored q and
    scale bits included) of a state, on the CPU."""
    from repro_torch.core import dsgd
    mom = {k: v for k, v in state["opt"].items() if k != "step_count"}
    return tree_to(dsgd._take_rows({"panel": state["panel"], "opt": mom},
                                   slice(None)), "cpu")


def agent_rows_of(rows, r):
    """Agent r's rows out of :func:`agent_rows`."""
    if isinstance(rows, dict):
        return {k: agent_rows_of(v, r) for k, v in rows.items()}
    return rows[r]


def tree_equal(torch, a, b):
    """Two trees of tensors bit for bit (compared as integers of their
    width, so -0.0 is not 0.0 and a NaN equals its own bits)."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(tree_equal(torch, a[k], b[k])
                                        for k in a)
    as_int = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(as_int[a.element_size()]), b.view(as_int[b.element_size()])))


def tree_to(tree, dev):
    """A state's tensors (nested dicts of them) moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev) if hasattr(tree, "to") else tree


def drive_path(torch, path):
    """Phases 5 and 6: olmo-1b at full width, 2 layers, 8 agents, the
    final-merge schedule, through init_panel_state -> make_panel_segment
    -> merged and local eval. ``path`` is the wire codec of the gossip
    payload (``f32`` is the main path, as the launcher's default), or
    ``merge <operator>``: the f32 wire with that merge operator on the
    global round (the segment told which round is global, as the launcher
    tells it). The launch counts are set to 0 just before and read just
    after; the main path then times each piece of a round (breakdown).
    ``residency int8`` keeps its moments as companded grouped int8 (the
    launcher's --residency moments=int8), updated by the fused kernel, or
    with `` unfused`` through the storage's read, AdamW and write; after
    each local step it counts the entries whose decoded second moment is 0
    while the first moment is not (plain versions: no launch is counted).
    ``attn_block <n>`` runs the blockwise attention route at batch
    ATTN_BATCH, seq ATTN_SEQ, then holds one agent's gradient through it
    against the dense route's. ``faults`` runs the f32 wire under the fault
    plan FAULTS (the schedule's degraded W and live trits, as the
    launcher's --faults): the dead agent 5's parameter and moment rows
    after the last round equal their copy after round 1 bit for bit, the 7
    live rows are identical after the final merge, the live Xi reads 0.0,
    and the merged eval (the live agents) equals the live local eval.
    ``int8_ef native`` is int8_ef with an Int8Codec(draws="kernel")
    instance: the on-chip-seeded quantize in every communicating round and
    the supplied-uniform one never. Returns (counts, record): the per-round
    losses, Xi and times, the peak, the evals and, on a residency path, the
    final state's panels and moments and the per-step counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import dsgd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import eval_local, eval_merged, to_device
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.telemetry.metrics import (fused_moments_auto,
                                               resident_bytes_model)
    from repro_torch.wire import Int8Codec
    dev = torch.device("cuda")
    cfg = get_config("olmo-1b").replace(num_layers=2)
    batch, seq = BATCH, SEQ
    if path.startswith("attn_block "):
        cfg = cfg.replace(dist=dataclasses.replace(
            cfg.dist, attn_block=int(path.split()[1])))
        batch, seq = ATTN_BATCH, ATTN_SEQ
    model = build_model(cfg)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=ROUNDS * H)
    plan = FAULTS if path == "faults" else None
    per_round, eval_batch = segment_inputs(cfg, M, ROUNDS,
                                           data_vocab=DATA_VOCAB,
                                           batch=batch, seq=seq, faults=plan)
    eval_batch = to_device(eval_batch, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    wire, merger, res, fused = path, None, None, None
    if path.startswith("merge "):
        wire, merger = None, path.split()[1]
    elif path.startswith("residency "):
        wire, res = None, "moments=" + path.split()[1]
        fused = False if path.endswith(" unfused") else None
    elif path.startswith("attn_block ") or path == "faults":
        wire = "f32"
    elif path == "int8_ef native":
        wire = Int8Codec("int8_ef", error_feedback=True, draws="kernel")
    reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(0)
    state, spec = dsgd.init_panel_state(model.init_params, opt, M, gen,
                                        device=dev, wire=wire, merger=merger,
                                        residency=res)
    zero_v, after_step = [], None
    if res:
        moments = dsgd._res_plan(spec)["moments"]

        def after_step(step, opt_state):
            zero_v.append(zero_v_count(torch, opt_state, moments))

    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec, fused=fused,
                                  after_step=after_step)
    wire_gen = torch.Generator(device=dev).manual_seed(3)
    print(f"path {path}: {cfg.name} d_model {cfg.d_model}, {cfg.num_layers} "
          f"layers, vocab {cfg.vocab_size} padded to {cfg.padded_vocab}, "
          f"D {spec.width} per agent, m {M}, H {H}, batch {batch}, seq "
          f"{seq}, attn_block {cfg.dist.attn_block}; device memory held "
          f"before the path {held} bytes; "
          f"{spec.wire_payload_bytes} B/agent payload "
          f"({spec.wire_total_bytes} B with scales/indices) per full-panel "
          f"exchange; merge operator {spec.merger}", flush=True)
    active = fused_moments_auto(spec, opt) if fused is None else fused
    rb = resident_bytes_model(spec, opt, fused=active)
    print(f"residency {res or 'f32'} ({path}): {rb['total']} B/agent "
          f"resident (params {rb['params']}, moments {rb['moments']}, "
          f"wire_err {rb['wire_err']}, merge_stat {rb['merge_stat']}); peak "
          f"{rb['peak']} B/agent (+{rb['transient_bytes']} transient); fused "
          f"moments {'on' if active else 'off'}", flush=True)
    losses, gnorms, xis, times, dead_row = [], [], [], [], None
    for t, (W, b, glob, live) in enumerate(per_round):
        t0 = time.perf_counter()
        state, mets = seg(state, b, W, wire_gen, global_rounds=glob,
                          live=live)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        losses.append(float(mets["loss"][0]))
        gnorms.append(float(mets["grad_norm"][0]))
        xis.append(float(mets["consensus"][0]))
        kind = ("idle" if (W[0] == torch.eye(M).numpy()).all() else
                "merge" if glob[0] else "mix")
        trits = "" if live is None else f", live {live[0].tolist()}"
        print(f"round {t} ({kind}{trits}, {path}): loss {losses[-1]:.6f} Xi "
              f"{xis[-1]!r} {dt:.3f}s; device memory peak so far "
              f"{torch.cuda.max_memory_allocated()} bytes, held "
              f"{torch.cuda.memory_allocated()}", flush=True)
        if plan is not None and t == 1:
            # agent 5 is dead from round 2 on: its rows from here
            dead_row = dsgd._take_rows(
                {"panel": state["panel"], "m": state["opt"]["m"],
                 "v": state["opt"]["v"]}, [5])
    alive = None if plan is None else per_round[-1][3][0] == 1
    t0 = time.perf_counter()
    merged = eval_merged(model.loss_fn, state["panel"], spec, eval_batch,
                         state.get("merge_stat"), live=alive)
    local = eval_local(model.loss_fn, state["panel"], spec, eval_batch,
                       live=alive)
    torch.cuda.synchronize()
    dt_eval = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    same = rows_identical(torch, state["panel"], alive)
    print(f"kernels ({path}) {json.dumps(counts)}", flush=True)
    print(f"eval ({path}): merged {merged!r} local {local!r} "
          f"({dt_eval:.3f}s for both); peak device memory {peak} bytes; "
          f"after the final merge the rows are identical: {same}, Xi "
          f"reported {xis[-1]!r}", flush=True)
    check(all(counts[k] > 0 for k in PATH_KERNELS[path]),
          f"a kernel of the {path} path never launched: {counts}")
    if plan is not None:
        kept = tree_equal(torch, dead_row, dsgd._take_rows(
            {"panel": state["panel"], "m": state["opt"]["m"],
             "v": state["opt"]["v"]}, [5]))
        print(f"faults ({FAULTS}): the dead agent 5's parameter and moment "
              f"rows after round 3 equal their copy after round 1 bit for "
              f"bit: {kept}; live agents after the final merge "
              f"{alive.tolist()}", flush=True)
        check(kept, "faults: the dead agent's rows changed")
        del dead_row
    if path == "int8_ef native":
        comm = sum(not (W[0] == torch.eye(M).numpy()).all()
                   for W, *_ in per_round)
        check(counts["quantize_int8_native"] == comm == counts[
            "dequantize_int8"] and counts["quantize_int8"] == 0,
              f"{path}: {comm} communicating rounds but launches {counts}")
    check(same, f"{path}: the agents' rows differ after the final merge")
    # bf16 rounds the merged rows through bf16 while the folded mean stays
    # float32 (the reference's rule): the segment's Xi is that rounding
    check(xis[-1] == 0.0 or wire == "bf16",
          f"{path}: Xi after the final merge is {xis[-1]!r}, not 0")
    check(all(math.isfinite(x) for x in losses + [merged, local]),
          f"{path}: a loss is not finite")
    check(abs(local - merged) <= 1e-6 * abs(merged),
          f"{path}: local eval {local!r} != merged eval {merged!r}")
    if path == "f32" or cfg.dist.attn_block:
        breakdown(torch, model, opt, state, spec, per_round[0], path)
    record = {"losses": losses, "grad_norms": gnorms, "xis": xis,
              "peak": peak, "width": spec.width,
              "merged": merged, "local": local, "times": times}
    if cfg.dist.attn_block:
        check(counts["flash_attention_bwd"] == ROUNDS * H * M * cfg.num_layers
              and counts["flash_attention_fwd"] >= counts[
                  "flash_attention_bwd"],
              f"{path}: flash attention launches {counts} are not one "
              f"forward and one backward per layer, agent and local step "
              f"(plus the evals' forwards)")
        record["grad_rel_l2"] = grad_route_check(torch, cfg, state, spec,
                                                 per_round[0])
    if res:  # kept for the fused == unfused comparison
        print(f"int8 moments ({path}): entries with a decoded second moment "
              f"of 0 under a nonzero first moment, per local step, of "
              f"{M * spec.width}: {zero_v}", flush=True)
        record["panel"] = state["panel"]
        record["opt"] = state["opt"]
        record["zero_v"] = zero_v
    del state, seg
    torch.cuda.empty_cache()
    return counts, record


def drive_tree_path(torch, main):
    """Phase 7: the main path's cell (olmo-1b at full width, 2 layers, 8
    agents, AdamW, H local steps, the final-merge schedule; the same init,
    batch stream and W stack) through the tree-state driver: dsgd.init_state
    -> make_dsgd_round, whose rounds mix per leaf (torch.tensordot, no
    kernel). Each round's loss and grad norm against the main path's record
    ``main`` within TREE_RTOL; after the final merge the consensus of the
    tree state (consensus.consensus_distance: the reduce kernel) < 1e-3, its
    exact value printed, and the merged eval (gossip.merged_model) within
    1e-5 of the mean local eval; then the state before the final merge
    merged by gossip_merge_rounds over log2(M) rounds of the exponential
    graph (the gossip_mix kernel, one launch a round) against
    gossip.merged_model of that state, max |err| <= 1e-4 max |theta|. The
    launch counts are set to 0 just before and read just after. Returns
    (counts, record)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import consensus, dsgd, gossip, topology
    from repro_torch.core.merge import gossip_merge_rounds
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import to_device
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten
    dev = torch.device("cuda")
    cfg = get_config("olmo-1b").replace(num_layers=2)
    model = build_model(cfg)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=ROUNDS * H)
    per_round, eval_batch = segment_inputs(cfg, M, ROUNDS,
                                           data_vocab=DATA_VOCAB)
    eval_batch = to_device(eval_batch, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(0)
    state = dsgd.init_state(lambda g: model.init_params(g, dev), opt, M, gen)
    width = sum(x[0].numel() for x in tree_flatten(state["params"])[0])
    round_fn = dsgd.make_dsgd_round(model.loss_fn, opt, H)
    n_leaves = len(tree_flatten(state["params"])[0])
    print(f"path tree: {cfg.name} d_model {cfg.d_model}, {cfg.num_layers} "
          f"layers, D {width} per agent as {n_leaves} agent-stacked leaves, "
          f"m {M}, H {H}, batch {BATCH}, seq {SEQ}; "
          f"device memory held before the path {held} bytes", flush=True)
    losses, gnorms, xis, times, pre_merge = [], [], [], [], None
    for t, (W, b, glob, live) in enumerate(per_round):
        if t == ROUNDS - 1:  # the state before the final merge
            pre_merge = tree_map(lambda x: x.clone(), state["params"])
        t0 = time.perf_counter()
        state, mets = round_fn(state, {k: torch.as_tensor(v[0]).to(dev)
                                       for k, v in b.items()}, W[0])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(mets["loss"]))
        gnorms.append(float(mets["grad_norm"]))
        xis.append(float(mets["consensus"]))
        print(f"round {t} (tree): loss {losses[-1]:.6f} (main path "
              f"{main['losses'][t]:.6f}) grad_norm {gnorms[-1]!r} (main "
              f"{main['grad_norms'][t]!r}) Xi {xis[-1]!r} (main "
              f"{main['xis'][t]!r}) {times[-1]:.3f}s; device memory peak so "
              f"far {torch.cuda.max_memory_allocated()} bytes", flush=True)
    rel = {name: max(abs(a - b) / abs(b) for a, b in zip(ours, main[key]))
           for name, ours, key in (("loss", losses, "losses"),
                                   ("grad_norm", gnorms, "grad_norms"))}
    params = state["params"]
    leaves, skel = tree_flatten(params)
    same = all(torch.equal(x[k], x[0]) for x in leaves for k in range(1, M))
    xi = float(consensus.consensus_distance(params))
    with torch.no_grad():
        merged = float(model.loss_fn(gossip.merged_model(params), eval_batch,
                                     None)[0])
        local = float(torch.mean(torch.stack([
            model.loss_fn(tree_unflatten(skel, [x[k] for x in leaves]),
                          eval_batch, None)[0] for k in range(M)])))
    print(f"tree path: largest relative difference from the main path over "
          f"the rounds {json.dumps(rel)} (tolerance {TREE_RTOL}); after the "
          f"final merge the rows are identical: {same}, "
          f"consensus.consensus_distance {xi!r}; eval merged {merged!r} "
          f"local {local!r}", flush=True)
    check(all(v <= TREE_RTOL for v in rel.values()),
          f"tree path: rounds differ from the main path's by {rel}")
    check(xi < 1e-3, f"tree path: Xi after the final merge is {xi!r}")
    check(abs(merged - local) <= 1e-5 and math.isfinite(merged),
          f"tree path: merged eval {merged!r} against local {local!r}")
    del state, params, leaves
    torch.cuda.empty_cache()
    mix_before = launch_counts()["gossip_mix"]
    target = gossip.merged_model(pre_merge)
    t0 = time.perf_counter()
    approx, gxis = gossip_merge_rounds(
        pre_merge, topology.make_sampler("exponential", M), int(np.log2(M)),
        np.random.default_rng(0), return_xi=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    mixes = launch_counts()["gossip_mix"] - mix_before
    err = max(float(torch.max(torch.abs(a - tgt[None]))) for a, tgt in zip(
        tree_flatten(approx)[0], tree_flatten(target)[0]))
    scale = max(float(torch.max(torch.abs(tgt)))
                for tgt in tree_flatten(target)[0])
    del approx, target, pre_merge
    torch.cuda.empty_cache()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"gossip_merge_rounds (tree path, {int(np.log2(M))} rounds of the "
          f"exponential graph): max |err| {err!r} against gossip.merged_model "
          f"(max |theta| {scale!r}); Xi trace {gxis.tolist()}; "
          f"{mixes} gossip_mix launches; {dt:.3f}s", flush=True)
    print(f"kernels (tree) {json.dumps(counts)}", flush=True)
    print(f"tree path: rounds (s) {times}; peak device memory {peak} bytes",
          flush=True)
    check(mixes == counts["gossip_mix"] == int(np.log2(M)),
          f"tree path: {counts['gossip_mix']} gossip_mix launches, not "
          f"{int(np.log2(M))}")
    check(counts["panel_mean_consensus"] >= 1,
          f"tree path: no panel_mean_consensus launch: {counts}")
    check(err <= 1e-4 * scale,
          f"tree path: the gossip merge is {err!r} from the merged model")
    return counts, {"losses": losses, "grad_norms": gnorms, "xis": xis,
                    "peak": peak, "width": width, "times": times,
                    "merged": merged, "local": local}


def figure_phase(torch):
    """Phase 8: the paper's figures on the card (repro_torch.bench.figures),
    their CSV lines, the reference tests' claims on them, and Fig. 1 on the
    CPU from the same init (the plain versions) within 0.01 of the card's
    accuracies. Returns the card's derived values."""
    from repro_torch.bench import figures
    t0 = time.perf_counter()
    got = {}
    for name, fn in figures.BENCHES:
        us, derived = fn(device="cuda")
        got[name] = derived
        print(f"figure {figures.csv_line(name, us, derived)}", flush=True)
    t_card = time.perf_counter() - t0
    fig1, c34 = (got["fig1_single_global_merging"],
                 got["appendix_c34_gossip_merge"])
    claims = {
        "fig1 merged > local + 0.05 and > 0.30": (
            fig1["gossip_merged_acc"] > fig1["gossip_local_acc"] + 0.05
            and fig1["gossip_merged_acc"] > 0.30),
        "fig1 local-only merged < 0.25": fig1["localonly_merged_acc"] < 0.25,
        "fig2c gap with communication > without": (
            got["fig2c_counterfactual_mergeability"]["mean_gap_comm"]
            > got["fig2c_counterfactual_mergeability"]["mean_gap_nocomm"]),
        "C.3.4 3-round gossip merge within 0.01 of the exact merge": abs(
            c34["gossip_3r"] - c34["exact_merge"]) <= 0.01,
        "Cor. D.2 bound satisfied": bool(
            got["corollary_d2_consensus_bound"]["satisfied"]),
        "Table 1 ratio finite": math.isfinite(
            got["table1_convergence_rates"]["ratio"])}
    t0 = time.perf_counter()
    _, cpu = figures.fig1_single_global_merging(device="cpu")
    t_cpu = time.perf_counter() - t0
    accs = ("gossip_local_acc", "gossip_merged_acc", "localonly_merged_acc")
    diff = {k: round(abs(cpu[k] - fig1[k]), 4) for k in accs}
    print(f"figures: {t_card:.1f}s on the card; claims {json.dumps(claims)}; "
          f"fig1 on the CPU {json.dumps(cpu)} ({t_cpu:.1f}s), |card - cpu| "
          f"{json.dumps(diff)}", flush=True)
    for what, ok in claims.items():
        check(ok, f"figures: the card does not hold '{what}': {got}")
    check(all(v <= 0.01 for v in diff.values()),
          f"figures: fig1 on the CPU {cpu} is not within 0.01 of the card's "
          f"{fig1}")
    return got


def zero_v_count(torch, opt, sts):
    """Entries whose decoded second moment v is 0 while the decoded first
    moment m is not, over the stored grouped-int8 moments ``opt`` (storages
    ``sts`` by dtype group); decoded a slab at a time by the plain
    versions, so no kernel launch is counted."""
    from repro_torch.kernels.ref import dequantize_int8_grouped_ref
    n = 0
    for g, st in sts.items():
        m, v = opt["m"][g], opt["v"][g]
        D, step = m["q"].shape[1], st.slab()
        for lo in range(0, D, step):
            cs = slice(lo, min(lo + step, D))
            gs = slice(lo // st.group, -(-cs.stop // st.group))
            dm, dv = (st.transform_inv(dequantize_int8_grouped_ref(
                x["q"][:, cs], x["scale"][:, gs], st.group)) for x in (m, v))
            n += int(torch.count_nonzero((dv == 0) & (dm != 0)))
            del dm, dv
    return n


def grad_route_check(torch, cfg, state, spec, round_inputs, tol=1e-4):
    """One agent's gradient at full width through the blockwise route (the
    flash attention kernels) against the dense _sdpa route (attn_block 0):
    agent 0's parameters of the trained state, its first batch; relative
    l2 of the whole gradient <= ``tol``. Returns it."""
    import dataclasses
    from repro_torch.core import panel as panel_mod
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    dev = next(iter(state["panel"].values())).device
    batch = {k: torch.as_tensor(v[0, 0, 0]).to(dev)
             for k, v in round_inputs[1].items()}
    grads = {}
    for route, block in (("blockwise", cfg.dist.attn_block), ("dense", 0)):
        model = build_model(cfg.replace(dist=dataclasses.replace(
            cfg.dist, attn_block=block)))
        leaves, skel = tree_flatten(panel_mod.agent_params(state["panel"],
                                                           spec, 0))
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        loss, _ = model.loss_fn(tree_unflatten(skel, leaves), batch)
        grads[route] = torch.cat([g.reshape(-1) for g in
                                  torch.autograd.grad(loss, leaves)])
        del leaves, loss
    rel = float(torch.linalg.vector_norm(grads["blockwise"] - grads["dense"])
                / torch.linalg.vector_norm(grads["dense"]))
    err = float(torch.max(torch.abs(grads["blockwise"] - grads["dense"])))
    print(f"gradient route check (agent 0, batch {tuple(batch['tokens'].shape)}"
          f", {grads['dense'].numel()} entries): blockwise (flash kernels) vs "
          f"dense _sdpa relative l2 {rel:.3g}, max|err| {err:.3g}",
          flush=True)
    check(rel <= tol, f"the blockwise route's gradient is {rel} (relative "
                      f"l2) from the dense route's, over {tol}")
    del grads
    torch.cuda.empty_cache()
    return rel


def compare_fused_unfused(torch, fused, unfused, f32_peak):
    """The two residency paths drew the same uniforms in the same slabs, so
    their per-round losses, Xi, evals, final parameter panels and stored
    moments must be the same bit for bit; the fused path's peak must sit at
    least 8 GB under the f32 path's."""
    same = (fused["losses"] == unfused["losses"]
            and fused["xis"] == unfused["xis"]
            and fused["zero_v"] == unfused["zero_v"]
            and fused["merged"] == unfused["merged"]
            and all(torch.equal(fused["panel"][k], unfused["panel"][k])
                    for k in fused["panel"])
            and all(torch.equal(fused["opt"][mk][g][part],
                                unfused["opt"][mk][g][part])
                    for mk in ("m", "v") for g in fused["opt"][mk]
                    for part in ("q", "scale")))
    saved = f32_peak - fused["peak"]
    print(f"residency int8 fused vs unfused: losses, Xi, evals, final panels, "
          f"stored moments and zero-v counts bit-identical: {same}; peaks "
          f"f32 {f32_peak}, "
          f"fused {fused['peak']}, unfused {unfused['peak']} bytes; the fused "
          f"path holds {saved} bytes less than the f32 path", flush=True)
    check(same, "the fused and unfused residency paths differ")
    check(saved >= 8e9, f"the int8 residency path saves only {saved} bytes "
                        "of peak device memory against the f32 path")


def rows_identical(torch, panel, alive=None):
    """Whether every agent's row (every live agent's, given the (m,) bool
    ``alive``) equals the first one's bit for bit (Xi = 0 exactly; the
    reduce's column mean of 8 equal float32 rows need not be exact)."""
    import numpy as np
    m = next(iter(panel.values())).shape[0]
    rows = list(range(m)) if alive is None else np.flatnonzero(alive).tolist()
    return all(torch.equal(x[r], x[rows[0]]) for x in panel.values()
               for r in rows[1:])


def breakdown(torch, model, opt, state, spec, round_inputs, label,
              reps=3):
    """Where a round's time goes at full width: each piece of the round
    timed on its own (median of ``reps``, CUDA events) on the trained
    state. Runs after the main path's counts were read."""
    from repro_torch.core import dsgd
    from repro_torch.core import panel as panel_mod
    b = round_inputs[1]
    W_mix = torch.full((M, M), 1.0 / M).numpy()
    dev = next(iter(state["panel"].values())).device
    batch = {k: torch.as_tensor(v[0, 0]).to(dev) for k, v in b.items()}
    pan = state["panel"]
    holder = {}

    def grads():
        holder["g"] = dsgd.panel_grads(model.loss_fn, pan, spec, batch)[0]

    parts = {"local_grads_8_agents": grads}
    grads()
    parts["adamw_update"] = lambda: opt.update(holder["g"], state["opt"], pan)
    parts["grad_norm"] = lambda: panel_mod.panel_norm(holder["g"], True)
    parts["mix_dense_mean"] = lambda: panel_mod.mix_dense_mean(pan, W_mix)
    mixed, mean, _ = panel_mod.mix_dense_mean(pan, W_mix)
    parts["consensus_from_mean"] = lambda: panel_mod.consensus_from_mean(
        mixed, mean)
    parts["consensus_distance"] = lambda: panel_mod.consensus_distance(pan)
    out = {name: time_ms(torch, fn, reps=reps, warmup=1)
           for name, fn in parts.items()}
    per_step = (out["local_grads_8_agents"] + out["adamw_update"]
                + out["grad_norm"])
    out["round_estimate"] = (H * per_step + out["mix_dense_mean"]
                             + out["consensus_from_mean"])
    print(f"breakdown ms ({label}) " + json.dumps(
        {k: round(v, 3) for k, v in out.items()}), flush=True)
    return out


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip_smoke: the port's package src/repro_torch is not beside "
              f"this script (in {ROOT}); run it from a checkout of the "
              f"repository", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.configs import get_config
    from repro_torch.core import panel as panel_mod
    from repro_torch.kernels import SOURCES, build
    from repro_torch.models import build_model
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    report = build.build(SOURCES + ("philox_check",))
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in report.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    cfg = get_config("olmo-1b").replace(num_layers=2)
    D = panel_mod.make_spec(build_model(cfg).init_params(None, "meta"),
                            rows=M).width
    measured = kernel_checks(torch, D)
    measured.update(wire_checks(torch, D))
    measured.update(native_checks(torch, D))
    measured.update(int4_checks(torch, D))
    measured.update(merge_checks(torch, D))
    measured.update(residency_checks(torch, D))
    measured.update(flash_checks(torch))
    small_parity(torch)
    counts, records = {}, {}
    for path in PATH_KERNELS:
        if path == "tree":
            counts[path], records[path] = drive_tree_path(torch,
                                                          records["f32"])
        else:
            counts[path], records[path] = drive_path(torch, path)
        check(records[path]["width"] == D,
              f"{path} path D {records[path]['width']} != checked D {D}")
        if path == "residency int8 unfused":
            compare_fused_unfused(torch, records.pop("residency int8"),
                                  records[path], records["f32"]["peak"])
            records[path].pop("panel")
            records[path].pop("opt")
            torch.cuda.empty_cache()
    figure_phase(torch)
    for path, base in (("int8_ef native", "int8_ef"), ("faults", "f32"),
                       ("tree", "f32")):
        a, b = records[path], records[base]
        print(f"{path} against {base}: rounds (s) {a['times']} against "
              f"{b['times']}; peak {a['peak']} against {b['peak']} bytes "
              f"({a['peak'] - b['peak']:+d})", flush=True)

    # name: (source, the TPU kernel it replaces, the run its launches are
    # read from)
    kernels_of = {
        "gossip_mix": ("gossip_mix.cu", "gossip_mix.py:26", counts["f32"]),
        "panel_mean_consensus": ("panel_reduce.cu", "panel_reduce.py:38",
                                 counts["f32"]),
        "quantize_int8": ("wire_quant.cu", "wire_quant.py:63",
                          counts["int8_ef"]),
        "quantize_int8_native": ("wire_native.cu", "wire_quant.py:96",
                                 counts["int8_ef native"]),
        "dequantize_int8": ("wire_quant.cu", "wire_quant.py:140",
                            counts["int8_ef"]),
        "sparsify_topk": ("wire_quant.cu", "wire_quant.py:404",
                          counts["topk"]),
        "quantize_int4": ("wire_int4.cu", "wire_quant.py:197",
                          counts["int4_ef"]),
        "dequantize_int4": ("wire_int4.cu", "wire_quant.py:234",
                            counts["int4_ef"]),
        "pack_int4": ("wire_int4.cu", "wire_quant.py:358",
                      counts["int4_ef"]),
        "unpack_int4": ("wire_int4.cu", "wire_quant.py:377",
                        counts["int4_ef"]),
        "weighted_colmerge": ("merge_ops.cu", "merge_ops.py:62",
                              counts["merge var"]),
        "ties_colmerge": ("merge_ops.cu", "merge_ops.py:85",
                          counts["merge ties"]),
        "quantize_int8_grouped": ("wire_int8g.cu", "wire_quant.py:282",
                                  counts["residency int8 unfused"]),
        "dequantize_int8_grouped": ("wire_int8g.cu", "wire_quant.py:319",
                                    counts["residency int8 unfused"]),
        "adamw_fused_int8": ("opt_fused.cu", "opt_fused.py:94",
                             counts["residency int8"]),
        "flash_attention_fwd": ("flash_attention.cu", "flash_attention.py:69",
                                counts[f"attn_block {ATTN_BLOCK}"]),
        "flash_attention_bwd": ("flash_attention.cu", "flash_attention.py:69",
                                counts[f"attn_block {ATTN_BLOCK}"])}
    # sub-rows: the round-to-nearest quantizes, the bf16 variant of the mix
    variants = {"quantize_int8": ("rtn", "quantize_int8_rtn", None),
                "quantize_int4": ("rtn", "quantize_int4_rtn", None),
                "quantize_int8_grouped": ("rtn", "quantize_int8_grouped_rtn",
                                          None),
                "gossip_mix": ("bf16", "gossip_mix_bf16",
                               counts["bf16"]["gossip_mix_bf16"])}
    kernels = []
    for name, (src, replaces, run) in kernels_of.items():
        r = measured[name]
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}",
               "replaces": f"src/repro/kernels/{replaces}",
               "launches": run[name], "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"]}
        for extra in ("sq_rel_err", "max_abs_err_bf16", "supplied"):
            if extra in r:
                row[extra] = r[extra]
        if name in variants:
            key, sub, launches = variants[name]
            row[key] = {k: measured[sub][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")}
            if launches is not None:
                row[key]["launches"] = launches
        kernels.append(row)
    print(f"total: {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
