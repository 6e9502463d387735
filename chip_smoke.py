#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each printing its lines:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel of the port from the sources in this checkout
     (one nvcc per source, all started together);
  3. hold each kernel against its plain PyTorch version on the card, at odd
     widths and at the main path's own shapes, and time kernel, plain
     version (the median of PLAIN_REPS calls; the kernel and the library
     call of REPS), byte bound and the one PyTorch call that computes the same
     function where there is one (torch.matmul for the mix, on float32,
     bf16 and f16 operands: the mix's float16 entry and the reduce's
     bfloat16 and float16 entries bit for bit with their plain versions, torch.quantize_per_channel and dequantize() for
     round-to-nearest int8; none for grouped int4, nibble packing or the
     merge operators' column merges); the TIES thresholds computed on the
     card equal the CPU's bit for bit; the residency kernels (grouped int8
     quantize and dequantize, the fused AdamW step on grouped-int8 moments,
     library torch.quantize_per_channel on the (m G, 128) view for the
     round-to-nearest pair); flash attention forward and backward in
     float32, bfloat16 and float16 (the 16-bit kernels of
     csrc/flash_attention16.cu on the 16-bit tensor cores at every head
     dim: their resources checked for no spills and 8 warps an SM, each
     output held to the float32 yardstick against the plain 16-bit
     version's gap, each output's worst ratio printed, a second run bit
     for bit: flash16_checks, timed at hd 128 and 256 against
     scaled_dot_product_attention on the same 16-bit tensors), float32
     at odd sizes, at the attn_block path's shape and at a GQA
     shape (library torch's scaled_dot_product_attention, is_causal; the
     bound of the kernels' split-TF32 tensor-core route, and the float32
     CUDA cores' figure in the text; each kernel's registers, local (spill)
     bytes and blocks per SM, checked for no spills and 8 warps an SM);
     the same at head dims 96 and 256 (odd sizes, windows, tails, GQA/MQA
     with 8 and 10 query heads on 1, no causal mask, one position,
     bfloat16; resources checked for no spills and 8 warps an SM, the
     hd-256 forward and backward warp pairs included; three forward and
     backward runs at each hd-256 MQA shape bit for bit); phase 11's
     multimodal shapes (hd 128 with 64 query heads on 8 at S 2048, causal:
     qwen2-vl's widths; hd 64 with 16 heads at B 4, S 1024, not causal and
     causal: seamless's encoder and decoder), forward and backward against
     the plain versions; timed at
     FLASH_TIMED's shapes beside their bound and
     scaled_dot_product_attention with enable_gqa, the backward's own
     kernels, row sums, dK/dV, its reduction and dQ, from a torch.profiler
     trace); the
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
     then, each in SIDE_ROUNDS rounds (a gossip round and the merge;
     the main and elastic paths take ROUNDS),
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
  9. (run right after phase 5, on its final state) the merged model saved
     and served: the main path's state merged as launch/train.py
     --save-merged merges it (the reduce kernel), saved with
     checkpoint.save, restored into an init of another seed and held bit
     for bit against the in-memory merged model (blob bytes, save and
     restore seconds); then the ServingEngine on the restored model
     (SERVE_C slots, SERVE_REQUESTS requests with prompts of SERVE_PROMPTS
     tokens in turn, SERVE_NEW new tokens each, a warmup then reset()),
     with dense prefill and with attn_block SERVE_BLOCK prefill (the flash
     attention forward kernel), and the same traffic on olmo-1b at its
     published depth (16 layers, ~4.7 GB of float32 parameters, the port's
     own init) with attn_block SERVE_BLOCK: per run tok/s, TTFT p50/p99,
     decode step p50 beside its byte bound, per-token p50, occupancy, peak
     device memory and the flash forward launches; checked: no OOV id, the
     greedy tokens of two requests (one at 16 layers) equal generate of
     each alone (the in-memory merged model for the restored one), the
     flash forward launched exactly once a layer a prefill, the attn_block
     run's prefill logits within 2e-5 (+ 2e-5 relative) of the dense
     run's and its greedy tokens equal to the dense run's in every
     request, and SERVE_PROBE decode
     steps of a batch of SERVE_C against each row alone (the largest logit
     difference and the smallest top-1/top-2 gap printed); the launch
     counts of the merge and of each engine run (its warmup included, the
     checks not) summed into the kernels line's ``launches_serve``;
  8. the figure harness (repro_torch.bench.figures): its 8 functions on the
     card, their CSV lines, the reference tests' claims (Fig. 1's merge gain
     and local-only merge, Fig. 2c's gaps, App. C.3.4's 3-round gossip
     merge, Cor. D.2's bound, Table 1's finite ratio), and Fig. 1 on the
     CPU from the same init within 0.01 of the card's accuracies;
  10. (after phase 8) the launcher's own loop, launch/train.py:run, on the
     main path's cell (olmo-1b cut to 2 layers through run(cfg=), its data
     over DATA_VOCAB ids through run(lm=); segments of 2 rounds) with
     --telemetry --events --snapshot --profile: its per-round loss, grad
     norm and Xi and its final evals equal phase 5's bit for bit, the last
     Xi 0.0 and merged == local, the stream valid, sqrt(mean(dist_to_mean^2))
     equal to Xi to 1e-4 relative each round, the wire_bytes summing to the
     codec model's count, the peak within 1 GB of phase 5's; from the
     profiler's Chrome trace the device busy share over the traced window,
     the top device operations and the longest idle gaps; then
     scripts/fault_smoke.py's CFG on the card in three children of the
     launcher (a baseline, a run SIGKILLed after its first segment, its
     --resume): equal histories, byte-identical valid streams, and the
     baseline and resumed children launching the int8 quantize and
     dequantize, the weighted column merge and the mix;
  11. (after phase 10) the registry's decoders (ARCH_CELLS):
     phi3-mini-3.8b, gemma-2b (attn_block 512: the flash kernels at hd 256,
     MQA), yi-34b (m D > 2^31), arctic-480b (MoE, 8 of its 128 experts)
     at their published widths cut in depth, deepseek-v3-671b's reduced()
     config (MLA, MoE, MTP), and the recurrent decoders cut to one period:
     recurrentgemma-2b (RG-LRU, RG-LRU, local attention at attn_block 512:
     the flash kernels at hd 256, 10 query heads on 1) and xlstm-1.3b (7
     mLSTM, 1 sLSTM), each through init_panel_state -> make_panel_segment
     for ARCH_ROUNDS rounds: D against ARCH_D, losses finite, the rows
     identical bit for bit and Xi 0.0 after the merge, merged == local
     eval to 1e-6, the mix and reduce launched (and with attn_block the
     flash kernels exactly once forward and once backward an attention
     layer, agent and local step, plus the evals' forwards); the merged
     phi3, arctic, recurrentgemma and xlstm models served by the engine
     (ARCH_SERVE_C slots, ARCH_SERVE_REQUESTS requests of ARCH_SERVE_PROMPT
     tokens, ARCH_SERVE_NEW new: every request's tokens equal to it
     generated alone), the recurrent ones then timed mixer by mixer
     inside one agent's local step (CUDA events: the sLSTM loop's share),
     and deepseek's teacher-forced decode (the absorbed MLA path) against
     the whole sequence's prefill at 2e-5 + 1e-5 relative; then deepseek-v3
     at its published widths (d_model 7168, 128 heads, MLA ranks 1536/512,
     vocab 129,280, top-8 sigmoid router, shared expert, MTP), cut to its
     dense front layer, one MoE layer and MLA_WIDE_EXPERTS experts: its
     loss finite with the MTP and load-balance terms, the MoE layer's
     dispatch against its dense twin, and the same decode check; then
     recurrentgemma-2b (26 layers, the RG-LRU tail) and xlstm-1.3b (48
     layers) at their published depth and widths: the loss finite and the
     teacher-forced decode against prefill at REC_ATOL + REC_RTOL relative
     (recurrentgemma in float32, its attention layers running the flash
     kernels; xlstm, whose float32 logits at 48 layers are themselves
     farther than that from exact arithmetic, in float64 at REC64_ATOL +
     REC64_RTOL, its float32 reading printed beside); and the last two
     families: (h) qwen2-vl-72b's reduced() (M-RoPE (8, 4, 4), an 8-row
     patch prefix; m 8, batch 4 x 256, a seeded patch_embeds in every
     batch: the loss sliced past the prefix trains) and (i)
     seamless-m4t-medium at its published widths and depth (12 encoder +
     12 decoder layers, m 2, batch 4 x 1024 with 1024 seeded frames a row,
     attn_block 512) as ARCH_CELLS cells, held to the same row, Xi and
     eval gates, the mix and reduce launched, (i)'s flash kernels at hd 64
     exactly once forward and once backward an attention layer (12
     non-causal encoder and 12 causal decoder layers), agent and local
     step, plus the evals' forwards (24 + 2 x 24); both merged models
     served with their extras (every request with its prefix or its
     ARCH_SERVE_PROMPT frames, the cross keys and values padded to max_len
     at pos -1) and their teacher-forced decode against prefill at
     2e-5 + 1e-5 relative, (i)'s flash prefill (logits, the self and cross
     keys and values) against its dense route's at the same tolerance
     (route_check); then (h') qwen2-vl-72b at its published widths
     cut to VLM_LAYERS layers, one model (vlm_width_check): the loss and
     its gradient at 1 x (256 patch rows + 1792 tokens), finite, the flash
     kernels at hd 128 (64 query heads on 8) exactly once forward and once
     backward a layer, the loss equal to the dense route's within 1e-5
     relative and every gradient leaf within VLM_GRAD_RTOL relative in l2,
     the decode against the prefill in float64 on the dense route at
     REC64_ATOL + REC64_RTOL and the flash route's float32 prefill and
     decode against that float64 prefill at VLM32_ATOL + VLM32_RTOL (the
     float32 readings against 2e-5 + 1e-5 printed), served with every
     other request carrying a 256-row prefix;
  12. (after phase 11) (a) the main path's cell with bfloat16 parameters
     (param_dtype, BF16_ROUNDS rounds), then with attn_block ATTN_BLOCK at
     m BF16_ATTN_M and batch ATTN_BATCH x ATTN_SEQ (the flash kernels'
     bfloat16 forward and backward: fault C1's repair, each backward
     launch counted): the rows identical after the merge,
     consensus_distance 0.0, the merged model in bfloat16 equal to the
     local eval within 1e-6 relative (the float32-leaf merged eval printed
     beside it), the bf16 entries of the mix and the reduce launched; its
     rounds and peak against phase 5's; (b) the main path sharded over
     SHARD_MESH, 4 ranks sharing the card over gloo, their CUDA tensors
     exchanged through CUDA IPC buffers, every rank's route checked
     (launch/mesh.py, init_panel_state(mesh=)): the ranks' shards sum to
     phase 5's state fingerprint, their evals and losses equal phase 5's
     bit for bit, Xi within 1e-6 relative and 0.0 after the merge; then
     one round at world size 1 over NCCL against phase 5's first round;
     (c) the sharded run's other options: the native quantize at a
     shard's offsets, the top-k sparsify, the column merges and the fused
     int8 AdamW (the block's slab draws) at a shard's shapes against their
     plain versions; then OPTIONS on one process and on SHARD_MESH's 4
     ranks: at the main path's cell (A) the kernel-drawn int8_ef, var,
     int8 moments fused and the telemetry columns, (B) topk, ties and the
     fault plan OPT_FAULTS, and at reduced() width int8 with weighted and
     int8g moments unfused, int4 with fisher and int8r statistics, int4_ef
     with swa and bf16 / int8r storages: each sharded state bit for bit
     with the one-process run's (weighted's parameters within 1e-5), its
     losses and evals bit for bit, Xi and the grad norms within 1e-6 and
     Xi 0.0 after the merge, the live rows identical, merged == local eval
     (but swa, which merges its accumulators), the telemetry columns' loss,
     live and wire bytes equal and their norms within 1e-4, the native
     quantize once a communicating round; each run's rounds, evals, peak
     and collective seconds a rank beside 12b's; (d) sharded checkpoints:
     the launcher (launch/train.py:run, phase 10a's cell and arguments) on
     SHARD_MESH's 4 ranks with --checkpoint-every 1 --checkpoint-keep 1
     saves each rank's blocks of the 22.8 GB state after its first
     segment, in parts, and is SIGKILLed (rank 1 first) once MANIFEST.json
     names the step (the disk checked first for CKPT_DISK_SHARE times the
     state); then --resume on SHARD_MESH and on one process (a (1, 4, 1,
     1) resume dropped for phase 12g's time), each held to phase 10a's
     run: the restored step, the losses
     and evals bit for bit, grad norms and Xi within 1e-6, Xi 0.0 and
     merged == local after the merge, the final state's fingerprint
     (summed over the ranks) bit for bit, the mix and the reduce launched
     on every rank; each rank's bytes written, pack + write and restore
     seconds printed; (e) the dry run (launch/dryrun.py:reckon, traced on
     the host in a child started before phase 11, no card) of 12b's and
     12c (A)'s runs: its peak a rank within DRY_PEAK_SHARE of each rank's
     measured peak, its collective calls and bytes equal to each rank's
     Mesh.stats, no host read of a traced value, the card's memory
     equal to the figure the dry run's ``fits`` reads, what a 12b rank
     holds beyond its peak (its CUDA context and its allocator's reserve)
     under ``hardware.RANK_RESERVE_BYTES``, the reckoned device total
     (``dryrun.device_total``: peak, reserve, IPC buffer) within
     DRY_PEAK_SHARE of each 12b rank's measured one, and the reckon of
     12d's resume on (1, 4, 1, 1) (the rounds after the checkpoint's step)
     within DRY_PEAK_SHARE of its ranks' measured peak; (f) the split route
     (core.dsgd.make_panel_segment(param_shardings=), models/
     tensor_parallel.py): SPLIT_CELLS' olmo cell (the main path's widths,
     m 4) on (1, 1, 2, 2), each agent's batch over 2 fsdp ranks and its
     heads, d_ff and vocabulary over 2 model ranks, and gemma-2b
     reduced(d_model=512) with attn_block 512 on (1, 1, 1, 2) (the flash
     kernels on each rank's 4 heads, the one kv head whole), SPLIT_ROUNDS
     rounds each on the card's ranks over CUDA IPC, against the same cell
     on one process on the replica route (and that run from its init one
     ulp up, printed: the trajectory's float32 conditioning): one local
     step's gradients leaf by leaf within SPLIT_GRAD_RTOL, the first
     round's loss and grad norm and every round's Xi within SPLIT_RTOL,
     every round and the evals within SPLIT_SAME, Xi 0.0, the rows
     identical and merged == local after the merge, SPLIT_KERNELS
     launched on every rank, and the
     olmo cell's peak a rank within DRY_PEAK_SHARE of its reckon (traced
     on the host beside phase 11) and its collective calls and bytes equal
     to the reckoned; its rounds, peaks and collective seconds a rank
     printed; (g) the serve shapes split (models/tensor_parallel.py's serve
     route, the reference's build_serve layout: weights and caches as
     param_spec / cache_spec resolve under serve_rules) on ranks sharing
     the card over CUDA IPC (SERVE_CELLS): olmo-1b at full width and depth
     in bfloat16 with attn_block 512 on (data 2, model 2), 4 prompts of
     4096 tokens and 64 decode steps, and gemma-2b-sw at full width and
     depth in bfloat16 on (data 1, model 2), a prompt past its window and
     decode steps through the ring, each against one process's run of the
     same seeded weights and both against a float32 forward of them: the
     split's relative l2 gap at most SERVE_FACTOR times one process's and
     its gap to one process at most SERVE_DIRECT times one process's (a
     fault planted on one rank, SERVE_FAULTS, must fail them), the
     model ranks of a data rank bit for bit, each rank's peak within
     DRY_PEAK_SHARE of launch/dryrun.py:reckon_serve's (traced on the host
     beside phase 11), the flash forward's bfloat16 entry once a layer a
     rank; and phase 9's merged model in float32 through the engine on
     (data 1, model 2) serving phase 9's requests: every request's tokens
     equal one process's engine's, a probe's logits within SERVE_ATOL +
     SERVE_RTOL;
then the script's total time, a JSON line of per-kernel numbers (the
flash rows with their hd96, hd256 and hd256_h10 timings and the
backward's own kernels' times, kernels_ms; every row with its phase-11
launches by cell, ``launches_arch``, and phase 12's, ``launches_phase12``:
bf16_params (12a), sharded (12b), sharded_options (12c, summed over the
ranks and the runs), sharded_checkpoint (12d's resumed runs, summed
over their ranks), split (12f's two cells, summed over their ranks) and
split_serve (12g's cells, each summed over its ranks); the mix's bf16 and
f16 and the reduce's bf16 and f16 sub-rows, each with that variant's own
launches: the bf16 wire path's for bf16, the main path's for f16, and
its own ``launches_phase12``; the flash rows' bf16 and f16 sub-rows of
the 16-bit kernels, bf16's launches phase 12a's, f16's the attn_block
path's), the
card's line again and, last, the result line. It fails (non-zero exit, no
result line) if there is no card, if the port's package is not beside it,
if a kernel does not build, launch or agree, or if any check fails.
Imports torch, numpy and the port only.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM published peaks (data sheet; dense, at the 700 W limit),
# from the port's one module of them (run alone, without the port beside
# it, main() says so and exits 2)
try:
    from repro_torch.hardware import BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S
    from repro_torch.hardware import SPLIT_TF32_FLOPS as TF32_SPLIT_FLOPS
except ImportError:
    BF16_FLOPS = FP32_FLOPS = HBM_BYTES_PER_S = TF32_SPLIT_FLOPS = None

M = 8                 # agents
ROUNDS, H = 4, 2      # rounds, local steps per round
# rounds of the phase-6 paths but faults (a gossip round and the merge;
# cut from 3 for phase 12g's time)
SIDE_ROUNDS = 2
BATCH, SEQ = 4, 512
DATA_VOCAB = 1024     # token ids the synthetic streams draw (of 50304)
REPS = 20             # timed launches per measurement
PLAIN_REPS = 5        # timed calls of a plain version (10-1000x slower)
# the attn_block path's input: olmo-1b's context length, blocks of 512 keys
# (the dry-run's flashxla value: 4 key blocks a row)
ATTN_BLOCK, ATTN_BATCH, ATTN_SEQ = 512, 2, 2048
# phase 3's timed flash shapes (at ATTN_BATCH, ATTN_SEQ, causal): (H, Kv,
# hd) of the attn_block path (hd 128, the kernel rows' own numbers), of
# phi3-mini (hd 96), of gemma-2b (hd 256, MQA: phase 11's gemma cell) and
# of recurrentgemma-2b's local attention (hd 256, 10 query heads on 1)
FLASH_TIMED = {"hd128": (16, 16, 128), "hd96": (32, 32, 96),
               "hd256": (8, 1, 256), "hd256_h10": (10, 1, 256)}
# phase 3's 16-bit flash checks (flash16_checks): bfloat16 and float16 at
# every head dim of the kernels, and the timed shapes of FLASH16_TIMED (the
# attn_block path's hd 128 and gemma-2b's hd 256). Each output leaf's
# relative l2 distance from the float32 yardstick (the plain version on the
# same 16-bit values widened to float32) must be at most FLASH16_FACTOR
# times the plain 16-bit version's: the plain version rounds every einsum
# to the inputs' type, the kernels (csrc/flash_attention16.cu) P and dS
# before their products and each output once. Emulated on the CPU, their
# rounding reads 0.46-0.80 of the plain version's distance, a float32
# gradient rounded once 0.31-0.57 (tests/test_torch_flash16.py:
# test_rounded_once_beats_the_plain_version)
FLASH16_FACTOR = 1.0
FLASH16_SOURCE = "src/repro_torch/kernels/csrc/flash_attention16.cu"
FLASH16_TIMED = {"hd128": (16, 16, 128), "hd256": (8, 1, 256)}

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
# the serve phase's traffic: SERVE_C slots, SERVE_REQUESTS requests whose
# prompts take SERVE_PROMPTS tokens in turn (olmo-1b's context and half of
# it), SERVE_NEW new tokens each; attn_block prefill at SERVE_BLOCK; the
# batch-independence probe's decode steps
SERVE_C, SERVE_REQUESTS, SERVE_NEW = 8, 16, 128
SERVE_PROMPTS = (2048, 1024)
SERVE_BLOCK, SERVE_SEED, SERVE_PROBE = 512, 0, 8

# phase 10: the launcher's own loop on the main path's cell (two segments
# of two rounds) and scripts/fault_smoke.py's CFG on the card, with the
# kernels its baseline and resumed children must launch (int8_ef wire,
# fisher merge) and the children's wrapper (launch_counts() after main)
LAUNCHER_ARGS = ["--agents", str(M), "--rounds", str(ROUNDS),
                 "--local-steps", str(H), "--batch", str(BATCH), "--seq",
                 str(SEQ), "--segment", "2", "--seed", "0"]
FAULT_SMOKE_CFG = ["--rounds", "6", "--segment", "2", "--agents", "4",
                   "--local-steps", "2", "--batch", "4", "--seq", "32",
                   "--wire", "int8_ef", "--merge", "fisher",
                   "--schedule", "final_merge", "--seed", "0", "--telemetry"]
FAULT_SMOKE_TAG = "olmo-1b_final_merge_a0.1_mfisher"
FAULT_SMOKE_KERNELS = ("quantize_int8", "dequantize_int8",
                       "weighted_colmerge", "gossip_mix")
# phase 11: the registry's decoders at their published widths, cut in depth
# (and agents; arctic in experts) to fit one card: cell: (arch, layers, m,
# batch, seq, attn_block, experts); deepseek-v3 runs its reduced() config
# (layers None). The recurrent decoders are cut to one period: for
# recurrentgemma (RG-LRU, RG-LRU, local attention with window 2048; its
# attention layer at attn_block 512: the flash kernels at hd 256, 10 query
# heads on 1 key head), for xlstm 7 mLSTM and 1 sLSTM layers (at m 4
# since phase 12f joined the script: its sLSTM's per-token loop made the
# cell ~115 s at m 8; at m 2 since phase 12g did).
# ARCH_ROUNDS rounds (a gossip round and the merge; cut from 3 for phase
# 12g's time), H local steps;
# ARCH_D the width D of an agent each cut gives.
ARCH_CELLS = {"phi3": ("phi3-mini-3.8b", 2, 8, 4, 512, 0, None),
              "gemma": ("gemma-2b", 2, 4, 2, 2048, 512, None),
              "yi": ("yi-34b", 1, 2, 4, 512, 0, None),
              "arctic": ("arctic-480b", 1, 2, 4, 512, 0, 8),
              "deepseek": ("deepseek-v3-671b", None, 8, 4, 256, 0, None),
              "recurrentgemma": ("recurrentgemma-2b", 3, 3, 2, 2048, 512,
                                 None),
              "xlstm": ("xlstm-1.3b", 8, 2, 4, 512, 0, None),
              "qwen2vl": ("qwen2-vl-72b", None, 8, 4, 256, 0, None),
              "seamless": ("seamless-m4t-medium", 12, 2, 4, 1024, 512,
                           None)}
ARCH_ROUNDS = 2
ARCH_D = {"phi3": 424_688_640, "gemma": 744_499_200, "yi": 1_475_367_936,
          "arctic": 1_517_630_464, "deepseek": 5_361_952,
          "recurrentgemma": 912_320_000, "xlstm": 378_712_120,
          "qwen2vl": 2_032_896, "seamless": 977_924_096}
# the last two families' cells: qwen2-vl-72b's reduced() (hd 32, M-RoPE
# sections (8, 4, 4), an 8-row patch prefix) with a seeded patch_embeds
# (b, 8, d) in every batch, so the loss sliced past the prefix is what
# trains; seamless-m4t-medium at its published widths and depth (12
# encoder + 12 decoder layers, hd 64, attn_block 512: the flash kernels
# non-causal in the encoder, causal in the decoder), its batches carrying
# seq seeded Gaussian frames a row (tests/test_archs.py:make_batch's
# spec). m 2: m D 4 = 7.8 GB a panel, ~5.5 panels and the activations
# (the 512-token loss chunks over 256,256 columns) fit; m 3 would hold
# 64.5 GB before them. The extras are drawn from numpy generators seeded
# EXTRAS_SEED and the round.
EXTRAS_SEED = 11
# the merged models served (C slots, requests of PROMPT tokens, NEW new
# tokens each, greedy) and the MLA cell's teacher-forced decode (a prompt
# of MLA_PROMPT tokens, MLA_STEPS steps, 2 rows; the recurrent decoders'
# full-depth check takes the same prompt and steps)
ARCH_SERVED = ("phi3", "arctic", "recurrentgemma", "xlstm", "qwen2vl",
               "seamless")
ARCH_SERVE_C, ARCH_SERVE_REQUESTS = 4, 8
ARCH_SERVE_PROMPT, ARCH_SERVE_NEW = 512, 32
MLA_PROMPT, MLA_STEPS = 192, 8
# deepseek-v3 at its published widths (d_model 7168, 128 heads, q/kv LoRA
# ranks 1536/512, rope 64, vocab 129,280, the top-8 sigmoid router, the
# shared expert, MTP 1) cut in depth to its dense front layer and one MoE
# layer, and in routed experts from 256 to MLA_WIDE_EXPERTS. An expert is
# 44.0 M parameters in the MoE layer and as many in the MTP block; the
# rest (the embedding, the untied head, the front layer, the three MLA
# mixers, the MTP projection) is 12.0 GB of float32. At 256 experts the
# weights are 102.2 GB against the card's 85.0 GB (79.18 GiB); at 160,
# 68.4 GB, and the draw of a bank (or moe_ref's einsum copy of one) 9.4 GB
# more, with no room left for the allocator's slack; at 128, 57.1 GB and
# 7.5 GB. The loss (no gradient: the weights alone take 67% of the card)
# at MLA_WIDE_BATCH rows of MLA_WIDE_SEQ tokens; the MoE layer's dispatch
# against its dense twin at as many tokens
MLA_WIDE_EXPERTS = 128
MLA_WIDE_BATCH, MLA_WIDE_SEQ = 2, 256
# the recurrent decoders at their published depth (recurrentgemma-2b's 26
# layers: 8 periods and the 2-layer RG-LRU tail; xlstm-1.3b's 48), one
# model each, no panel, no gradient: the loss at REC_DEPTH_BATCH rows of
# REC_DEPTH_SEQ tokens, then the teacher-forced decode against prefill at
# the reference's recurrent-decode tolerance (tests/test_models.py:
# atol 1e-4, rtol 1e-3)
REC_DEPTH = ("recurrentgemma-2b", "xlstm-1.3b")
REC_DEPTH_BATCH, REC_DEPTH_SEQ = 2, 512
REC_ATOL, REC_RTOL = 1e-4, 1e-3
# a stack without attention is held in float64 (float64_model), at that
# tolerance times 1e-6: float64 rounds 1.9e-9 as coarsely as float32, so
# this is no tighter against each one's rounding, and it catches what the
# literal tolerance lets through in float64 (tests/test_torch_recurrent.py:
# test_float64_decode_check_catches_a_dropped_state_term)
REC64_ATOL, REC64_RTOL = 1e-10, 1e-9
# qwen2-vl-72b at its published widths (d_model 8192, 64 heads on 8 x 128,
# d_ff 29,568, vocab 152,064, untied head, M-RoPE (16, 24, 24)) cut to 2 of
# its 80 layers, one model: 4,246,773,760 parameters (the embedding and
# head alone 2,491,416,576), 17.0 GB of float32. Decentralized training
# holds Theta, two moments and a gradient, 16 B a parameter an agent: at
# m >= 2 the embedding and head alone take 79.7 GB, so no depth fits one
# card as a panel; its panel path runs at reduced() (the qwen2vl cell).
# Here the loss and its gradient at batch 1 x (VLM_PREFIX patch rows +
# VLM_TOKENS tokens) with attn_block VLM_BLOCK (the flash kernels at hd
# 128, 64 query heads on 8, causal across the prefix), then the
# teacher-forced decode with the prefix and the engine (ARCH_SERVE_C
# slots, ARCH_SERVE_REQUESTS requests of ARCH_SERVE_PROMPT tokens and
# ARCH_SERVE_NEW new, every other one with a VLM_PREFIX-row prefix: the
# reference's tests/test_serving.py:201-219 mix)
VLM_LAYERS, VLM_PREFIX, VLM_TOKENS, VLM_BLOCK = 2, 256, 1792, 512
VLM_PARAMS = 4_246_773_760
# the flash route against the dense one there: each gradient leaf within
# VLM_GRAD_RTOL relative in l2, flash_checks' gradient tolerance (the
# kernels' own gradients read ~3e-6 relative in l2 against their plain
# versions); the flash route's float32 prefill and decode logits within
# VLM32_ATOL + VLM32_RTOL of the float64 dense prefill, 5x the serving
# tolerance: the float32 dense prefill reads 1.91 of that tolerance from
# the float64 one at these widths (H100 80GB HBM3, 700.00 W), and a wrong
# mask, head group or prefix offset moves logits by O(0.1)
VLM_GRAD_RTOL = 1e-4
VLM32_ATOL, VLM32_RTOL = 1e-4, 5e-5
CHILD = ("import json, sys\n"
         "from repro_torch.kernels import launch_counts\n"
         "from repro_torch.launch import train\n"
         "train.main(sys.argv[1:])\n"
         "print('launch counts ' + json.dumps(launch_counts()), flush=True)\n")

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
    err = {"gossip_mix": 0.0, "gossip_mix_bf16": 0.0, "gossip_mix_f16": 0.0,
           "panel_mean_consensus": 0.0, "panel_mean_consensus_bf16": 0.0,
           "panel_mean_consensus_f16": 0.0}
    sq_rel = {"": 0.0, "_bf16": 0.0, "_f16": 0.0}
    out = {}
    for D in (333, 1000, 1001, D_main):
        theta = torch.randn((M, D), generator=gen, device=dev)
        theta16 = theta.to(torch.bfloat16)
        thetah = theta.to(torch.float16)
        W = torch.as_tensor(random_matching(M, 0.7, rng), dtype=torch.float32)
        Wm = torch.cat([W, torch.full((1, M), 1.0 / M)]).to(dev)
        for Wk in (W.to(dev), Wm):
            for name, t in (("gossip_mix", theta),
                            ("gossip_mix_bf16", theta16),
                            ("gossip_mix_f16", thetah)):
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
        sq_rel[""] = max(sq_rel[""], r)
        # 16-bit panels (bfloat16 and float16 parameter groups): the same
        # float32 mean of the exactly widened values, bit for bit
        for sfx, t in (("_bf16", theta16), ("_f16", thetah)):
            hmean, hsq = panel_mean_consensus(t)
            rhmean, rhsq = panel_mean_consensus_ref(t)
            torch.cuda.synchronize()
            eh = float(torch.max(torch.abs(hmean - rhmean)))
            rh = abs(float(hsq) - float(rhsq)) / abs(float(rhsq))
            check(hmean.dtype == torch.float32 and torch.equal(hmean, rhmean),
                  f"panel_mean_consensus{sfx} mean disagrees at D={D}: {eh}")
            check(rh <= 1e-5, f"panel_mean_consensus{sfx} sq disagrees at "
                              f"D={D}: rel {rh}")
            err["panel_mean_consensus" + sfx] = max(
                err["panel_mean_consensus" + sfx], eh,
                abs(float(hsq) - float(rhsq)))
            sq_rel[sfx] = max(sq_rel[sfx], rh)
            del hmean, hsq, rhmean, rhsq
        print(f"check D={D}: gossip_mix max|err| {err['gossip_mix']:.3g} "
              f"(bf16 theta {err['gossip_mix_bf16']:.3g}, f16 theta "
              f"{err['gossip_mix_f16']:.3g}), panel_mean_consensus mean "
              f"max|err| {e:.3g} sq rel {r:.3g} (bf16 {sq_rel['_bf16']:.3g}, "
              f"f16 {sq_rel['_f16']:.3g} sq rel; means bit for bit)",
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
        plain = time_ms(torch, lambda: gossip_mix_ref(Wm, theta),
                        reps=PLAIN_REPS, warmup=1)
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
            "plain_ms": time_ms(torch, lambda: gossip_mix_ref(Wm, theta16),
                                reps=PLAIN_REPS, warmup=1),
            "library_ms": time_ms(torch, lambda: torch.matmul(Wm16,
                                                              theta16)),
            "bytes": mix16_bytes, "ops": mix_ops, "bound_ms": b_ms,
            "bound_by": b_by}
        # a float16 group's mix: f16 theta, float32 rows out (library:
        # torch.matmul on half operands)
        Wmh = Wm.to(torch.float16)
        out["gossip_mix_f16"] = {
            "ms": time_ms(torch, lambda: gossip_mix(Wm, thetah)),
            "plain_ms": time_ms(torch, lambda: gossip_mix_ref(Wm, thetah),
                                reps=PLAIN_REPS, warmup=1),
            "library_ms": time_ms(torch, lambda: torch.matmul(Wmh, thetah)),
            "bytes": mix16_bytes, "ops": mix_ops, "bound_ms": b_ms,
            "bound_by": b_by}
        ms = time_ms(torch, lambda: panel_mean_consensus(theta))
        plain = time_ms(torch, lambda: panel_mean_consensus_ref(theta),
                        reps=PLAIN_REPS, warmup=1)
        b_ms, b_by = bound(red_bytes, red_ops)
        out["panel_mean_consensus"] = {
            "ms": ms, "plain_ms": plain, "library_ms": None,
            "bytes": red_bytes, "ops": red_ops, "bound_ms": b_ms,
            "bound_by": b_by}
        # the reduce of a 16-bit group: 2 bytes an element read
        red16_bytes = 2 * M * D + 4 * (D + 1)
        b_ms, b_by = bound(red16_bytes, red_ops)
        for sfx, t in (("_bf16", theta16), ("_f16", thetah)):
            out["panel_mean_consensus" + sfx] = {
                "ms": time_ms(torch, lambda: panel_mean_consensus(t)),
                "plain_ms": time_ms(torch,
                                    lambda: panel_mean_consensus_ref(t),
                                    reps=PLAIN_REPS, warmup=1),
                "library_ms": None, "bytes": red16_bytes, "ops": red_ops,
                "bound_ms": b_ms, "bound_by": b_by}
        for name, r_ in out.items():
            print(f"time {name} (m={M}, D={D}): kernel {r_['ms']:.4f} ms, "
                  f"plain {r_['plain_ms']:.4f} ms, library "
                  f"{r_['library_ms']} ms, bound {r_['bound_ms']:.4f} ms "
                  f"({r_['bytes']} bytes), {100 * r_['bound_ms'] / r_['ms']:.1f}"
                  f"% of the bound", flush=True)
        del theta, theta16, thetah
    for name, e in err.items():
        out[name]["max_abs_err"] = e
    for sfx, r in sq_rel.items():
        out["panel_mean_consensus" + sfx]["sq_rel_err"] = r
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
                         "plain_ms": time_ms(torch, plain, reps=PLAIN_REPS,
                                               warmup=1),
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
                         "plain_ms": time_ms(torch, plain, reps=PLAIN_REPS,
                                               warmup=1),
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


# rows of the TIES thresholds held card == CPU at D = D_main (each row is
# its own order statistic; every row at the small widths): cut from M,
# the CPU's sorts of 8 full rows took most of the script's phase 3
TIES_CPU_ROWS = 2


def merge_checks(torch, D_main):
    """Phase 3, merge kernels: the weighted and the TIES column merge
    (trim 0.2 and 1.0) against their plain versions (max |err| must be 0),
    the TIES thresholds on the card against the CPU's (bit for bit; at
    D_main the first TIES_CPU_ROWS rows); times at m = 8, D = D_main. No
    single PyTorch call computes either column merge: library_ms null."""
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
                                    lambda: weighted_colmerge_ref(x, w),
                                    reps=PLAIN_REPS, warmup=1),
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
            rows = slice(0, TIES_CPU_ROWS if D == D_main else M)
            check(torch.equal(th[rows].cpu(),
                              ties_thresh_ref(tau[rows].cpu(), trim)),
                  f"TIES thresholds (trim {trim}) on the card differ from "
                  f"the CPU's at D={D}")
            got = ties_colmerge(tau, th)
            check(torch.equal(got, ties_colmerge_ref(tau, th)),
                  f"ties_colmerge (trim {trim}) disagrees at D={D}")
            del got
        print(f"check D={D}: weighted_colmerge, ties_colmerge (trim 0.2, "
              f"1.0) max|err| 0; TIES thresholds card == CPU "
              f"({rows.stop} rows), "
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
                                    lambda: ties_colmerge_ref(tau, th),
                                    reps=PLAIN_REPS, warmup=1),
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
                                 "plain_ms": time_ms(
                                     torch, plain, reps=PLAIN_REPS,
                                     warmup=1),
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
    show no local memory and at least 8 warps an SM; then the forward
    kernel (float32 and bfloat16) and the backward kernels against their plain versions (the online loop,
    and torch autograd through it) at odd sizes (S = 100, hd 64 and 128, a
    window, GQA), at the attn_block path's shape (B 2, S 2048, H 16, hd
    128), a GQA one (H 32 on Kv 8), the serve path's prefills (B 1, S
    1024 and 2048, H 16, hd 128) and phase 11's multimodal shapes
    (qwen2-vl's 64 heads on 8 at hd 128, S 2048; seamless's hd 64, H 16,
    B 4, S 1024, not causal and causal). Tolerances: float32 output and lse
    2e-5, gradients 1e-4, bfloat16 output 2e-2 (other summation orders).
    Times at FLASH_TIMED's shapes (flash_times): the hd 128 one gives the
    kernel rows their numbers, the hd 96 and hd 256 ones their sub-rows."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd,
                                                     occupancy)
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_fwd_ref)
    # 8 warps an SM for each kernel: two 4-warp blocks up to hd 128, one
    # 8-warp block (warp pairs) at hd 256
    for hd in (128, 96, 256):
        for name, r in occupancy(hd, ATTN_SEQ).items():
            print(f"flash attention {name} at hd {hd}: {r['registers']} "
                  f"registers, {r['local_bytes']} B local (spills) a "
                  f"thread, {r['blocks_per_sm']} blocks "
                  f"({r['warps_per_sm']} warps) per SM, {r['smem']} B "
                  f"shared memory", flush=True)
            check(r["registers"] > 0 and r["local_bytes"] == 0
                  and r["warps_per_sm"] >= 8,
                  f"flash attention {name} at hd {hd} spills or runs under "
                  f"8 warps an SM: {r}")
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(6)
    err = {"fwd": 0.0, "fwd_bf16": 0.0, "bwd": 0.0}
    timed = {}
    f32, bf16_ = torch.float32, torch.bfloat16
    # (B, S, H, Kv, hd, window, dtype, causal)
    cases = [(2, 100, 4, 2, 64, None, f32, True),
             (1, 100, 2, 2, 128, 48, f32, True),
             (2, 100, 4, 2, 64, None, bf16_, True),
             (1, 100, 2, 1, 128, 48, bf16_, True),
             (ATTN_BATCH, ATTN_SEQ, 16, 16, 128, None, f32, True),
             (ATTN_BATCH, ATTN_SEQ, 32, 8, 128, None, f32, True)]
    # the serve path's prefills (phase 9): one request a call, a prompt of
    # each bucket
    cases += [(1, S, 16, 16, 128, None, f32, True)
              for S in sorted(SERVE_PROMPTS)]
    # the wide heads: hd 96 (phi3-mini) and 256 (gemma-2b: 8 query heads
    # on 1; recurrentgemma-2b: 10 on 1), odd sizes, tails, windows, no
    # causal mask, one position and bfloat16; then the timed shapes of
    # FLASH_TIMED
    cases += [(2, 100, 4, 2, 96, None, f32, True),
              (1, 300, 8, 1, 96, 100, f32, True),
              (2, 100, 4, 2, 96, 48, bf16_, True),
              (2, 100, 8, 1, 256, None, f32, True),
              (1, 130, 4, 2, 256, 48, f32, True),
              (1, 300, 10, 1, 256, 100, f32, True),
              (1, 77, 2, 1, 256, None, f32, False),
              (2, 1, 2, 1, 256, None, f32, True),
              (2, 100, 8, 1, 256, None, bf16_, True)]
    cases += [(ATTN_BATCH, ATTN_SEQ, *shape, None, f32, True)
              for key, shape in FLASH_TIMED.items() if key != "hd128"]
    # phase 11's multimodal shapes: qwen2-vl's widths (hd 128, 64 query
    # heads on 8, causal across the prefix: VLM_PREFIX + VLM_TOKENS rows),
    # seamless-m4t's batch (hd 64, 16 heads; its encoder non-causal, its
    # decoder causal)
    cases += [(1, VLM_PREFIX + VLM_TOKENS, 64, 8, 128, None, f32, True),
              (4, 1024, 16, 16, 64, None, f32, False),
              (4, 1024, 16, 16, 64, None, f32, True)]
    for B, S, Hq, Kv, hd, window, dtype, causal in cases:
        q = torch.randn((B, S, Hq, hd), generator=gen, device=dev)
        k = torch.randn((B, S, Kv, hd), generator=gen, device=dev)
        v = torch.randn((B, S, Kv, hd), generator=gen, device=dev)
        do = torch.randn((B, S, Hq, hd), generator=gen, device=dev)
        pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        kw = dict(causal=causal, window=window)
        bf16 = dtype == torch.bfloat16
        qc, kc, vc = (t.to(dtype) for t in (q, k, v))
        o, lse = flash_attention_fwd(qc, kc, vc, pos, pos, **kw)
        ro, rlse = flash_attention_fwd_ref(qc, kc, vc, pos, pos, **kw)
        torch.cuda.synchronize()
        tol = 2e-2 if bf16 else 2e-5
        e = float(torch.max(torch.abs(o.float() - ro.float())))
        el = float(torch.max(torch.abs(lse - rlse)))
        label = (f"B={B} S={S} H={Hq} Kv={Kv} hd={hd} window={window} "
                 f"{str(dtype)[6:]}" + ("" if causal else " non-causal"))
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
            # (a gradient that is 0, as dQ and dK at S = 1, has none)
            rel = max((float(torch.linalg.vector_norm(a - b)
                             / torch.linalg.vector_norm(b))
                       for a, b in zip(g, rg) if bool(torch.any(b != 0))),
                      default=0.0)
            check(all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                      for a, b in zip(g, rg)),
                  f"flash_attention_bwd disagrees at {label}: {eb}")
            err["bwd"] = max(err["bwd"], eb)
            line += f"; backward max|err| {eb:.3g} (rel l2 {rel:.3g})"
            if hd == 256 and Kv == 1 and S == ATTN_SEQ:
                # MQA: the warp pairs' exchanged partials of S, dK/dV's
                # partial sums over the heads' parts
                for _ in range(2):
                    o2, lse2 = flash_attention_fwd(q, k, v, pos, pos, **kw)
                    g2 = flash_attention_bwd(q, k, v, o, lse, do, pos, pos,
                                             **kw)
                    check(torch.equal(o2, o) and torch.equal(lse2, lse),
                          f"flash_attention_fwd at {label}: three runs do "
                          f"not give the same bits")
                    check(all(torch.equal(a, b) for a, b in zip(g2, g)),
                          f"flash_attention_bwd at {label}: three runs do "
                          f"not give the same bits")
                line += "; three forward and backward runs bit for bit"
                del o2, lse2, g2
            del g, rg
        print(line, flush=True)
        key = [k_ for k_, v_ in FLASH_TIMED.items() if v_ == (Hq, Kv, hd)]
        if B == ATTN_BATCH and S == ATTN_SEQ and key:
            timed[key[0]] = flash_times(torch, q, k, v, do, pos, o, lse)
        del q, k, v, do, qc, kc, vc, o, lse
        torch.cuda.empty_cache()
    out = timed.pop("hd128")
    out["flash_attention_fwd"]["max_abs_err"] = err["fwd"]
    out["flash_attention_fwd"]["max_abs_err_bf16"] = err["fwd_bf16"]
    out["flash_attention_bwd"]["max_abs_err"] = err["bwd"]
    for key, res in timed.items():
        for name, r_ in res.items():
            out[name][key] = r_
    return out


def flash_times(torch, q, k, v, do, pos, o, lse):
    """Phase 3, a timed shape of FLASH_TIMED (causal, no window): the
    forward and backward kernels, their plain versions, the bound of the
    kernels' split-TF32 route (three TF32 products a float32 operation over
    the visible pairs at the tensor cores' 495 TFLOP/s, or the bytes if
    larger; beside it, for continuity, the float32 operations at the CUDA
    cores' 67 TFLOP/s) and torch's scaled_dot_product_attention(
    is_causal=True, enable_gqa for Kv < H) on the same float32 tensors in
    its (B, H, S, hd) layout, forward, and its backward on a retained
    graph; then the backward's own kernels (row sums, dK/dV, the reduction
    of its partial sums where the heads are split, dQ): each one's device
    time a call from a torch.profiler trace (flash_bench.backward_kernel_ms,
    "kernels_ms"). Returns {kernel: its numbers}."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    from repro_torch.kernels.flash_bench import (backward_kernel_ms,
                                                 library_ms, shares_line)
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_fwd_ref)
    B, S, Hq, hd = q.shape
    Kv = k.shape[2]
    pairs = visible_pairs(S, True, None)
    n_q, n_kv, rows = B * S * Hq * hd, B * S * Kv * hd, B * Hq * S
    cost = {"flash_attention_fwd": (4 * (2 * n_q + 2 * n_kv + rows)
                                    + 8 * B * S, 4 * hd * pairs * B * Hq),
            "flash_attention_bwd": (4 * (4 * n_q + 4 * n_kv + rows)
                                    + 8 * B * S, 10 * hd * pairs * B * Hq)}
    timed = {"flash_attention_fwd": (
                 lambda: flash_attention_fwd(q, k, v, pos, pos),
                 lambda: flash_attention_fwd_ref(q, k, v, pos, pos)),
             "flash_attention_bwd": (
                 lambda: flash_attention_bwd(q, k, v, o, lse, do, pos, pos),
                 lambda: flash_attention_bwd_ref(q, k, v, do, pos, pos))}
    res = {}
    for name, (fn, plain) in timed.items():
        nbytes, ops = cost[name]
        b_ms, b_by = bound(nbytes, ops, TF32_SPLIT_FLOPS)
        res[name] = {"shape": [B, S, Hq, Kv, hd], "ms": time_ms(torch, fn),
                     "plain_ms": time_ms(torch, plain, reps=PLAIN_REPS,
                                         warmup=1),
                     "bytes": nbytes, "ops": ops, "bound_ms": b_ms,
                     "bound_by": b_by}
    (res["flash_attention_fwd"]["library_ms"],
     res["flash_attention_bwd"]["library_ms"]) = library_ms(q, k, v, do)
    per = backward_kernel_ms(timed["flash_attention_bwd"][0])
    res["flash_attention_bwd"]["kernels_ms"] = per
    print(f"time flash_attention_bwd's kernels (B={B}, S={S}, H={Hq}, "
          f"Kv={Kv}, hd={hd}, causal; torch.profiler, a call): "
          f"{shares_line(per)}; {card_line()}", flush=True)
    for name, r_ in res.items():
        print(f"time {name} (B={B}, S={S}, H={Hq}, Kv={Kv}, hd={hd}, "
              f"causal; {card_line()}): kernel {r_['ms']:.4f} ms, plain "
              f"{r_['plain_ms']:.4f} ms, library {r_['library_ms']} ms; "
              f"bound {r_['bound_ms']:.4f} ms ({r_['bound_by']}: 3 TF32 "
              f"products for each of {r_['ops']} float32 operations at 495 "
              f"TFLOP/s), {100 * r_['bound_ms'] / r_['ms']:.1f}% of it; on "
              f"the float32 CUDA cores (67 TFLOP/s) "
              f"{1e3 * r_['ops'] / FP32_FLOPS:.4f} ms", flush=True)
    return res


def _rel_l2(torch, a, b, slab=1 << 24):
    """||a - b|| / ||b|| in float64, a slab of elements at a time (no
    float64 copy of a leaf of billions)."""
    a, b = a.reshape(-1), b.reshape(-1)
    err = ref = 0.0
    for lo in range(0, b.numel(), slab):
        x = b[lo:lo + slab].double()
        err += float(torch.sum(torch.square(a[lo:lo + slab].double() - x)))
        ref += float(torch.sum(torch.square(x)))
    return math.sqrt(err / max(ref, 1e-60))


def flash16_checks(torch):
    """Phase 3, flash attention on bfloat16 and float16 q, k, v
    (``csrc/flash_attention16.cu``): first each 16-bit kernel's resources
    at every head dim of HEAD_DIMS, which must show no local memory
    (spills) and at least 8 warps an SM; then the forward and the backward
    kernels of each 16-bit library against their plain versions at every
    head dim (B 2, S 100, H 4 on Kv 2, causal), with a window, without the
    causal mask, MQA at hd 256, seamless's non-causal hd 64 batch and the
    timed shapes of FLASH16_TIMED. The gate (FLASH16_FACTOR): each output's
    relative l2 distance from the float32 yardstick (the plain version on
    the 16-bit values widened to float32: out, and dq, dk, dv from the same
    dO) at most the factor times the plain 16-bit version's; outputs in the
    inputs' type, finite; at the timed shapes a second forward and backward
    bit for bit the first. Prints each output's worst ratio a type. Times
    at FLASH16_TIMED (flash16_times). Returns {"flash_attention_fwd_bf16":
    ..., "flash_attention_bwd_bf16": ..., "..._f16": ...}, each with the hd
    128 numbers and an "hd256" sub-dict, "max_abs_err" (against the plain
    version) and "worst_ratio"."""
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     flash_attention_bwd,
                                                     flash_attention_fwd,
                                                     occupancy)
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_fwd_ref)
    for hd in HEAD_DIMS:
        for name, r in occupancy(hd, ATTN_SEQ).items():
            if name.endswith("float32"):
                continue
            print(f"flash attention {name} at hd {hd}: {r['registers']} "
                  f"registers, {r['local_bytes']} B local (spills) a "
                  f"thread, {r['blocks_per_sm']} blocks "
                  f"({r['warps_per_sm']} warps) per SM, {r['smem']} B "
                  f"shared memory", flush=True)
            check(r["registers"] > 0 and r["local_bytes"] == 0
                  and r["warps_per_sm"] >= 8,
                  f"flash attention {name} at hd {hd} spills or runs under "
                  f"8 warps an SM: {r}")
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(16)
    # (B, S, H, Kv, hd, window, causal)
    cases = [(2, 100, 4, 2, hd, None, True) for hd in HEAD_DIMS]
    cases += [(1, 100, 2, 1, 128, 48, True), (2, 100, 4, 2, 96, 48, True),
              (1, 130, 4, 2, 256, 48, True), (1, 77, 2, 1, 256, None, False),
              (2, 100, 8, 1, 256, None, True),
              (4, 1024, 16, 16, 64, None, False)]
    cases += [(ATTN_BATCH, ATTN_SEQ, H_, Kv_, hd, None, True)
              for H_, Kv_, hd in FLASH16_TIMED.values()]
    out = {}
    for dtype, sfx in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        fname, bname = f"flash_attention_fwd_{sfx}", f"flash_attention_bwd_{sfx}"
        res = {fname: {"max_abs_err": 0.0, "worst_ratio": 0.0},
               bname: {"max_abs_err": 0.0, "worst_ratio": 0.0}}
        worst = dict.fromkeys(("out", "dq", "dk", "dv"), 0.0)
        for B, S, Hq, Kv, hd, window, causal in cases:
            q, k, v, do = (torch.randn((B, S, n, hd), generator=gen,
                                       device=dev).to(dtype)
                           for n in (Hq, Kv, Kv, Hq))
            pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
            kw = dict(causal=causal, window=window)
            label = (f"B={B} S={S} H={Hq} Kv={Kv} hd={hd} window={window} "
                     f"{sfx}" + ("" if causal else " non-causal"))
            o, lse = flash_attention_fwd(q, k, v, pos, pos, **kw)
            ro, _ = flash_attention_fwd_ref(q, k, v, pos, pos, **kw)
            yo, _ = flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                            pos, pos, **kw)
            g = flash_attention_bwd(q, k, v, o, lse, do, pos, pos, **kw)
            rg = flash_attention_bwd_ref(q, k, v, do, pos, pos, **kw)
            yg = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                         do.float(), pos, pos, **kw)
            torch.cuda.synchronize()
            line = f"check flash attention {label}:"
            for name, what, got, plain, yard in (
                    [(fname, "out", o, ro, yo)]
                    + [(bname, w, a, b, y) for w, a, b, y in
                       zip(("dq", "dk", "dv"), g, rg, yg)]):
                check(got.dtype == dtype and bool(torch.isfinite(got).all()),
                      f"{name} at {label}: {got.dtype} output or not finite")
                if not bool(torch.any(yard != 0)):
                    continue  # dq and dk at S = 1: none to measure
                ek, ep = _rel_l2(torch, got, yard), _rel_l2(torch, plain,
                                                            yard)
                check(ek <= FLASH16_FACTOR * ep,
                      f"{name} at {label}: {ek:.3g} from the float32 "
                      f"yardstick, the plain version {ep:.3g} (factor "
                      f"{FLASH16_FACTOR})")
                r = res[name]
                r["worst_ratio"] = max(r["worst_ratio"], ek / ep)
                worst[what] = max(worst[what], ek / ep)
                r["max_abs_err"] = max(r["max_abs_err"], float(torch.max(
                    torch.abs(got.float() - plain.float()))))
                line += f" {ek:.3g}/{ep:.3g}"
            print(line + " (kernel / plain relative l2 from the float32 "
                  "yardstick: out, dq, dk, dv)", flush=True)
            key = [k_ for k_, v_ in FLASH16_TIMED.items()
                   if v_ == (Hq, Kv, hd)]
            if B == ATTN_BATCH and S == ATTN_SEQ and key:
                o2, lse2 = flash_attention_fwd(q, k, v, pos, pos, **kw)
                g2 = flash_attention_bwd(q, k, v, o, lse, do, pos, pos, **kw)
                check(torch.equal(o2, o) and torch.equal(lse2, lse)
                      and all(torch.equal(a, b) for a, b in zip(g2, g)),
                      f"flash attention at {label}: two runs do not give "
                      f"the same bits")
                print(f"check flash attention {label}: a second forward "
                      f"and backward bit for bit", flush=True)
                del o2, lse2, g2
                t = flash16_times(torch, q, k, v, do, pos, o, lse)
                for name, r_ in ((fname, t["fwd"]), (bname, t["bwd"])):
                    if key[0] == "hd128":
                        res[name].update(r_)
                    else:
                        res[name][key[0]] = r_
            del q, k, v, do, o, lse, ro, yo, g, rg, yg
            torch.cuda.empty_cache()
        print(f"flash attention {sfx}: each output's worst ratio of its "
              f"relative l2 distance from the float32 yardstick to the "
              f"plain 16-bit version's, over every case: "
              + ", ".join(f"{w} {x:.3f}" for w, x in worst.items())
              + f" (gate {FLASH16_FACTOR})", flush=True)
        out.update(res)
    return out


def flash16_times(torch, q, k, v, do, pos, o, lse):
    """Phase 3, a timed shape of FLASH16_TIMED on 16-bit tensors (causal):
    the forward and the backward kernels, their plain 16-bit versions,
    scaled_dot_product_attention on the same tensors (forward; backward on
    a retained graph) and the bound: the function's operations over the
    visible pairs at the tensor cores' dense 16-bit rate (BF16_FLOPS, the
    same for float16; the forward S = Q K^T and P V: 4 hd a pair; the
    backward S, dP, dV, dK and dQ: 10 hd a pair, P and dS rounded to the
    inputs' type as the plain 16-bit version rounds them), or the bytes (2
    a value, 4 an lse or position) if larger. Beside it, as ``route_ms``,
    the operations the kernels do at the same rate (``route_ops``): the
    forward 4 hd a pair; the backward 14 hd (dK/dV and dQ each compute S
    and dP), 18 hd at hd 256 (dK/dV's two column blocks each compute S^T
    and dP^T). Returns {"fwd", "bwd": numbers}."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    from repro_torch.kernels.flash_bench import (backward_kernel_ms,
                                                 library_ms, shares_line)
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_fwd_ref)
    B, S, Hq, hd = q.shape
    Kv = k.shape[2]
    pairs = visible_pairs(S, True, None)
    n_q, n_kv, rows = B * S * Hq * hd, B * S * Kv * hd, B * Hq * S
    e = q.element_size()
    # (bytes, the function's operations, the kernels' operations)
    cost = {"fwd": (e * (2 * n_q + 2 * n_kv) + 4 * rows + 8 * B * S,
                    4 * hd * pairs * B * Hq, 4 * hd * pairs * B * Hq),
            "bwd": (e * (4 * n_q + 4 * n_kv) + 4 * rows + 8 * B * S,
                    10 * hd * pairs * B * Hq,
                    (14 if hd <= 128 else 18) * hd * pairs * B * Hq)}
    fns = {"fwd": (lambda: flash_attention_fwd(q, k, v, pos, pos),
                   lambda: flash_attention_fwd_ref(q, k, v, pos, pos)),
           "bwd": (lambda: flash_attention_bwd(q, k, v, o, lse, do, pos, pos),
                   lambda: flash_attention_bwd_ref(q, k, v, do, pos, pos))}
    res = {}
    for name, (fn, plain) in fns.items():
        nbytes, ops, route_ops = cost[name]
        b_ms, b_by = bound(nbytes, ops, BF16_FLOPS)
        res[name] = {"shape": [B, S, Hq, Kv, hd], "ms": time_ms(torch, fn),
                     "plain_ms": time_ms(torch, plain, reps=PLAIN_REPS,
                                         warmup=1),
                     "bytes": nbytes, "ops": ops, "bound_ms": b_ms,
                     "bound_by": b_by, "route_ops": route_ops,
                     "route_ms": bound(nbytes, route_ops, BF16_FLOPS)[0]}
    res["fwd"]["library_ms"], res["bwd"]["library_ms"] = library_ms(q, k, v,
                                                                   do)
    per = backward_kernel_ms(fns["bwd"][0])
    res["bwd"]["kernels_ms"] = per
    tag = f"{str(q.dtype)[6:]} B={B}, S={S}, H={Hq}, Kv={Kv}, hd={hd}, causal"
    print(f"time flash_attention_bwd's kernels ({tag}; torch.profiler, a "
          f"call): {shares_line(per)}; {card_line()}", flush=True)
    for name, r_ in res.items():
        print(f"time flash attention {name} ({tag}; {card_line()}): kernel "
              f"{r_['ms']:.4f} ms, plain {r_['plain_ms']:.4f} ms, library "
              f"{r_['library_ms']} ms; bound {r_['bound_ms']:.4f} ms "
              f"({r_['bound_by']}: {r_['ops']} operations at 989 TFLOP/s), "
              f"{100 * r_['bound_ms'] / r_['ms']:.1f}% of it; the kernels' "
              f"own operations' {r_['route_ms']:.4f} ms ({r_['route_ops']} "
              f"at 989 TFLOP/s), {100 * r_['route_ms'] / r_['ms']:.1f}% of "
              f"it", flush=True)
    return res


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
    rounds = ROUNDS if path in ("f32", "faults") else SIDE_ROUNDS
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=rounds * H)
    plan = FAULTS if path == "faults" else None
    per_round, eval_batch = segment_inputs(cfg, M, rounds,
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
    # the main path's final state, before the breakdown's timed AdamW
    # steps update it in place (phase 10 holds the launcher's to it)
    fingerprint = state_fingerprint(torch, state) if path == "f32" else None
    if path == "f32" or cfg.dist.attn_block:
        breakdown(torch, model, opt, state, spec, per_round[0], path)
    record = {"losses": losses, "grad_norms": gnorms, "xis": xis,
              "peak": peak, "width": spec.width,
              "merged": merged, "local": local, "times": times}
    if cfg.dist.attn_block:
        check(counts["flash_attention_bwd"] == rounds * H * M * cfg.num_layers
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
    if path == "f32":  # the serve phase merges, saves and serves it
        record["state"], record["spec"] = state, spec
        record["fingerprint"] = fingerprint
    del state, seg
    torch.cuda.empty_cache()
    return counts, record


def state_fingerprint(torch, state, slab=1 << 22, col0=0):
    """{panel, m, v: [sum of the float32 bit patterns, sum of the patterns
    times (column % 65521 + 1), mod 2^64]} of a float32 panel state: equal
    states give equal fingerprints; taken a column slab at a time (int64
    views of SLAB columns, no (m, D) temporary). A shard whose first column
    is ``col0`` gives its part (the parts of a sharded state sum to the
    whole's, modulo 2^64): tensors_fingerprint of the three panels."""
    return tensors_fingerprint(torch, {
        "panel": (state["panel"]["float32"], col0),
        "m": (state["opt"]["m"]["float32"], col0),
        "v": (state["opt"]["v"]["float32"], col0)}, slab)


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


def tree_nbytes(tree):
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def serve_requests(cfg, n, seed=SERVE_SEED):
    """The serve phase's traffic: ``n`` requests, prompts of SERVE_PROMPTS
    tokens in turn (two buckets), ids drawn as launch/serve.py draws them,
    SERVE_NEW new tokens each."""
    from repro_torch.launch.serve import request_tokens
    from repro_torch.serving import Request
    return [Request(rid=i, tokens=request_tokens(
        cfg, seed, i, SERVE_PROMPTS[i % len(SERVE_PROMPTS)]),
        max_new=SERVE_NEW) for i in range(n)]


def decode_bound_ms(cfg, params, C, live_keys):
    """The least time of one decode step over C slots: every weight read
    once, plus the keys and values the step's queries attend to
    (``live_keys`` of them, summed over the C slots: the cache positions
    each slot holds), over the memory rate; the logits (C, padded vocab)
    written once."""
    a = cfg.attn
    kv = 2 * live_keys * cfg.num_layers * a.num_kv_heads * a.head_dim * 4
    nbytes = tree_nbytes(params) + kv + C * cfg.padded_vocab * 4
    return 1e3 * nbytes / HBM_BYTES_PER_S, nbytes


def batch_probe(torch, model, params, reqs, max_len, steps=SERVE_PROBE):
    """Batch independence on the card: the C prompts of ``reqs`` prefilled
    one at a time and put in the slots of one cache, then ``steps`` decode
    steps over all C slots against each row decoded alone (B = 1), both fed
    the lone rows' greedy tokens. Returns (max |logit difference|, the
    smallest top-1/top-2 gap of the lone rows' masked logits, the steps
    whose greedy token differs)."""
    from repro_torch.serving import make_decode_fn, make_prefill_fn, mask_oov
    from repro_torch.serving.engine import _tree_insert
    dev = torch.device("cuda")
    C = len(reqs)
    prefill = make_prefill_fn(model, max_len=max_len)
    decode = make_decode_fn(model)
    batched = model.init_cache(C, max_len, device=dev)
    rows, last, pos = [], [], []
    for i, r in enumerate(reqs):
        logits, row = prefill(params, {"tokens": torch.from_numpy(
            r.tokens[None]).to(dev)})
        _tree_insert(batched, row, i)
        rows.append(row)
        last.append(int(torch.argmax(mask_oov(logits, model.cfg.vocab_size))))
        pos.append(len(r.tokens))
    diff, gap, flips = 0.0, math.inf, 0
    for _ in range(steps):
        tok = torch.tensor(last, dtype=torch.int32, device=dev)[:, None]
        idx = torch.tensor(pos, dtype=torch.int32, device=dev)
        lb, _ = decode(params, batched, tok, idx)
        lb = mask_oov(lb, model.cfg.vocab_size)
        for i in range(C):
            li, _ = decode(params, rows[i], tok[i:i + 1], pos[i])
            li = mask_oov(li, model.cfg.vocab_size)[0]
            fin = torch.isfinite(li)
            diff = max(diff, float(torch.max(torch.abs(lb[i][fin] - li[fin]))))
            top2 = torch.topk(li, 2).values
            gap = min(gap, float(top2[0] - top2[1]))
            flips += int(torch.argmax(lb[i]) != torch.argmax(li))
            last[i] = int(torch.argmax(li))
            pos[i] += 1
    return diff, gap, flips


def serve_run(torch, label, model, params, merged_ref=None, checked=2):
    """One engine run of the serve phase: SERVE_C slots, warmed up on one
    request of each prompt bucket (4 new tokens; then reset), SERVE_REQUESTS
    requests
    timed; the launch counts set to 0 before the warmup and read after the
    timed run. Then the checks: no id >= vocab_size, and the greedy tokens
    of the first ``checked`` requests equal ``generate`` of each alone (on
    ``merged_ref``
    when given, the in-memory merged model the engine's restored params
    came from). Returns (counts, record, the served tokens by request)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import ServingEngine, generate
    cfg = model.cfg
    dev = torch.device("cuda")
    max_len = max(SERVE_PROMPTS) + SERVE_NEW
    reqs = serve_requests(cfg, SERVE_REQUESTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.perf_counter()
    eng = ServingEngine(model, params, max_concurrency=SERVE_C,
                        max_len=max_len)
    warm = serve_requests(cfg, len(SERVE_PROMPTS), seed=SERVE_SEED + 1)
    for r in warm:
        r.max_new = 4
    eng.serve(warm)
    eng.reset()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    snap = eng.snapshot()
    lat = snap["latency"]
    n_tok = sum(len(v) for v in out.values())
    b_ms, b_bytes = decode_bound_ms(
        cfg, params, SERVE_C,
        sum(len(r.tokens) + SERVE_NEW // 2 for r in reqs[:SERVE_C]))
    rec = {"tok_s": n_tok / dt, "seconds": dt, "tokens": n_tok,
           "ticks": snap["ticks"], "occupancy": snap["occupancy"],
           "ttft_p50_ms": 1e3 * lat["ttft_s"]["p50_s"],
           "ttft_p99_ms": 1e3 * lat["ttft_s"]["p99_s"],
           "queue_p50_ms": 1e3 * lat["queue_wait_s"]["p50_s"],
           "decode_step_p50_ms": 1e3 * lat["decode_step_s"]["p50_s"],
           "per_token_p50_ms": 1e3 * lat["per_token_s"]["p50_s"],
           "decode_bound_ms": b_ms, "decode_bound_bytes": b_bytes,
           "peak": peak, "held": held, "warmup_s": t_warm,
           "flash_fwd": counts["flash_attention_fwd"]}
    print(f"serve ({label}): {cfg.num_layers} layers, attn_block "
          f"{cfg.dist.attn_block}, {SERVE_C} slots, {SERVE_REQUESTS} "
          f"requests of {SERVE_PROMPTS} prompt tokens, {SERVE_NEW} new: "
          f"{rec['tok_s']:.1f} tok/s ({n_tok} tokens in {dt:.3f}s, "
          f"{snap['ticks']} ticks) | ttft p50/p99 {rec['ttft_p50_ms']:.1f}/"
          f"{rec['ttft_p99_ms']:.1f} ms | queue p50 {rec['queue_p50_ms']:.1f}"
          f" ms | decode step p50 {rec['decode_step_p50_ms']:.3f} ms (bound "
          f"{b_ms:.3f} ms: {b_bytes} bytes) | per-token p50 "
          f"{rec['per_token_p50_ms']:.3f} ms | occupancy "
          f"{snap['occupancy']:.4f} | peak device memory {peak} bytes "
          f"({held} held before) | warmup {t_warm:.1f}s | flash forward "
          f"launches {rec['flash_fwd']}", flush=True)
    print(f"kernels (serve {label}) {json.dumps(counts)}", flush=True)
    oov = [rid for rid, v in out.items()
           if not ((v >= 0) & (v < cfg.vocab_size)).all()]
    check(not oov, f"serve ({label}): requests {oov} emitted an OOV id")
    check(len(out) == SERVE_REQUESTS and all(
        len(v) == SERVE_NEW for v in out.values()),
        f"serve ({label}): not every request got {SERVE_NEW} tokens")
    check(snap["occupancy"] > 0.9,
          f"serve ({label}): occupancy {snap['occupancy']}")
    same = []
    for r in reqs[:checked]:
        alone = generate(model, params if merged_ref is None else merged_ref,
                         {"tokens": torch.from_numpy(r.tokens[None]).to(dev)},
                         SERVE_NEW, max_len=max_len)[0]
        same.append(bool((alone == out[r.rid]).all()))
    diff, gap, flips = batch_probe(torch, model, params, reqs[:SERVE_C],
                                   max_len)
    rec.update(logit_diff=diff, min_gap=gap, flips=flips)
    print(f"serve ({label}): greedy tokens of the first {checked} "
          f"requests equal generate alone: {same}; batch of {SERVE_C} "
          f"against each row "
          f"alone over {SERVE_PROBE} decode steps: max |logit difference| "
          f"{diff!r}, smallest top-1/top-2 gap {gap!r}, argmax flips "
          f"{flips}", flush=True)
    check(all(same), f"serve ({label}): the engine's greedy tokens differ "
                     f"from generate alone")
    del eng
    torch.cuda.empty_cache()
    return counts, rec, out


def prefill_agreement(torch, dense, blockwise, params, reqs, max_len):
    """The attn_block model's prefill logits (the flash attention forward
    kernel) against the dense model's (plain ``_sdpa``) on the same
    restored params and prompts, one request a call as the engine
    prefills: max |difference| and whether every one is within the phase-3
    float32 tolerance (2e-5 absolute + 2e-5 relative)."""
    from repro_torch.serving import make_prefill_fn
    fd = make_prefill_fn(dense, max_len=max_len)
    fb = make_prefill_fn(blockwise, max_len=max_len)
    diff, ok = 0.0, True
    for r in reqs:
        batch = {"tokens": torch.from_numpy(r.tokens[None]).cuda()}
        ld, _ = fd(params, batch)
        lb, _ = fb(params, batch)
        diff = max(diff, float(torch.max(torch.abs(ld - lb))))
        ok = ok and torch.allclose(lb, ld, atol=2e-5, rtol=2e-5)
    return diff, ok


def serve_phase(torch, state, spec):
    """Phase 9, the merged model saved and served (run on the main path's
    final state, right after it): the merged model (``merged_panel_tree``,
    the reduce kernel, as launch/train.py --save-merged takes it) saved with
    checkpoint.save, restored into a fresh init of another seed, every leaf
    held bit for bit against the in-memory merged tree; then the
    ServingEngine on the restored model with dense prefill and with
    attn_block SERVE_BLOCK prefill (the flash attention forward kernel,
    once a layer a prefill), the two runs held against each other
    (prefill_agreement, and their greedy tokens equal), and the whole
    published olmo-1b (16 layers, the port's own init) with attn_block
    SERVE_BLOCK (serve_run). Returns (counts summed over its runs,
    records)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_config
    from repro_torch.core import merge as merge_mod
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    total = {}

    def add(c):
        for k, v in c.items():
            total[k] = total.get(k, 0) + v

    reset_launch_counts()
    merged = merge_mod.merged_panel_tree(state["panel"], spec,
                                         stats=state.get("merge_stat"))
    del state
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix=".serve_ckpt_", dir=ROOT)
    try:
        path = os.path.join(tmp, "merged.ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(path, merged)
        t_save = time.perf_counter() - t0
        add(launch_counts())
        nbytes = os.path.getsize(path)
        cfg2 = get_config("olmo-1b").replace(num_layers=2)
        model = build_model(cfg2)
        template = model.init_params(
            torch.Generator(device=dev).manual_seed(1), dev)
        t0 = time.perf_counter()
        restored = restore(path, template)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del template
    same = tree_equal(torch, restored, merged)
    print(f"serve: merged model ({spec.merger}) saved to a "
          f"{nbytes}-byte blob ({tree_nbytes(merged)} bytes of float32 "
          f"leaves) in {t_save:.3f}s, restored into an init of another seed "
          f"in {t_restore:.3f}s; every leaf equal to the in-memory merged "
          f"model bit for bit: {same}; launches {json.dumps(total)}",
          flush=True)
    check(same, "serve: the restored model differs from the merged one")
    check(total["panel_mean_consensus"] == 1,
          f"serve: the merge launched {total}")
    records = {"save_s": t_save, "restore_s": t_restore, "bytes": nbytes}
    # one flash forward launch a layer a prefill: every timed request and
    # the warmup's one of each bucket
    prefills = SERVE_REQUESTS + len(SERVE_PROMPTS)
    models, served = {}, {}
    for label, blk in (("dense", 0), (f"attn_block {SERVE_BLOCK}",
                                      SERVE_BLOCK)):
        models[blk] = build_model(cfg2.replace(dist=dataclasses.replace(
            cfg2.dist, attn_block=blk)))
        c, records[label], served[blk] = serve_run(
            torch, label, models[blk], restored, merged)
        add(c)
        want = prefills * cfg2.num_layers if blk else 0
        check(c["flash_attention_fwd"] == want,
              f"serve ({label}): {c['flash_attention_fwd']} flash forward "
              f"launches, not {want}")
    diff, close = prefill_agreement(
        torch, models[0], models[SERVE_BLOCK], restored,
        serve_requests(cfg2, SERVE_C), max(SERVE_PROMPTS) + SERVE_NEW)
    same = [rid for rid, v in served[0].items()
            if np.array_equal(v, served[SERVE_BLOCK][rid])]
    print(f"serve: attn_block {SERVE_BLOCK} prefill (flash forward) against "
          f"dense prefill on the restored model, {SERVE_C} prompts of "
          f"{SERVE_PROMPTS} tokens: max |logit difference| {diff!r} "
          f"(within 2e-5 + 2e-5 relative: {close}); greedy tokens equal "
          f"between the two runs in {len(same)} of {SERVE_REQUESTS} "
          f"requests", flush=True)
    check(close, f"serve: attn_block prefill logits differ from dense by "
                 f"{diff}")
    check(len(same) == SERVE_REQUESTS,
          "serve: the attn_block run's greedy tokens differ from the dense "
          "run's")
    # phase 12g (ii) serves the merged model again, split over two ranks
    records["merged_cpu"] = tree_to(merged, "cpu")
    del restored, merged, models, served
    torch.cuda.empty_cache()
    full = get_config("olmo-1b")
    full = full.replace(dist=dataclasses.replace(full.dist,
                                                 attn_block=SERVE_BLOCK))
    model = build_model(full)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(2),
                               dev)
    torch.cuda.synchronize()
    print(f"serve: olmo-1b at its published depth ({full.num_layers} "
          f"layers, d_model {full.d_model}, vocab {full.vocab_size} padded "
          f"to {full.padded_vocab}): {tree_nbytes(params)} bytes of float32 "
          f"parameters, initialised on the card in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    label = f"olmo-1b {full.num_layers} layers, attn_block {SERVE_BLOCK}"
    c, records["full"], _ = serve_run(torch, label, model, params,
                                      checked=1)
    add(c)
    want = prefills * full.num_layers
    check(c["flash_attention_fwd"] == want,
          f"serve ({label}): {c['flash_attention_fwd']} flash forward "
          f"launches, not {want}")
    del params
    torch.cuda.empty_cache()
    print(f"serve phase: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return total, records


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
    state (its AdamW steps update the state in place). Runs after the main
    path's counts were read."""
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


def trace_summary(path, top=10, gaps=5):
    """The device's share of a torch.profiler Chrome trace: the union of
    its kernel, memcpy and memset intervals over the traced window (the
    span of every timed event), the ``top`` device operations by total
    time and the ``gaps`` longest idle gaps between device intervals (each
    with the device operations on either side and the innermost host
    operation spanning its middle)."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "ts" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                     e.get("name", "?")) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    check(device, f"the trace {path} holds no device operation")
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    merged = []  # (start, end, first name, last name)
    for a, b, name in device:
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b, merged[-1][2], name)
        else:
            merged.append((a, b, name, name))
    busy = sum(b - a for a, b, *_ in merged)
    per_op = {}
    for a, b, name in device:
        n, t = per_op.get(name, (0, 0.0))
        per_op[name] = (n + 1, t + b - a)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("name", "?")) for e in events
                  if e.get("cat") == "cpu_op")
    holes = sorted(((merged[i + 1][0] - merged[i][1], i)
                    for i in range(len(merged) - 1)), reverse=True)[:gaps]
    longest = []
    for gap, i in holes:
        mid = merged[i][1] + gap / 2
        over = [h for h in host if h[0] <= mid <= h[1]]
        ended = [h for h in host if h[1] < mid]
        starts = [h for h in host if h[0] > mid]
        longest.append({
            "ms": round(gap / 1e3, 3),
            "at_ms": round((merged[i][1] - lo) / 1e3, 3),
            "after": merged[i][3][:60], "before": merged[i + 1][2][:60],
            # the innermost host operation spanning the gap's middle, else
            # the host operations on either side of it
            "host_op": (min(over, key=lambda h: h[1] - h[0])[2] if over
                        else None),
            "host_before": max(ended, key=lambda h: h[1])[2] if ended
            else None,
            "host_after": starts[0][2] if starts else None})
    return {"window_ms": round((hi - lo) / 1e3, 3),
            "device_busy_ms": round(busy / 1e3, 3),
            "device_busy_share": busy / (hi - lo),
            "device_ops": len(device),
            "top_ops": [{"name": k[:80], "launches": n, "ms": round(t / 1e3,
                                                                    3)}
                        for k, (n, t) in sorted(per_op.items(),
                                                key=lambda kv: -kv[1][1])
                        [:top]],
            "longest_gaps": longest}


def launcher_run(torch, main, tmp):
    """Phase 10 (a): the launcher's own loop (launch/train.py:run) on the
    main path's cell, with --telemetry --events --snapshot --profile into
    ``tmp``; held against phase 5's record ``main``. Returns (counts,
    record)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.telemetry import (export_stream, read_events,
                                       validate_stream)
    import numpy as np
    cfg = get_config("olmo-1b").replace(num_layers=2)
    lm = SyntheticLM(vocab=DATA_VOCAB, num_domains=8, seed=0)
    ev = os.path.join(tmp, "events.jsonl")
    prof = os.path.join(tmp, "profile")
    args = train.parse_args(LAUNCHER_ARGS + [
        "--telemetry", "--events", ev, "--snapshot",
        os.path.join(tmp, "snapshot.json"), "--profile", prof, "--out", tmp])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the segment's last output state, kept for its fingerprint (the run
    # returns its history only)
    last, make = {}, train.dsgd.make_panel_segment

    def keeping(*a, **kw):
        seg = make(*a, **kw)

        def run_seg(*sa, **skw):
            out = seg(*sa, **skw)
            last["state"] = out[0]
            return out
        return run_seg

    reset_launch_counts()
    t0 = time.perf_counter()
    train.dsgd.make_panel_segment = keeping
    try:
        hist = train.run(args, cfg=cfg, lm=lm)
    finally:
        train.dsgd.make_panel_segment = make
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    fingerprint = state_fingerprint(torch, last.pop("state"))
    print(f"kernels (launcher) {json.dumps(counts)}", flush=True)
    check(all(counts[k] > 0 for k in PATH_KERNELS["f32"]),
          f"a kernel of the main path never launched in the launcher's run: "
          f"{counts}")
    got = {"losses": [h["train_loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "xis": [h["consensus"] for h in hist],
           "merged": hist[-1]["merged_eval"], "local": hist[-1]["local_eval"]}
    same = {k: got[k] == main[k] for k in got}
    same["state"] = fingerprint == main["fingerprint"]
    errors = validate_stream(ev)
    rounds = [e for e in read_events(ev) if e["type"] == "round"]
    decomp = [abs(math.sqrt(sum(d * d for d in e["dist_to_mean"])
                            / len(e["dist_to_mean"])) - e["consensus"])
              / max(e["consensus"], 1e-30) if e["consensus"] else
              max(e["dist_to_mean"]) for e in rounds]
    wire = sum(sum(e["wire_bytes"]) for e in rounds)
    per_round, _ = segment_inputs(cfg, M, ROUNDS, data_vocab=DATA_VOCAB)
    rows = sum(int(np.sum(~np.all(W[0] == np.eye(M, dtype=np.float32),
                                  axis=1))) for W, *_ in per_round)
    want = rows * 4 * main["width"]  # the f32 codec: 4 B a value
    with open(os.path.join(tmp, "snapshot.json")) as f:
        snap = json.load(f)
    snap_ok = (snap == export_stream(ev)
               and snap["last_round"]["round"] == ROUNDS - 1)
    trace_path = os.path.join(prof, "trace.json")
    check(os.path.exists(trace_path),
          f"launcher: --profile wrote no trace at {trace_path}")
    trace = trace_summary(trace_path)
    print(f"launcher (phase 10a, {args.rounds} rounds, segment "
          f"{args.segment}, telemetry, events, snapshot, profile): {dt:.1f}s; "
          f"history and final state (panel, m, v fingerprints "
          f"{json.dumps(fingerprint)}) equal to phase 5's "
          f"{json.dumps(same)}; last round Xi "
          f"{got['xis'][-1]!r}, merged {got['merged']!r} local "
          f"{got['local']!r}; stream {len(rounds)} rounds, validation errors "
          f"{errors}, snapshot equal to its export {snap_ok}; "
          f"|sqrt(mean(dist_to_mean^2)) - Xi| / Xi per round "
          f"{decomp}; wire bytes {wire} against the codec model's {want} "
          f"({rows} sending rows x 4 B x D); peak {peak} bytes against the "
          f"f32 path's {main['peak']} ({peak - main['peak']:+d})",
          flush=True)
    print(f"trace (phase 10a, {card_line()}) {json.dumps(trace)}",
          flush=True)
    check(all(same.values()), f"launcher: the history or the final state "
          f"differs from phase 5's: {got} {fingerprint} against {main}")
    check(got["xis"][-1] == 0.0, f"launcher: last Xi {got['xis'][-1]!r}")
    check(abs(got["local"] - got["merged"]) <= 1e-6 * abs(got["merged"]),
          f"launcher: local {got['local']!r} != merged {got['merged']!r}")
    check(not errors and len(rounds) == ROUNDS,
          f"launcher: the event stream is not valid: {errors}")
    check(snap_ok, f"launcher: the snapshot {snap} is not its stream's")
    check(all(d <= 1e-4 for d in decomp),
          f"launcher: dist_to_mean does not decompose Xi: {decomp}")
    check(wire == want, f"launcher: wire bytes {wire} != {want}")
    check(abs(peak - main["peak"]) <= 1e9,
          f"launcher: peak {peak} not within 1 GB of {main['peak']}")
    return counts, {"seconds": dt, "peak": peak, "trace": trace, **got,
                    "fingerprint": fingerprint}


def fault_smoke_children(torch, tmp):
    """Phase 10 (b): scripts/fault_smoke.py's kill and resume on the card:
    three children of the port's launcher with its CFG (no --device): a
    baseline, a run SIGKILLed after its first segment's checkpoint and its
    --resume (the two sharing one events path). The histories equal, the
    streams byte-identical and valid (the port's validate CLI), and the
    baseline and resumed children launched the path's kernels (each child
    prints launch_counts() after main returns)."""
    import signal
    from repro_torch.telemetry import validate
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    base, intr = os.path.join(tmp, "baseline"), os.path.join(tmp, "intr")
    ev_base = os.path.join(base, "events.jsonl")
    ev_intr = os.path.join(intr, "events.jsonl")

    def child(out, extra):
        return subprocess.Popen(
            [sys.executable, "-c", CHILD, *FAULT_SMOKE_CFG, "--out", out,
             *extra], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def finish(proc, what, rc=0):
        out, err = proc.communicate(timeout=300)
        check(proc.returncode == rc, f"fault smoke {what}: exit "
              f"{proc.returncode}, expected {rc}:\n{out}\n{err}")
        return out

    t0 = time.perf_counter()
    runs = [child(base, ["--events", ev_base]),
            child(intr, ["--checkpoint-every", "1", "--die-after-segments",
                         "1", "--events", ev_intr])]
    try:
        outs = {"baseline": finish(runs[0], "baseline")}
        finish(runs[1], "interrupted", -signal.SIGKILL)
        runs.append(child(intr, ["--checkpoint-every", "1", "--resume",
                                 "--events", ev_intr]))
        outs["resumed"] = finish(runs[2], "resumed")
    finally:
        for proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    dt = time.perf_counter() - t0
    counts = {k: json.loads(o.strip().splitlines()[-1].split(" ", 2)[2])
              for k, o in outs.items()}
    hist = {}
    for k, d in (("baseline", base), ("resumed", intr)):
        with open(os.path.join(d, FAULT_SMOKE_TAG + ".json")) as f:
            hist[k] = json.load(f)["history"]
    with open(ev_base, "rb") as f:
        eb = f.read()
    with open(ev_intr, "rb") as f:
        er = f.read()
    valid = validate.main([ev_base, ev_intr]) == 0
    resumed = "resumed from checkpoint" in outs["resumed"]
    with open(os.path.join(intr, "events.wall.jsonl")) as f:
        saves = [(op["bytes"], round(op["dt"], 3)) for op in map(
            json.loads, f) if op.get("op") == "checkpoint_save"]
    print(f"fault smoke (phase 10b, {card_line()}): 3 children in "
          f"{dt:.1f}s; checkpoints (bytes, seconds to pack and write) "
          f"{saves}; resumed from a checkpoint {resumed}; histories equal "
          f"{hist['baseline'] == hist['resumed']} ({len(hist['baseline'])} "
          f"rounds, final merged eval {hist['baseline'][-1]['merged_eval']!r}"
          f"); streams byte-identical {eb == er} ({len(eb)} bytes), valid "
          f"{valid}; launches (nonzero) baseline "
          f"{json.dumps({k: v for k, v in counts['baseline'].items() if v})}"
          f", resumed "
          f"{json.dumps({k: v for k, v in counts['resumed'].items() if v})}",
          flush=True)
    check(resumed, "fault smoke: the resumed run restored no checkpoint")
    check(hist["baseline"] == hist["resumed"],
          "fault smoke: the resumed history differs from the baseline's")
    check(eb == er and eb, "fault smoke: the event streams differ")
    check(valid, "fault smoke: an event stream is not valid")
    for k, c in counts.items():
        check(all(c[n] > 0 for n in FAULT_SMOKE_KERNELS),
              f"fault smoke: the {k} child did not launch every one of "
              f"{FAULT_SMOKE_KERNELS}: {c}")
    return {"seconds": dt, "bytes": len(eb)}


def launcher_phase(torch, main):
    """Phase 10: (a) launcher_run, (b) fault_smoke_children, in a directory
    of the checkout removed at the end."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix=".launcher_run_", dir=ROOT)
    try:
        counts, rec = launcher_run(torch, main, tmp)
        torch.cuda.empty_cache()
        rec["fault_smoke"] = fault_smoke_children(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"launcher phase ({card_line()}): {time.perf_counter() - t0:.1f}s",
          flush=True)
    return counts, rec


# phase 12: (a) the main path's cell with bfloat16 parameters
# (cfg.param_dtype, as the reference's dry-run sets it), BF16_ROUNDS rounds
# (two gossip rounds and the merge); (b) the main path sharded over a world
# of ranks sharing the one card (launch/mesh.py): SHARD_MESH (pod, agent,
# fsdp, model) = (1, 2, 2, 1), 4 ranks (agents over 2, columns over 2), the
# main path's cell, rounds and seeds, held against phase 5's run; then one
# round at world size 1 over NCCL. A rank's process gets SHARD_TIMEOUT
# seconds.
BF16_ROUNDS = 3
# phase 12a's second cell (fault C1's repair on the card): the bf16 cell
# with attn_block ATTN_BLOCK (the flash kernels' bfloat16 forward and
# backward), m BF16_ATTN_M, batch ATTN_BATCH x ATTN_SEQ, BF16_ROUNDS rounds
BF16_ATTN_M = 4
SHARD_MESH = (1, 2, 2, 1)
SHARD_TIMEOUT = 600
SHARD_CHILD = ("import sys\n"
               "sys.path.insert(0, sys.argv[1])\n"
               "import chip_smoke\n"
               "chip_smoke.sharded_child(sys.argv[2])\n")


def bf16_params_phase(torch, main):
    """Phase 12 (a): bf16_cell on the main path's cell (compared with phase
    5's run), then on its attn_block cell (ATTN_BLOCK, m BF16_ATTN_M,
    batch ATTN_BATCH x ATTN_SEQ: fault C1's repair, the flash kernels'
    bfloat16 forward and backward, each backward launch counted: one a
    layer an agent a local step). Returns (the two cells' launch counts,
    summed, and {"main", "attn": records})."""
    counts, rec = bf16_cell(torch, main)
    attn, rec_attn = bf16_cell(torch, None, block=ATTN_BLOCK, m=BF16_ATTN_M,
                               batch=ATTN_BATCH, seq=ATTN_SEQ)
    want = BF16_ROUNDS * H * BF16_ATTN_M * 2  # rounds x steps x agents x layers
    check(attn["flash_attention_bwd_bf16"] == want
          and attn["flash_attention_fwd_bf16"] >= want,
          f"bf16 params (attn_block {ATTN_BLOCK}): the flash kernels' "
          f"bfloat16 entries launched {attn['flash_attention_fwd_bf16']} "
          f"(forward) and {attn['flash_attention_bwd_bf16']} (backward) "
          f"times, not {want}")
    return ({k: counts[k] + attn[k] for k in counts},
            {"main": rec, "attn": rec_attn, "attn_counts": attn})


def bf16_cell(torch, main, block=0, m=M, batch=BATCH, seq=SEQ):
    """Phase 12 (a), one cell: olmo-1b at full width cut to 2 layers with
    param_dtype bfloat16 (one bfloat16 group: parameters, gradients and
    both AdamW moments in bfloat16), m agents, H local steps, ``batch`` x
    ``seq`` tokens, attn_block ``block``, BF16_ROUNDS rounds from the main
    path's seeds: the bf16 mix (gossip_mix's bf16 entry, rows rounded once
    to bfloat16) and the reduce's bf16 entry (the idle rounds' Xi, the
    evals' merged row). Gates: every row identical bit for bit after the
    merge, consensus_distance of the merged panel 0.0, the merged model in
    the group's dtype evaluated equal to the local eval within 1e-6
    relative, every loss finite. The float32 merged eval (the reference's
    merged_panel_tree: float32 leaves) is printed beside it with its gap: a
    float32 forward of the same numbers. Round times and the peak are
    printed against phase 5's (``main``; None: not compared)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import dsgd
    from repro_torch.core import panel as panel_mod
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import eval_local, eval_merged, to_device
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    dev = torch.device("cuda")
    cfg = get_config("olmo-1b").replace(num_layers=2,
                                        param_dtype="bfloat16")
    cfg = cfg.replace(dist=dataclasses.replace(cfg.dist, attn_block=block))
    tag = "bf16 params" + (f", attn_block {block}" if block else "")
    model = build_model(cfg)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=BF16_ROUNDS * H)
    per_round, eval_batch = segment_inputs(cfg, m, BF16_ROUNDS,
                                           data_vocab=DATA_VOCAB,
                                           batch=batch, seq=seq)
    eval_batch = to_device(eval_batch, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(0)
    state, spec = dsgd.init_panel_state(model.init_params, opt, m, gen,
                                        device=dev)
    check(len(spec.groups) == 1 and spec.groups[0][0] == "bfloat16",
          f"{tag}: groups {spec.groups}")
    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec)
    print(f"{tag} (phase 12a, {card_line()}): {cfg.name} d_model "
          f"{cfg.d_model}, {cfg.num_layers} layers, param_dtype "
          f"{cfg.param_dtype}, attn_block {block}, groups {spec.groups}, m "
          f"{m}, H {H}, batch {batch}, seq {seq}", flush=True)
    losses, xis, times = [], [], []
    for t, (W, b, glob, live) in enumerate(per_round):
        t0 = time.perf_counter()
        state, mets = seg(state, b, W, None, global_rounds=glob)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(mets["loss"][0]))
        xis.append(float(mets["consensus"][0]))
        print(f"round {t} ({tag}): loss {losses[-1]!r} Xi "
              f"{xis[-1]!r} {times[-1]:.3f}s; device memory peak so far "
              f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
    pan = state["panel"]
    check(pan["bfloat16"].dtype == torch.bfloat16
          and state["opt"]["m"]["bfloat16"].dtype == torch.bfloat16,
          f"{tag}: the panel or the moments left bfloat16")
    same = rows_identical(torch, pan)
    xi_rows = float(panel_mod.consensus_distance(pan))
    merged32 = eval_merged(model.loss_fn, pan, spec, eval_batch)
    row = panel_mod.merged(pan)
    merged16 = float(model.loss_fn(panel_mod.from_panel(row, spec), eval_batch,
                                   None)[0])
    local = eval_local(model.loss_fn, pan, spec, eval_batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"kernels ({tag}) {json.dumps(counts)}", flush=True)
    print(f"eval ({tag}): merged (bfloat16 leaves) {merged16!r} local "
          f"{local!r}; merged with float32 leaves (the reference's "
          f"merged_panel_tree) {merged32!r}, {abs(merged32 - local) / local!r}"
          f" relative from local: a float32 forward of the same values; rows "
          f"identical {same}; consensus_distance of the merged panel "
          f"{xi_rows!r} (the segment's Xi {xis[-1]!r}: the rows rounded to "
          f"bfloat16 against the float32 folded mean, the reference's rule)",
          flush=True)
    if main is not None:
        print(f"{tag} against f32 (phase 5): rounds (s) {times} against "
              f"{main['times'][:BF16_ROUNDS]}; peak {peak} against "
              f"{main['peak']} bytes ({peak - main['peak']:+d})", flush=True)
    else:
        print(f"{tag}: rounds (s) {times}; peak {peak} bytes", flush=True)
    check(same, f"{tag}: the rows differ after the final merge")
    check(xi_rows == 0.0, f"{tag}: Xi of the merged rows {xi_rows!r}")
    check(all(math.isfinite(x) for x in losses + [merged16, merged32,
                                                  local]),
          f"{tag}: a loss is not finite")
    check(abs(local - merged16) <= 1e-6 * abs(merged16),
          f"{tag}: local eval {local!r} != merged eval {merged16!r}")
    check(counts["gossip_mix_bf16"] > 0
          and counts["panel_mean_consensus_bf16"] > 0,
          f"{tag}: the bf16 kernel entries never launched: {counts}")
    del state, seg, pan, row
    torch.cuda.empty_cache()
    return counts, {"times": times, "peak": peak, "losses": losses,
                    "xis": xis, "merged": merged16, "local": local}


def _wrap64(v):
    return (v + (1 << 63)) % (1 << 64) - (1 << 63)


def sharded_child(kind):
    """One rank of phase 12 (b), in its own process (torch.distributed from
    the environment sharded_phase sets): ``gloo4`` runs the main path's cell
    on SHARD_MESH, ``nccl1`` one round of it on the (1, 1, 1, 1) mesh over
    NCCL. Prints one ``SHARD {json}`` line: per-round loss, Xi, grad norm
    and seconds, the evals, the rank's fingerprint part and coordinate, the
    row check, launch counts and peak device memory."""
    import hashlib

    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.configs import get_config
    from repro_torch.core import dsgd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import eval_local, eval_merged, to_device
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    if kind == "options":
        return options_child(os.environ["SHARD_TMP"])
    if kind.startswith("split_"):
        return split_child(kind)
    if kind.startswith("splith_"):
        return split_h_child(kind)
    if kind.startswith("serve_"):
        return serve_child(kind)
    shape = SHARD_MESH if kind == "gloo4" else (1, 1, 1, 1)
    rounds = ROUNDS if kind == "gloo4" else 1
    mesh = mesh_mod.make_mesh(shape)
    dev = mesh.device
    cfg = get_config("olmo-1b").replace(num_layers=2)
    model = build_model(cfg)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=ROUNDS * H)
    per_round, eval_batch = segment_inputs(cfg, M, ROUNDS,
                                           data_vocab=DATA_VOCAB)
    eval_batch = to_device(eval_batch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t_init = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    state, spec = dsgd.init_panel_state(model.init_params, opt, M, gen,
                                        wire="f32", mesh=mesh)
    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec)
    torch.cuda.synchronize(dev)
    t_init = time.perf_counter() - t_init
    torch.cuda.empty_cache()  # the 8 inits drawn whole, kept in part
    rec = {"rank": mesh.rank, "coord": mesh.coord, "backend": mesh.backend,
           "transport": mesh.transport, "device": str(dev), "init_s": t_init, "losses": [], "xis": [],
           "grad_norms": [], "times": []}
    mesh.stats.update(dict.fromkeys(mesh.stats, 0))
    for W, b, glob, _ in per_round[:rounds]:
        t0 = time.perf_counter()
        state, mets = seg(state, b, W, None, global_rounds=glob)
        torch.cuda.synchronize(dev)
        rec["times"].append(time.perf_counter() - t0)
        rec["losses"].append(float(mets["loss"][0]))
        rec["xis"].append(float(mets["consensus"][0]))
        rec["grad_norms"].append(float(mets["grad_norm"][0]))
    t0 = time.perf_counter()
    rec["merged"] = eval_merged(model.loss_fn, state["panel"], spec,
                                eval_batch)
    rec["local"] = eval_local(model.loss_fn, state["panel"], spec,
                              eval_batch)
    torch.cuda.synchronize(dev)
    rec["eval_s"] = time.perf_counter() - t0
    rec["counts"] = launch_counts()
    rec["comm"] = dict(mesh.stats)
    rec["fingerprint"] = state_fingerprint(
        torch, state, col0=spec.col_range("float32")[0])
    rec["rows"] = list(spec.row_range("float32"))
    rec["cols"] = list(spec.col_range("float32"))
    rec["rows_identical"] = rows_identical(torch, state["panel"])
    first = state["panel"]["float32"][0].contiguous().view(torch.int32)
    rec["row_digest"] = hashlib.sha256(
        first.cpu().numpy().tobytes()).hexdigest()
    one = torch.full((4,), 2.0, device=dev)
    mesh.all_reduce(one, "rows")
    rec["all_reduce"] = one.tolist()
    rec["peak"] = torch.cuda.max_memory_allocated(dev)
    rec["reserved"] = torch.cuda.memory_reserved(dev)
    rec["max_reserved"] = torch.cuda.max_memory_reserved(dev)
    if kind == "gloo4":  # the card's used bytes, every rank holding its own
        dist.barrier()
        free, total = torch.cuda.mem_get_info(dev)
        rec["card_used"] = total - free
        dist.barrier()
    print("SHARD " + json.dumps(rec), flush=True)
    del state, seg
    dist.destroy_process_group()


def _run_ranks(kind, world, tmp):
    """Start ``world`` children of sharded_child(kind) on the card (a
    file:// rendezvous in ``tmp``), wait for all (SHARD_TIMEOUT each) and
    return their SHARD records; a rank that fails fails the phase."""
    # the ranks share the card: segments that grow and are freed keep each
    # rank's reserve near its live memory
    env = dict(os.environ, WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world),
               REPRO_TORCH_INIT_METHOD=f"file://{tmp}/rdv_{kind}",
               SHARD_TMP=tmp,
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARD_CHILD, ROOT, kind],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SHARD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs, failed = [], []
    for r, (p, log) in enumerate(zip(procs, logs)):
        lines = [ln for ln in log.splitlines() if ln.startswith("SHARD ")]
        if p.returncode != 0 or not lines:
            failed.append(f"--- rank {r} (exit {p.returncode}):\n"
                          + log[-3000:])
        else:
            recs.append(json.loads(lines[-1][len("SHARD "):]))
    check(not failed, f"phase 12: {kind} ranks failed:\n" + "\n".join(
        failed))
    return recs


def sharded_phase(torch, main):
    """Phase 12 (b): the main path sharded over 4 ranks on the one card
    (gloo: NCCL takes one rank a device; CUDA tensors travel through host
    memory), then one round at world size 1 over NCCL. Gates: every rank's
    final panel and moments, summed over the ranks' shards, give phase 5's
    fingerprint exactly (the bits of every row and column); every rank's
    rows identical after the merge and the first row's digest equal across
    ranks of one column shard; the evals and the per-round losses equal
    phase 5's bit for bit; Xi within 1e-6 relative of phase 5's each round
    and 0.0 after the merge; gossip_mix and panel_mean_consensus launched on
    every rank. The NCCL round: the backend NCCL, its all-reduce right, its
    loss equal to phase 5's first round's bit for bit and its Xi within
    1e-6 relative."""
    import tempfile
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    free, total = torch.cuda.mem_get_info()
    parent_used = total - free  # this process's context and reserve
    t0 = time.perf_counter()
    recs = _run_ranks("gloo4", 4, tmp)
    wall = time.perf_counter() - t0
    for r in recs:
        print(f"rank {r['rank']} {r['coord']} ({r['transport']}, "
              f"{r['device']};"
              f" rows {r['rows']}, columns {r['cols']}): init {r['init_s']:.2f}s,"
              f" rounds (s) {[round(x, 3) for x in r['times']]}, evals "
              f"{r['eval_s']:.2f}s, peak {r['peak']} bytes; collectives "
              f"{r['comm']}; losses "
              f"{r['losses']}, Xi {r['xis']}, grad norms {r['grad_norms']}",
              flush=True)
    fp = {name: [_wrap64(sum(r["fingerprint"][name][i] for r in recs))
                 for i in (0, 1)] for name in ("panel", "m", "v")}
    merged, local = recs[0]["merged"], recs[0]["local"]
    print(f"sharded (phase 12b, {card_line()}): mesh {SHARD_MESH} on one "
          f"card over {recs[0]['transport']}, {wall:.1f}s for the world; "
          f"fingerprint {json.dumps(fp)} against phase 5's "
          f"{json.dumps(main['fingerprint'])}; evals merged {merged!r} "
          f"local {local!r} against {main['merged']!r} {main['local']!r}; "
          f"rounds (s) {[max(r['times'][t] for r in recs) for t in range(ROUNDS)]}"
          f" against {main['times']}; peak per rank "
          f"{max(r['peak'] for r in recs)} bytes against phase 5's "
          f"{main['peak']}", flush=True)
    check(fp == main["fingerprint"],
          f"phase 12b: the sharded state {fp} differs from phase 5's "
          f"{main['fingerprint']}")
    for r in recs:
        check(r["transport"] == "cuda ipc",
              f"phase 12b: rank {r['rank']}'s collectives went over "
              f"{r['transport']}, not CUDA IPC")
        check(r["rows_identical"], f"phase 12b: rank {r['rank']}'s rows "
                                   f"differ after the merge")
        check(r["merged"] == main["merged"] and r["local"] == main["local"],
              f"phase 12b: rank {r['rank']}'s evals {r['merged']!r} "
              f"{r['local']!r} differ from phase 5's")
        check(r["losses"] == main["losses"],
              f"phase 12b: rank {r['rank']}'s losses {r['losses']} differ "
              f"from phase 5's {main['losses']}")
        check(all(abs(a - b) <= 1e-6 * abs(b) for a, b in
                  zip(r["xis"], main["xis"])) and r["xis"][-1] == 0.0,
              f"phase 12b: rank {r['rank']}'s Xi {r['xis']} against "
              f"{main['xis']}")
        check(r["counts"]["gossip_mix"] > 0
              and r["counts"]["panel_mean_consensus"] > 0,
              f"phase 12b: rank {r['rank']} launched {r['counts']}")
        check(r["all_reduce"] == [4.0] * 4,
              f"phase 12b: all_reduce over 2 ranks gave {r['all_reduce']}")
        mate = [o for o in recs if o["cols"] == r["cols"]]
        check(len({o["row_digest"] for o in mate}) == 1,
              "phase 12b: the merged rows differ between ranks")
    counts = {k: sum(r["counts"][k] for r in recs) for k in recs[0]["counts"]}
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    one, = _run_ranks("nccl1", 1, tmp)
    print(f"sharded world 1 (phase 12b, {card_line()}): backend "
          f"{one['backend']} on {one['device']}, {time.perf_counter() - t1:.1f}"
          f"s with the process; init {one['init_s']:.2f}s, round "
          f"{one['times'][0]:.3f}s; loss {one['losses'][0]!r} Xi "
          f"{one['xis'][0]!r} against phase 5's round 0 "
          f"{main['losses'][0]!r} {main['xis'][0]!r}; all_reduce "
          f"{one['all_reduce']}; peak {one['peak']} bytes", flush=True)
    check(one["backend"] == "nccl", f"world 1 ran on {one['backend']}")
    check(one["all_reduce"] == [2.0] * 4, "world 1: all_reduce")
    check(one["losses"][0] == main["losses"][0]
          and abs(one["xis"][0] - main["xis"][0])
          <= 1e-6 * abs(main["xis"][0]),
          f"world 1: round 0 {one['losses'][0]!r} {one['xis'][0]!r}")
    return counts, {"recs": recs, "nccl": one, "wall": wall,
                    "parent_used": parent_used}


# phase 12c: the sharded run's other options (ROADMAP A16b) on SHARD_MESH
# (4 gloo ranks on the card), each run gated against the same run on one
# process in this phase (the same seeds, batches and W stream). At the main
# path's cell (olmo-1b full width, 2 layers, m 8, H 2, batch 4 x 512),
# OPT_ROUNDS rounds (two gossip rounds, then the merge): (A) the int8_ef
# wire with the kernel's draws (Int8Codec(draws="kernel")), --merge var,
# --residency moments=int8 with the fused moment update, the telemetry
# columns; (B) --wire topk, --merge ties, the fault plan OPT_FAULTS (agent
# 2 dead in the second gossip round, back for the merge). Then at reduced()
# width (batch 4 x 32), SMALL_ROUNDS rounds (a gossip round, the merge),
# the remaining codecs, operators and storages, unfused. label: (wire,
# merge operator, residency, fused, fault plan, telemetry); "native" is
# the kernel-drawn int8_ef.
OPT_ROUNDS = 3  # its fault plan's agent rejoins in the third round
OPT_FAULTS = "2@1-2"
OPT_RUNS = {"A": ("native", "var", "moments=int8", True, None, True),
            "B": ("topk", "ties", None, None, OPT_FAULTS, False)}
SMALL_ROUNDS = 2
SMALL_OPTIONS = {
    "int8 weighted moments=int8g": ("int8", "weighted", "moments=int8g",
                                    False, None, False),
    "int4 fisher stats=int8r": ("int4", "fisher", "stats=int8r", None, None,
                                False),
    "int4_ef swa moments=bf16 wire_err=int8r": (
        "int4_ef", "swa", "moments=bf16,stats=bf16,wire_err=int8r", None,
        None, False)}
OPTIONS = {**OPT_RUNS, **SMALL_OPTIONS}
# what each run must launch on every rank
OPTION_KERNELS = {
    "A": ("quantize_int8_native", "dequantize_int8", "gossip_mix",
          "adamw_fused_int8", "weighted_colmerge"),
    "B": ("sparsify_topk", "gossip_mix", "panel_mean_consensus",
          "ties_colmerge"),
    "int8 weighted moments=int8g": ("quantize_int8", "dequantize_int8",
                                    "quantize_int8_grouped",
                                    "dequantize_int8_grouped", "gossip_mix"),
    "int4 fisher stats=int8r": ("quantize_int4", "pack_int4", "unpack_int4",
                                "dequantize_int4", "weighted_colmerge",
                                "quantize_int8", "dequantize_int8"),
    "int4_ef swa moments=bf16 wire_err=int8r": (
        "quantize_int4", "dequantize_int4", "quantize_int8",
        "dequantize_int8", "gossip_mix", "panel_mean_consensus")}
# the sums over whole rows (Xi, grad norms; test_torch_sharded.py's bound),
# weighted's distances (the reference's own bound for its sharded
# merge_row) and the per-agent telemetry columns summed over the ranks
OPT_XI_RTOL, OPT_WEIGHTED_RTOL, OPT_COL_RTOL = 1e-6, 1e-5, 1e-4


def tensors_fingerprint(torch, named, slab=1 << 22):
    """{name: [sum of the bit patterns, sum of the patterns times (column %
    65521 + 1), mod 2^64]} of ``named`` {name: (2-D tensor, the panel
    column of its first column)}, a column slab at a time: the parts of a
    sharded state (each rank's, with its columns' offsets) sum to the
    whole's."""
    as_int = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for name, (x, col0) in named.items():
        bits = x.view(as_int[x.element_size()])
        tot = torch.zeros((), dtype=torch.int64, device=x.device)
        wtot = torch.zeros((), dtype=torch.int64, device=x.device)
        for lo in range(0, x.shape[1], slab):
            c = bits[:, lo:lo + slab].to(torch.int64)
            w = torch.arange(col0 + lo, col0 + lo + c.shape[1],
                             device=x.device) % 65521
            tot += c.sum()
            wtot += (c * (w + 1)).sum()
            del c, w
        out[name] = [int(tot), int(wtot)]
    return out


def state_tensors(state, spec, every=False):
    """{name: (2-D tensor, first column)} of every panel of a state (this
    rank's shard of it): the parameters, each moment (a stored one's q
    and scales: a grouped scale's first group; a per-row scale, held by
    every column shard, counted on the first unless ``every``), the
    error-feedback and the statistics panels."""
    out = {}

    def add(name, x, k):
        c0 = spec.col_range(k)[0]
        if not isinstance(x, dict):
            out[name] = (x, c0)
            return
        out[name + ".q"] = (x["q"], c0)
        G, c = x["scale"].shape[1], x["q"].shape[1]
        if G > 1 or c0 == 0 or every:
            out[name + ".scale"] = (x["scale"], c0 * G // c)

    for k, x in state["panel"].items():
        add(f"panel.{k}", x, k)
    for mk in ("m", "v"):
        for k, x in state["opt"][mk].items():
            add(f"{mk}.{k}", x, k)
    for k, x in state.get("wire_err", {}).items():
        add(f"wire_err.{k}", x, k)
    for n, grp in state.get("merge_stat", {}).items():
        for k, x in grp.items():
            add(f"stat.{n}.{k}", x, k)
    return out


def gathered_state(state, spec):
    """Every panel of a sharded state gathered whole (state_tensors' names;
    a per-row scale gathered over the rows alone), on the CPU."""
    import torch
    from repro_torch.core import panel as panel_mod
    out = {}
    for name, (x, _) in state_tensors(state, spec, every=True).items():
        k = name.split(".")[-1] if not name.endswith((".q", ".scale")) \
            else name.split(".")[-2]
        rows = panel_mod.gather_rows(x.contiguous(), spec, k)
        if name.endswith(".scale") and x.shape[1] == 1:
            out[name] = rows.cpu()
        else:
            out[name] = torch.stack([panel_mod.gather_cols(
                r.contiguous(), spec, k) for r in rows]).cpu()
        del rows
    return out


def option_run(torch, label, mesh=None, save=None):
    """One run of phase 12c (OPTIONS[label]) on the card: on ``mesh`` (this
    rank's shard) or on one process. Returns a JSON-able record: per-round
    loss, Xi, grad norm, seconds and (with telemetry) the per-agent
    columns, the evals, the state's fingerprint, the rows check, the
    launch counts and the peak; ``save``: a path where a small run's whole
    state is written (rank 0 of a mesh; on one process the state is
    returned under "state")."""
    import hashlib

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import dsgd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import eval_local, eval_merged, to_device
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.telemetry.metrics import AGENT_COLUMNS
    from repro_torch.wire import Int8Codec
    wire, merger, res, fused, plan, tele = OPTIONS[label]
    small = label in SMALL_OPTIONS
    dev = mesh.device if mesh is not None else torch.device("cuda")
    if small:
        cfg, rounds, batch, seq, vocab = (get_config("olmo-1b").reduced(),
                                          SMALL_ROUNDS, 4, 32, None)
    else:
        cfg, rounds, batch, seq, vocab = (
            get_config("olmo-1b").replace(num_layers=2), OPT_ROUNDS, BATCH,
            SEQ, DATA_VOCAB)
    model = build_model(cfg)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=rounds * H)
    per_round, eval_batch = segment_inputs(cfg, M, rounds, data_vocab=vocab,
                                           batch=batch, seq=seq, faults=plan)
    eval_batch = to_device(eval_batch, dev)
    if wire == "native":
        wire = Int8Codec("int8_ef", error_feedback=True, draws="kernel")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    if mesh is not None:
        mesh.stats.update(dict.fromkeys(mesh.stats, 0))
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = {"mesh": mesh} if mesh is not None else {"device": dev}
    state, spec = dsgd.init_panel_state(model.init_params, opt, M, gen,
                                        wire=wire, merger=merger,
                                        residency=res, **kw)
    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec, fused=fused,
                                  telemetry=tele)
    torch.cuda.synchronize(dev)
    rec = {"init_s": time.perf_counter() - t0, "losses": [], "xis": [],
           "grad_norms": [], "times": [], "cols": {k: [] for k in (
               AGENT_COLUMNS if tele else ())}}
    wire_gen = torch.Generator(device=dev).manual_seed(3)
    comm = 0
    for W, b, glob, live in per_round:
        t0 = time.perf_counter()
        state, mets = seg(state, b, W, wire_gen, global_rounds=glob,
                          live=live)
        torch.cuda.synchronize(dev)
        rec["times"].append(time.perf_counter() - t0)
        comm += not (W[0] == np.eye(M, dtype=np.float32)).all()
        for key, name in (("losses", "loss"), ("xis", "consensus"),
                          ("grad_norms", "grad_norm")):
            rec[key].append(float(mets[name][0]))
        for k in rec["cols"]:
            rec["cols"][k].append(mets[k][0].tolist())
        if mesh is None or mesh.rank == 0:
            print(f"round {len(rec['times']) - 1} (phase 12c {label}, "
                  f"{'rank 0' if mesh is not None else 'one process'}): "
                  f"loss {rec['losses'][-1]!r} Xi {rec['xis'][-1]!r} "
                  f"{rec['times'][-1]:.3f}s; peak so far "
                  f"{torch.cuda.max_memory_allocated(dev)}", flush=True)
    rec["comm_rounds"] = int(comm)
    # the agents live in the merge round (drive_path's faults path)
    alive = None if plan is None else per_round[-1][3][0] == 1
    t0 = time.perf_counter()
    rec["merged"] = eval_merged(model.loss_fn, state["panel"], spec,
                                eval_batch, state.get("merge_stat"),
                                live=alive)
    rec["local"] = eval_local(model.loss_fn, state["panel"], spec,
                              eval_batch, live=alive)
    torch.cuda.synchronize(dev)
    rec["eval_s"] = time.perf_counter() - t0
    rec["counts"] = launch_counts()
    rec["peak"] = torch.cuda.max_memory_allocated(dev)
    rec["comm"] = None if mesh is None else dict(mesh.stats)
    lo, hi = spec.agent_range()
    here = None if alive is None else alive[lo:hi]
    rec["rows_identical"] = rows_identical(torch, state["panel"], here)
    first = lo + (0 if here is None else int(np.flatnonzero(here)[0]))
    row = state["panel"]["float32"][first - lo].contiguous()
    rec["row_digest"] = hashlib.sha256(
        row.view(torch.int32).cpu().numpy().tobytes()).hexdigest()
    rec["cols_range"] = list(spec.col_range("float32"))
    rec["rows_range"] = [lo, hi]
    rec["width"] = spec.width
    if small:
        if mesh is None:
            rec["state"] = {k: x.cpu() for k, (x, _) in
                            state_tensors(state, spec).items()}
        else:
            whole = gathered_state(state, spec)
            if mesh.rank == 0:
                torch.save(whole, save)
            del whole
    else:
        rec["fingerprint"] = tensors_fingerprint(torch,
                                                 state_tensors(state, spec))
    del state, seg
    torch.cuda.empty_cache()
    return rec


def options_child(tmp):
    """Phase 12c's ranks: every OPTIONS run in turn on SHARD_MESH."""
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.launch import mesh as mesh_mod
    mesh = mesh_mod.make_mesh(SHARD_MESH)
    runs = {}
    for i, label in enumerate(OPTIONS):
        runs[label] = option_run(torch, label, mesh,
                                 save=os.path.join(tmp, f"opt{i}.pt"))
    print("SHARD " + json.dumps({"rank": mesh.rank, "coord": mesh.coord,
                                 "backend": mesh.backend,
                                 "transport": mesh.transport, "runs": runs}),
          flush=True)
    dist.destroy_process_group()


def shard_kernel_checks(torch, D):
    """Phase 12c's kernels at a rank's shapes: the native quantize of the
    block at rows [4, 8) and columns [D/2, D) (row0, col0) equal to its
    plain twin and to that block of the whole panel's quantize; the top-k
    sparsify on the (4, D/2) shard, and the TIES and weighted column
    merges on a gathered (8, 2^22) slab, and the fused int8 AdamW on the
    (4, D/2) block a slab at a time (the block's slab_draws uniforms, its
    grouped scales), equal to their plain versions."""
    from repro_torch.kernels import merge_ops, ref, wire_quant
    g = torch.Generator(device="cuda").manual_seed(12)
    c0 = D // 2
    x = torch.randn((M, D), generator=g, device="cuda")
    s = ref.int8_scale_ref(x)
    seed = torch.tensor([12345], dtype=torch.int32, device="cuda")
    whole = wire_quant.quantize_int8_native(x, s, seed)
    blk = x[4:, c0:].contiguous()
    q = wire_quant.quantize_int8_native(blk, s[4:].contiguous(), seed,
                                        row0=4, col0=c0)
    plain = ref.quantize_int8_native_ref(blk, s[4:].contiguous(), seed,
                                         row0=4, col0=c0)
    ok_native = torch.equal(q, plain) and torch.equal(q, whole[4:, c0:])
    del x, whole, q, plain
    th = ref.topk_threshold_ref(blk, max(1, int(D * 0.125)) // 2)
    ok_topk = torch.equal(wire_quant.sparsify_topk(blk, th),
                          ref.sparsify_topk_ref(blk, th))
    del blk, th
    slab = torch.randn((M, 1 << 22), generator=g, device="cuda")
    w = torch.rand((M, 1 << 22), generator=g, device="cuda") + 0.1
    tth = ref.ties_thresh_ref(slab, 0.2)
    ok_merge = (torch.equal(merge_ops.weighted_colmerge(slab, w),
                            ref.weighted_colmerge_ref(slab, w))
                and torch.equal(merge_ops.ties_colmerge(slab, tth),
                                ref.ties_colmerge_ref(slab, tth)))
    del slab, w
    torch.cuda.empty_cache()
    ok_fused = shard_fused_check(torch, D, c0, g)
    print(f"shard kernels (phase 12c): native quantize of the block at "
          f"(row0 4, col0 {c0}) == its plain twin == the whole panel's "
          f"block: {ok_native}; sparsify_topk on (4, {D - c0}): {ok_topk}; "
          f"weighted and TIES column merges on (8, {1 << 22}): {ok_merge}; "
          f"adamw_fused_int8 on the (4, {D - c0}) block: {ok_fused}",
          flush=True)
    check(ok_native and ok_topk and ok_merge and ok_fused,
          "phase 12c: a kernel on a shard's shape disagrees with its plain "
          "version")


def shard_fused_check(torch, D, c0, gen):
    """The fused int8 AdamW step on rows [4, 8) and columns [c0, D) of an
    (M, D) panel, as dsgd._fused_opt_update runs it on that rank's block:
    one launch a range of storage.slab_ranges (the panel's 2^22-column
    slabs cut to the block), the uniforms from storage.slab_draws on the
    block's Shard, group 128; each range bit for bit with the plain
    version on the same inputs."""
    from repro_torch.core.panel import Shard
    from repro_torch.kernels.opt_fused import adamw_fused_int8 as kernel
    from repro_torch.kernels.ref import adamw_fused_int8_ref as plain
    from repro_torch.optim import make_optimizer
    from repro_torch.residency import SLAB
    from repro_torch.residency.storage import slab_draws, slab_ranges
    group = 128
    kw = dict(group=group, transform="sqrt",
              **make_optimizer("adamw", 3e-3, weight_decay=5e-4).hparams)
    g, p, qm, sm, qv, sv, um, uv, lr, bc1, bc2 = fused_inputs(
        torch, 4, D - c0, group, gen)
    del um, uv
    sh = Shard(mesh=None, rows=(4, M), cols=(c0, D), m=M, D=D, split=True)
    draws = [slab_draws(torch.Generator(device="cuda").manual_seed(s), M, D,
                        SLAB, sh, "cuda") for s in (21, 22)]
    got = [t.clone() for t in (p, qm, sm, qv, sv)]
    ok = True
    for lo, hi in slab_ranges(D - c0, SLAB, c0):
        cs, gs = slice(lo, hi), slice(lo // group, -(-hi // group))
        du, dv = next(draws[0]), next(draws[1])
        kernel(g[:, cs], got[0][:, cs], got[1][:, cs], got[2][:, gs],
               got[3][:, cs], got[4][:, gs], du, dv, lr, bc1, bc2, **kw)
        want = plain(g[:, cs], p[:, cs], qm[:, cs], sm[:, gs], qv[:, cs],
                     sv[:, gs], du, dv, lr, bc1, bc2, **kw)
        ok = ok and all(torch.equal(a[:, sl], b) for a, b, sl in
                        zip(got, want, (cs, cs, gs, cs, gs)))
        del du, dv, want
    del g, p, qm, sm, qv, sv, got
    torch.cuda.empty_cache()
    return ok


def _close(a, b, rtol):
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool(np.all(np.abs(a - b) <= rtol * np.abs(b) + 1e-12))


def _gap(a, b):
    """The largest relative gap of a from b."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def options_phase(torch, main, sharded):
    """Phase 12 (c): shard_kernel_checks, then every OPTIONS run on one
    process, then all of them on SHARD_MESH's 4 ranks (one world). Gates
    for each run, rank by rank: the losses and evals equal the one-process
    run's bit for bit, Xi and the grad norms within OPT_XI_RTOL and Xi 0.0
    after the merge, merged == local eval, the (live) rows identical after
    the merge and equal across the ranks of one column shard, the state
    (parameters, moments with their stored bits, error-feedback and
    statistics panels) bit for bit: at full width the ranks' fingerprints
    summed against the one-process state's, at reduced width the gathered
    state (weighted's parameters and evals within OPT_WEIGHTED_RTOL);
    the telemetry columns: losses, live trits and wire bytes equal, grad
    norms and distances within OPT_COL_RTOL (gaps printed); each run's
    OPTION_KERNELS launched on every rank, the native quantize once a
    communicating round. Prints rounds and peaks beside phase 12b's."""
    import tempfile
    shard_kernel_checks(torch, main["width"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_opts_")
    singles = {}
    t0 = time.perf_counter()
    for label in OPTIONS:
        singles[label] = option_run(torch, label)
        r = singles[label]
        print(f"one process (phase 12c {label}): rounds (s) "
              f"{[round(t, 3) for t in r['times']]}, evals {r['eval_s']:.2f}s,"
              f" peak {r['peak']} bytes; merged {r['merged']!r} local "
              f"{r['local']!r}", flush=True)
    t_single = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = _run_ranks("options", 4, tmp)
    wall = time.perf_counter() - t0
    for r in recs:
        check(r["transport"] == "cuda ipc",
              f"phase 12c: rank {r['rank']}'s collectives went over "
              f"{r['transport']}, not CUDA IPC")
    counts = {}
    for i, label in enumerate(OPTIONS):
        one = singles[label]
        runs = [r["runs"][label] for r in recs]
        weighted = OPTIONS[label][1] == "weighted"
        for r, run in zip(recs, runs):
            print(f"rank {r['rank']} (phase 12c {label}; rows "
                  f"{run['rows_range']}, columns {run['cols_range']}): init "
                  f"{run['init_s']:.2f}s, rounds (s) "
                  f"{[round(t, 3) for t in run['times']]}, evals "
                  f"{run['eval_s']:.2f}s, peak {run['peak']} bytes; "
                  f"collectives {run['comm']}", flush=True)
        gaps = {"xi": _gap(runs[0]["xis"][:-1], one["xis"][:-1]),
                "grad_norm": _gap(runs[0]["grad_norms"], one["grad_norms"])}
        for k in ("grad_norm_agent", "dist_to_mean"):
            if k in one["cols"]:
                gaps[k] = _gap(runs[0]["cols"][k], one["cols"][k])
        if label in OPT_RUNS:
            fp = {n: [_wrap64(sum(run["fingerprint"][n][j] for run in runs))
                      for j in (0, 1)] for n in one["fingerprint"]}
            same_state = fp == one["fingerprint"]
            state_note = f"fingerprint of {len(fp)} panels"
        else:
            whole = torch.load(os.path.join(tmp, f"opt{i}.pt"),
                               weights_only=False)
            diff = {n: x for n, x in whole.items()
                    if not tree_equal(torch, x, one["state"][n])}
            if weighted:  # the parameters move with the weights: their
                # largest gap over the panel's largest |value|
                gaps["panel"] = max([float(
                    (x.float() - one["state"][n].float()).abs().max()
                    / one["state"][n].float().abs().max())
                    for n, x in diff.items() if n.startswith("panel.")]
                    or [0.0])
                diff = {n: x for n, x in diff.items()
                        if not n.startswith("panel.")}
            same_state = set(whole) == set(one["state"]) and not diff
            state_note = f"gathered state of {len(whole)} panels"
            del whole
        print(f"sharded (phase 12c {label}, {card_line()}): mesh {SHARD_MESH}"
              f", {state_note} bit for bit with one process: {same_state}; "
              f"losses {runs[0]['losses']} against {one['losses']}; Xi "
              f"{runs[0]['xis']} against {one['xis']}; evals merged "
              f"{runs[0]['merged']!r} local {runs[0]['local']!r} against "
              f"{one['merged']!r} {one['local']!r}; rounds (s) "
              f"{[round(max(r['times'][t] for r in runs), 3) for t in range(len(one['times']))]}"
              f" against one process's "
              f"{[round(t, 3) for t in one['times']]}; peak per rank "
              f"{max(r['peak'] for r in runs)} against one process's "
              f"{one['peak']}; relative gaps {gaps} (bounds: Xi, grad norm "
              f"{OPT_XI_RTOL}, columns {OPT_COL_RTOL}, weighted "
              f"{OPT_WEIGHTED_RTOL})", flush=True)
        check(same_state, f"phase 12c {label}: the sharded state differs "
                          f"from one process's")
        check(gaps["xi"] <= OPT_XI_RTOL and gaps["grad_norm"] <= OPT_XI_RTOL
              and all(gaps.get(k, 0.0) <= OPT_COL_RTOL
                      for k in ("grad_norm_agent", "dist_to_mean"))
              and gaps.get("panel", 0.0) <= OPT_WEIGHTED_RTOL,
              f"phase 12c {label}: relative gaps {gaps}")
        for r, run in zip(recs, runs):
            ev_ok = (_close([run["merged"], run["local"]],
                            [one["merged"], one["local"]], OPT_WEIGHTED_RTOL)
                     if weighted else run["merged"] == one["merged"]
                     and run["local"] == one["local"])
            check(ev_ok and run["losses"] == one["losses"],
                  f"phase 12c {label}: rank {r['rank']}'s evals or losses "
                  f"differ from one process's")
            # swa merges its accumulators, not the rows: its merged model
            # is another model than the agents'
            check(run["xis"][-1] == 0.0 and run["rows_identical"]
                  and (OPTIONS[label][1] == "swa"
                       or abs(run["local"] - run["merged"])
                       <= 1e-6 * abs(run["merged"])),
                  f"phase 12c {label}: rank {r['rank']}: Xi {run['xis']}, "
                  f"rows identical {run['rows_identical']}, evals "
                  f"{run['merged']!r} {run['local']!r}")
            for k in ("loss_agent", "live", "wire_bytes"):
                if k in one["cols"]:
                    check(run["cols"][k] == one["cols"][k],
                          f"phase 12c {label}: rank {r['rank']}'s {k}")
            missing = [k for k in OPTION_KERNELS[label]
                       if run["counts"][k] == 0]
            check(not missing, f"phase 12c {label}: rank {r['rank']} never "
                               f"launched {missing}")
            if OPTIONS[label][0] == "native":
                check(run["counts"]["quantize_int8_native"]
                      == run["comm_rounds"]
                      and run["counts"]["quantize_int8"] == 0,
                      f"phase 12c {label}: rank {r['rank']} quantized "
                      f"{run['counts']} in {run['comm_rounds']} rounds")
            for k, n in run["counts"].items():
                counts[k] = counts.get(k, 0) + n
        for mate in {tuple(r["cols_range"]) for r in runs}:
            digests = {r["row_digest"] for r in runs
                       if tuple(r["cols_range"]) == mate}
            check(len(digests) == 1, f"phase 12c {label}: the merged rows "
                                     f"differ between ranks")
    b12 = sharded["recs"]
    print(f"sharded options (phase 12c, {card_line()}): {len(OPTIONS)} runs"
          f" on one process {t_single:.1f}s, on {SHARD_MESH} over "
          f"{recs[0]['transport']} {wall:.1f}s for the world; full-width "
          f"rounds (s) "
          f"{ {k: [round(max(r['runs'][k]['times'][t] for r in recs), 3) for t in range(OPT_ROUNDS)] for k in OPT_RUNS} }"
          f" and peaks per rank "
          f"{ {k: max(r['runs'][k]['peak'] for r in recs) for k in OPT_RUNS} }"
          f" against phase 12b's rounds "
          f"{[round(max(r['times'][t] for r in b12), 3) for t in range(ROUNDS)]}"
          f" and peak {max(r['peak'] for r in b12)}", flush=True)
    return counts, {"recs": recs, "singles": singles}


# phase 12d: sharded checkpoints (ROADMAP A16b'): the launcher on SHARD_MESH
# with --checkpoint-every 1 --checkpoint-keep 1 saves each rank's blocks
# after its first segment (the main path's cell, LAUNCHER_ARGS: rounds 0-1),
# is killed (rank 1 first) once MANIFEST.json names the step, and resumes
# from that step on CKPT_RESUMES' layouts in turn; each resumed run is held
# against phase 10a's uninterrupted one-process launcher run. The
# checkpoint directory (about 22.8 GB) lives in the checkout and is removed
# at the end; the disk must hold CKPT_DISK_SHARE times it.
CKPT_RESUMES = (("same mesh", 4, "1,2,2,1"), ("1,4,1,1", 4, "1,4,1,1"),
                ("one process", 1, None))
CKPT_STEP = 2  # the step the checkpoint names: after the first segment
CKPT_DISK_SHARE = 1.25
CKPT_TIMEOUT = 300
# phase 12e: the dry run (launch/dryrun.py:reckon) of 12b's and 12c (A)'s
# configurations, traced on the host in a child started before phase 11;
# its peak a rank within DRY_PEAK_SHARE of each rank's measured one
DRY_PEAK_SHARE = 0.10
DRY_TIMEOUT = 900


def ckpt_child():
    """One rank (or the one process) of phase 12d: launch/train.py:run on
    the main path's cell with the arguments in CKPT_ARGS. Prints "CKPT
    {json}" once its checkpoint is written (bytes and seconds of the pack
    and write) and "SHARD {json}" at the end: the history, the final
    state's fingerprint part, the restore's seconds, the transport,
    launch counts and peak."""
    import torch

    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    args = train.parse_args(json.loads(os.environ["CKPT_ARGS"]))
    cfg = get_config("olmo-1b").replace(num_layers=2)
    lm = SyntheticLM(vocab=DATA_VOCAB, num_domains=8, seed=0)
    rec = {"rank": int(os.environ.get("RANK", "0")), "restore_s": None,
           "transport": "one process"}
    commit, restore = (ckpt_io.ShardedCheckpointer._commit,
                       ckpt_io.restore_latest)
    make, build_mesh = train.dsgd.make_panel_segment, train.build_mesh
    last = {}

    def timed_commit(self, step, flat, *a):
        t0 = time.perf_counter()
        commit(self, step, flat, *a)
        # the process's own stdout: the launcher sends the console of
        # ranks but 0 to os.devnull
        print("CKPT " + json.dumps({
            "rank": self.rank, "step": step, "seconds":
                time.perf_counter() - t0,
            "bytes": sum(a.nbytes for _, a, _ in flat.values())}),
            file=sys.__stdout__, flush=True)

    def timed_restore(*a, **kw):
        t0 = time.perf_counter()
        out = restore(*a, **kw)
        torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t0
        rec["restored_step"] = None if out is None else out[0]
        rec["restore_peak"] = torch.cuda.max_memory_allocated()
        return out

    def keeping(loss_fn, opt, H_, spec, **kw):
        seg = make(loss_fn, opt, H_, spec, **kw)
        last["spec"] = spec

        def run_seg(*sa, **skw):
            out = seg(*sa, **skw)
            last["state"] = out[0]
            return out
        return run_seg

    def noting(*a, **kw):
        mesh = build_mesh(*a, **kw)
        rec["transport"] = mesh.transport
        return mesh

    ckpt_io.ShardedCheckpointer._commit = timed_commit
    ckpt_io.restore_latest = timed_restore
    train.dsgd.make_panel_segment, train.build_mesh = keeping, noting
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    hist = train.run(args, cfg=cfg, lm=lm)
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    rec["counts"] = launch_counts()
    rec["peak"] = torch.cuda.max_memory_allocated()
    spec = last["spec"]
    rec["fingerprint"] = state_fingerprint(
        torch, last.pop("state"), col0=spec.col_range("float32")[0])
    rec["history"] = hist
    print("SHARD " + json.dumps(rec), flush=True)


CKPT_CHILD = ("import sys\n"
              "sys.path.insert(0, sys.argv[1])\n"
              "import chip_smoke\n"
              "chip_smoke.ckpt_child()\n")


def _ckpt_ranks(world, argv, tmp, kill_when=None):
    """Start ``world`` launcher children (``world`` 4: SHARD_MESH's ranks
    over a file:// rendezvous in ``tmp``; 1: one process) with ``argv``;
    returns {rank: [output lines]}. With ``kill_when`` (a callable of the
    lines so far) the children are SIGKILLed, rank 1 first, once it holds,
    else each must exit 0 within CKPT_TIMEOUT."""
    import signal
    import threading
    env = dict(os.environ, CKPT_ARGS=json.dumps(argv),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    if world > 1:
        env.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   REPRO_TORCH_INIT_METHOD=f"file://{tmp}/rdv_{time.time()}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", CKPT_CHILD, ROOT],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)) if world > 1 else env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    lines = {r: [] for r in range(world)}

    def pump(r, p):
        for ln in p.stdout:
            lines[r].append(ln.rstrip("\n"))

    pumps = [threading.Thread(target=pump, args=(r, p), daemon=True)
             for r, p in enumerate(procs)]
    for t in pumps:
        t.start()
    deadline = time.monotonic() + CKPT_TIMEOUT
    try:
        if kill_when is not None:
            while not kill_when(lines):
                check(time.monotonic() < deadline and all(
                    p.poll() is None for p in procs),
                      "phase 12d: the checkpointed run ended or stalled "
                      "before its step was committed:\n" + "\n".join(
                          "\n".join(v[-20:]) for v in lines.values()))
                time.sleep(0.05)
            for r in [1] + [r for r in range(world) if r != 1]:
                procs[r].send_signal(signal.SIGKILL)
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in pumps:
            t.join(timeout=10)
    if kill_when is None:
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        check(not bad, "phase 12d: ranks failed:\n" + "\n".join(
            f"--- rank {r}:\n" + "\n".join(lines[r][-40:]) for r in bad))
    return lines


def _tagged(lines, tag):
    return [json.loads(ln[len(tag) + 1:]) for ln in lines
            if ln.startswith(tag + " ")]


def ckpt_phase(torch, launcher):
    """Phase 12d: the killed-and-resumed sharded launcher at full width (see
    CKPT_RESUMES). Gates: the disk holds CKPT_DISK_SHARE times the state
    (else it fails by name), MANIFEST.json names step 2 with every rank's
    parts, each resume restores step 2 and its history's losses and evals
    equal phase 10a's bit for bit (grad norms and Xi within 1e-6, summed
    over the ranks in another order), Xi 0.0 and merged == local after the
    merge, its final state's fingerprint (summed over the ranks) equal to
    phase 10a's, the 4-rank runs over CUDA IPC, and gossip_mix and
    panel_mean_consensus launched on every rank. Prints each rank's bytes
    written, its pack + write and its restore seconds."""
    import shutil
    t_phase = time.perf_counter()
    need = 3 * 4 * M * launcher["width"]  # the panel, two moments: float32
    free = shutil.disk_usage(ROOT).free
    check(free >= CKPT_DISK_SHARE * need,
          f"phase 12d: the checkpoint takes {need} B; the disk under {ROOT} "
          f"has {free} B free, under {CKPT_DISK_SHARE} x that")
    tmp = os.path.join(ROOT, f".ckpt_12d_{os.getpid()}")
    ck = os.path.join(tmp, "ckpt")
    os.makedirs(tmp)
    base = LAUNCHER_ARGS + ["--checkpoint-dir", ck]
    try:
        t0 = time.perf_counter()

        def committed(lines):
            try:
                with open(os.path.join(ck, "MANIFEST.json")) as f:
                    man = json.load(f)
            except (OSError, ValueError):
                return False
            steps = [c["step"] for c in man["checkpoints"]]
            return CKPT_STEP in steps and all(_tagged(v, "CKPT") for v in
                                              lines.values())
        lines = _ckpt_ranks(4, base + [
            "--mesh", ",".join(map(str, SHARD_MESH)), "--checkpoint-every",
            "1", "--checkpoint-keep", "1", "--out",
            os.path.join(tmp, "kill")], tmp, kill_when=committed)
        t_kill = time.perf_counter() - t0
        with open(os.path.join(ck, "MANIFEST.json")) as f:
            entry = json.load(f)["checkpoints"][-1]
        saves = {r: _tagged(v, "CKPT")[0] for r, v in lines.items()}
        written = {r: sum(p["bytes"] for p in entry["parts"]
                          if p["rank"] == r) for r in range(4)}
        print(f"sharded checkpoint (phase 12d, {card_line()}): mesh "
              f"{SHARD_MESH}, step {entry['step']}, {len(entry['parts'])} "
              f"parts, {sum(written.values())} B on disk (state {need} B); "
              f"the run killed (rank 1 first) once the manifest named it, "
              f"{t_kill:.1f}s; per rank: bytes written "
              f"{[written[r] for r in range(4)]}, pack + write (s) "
              f"{[round(saves[r]['seconds'], 3) for r in range(4)]}",
              flush=True)
        check(entry["step"] == CKPT_STEP
              and {p["rank"] for p in entry["parts"]}
              == set(range(4)), f"phase 12d: manifest entry {entry}")
        counts, peaks = {}, {}
        for label, world, shape in CKPT_RESUMES:
            t0 = time.perf_counter()
            lines = _ckpt_ranks(world, base + [
                "--resume", "--out", os.path.join(tmp, label)]
                + ([] if shape is None else ["--mesh", shape]), tmp)
            recs = [_tagged(lines[r], "SHARD")[-1] for r in range(world)]
            peaks[label] = [r["peak"] for r in recs]
            wall = time.perf_counter() - t0
            fp = {n: [_wrap64(sum(r["fingerprint"][n][i] for r in recs))
                      for i in (0, 1)] for n in ("panel", "m", "v")}
            hist = recs[0]["history"]
            got = {"losses": [h["train_loss"] for h in hist],
                   "merged": hist[-1]["merged_eval"],
                   "local": hist[-1]["local_eval"]}
            print(f"resumed on {label} (phase 12d, {card_line()}): "
                  f"{wall:.1f}s for the world; restore (s) "
                  f"{[round(r['restore_s'], 3) for r in recs]}, run (s) "
                  f"{[round(r['seconds'], 3) for r in recs]}, peak "
                  f"{[r['peak'] for r in recs]} B (by the restore's end "
                  f"{[r['restore_peak'] for r in recs]}), "
                  f"{recs[0]['transport']}; "
                  f"losses {got['losses']} against phase 10a's "
                  f"{launcher['losses']}; evals {got['merged']!r} "
                  f"{got['local']!r}; fingerprint equal to 10a's "
                  f"{fp == launcher['fingerprint']}", flush=True)
            for r in recs:
                check(r["restored_step"] == CKPT_STEP,
                      f"phase 12d {label}: rank {r['rank']} restored step "
                      f"{r['restored_step']}")
                check(r["history"] == hist, f"phase 12d {label}: the ranks' "
                                            "histories differ")
                check(world == 1 or r["transport"] == "cuda ipc",
                      f"phase 12d {label}: {r['transport']}")
                check(r["counts"]["gossip_mix"] > 0
                      and r["counts"]["panel_mean_consensus"] > 0,
                      f"phase 12d {label}: rank {r['rank']} launched "
                      f"{r['counts']}")
                for k, n in r["counts"].items():
                    counts[k] = counts.get(k, 0) + n
            check(got["losses"] == launcher["losses"]
                  and got["merged"] == launcher["merged"]
                  and got["local"] == launcher["local"],
                  f"phase 12d {label}: {got} against phase 10a's")
            for key, name in (("grad_norms", "grad_norm"),
                              ("xis", "consensus")):
                vals = [h[name] for h in hist]
                check(all(abs(a - b) <= 1e-6 * abs(b) for a, b in
                          zip(vals, launcher[key])),
                      f"phase 12d {label}: {key} {vals} against "
                      f"{launcher[key]}")
            check(hist[-1]["consensus"] == 0.0
                  and abs(got["local"] - got["merged"])
                  <= 1e-6 * abs(got["merged"]),
                  f"phase 12d {label}: last round {hist[-1]}")
            check(fp == launcher["fingerprint"],
                  f"phase 12d {label}: final state {fp} against phase "
                  f"10a's {launcher['fingerprint']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dt = time.perf_counter() - t_phase
    print(f"sharded checkpoints (phase 12d, {card_line()}): {dt:.1f}s",
          flush=True)
    return counts, {"seconds": dt, "written": written, "peaks": peaks}


def reckon_child(out):
    """Phase 12e's host work (on the CPU, no card): launch/dryrun.py's
    reckon of phase 12b's run and of 12c's run (A), rank 0 of SHARD_MESH,
    of phase 12d's resume on (1, 4, 1, 1), of phase 12f's olmo cell on the
    split route, (reckon_serve) of phase 12g's and 12h's serve cells and
    (reckon_step) of 12h's steps, written to ``out`` as JSON."""
    import torch
    torch.set_num_threads(2)
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.wire import Int8Codec
    cfg = get_config("olmo-1b").replace(num_layers=2)
    res = {}
    for label, rounds, kw in (
            ("12b", ROUNDS, {}),
            ("12c A", OPT_ROUNDS, {
                "wire": Int8Codec("int8_ef", error_feedback=True,
                                  draws="kernel"),
                "merger": "var", "residency": "moments=int8", "fused": True,
                "telemetry": True})):
        per_round, _ = segment_inputs(cfg, M, rounds, data_vocab=DATA_VOCAB)
        t0 = time.perf_counter()
        r = dryrun.reckon(cfg, SHARD_MESH, agents=M, local_steps=H,
                          batch=BATCH, seq=SEQ, route="cuda ipc",
                          rounds=[(W, g, lv) for W, _, g, lv in per_round],
                          **kw)
        res[label] = {k: r[k] for k in ("state_bytes", "peak", "init",
                                        "run", "host_reads", "flops")}
        res[label]["seconds"] = time.perf_counter() - t0
    # phase 12d's resume on (1, 4, 1, 1), rank 0: the rounds after the
    # checkpoint's step (the resumed run restores the state the reckon
    # initialises)
    label, _, shape = CKPT_RESUMES[1]
    per_round, _ = segment_inputs(cfg, M, ROUNDS, data_vocab=DATA_VOCAB)
    t0 = time.perf_counter()
    r = dryrun.reckon(cfg, tuple(int(x) for x in shape.split(",")), agents=M,
                      local_steps=H, batch=BATCH, seq=SEQ, route="cuda ipc",
                      rounds=[(W, g, lv) for W, _, g, lv
                              in per_round[CKPT_STEP:]])
    res[f"12d {label}"] = {k: r[k] for k in ("state_bytes", "peak")}
    res[f"12d {label}"]["seconds"] = time.perf_counter() - t0
    # phase 12f's olmo cell on the split route, rank 0 of its mesh
    label = "olmo"
    shape, m = SPLIT_CELLS[label]
    cfg = split_config(label)
    per_round, _ = segment_inputs(cfg, m, SPLIT_ROUNDS,
                                  data_vocab=DATA_VOCAB)
    t0 = time.perf_counter()
    r = dryrun.reckon(cfg, shape, agents=m, local_steps=H, batch=BATCH,
                      seq=SEQ, route="cuda ipc", split=True,
                      rounds=[(W, g, lv) for W, _, g, lv in per_round])
    res["12f"] = {k: r[k] for k in ("state_bytes", "peak", "init", "run",
                                    "host_reads", "flops", "split")}
    res["12f"]["seconds"] = time.perf_counter() - t0
    # phase 12g's and 12h's serve cells, rank 0 of each mesh (the prompt's
    # positions after the patch prefix where the model takes one)
    for phase, cells in (("12g", SERVE_CELLS), ("12h serve", SERVE_H_CELLS)):
        for label, (_, shape, _, _, _, B, prompt, steps) in cells.items():
            t0 = time.perf_counter()
            cfg = serve_cell_config(label)
            P = max(0, cfg.mm_prefix)
            r = dryrun.reckon_serve(cfg, shape, batch=B, prompt=P + prompt,
                                    max_len=P + prompt + steps,
                                    decode_steps=1, route="cuda ipc")
            key = f"{phase} {label}"
            res[key] = {k: r[k] for k in (
                "peak", "param_bytes", "cache_bytes", "flops")}
            res[key]["run"] = {k: r["run"][k] for k in ("calls", "bytes")}
            res[key]["seconds"] = time.perf_counter() - t0
    # phase 12h's steps on the split route, rank 0 of each mesh
    for label, (_, shape, _, _, rows, tokens) in SPLIT_H_CELLS.items():
        t0 = time.perf_counter()
        cfg = split_h_config(label)
        r = dryrun.reckon_step(cfg, shape, batch=rows,
                               seq=cfg.mm_prefix + tokens, route="cuda ipc")
        res[f"12h step {label}"] = {
            "peak": r["peak"], "flops": r["flops"],
            "param_bytes": r["param_bytes"],
            "run": {k: r["run"][k] for k in ("calls", "bytes")},
            "seconds": time.perf_counter() - t0}
    with open(out, "w") as f:
        json.dump(res, f)


RECKON_CHILD = ("import sys\n"
                "sys.path.insert(0, sys.argv[1])\n"
                "import chip_smoke\n"
                "chip_smoke.reckon_child(sys.argv[2])\n")


def start_reckon():
    """Start reckon_child in a process of its own, with no card visible;
    returns (process, output path)."""
    import tempfile
    fd, out = tempfile.mkstemp(prefix="chip_smoke_reckon_", suffix=".json")
    os.close(fd)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", RECKON_CHILD, ROOT, out],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


def dryrun_phase(torch, reckoning, sharded, options, ckpt):
    """Phase 12e: the dry run's reckoning of 12b's and 12c (A)'s runs
    against what they measured, rank by rank: the peak a rank within
    DRY_PEAK_SHARE of the measured max_memory_allocated, the collective
    bytes and calls equal to the run's Mesh.stats (12b's counted after the
    init, 12c's from before it, as each run reset them); and the card's
    memory the dry run's ``fits`` reads (``hardware.MEMORY_BYTES``) the
    card's own. The memory a 12b rank holds beyond its peak: the card's
    used bytes with every rank alive, less this process's, the ranks'
    allocator reserves and their IPC buffers, over the ranks (each rank's
    context), plus each rank's reserve over its peak; gated under
    ``hardware.RANK_RESERVE_BYTES``, and 12b's reckoned
    ``dryrun.device_total`` within DRY_PEAK_SHARE of what each rank's
    measured peak, reserve and buffer come to. And the reckoned peak of
    12d's (1, 4, 1, 1) resume within DRY_PEAK_SHARE of the peak its ranks
    measured (``ckpt``: phase 12d's record)."""
    from repro_torch import hardware
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import IPC_BYTES
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"dry run (phase 12e, {card_line()}): the card's memory {total} B"
          f", hardware.MEMORY_BYTES {hardware.MEMORY_BYTES}", flush=True)
    check(total == hardware.MEMORY_BYTES,
          f"phase 12e: the card has {total} B, the dry run reckons with "
          f"{hardware.MEMORY_BYTES}")
    proc, out = reckoning
    try:
        log = proc.communicate(timeout=DRY_TIMEOUT)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"phase 12e: the reckoning failed:\n"
                                f"{log[-3000:]}")
    with open(out) as f:
        res = json.load(f)
    os.remove(out)
    runs = {"12b": ([r for r in sharded["recs"]], ("run",)),
            "12c A": ([r["runs"]["A"] for r in options["recs"]],
                      ("init", "run"))}
    for label, (recs, parts) in runs.items():
        r = res[label]
        calls = sum(r[p]["calls"] for p in parts)
        nbytes = sum(r[p]["bytes"] for p in parts)
        peaks = [x["peak"] for x in recs]
        comm = [(int(x["comm"]["calls"]), int(x["comm"]["bytes"]))
                for x in recs]
        gaps = [(r["peak"] - p) / p for p in peaks]
        print(f"dry run (phase 12e {label}, reckoned on the host in "
              f"{r['seconds']:.1f}s; {card_line()}): peak a rank "
              f"{r['peak']} B against the measured {peaks} "
              f"({[round(g, 4) for g in gaps]}); state {r['state_bytes']} "
              f"B; collectives {calls} calls, {nbytes} B against "
              f"Mesh.stats {comm}; host reads {r['host_reads']}",
              flush=True)
        check(all(abs(g) <= DRY_PEAK_SHARE for g in gaps),
              f"phase 12e {label}: peak {r['peak']} against {peaks}")
        check(all(c == (calls, nbytes) for c in comm),
              f"phase 12e {label}: collectives ({calls}, {nbytes}) against "
              f"{comm}")
        check(r["host_reads"]["traced"] == 0,
              f"phase 12e {label}: host reads {r['host_reads']}")
    label = CKPT_RESUMES[1][0]
    r, peaks = res[f"12d {label}"], ckpt["peaks"][label]
    gaps = [(r["peak"] - p) / p for p in peaks]
    print(f"dry run (phase 12e, 12d's resume on {label}, reckoned on the "
          f"host in {r['seconds']:.1f}s; {card_line()}): peak a rank "
          f"{r['peak']} B against the measured {peaks} "
          f"({[round(g, 4) for g in gaps]}); state {r['state_bytes']} B",
          flush=True)
    check(all(abs(g) <= DRY_PEAK_SHARE for g in gaps),
          f"phase 12e, 12d's resume on {label}: peak {r['peak']} against "
          f"{peaks}")
    recs = sharded["recs"]
    ctx = (recs[0]["card_used"] - sharded["parent_used"]
           - sum(x["reserved"] for x in recs)
           - len(recs) * IPC_BYTES) // len(recs)
    beyond = [ctx + x["max_reserved"] - x["peak"] for x in recs]
    need = [x["max_reserved"] + ctx + IPC_BYTES for x in recs]
    reckoned = dryrun.device_total(res["12b"]["peak"], "cuda ipc")
    gaps = [(reckoned["per_device_total"] - n) / n for n in need]
    print(f"dry run (phase 12e 12b, {card_line()}): the card's used bytes "
          f"{recs[0]['card_used']} with the 4 ranks, this process's "
          f"{sharded['parent_used']}; a rank's context {ctx} B, allocator "
          f"reserve over its peak "
          f"{[x['max_reserved'] - x['peak'] for x in recs]} B, beyond its "
          f"peak {beyond} B against hardware.RANK_RESERVE_BYTES "
          f"{hardware.RANK_RESERVE_BYTES}; device total reckoned "
          f"{reckoned['per_device_total']} B (IPC {IPC_BYTES}) against the "
          f"measured {need} ({[round(g, 4) for g in gaps]})", flush=True)
    check(all(abs(g) <= DRY_PEAK_SHARE for g in gaps),
          f"phase 12e: device total {reckoned} against {need}")
    check(max(beyond) <= hardware.RANK_RESERVE_BYTES,
          f"phase 12e: a rank holds {max(beyond)} B beyond its peak, over "
          f"hardware.RANK_RESERVE_BYTES {hardware.RANK_RESERVE_BYTES}")
    return res


def arch_config(name):
    """Phase 11's model config of a cell of ARCH_CELLS."""
    import dataclasses

    from repro_torch.configs import get_config
    arch, layers, _, _, _, block, experts = ARCH_CELLS[name]
    cfg = get_config(arch)
    cfg = cfg.reduced() if layers is None else cfg.replace(num_layers=layers)
    if experts:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  num_experts=experts))
    if block:
        cfg = cfg.replace(dist=dataclasses.replace(cfg.dist,
                                                   attn_block=block))
    return cfg


def cell_extras(cfg, batch, seed):
    """The model's other inputs (repro_torch.models.extra_inputs: the vlm's
    patch prefix, the encoder-decoder's frames, one a token) of a batch
    dict whose tokens are (..., seq), float32 standard normals from the
    numpy generator seeded ``seed``; {} for a decoder of tokens alone."""
    import numpy as np

    from repro_torch.models import extra_inputs
    rng = np.random.default_rng(seed)
    lead, seq = batch["tokens"].shape[:-1], batch["tokens"].shape[-1]
    return {name: rng.standard_normal(lead + shape, dtype=np.float32)
            for name, shape in extra_inputs(cfg, seq).items()}


def attention_layers(cfg):
    """The attention layers a forward runs through the blockwise route:
    the decoder's GQA layers and the encoder's (MLA never takes it; the
    recurrent mixers have no attention; cross attention is the plain
    _sdpa)."""
    n = sum(s_.mixer == "gqa" for s_ in cfg.layer_specs())
    if cfg.encoder_layers:
        n += sum(s_.mixer == "gqa" for s_ in cfg.replace(
            num_layers=cfg.encoder_layers,
            dense_ff_first_k=0).layer_specs())
    return n


def drive_arch(torch, name):
    """Phase 11, one cell: the arch at its cut (arch_config) through
    init_panel_state -> make_panel_segment -> merged and local eval on the
    f32 wire, the final-merge schedule, ARCH_ROUNDS rounds of H local
    steps, the data over min(DATA_VOCAB, vocab) ids, every batch with the
    model's other inputs (cell_extras: the vlm's patch prefix, the
    encoder-decoder's frames). Checked: the width D against ARCH_D, every
    round's loss finite, after the merge every row identical bit for bit
    and Xi 0.0, merged eval == local eval to 1e-6 relative, the mix and the
    reduce launched (with attn_block, one flash forward and one backward an
    attention layer (attention_layers: the encoder's included), agent and
    local step, and one forward an attention layer for the merged eval and
    one an attention layer and agent for the local evals, exactly).
    Returns
    (counts, record, the merged model or None, model)."""
    from repro_torch.core import dsgd
    from repro_torch.core import merge as merge_mod
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import eval_local, eval_merged, to_device
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    dev = torch.device("cuda")
    _, _, m, batch, seq, _, _ = ARCH_CELLS[name]
    cfg = arch_config(name)
    model = build_model(cfg)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=ARCH_ROUNDS * H)
    per_round, eval_batch = segment_inputs(
        cfg, m, ARCH_ROUNDS, data_vocab=min(DATA_VOCAB, cfg.vocab_size),
        batch=batch, seq=seq)
    for t, (_, b, _, _) in enumerate(per_round):
        b.update(cell_extras(cfg, b, (EXTRAS_SEED, t)))
    eval_batch.update(cell_extras(cfg, eval_batch,
                                  (EXTRAS_SEED, ARCH_ROUNDS)))
    eval_batch = to_device(eval_batch, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, spec = dsgd.init_panel_state(
        model.init_params, opt, m, torch.Generator(device=dev).manual_seed(0),
        device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec)
    moe = cfg.moe
    print(f"cell {name} (phase 11, {card_line()}): {cfg.name} d_model "
          f"{cfg.d_model}, {cfg.num_layers} layers, heads {cfg.attn.num_heads}"
          f" (kv {cfg.attn.num_kv_heads}) x {cfg.attn.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size} padded to {cfg.padded_vocab}, "
          f"untied head {not cfg.tie_embeddings}, experts "
          f"{moe.num_experts if moe else 0} (top {moe.top_k if moe else 0}), "
          f"mla {cfg.layer_period[0].mixer == 'mla'}, mtp {cfg.mtp_depth}, "
          f"mixers {[s_.mixer for s_ in cfg.layer_specs()]}, encoder "
          f"layers {cfg.encoder_layers} (cross attention in every decoder "
          f"layer: {cfg.encoder_layers > 0}), rope {cfg.attn.rope} "
          f"{cfg.attn.mrope_sections}, patch prefix "
          f"{max(0, cfg.mm_prefix)}; "
          f"D {spec.width} per agent, m {m} (m D {m * spec.width}, 2^31 = "
          f"{2 ** 31}), H {H}, batch {batch}, seq {seq}, attn_block "
          f"{cfg.dist.attn_block}; init {t_init:.2f}s, device memory held "
          f"before {held} bytes", flush=True)
    check(spec.width == ARCH_D[name],
          f"cell {name}: D {spec.width} != {ARCH_D[name]}")
    losses, xis, times = [], [], []
    for t, (W, b, glob, live) in enumerate(per_round):
        t0 = time.perf_counter()
        state, mets = seg(state, b, W, global_rounds=glob, live=live)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(mets["loss"][0]))
        xis.append(float(mets["consensus"][0]))
        kind = ("idle" if (W[0] == torch.eye(m).numpy()).all() else
                "merge" if glob[0] else "mix")
        print(f"round {t} ({kind}, {name}): loss {losses[-1]:.6f} Xi "
              f"{xis[-1]!r} {times[-1]:.3f}s; device memory peak so far "
              f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
    t0 = time.perf_counter()
    merged = eval_merged(model.loss_fn, state["panel"], spec, eval_batch)
    local = eval_local(model.loss_fn, state["panel"], spec, eval_batch)
    torch.cuda.synchronize()
    dt_eval = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    same = rows_identical(torch, state["panel"])
    print(f"kernels ({cfg.name}) {json.dumps(counts)}", flush=True)
    print(f"eval ({name}, {card_line()}): merged {merged!r} local {local!r} "
          f"({dt_eval:.3f}s for both); rounds (s) {times}; peak device "
          f"memory {peak} bytes ({peak / (m * spec.width * 4):.2f} panels); "
          f"after the final merge the rows are identical: {same}, Xi "
          f"{xis[-1]!r}", flush=True)
    check(counts["gossip_mix"] > 0 and counts["panel_mean_consensus"] > 0,
          f"cell {name}: the mix or the reduce never launched: {counts}")
    if cfg.dist.attn_block:
        n_attn = attention_layers(cfg)
        steps = ARCH_ROUNDS * H * m * n_attn
        check(n_attn > 0 and counts["flash_attention_bwd"] == steps
              and counts["flash_attention_fwd"]
              == steps + n_attn + m * n_attn,
              f"cell {name}: flash attention launches {counts} are not one "
              f"forward and one backward an attention layer ({n_attn}), "
              f"agent and local step, plus one forward an attention layer "
              f"for the merged eval and one an attention layer and agent "
              f"for the local evals")
    check(all(math.isfinite(x) for x in losses + [merged, local]),
          f"cell {name}: a loss is not finite: {losses} {merged} {local}")
    check(same and xis[-1] == 0.0,
          f"cell {name}: rows differ or Xi {xis[-1]!r} after the merge")
    check(abs(local - merged) <= 1e-6 * abs(merged),
          f"cell {name}: local eval {local!r} != merged eval {merged!r}")
    record = {"losses": losses, "xis": xis, "times": times, "peak": peak,
              "width": spec.width, "merged": merged, "local": local,
              "init_s": t_init}
    served = None
    if name in ARCH_SERVED or cfg.layer_period[0].mixer == "mla":
        served = merge_mod.merged_panel_tree(state["panel"], spec)
    del state, seg
    torch.cuda.empty_cache()
    return counts, record, served, model


def arch_serve(torch, name, model, params, mixed=False):
    """Phase 11, a served cell: the merged model in the ServingEngine
    (ARCH_SERVE_C slots, ARCH_SERVE_REQUESTS requests of ARCH_SERVE_PROMPT
    prompt tokens, ARCH_SERVE_NEW new each, greedy; a one-request warmup,
    then reset()), each request with the model's other inputs
    (launch/serve.py:request_inputs: the vlm's patch prefix, the
    encoder-decoder's ARCH_SERVE_PROMPT frames, whose cross keys and values
    the slots hold padded to max_len at pos -1); with ``mixed`` every other
    request drops its prefix. Every request's tokens equal to the request
    generated alone, no OOV id. Returns (counts, record)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import request_inputs
    from repro_torch.serving import Request, ServingEngine, generate
    cfg = model.cfg
    dev = torch.device("cuda")
    max_len = ARCH_SERVE_PROMPT + max(0, cfg.mm_prefix) + ARCH_SERVE_NEW

    def request(rid, seed, i, max_new):
        toks, extras = request_inputs(cfg, seed, i, ARCH_SERVE_PROMPT)
        if mixed and i % 2:
            extras.pop("patch_embeds", None)
        return Request(rid=rid, tokens=toks, max_new=max_new, extras=extras)

    reqs = [request(i, SERVE_SEED, i, ARCH_SERVE_NEW)
            for i in range(ARCH_SERVE_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    eng = ServingEngine(model, params, max_concurrency=ARCH_SERVE_C,
                        max_len=max_len)
    eng.serve([request(-1, SERVE_SEED + 1, 0, 4)])
    eng.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    snap = eng.snapshot()
    lat = snap["latency"]
    n_tok = sum(len(v) for v in out.values())
    rec = {"tok_s": n_tok / dt, "seconds": dt, "occupancy": snap["occupancy"],
           "ttft_p50_ms": 1e3 * lat["ttft_s"]["p50_s"],
           "decode_step_p50_ms": 1e3 * lat["decode_step_s"]["p50_s"],
           "peak": peak}
    # the decode steps' share of the serving time (the rest: admissions,
    # each a prefill, an insert and the first sample)
    rec["decode_share"] = (lat["decode_step_s"]["count"]
                           * lat["decode_step_s"]["mean_s"] / dt
                           if "mean_s" in lat["decode_step_s"] else None)
    del eng
    same = []
    for r in reqs:
        batch = {"tokens": torch.from_numpy(r.tokens[None]).to(dev)}
        for k, v in r.extras.items():
            batch[k] = torch.from_numpy(v[None]).to(dev)
        alone = generate(model, params, batch, ARCH_SERVE_NEW,
                         max_len=max_len)[0]
        same.append(bool((alone == out[r.rid]).all()))
    extras = sorted(reqs[0].extras)
    print(f"serve ({name}, phase 11, {card_line()}): {ARCH_SERVE_C} slots, "
          f"{ARCH_SERVE_REQUESTS} requests of {ARCH_SERVE_PROMPT} prompt "
          f"tokens (extras {extras}"
          f"{', every other request without its prefix' if mixed else ''}),"
          f" {ARCH_SERVE_NEW} new: {rec['tok_s']:.1f} tok/s "
          f"({n_tok} tokens in {dt:.3f}s) | ttft p50 "
          f"{rec['ttft_p50_ms']:.1f} ms | decode step p50 "
          f"{rec['decode_step_p50_ms']:.3f} ms | decode share "
          f"{rec['decode_share']!r} | occupancy "
          f"{snap['occupancy']:.4f} | peak device memory {peak} bytes; "
          f"tokens equal to each request generated alone: {same}",
          flush=True)
    print(f"kernels (serve {cfg.name}) {json.dumps(counts)}", flush=True)
    oov = [rid for rid, v in out.items()
           if not ((v >= 0) & (v < cfg.vocab_size)).all()]
    check(not oov, f"serve ({name}): requests {oov} emitted an OOV id")
    check(len(out) == ARCH_SERVE_REQUESTS and all(
        len(v) == ARCH_SERVE_NEW for v in out.values()),
        f"serve ({name}): not every request got {ARCH_SERVE_NEW} tokens")
    check(all(same), f"serve ({name}): the engine's greedy tokens differ "
                     f"from generate alone: {same}")
    torch.cuda.empty_cache()
    return counts, rec


def tol_share(torch, pairs, atol, rtol):
    """(largest |a - ref|, largest |a - ref| / (atol + rtol |ref|)) over
    the (a, ref) pairs, in float64."""
    diff, share = 0.0, 0.0
    for a, ref in pairs:
        d = torch.abs(a.double() - ref.double())
        diff = max(diff, float(torch.max(d)))
        share = max(share, float(torch.max(
            d / (atol + rtol * torch.abs(ref.double())))))
    return diff, share


def decode_steps(torch, model, params, extras=None):
    """Teacher-forced decode: a prompt of MLA_PROMPT tokens (2 rows, seed 7)
    prefilled, then MLA_STEPS decode steps, on the parameters' device;
    ``extras`` (tensors of 2 rows) go into every prefill: a patch prefix
    shifts the decode positions by its rows, an encoder's frames feed the
    cross attention. Returns [(the decode logits, the prefill logits of the
    whole sequence up to that token)] a step."""
    import numpy as np

    from repro_torch.utils.tree import tree_leaves
    cfg = model.cfg
    dev = tree_leaves(params)[0].device
    extras = extras or {}
    off = (extras["patch_embeds"].shape[1] if "patch_embeds" in extras
           else 0)
    total = MLA_PROMPT + MLA_STEPS
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(2, total)).astype(np.int32)).to(dev)
    steps = []
    with torch.no_grad():
        logits, caches = model.prefill(
            params, {"tokens": toks[:, :MLA_PROMPT], **extras},
            max_len=off + total)
        for i in range(MLA_STEPS):
            at = MLA_PROMPT + i
            logits, caches = model.decode_step(params, caches,
                                               toks[:, at:at + 1], off + at)
            ref, _ = model.prefill(
                params, {"tokens": toks[:, :at + 1], **extras},
                max_len=off + total)
            steps.append((logits, ref))
    return steps


def decode_share(torch, name, steps, atol, rtol, what):
    """Prints decode_steps' largest |decode - prefill| and its largest share
    of atol + rtol relative; returns (difference, share)."""
    diff, share = tol_share(torch, steps, atol, rtol)
    print(f"{what} ({name}, phase 11, {card_line()}): {MLA_STEPS} "
          f"teacher-forced steps after a {MLA_PROMPT}-token prompt against "
          f"the whole sequence's prefill ({steps[0][0].dtype}): max |logit "
          f"difference| {diff!r}, largest share of {atol} + {rtol} relative "
          f"{share!r}, within it: {share <= 1.0}", flush=True)
    return diff, share


def decode_check(torch, name, steps, atol=2e-5, rtol=1e-5,
                 what="mla decode"):
    """Phase 11, decode_steps' decode against its prefill: fails unless
    within atol + rtol relative. For the MLA cell (the default tolerance,
    the serving one): the absorbed latent-space attention over the {ckv,
    krope, pos} cache and the dropless MoE against the materialised
    attention; for a recurrent decoder: the one-step updates of its states
    against the prefill's scan and chunk loop. Returns (the largest
    difference, its largest share of the tolerance)."""
    diff, share = decode_share(torch, name, steps, atol, rtol, what)
    check(share <= 1.0,
          f"{what} ({name}): decode differs from prefill by {diff}")
    return diff, share


class _Float64Torch:
    """torch, its ``float32`` reading float64."""

    def __init__(self, torch):
        self._torch = torch
        self.float32 = torch.float64

    def __getattr__(self, name):
        return getattr(self._torch, name)


@contextlib.contextmanager
def float64_model(torch, cfg):
    """Within it, a model of ``cfg`` whose parameters are float64 computes
    in float64 throughout: the port's model modules (layers, attention,
    recurrent, transformer, model) read ``torch.float32`` as float64
    wherever they cast or allocate. A stack whose attention takes the flash
    route (attn_block > 0: attention_layers) is refused: the flash kernels
    take float32 and bfloat16 only. A cast written otherwise would stay
    float32 and add float32 rounding to the float64 run, so a decode check
    inside it reads more noise, never less."""
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import layers, recurrent, transformer
    from repro_torch.models import model as model_mod
    if cfg.dist.attn_block and attention_layers(cfg):
        raise ValueError(f"{cfg.name}: float64_model takes attention on the "
                         "dense route (attn_block 0) only")
    mods = (layers, attention_mod, recurrent, transformer, model_mod)
    saved = [m.torch for m in mods]
    try:
        for m in mods:
            m.torch = _Float64Torch(torch)
        yield
    finally:
        for m, t in zip(mods, saved):
            m.torch = t


def mla_width_check(torch):
    """Phase 11, deepseek-v3 at its published widths, cut in depth and in
    experts (MLA_WIDE_EXPERTS): the weights drawn on the card from seed 0;
    the training loss at MLA_WIDE_BATCH x MLA_WIDE_SEQ (the materialised
    MLA, the front layer's dense FFN, the capacity-capped MoE, the MTP
    head) finite, with its MTP and load-balance terms; the MoE layer's
    dropless moe_forward against its dense twin moe_ref on one draw of
    inputs at 2e-5 + 2e-5 relative (float32 products summed in other
    orders); then decode_check (the absorbed decode against the
    prefill). Returns a record."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import moe_forward, moe_ref
    from repro_torch.utils.tree import tree_leaves
    dev = torch.device("cuda")
    cfg = get_config("deepseek-v3-671b")
    cfg = cfg.replace(num_layers=2, dense_ff_first_k=1,
                      moe=dataclasses.replace(
                          cfg.moe, num_experts=MLA_WIDE_EXPERTS))
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    peaks = {"init": torch.cuda.max_memory_allocated()}
    n_params = sum(t.numel() for t in tree_leaves(params))
    a, moe = cfg.attn, cfg.moe
    print(f"mla width ({card_line()}): {cfg.name} d_model {cfg.d_model}, "
          f"heads {a.num_heads}, q/kv LoRA ranks {a.q_lora_rank}/"
          f"{a.kv_lora_rank}, nope/rope/v {a.qk_nope_dim}/{a.qk_rope_dim}/"
          f"{a.v_head_dim}, vocab {cfg.vocab_size}, layers {cfg.num_layers} "
          f"(dense front {cfg.dense_ff_first_k}, d_ff {cfg.dense_ff_size}), "
          f"experts {moe.num_experts} of 256 (top {moe.top_k}, "
          f"{moe.router}, expert_ff {moe.expert_ff}, shared "
          f"{moe.shared_ff}), mtp {cfg.mtp_depth}: {n_params} parameters, "
          f"init {t_init:.2f}s", flush=True)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(MLA_WIDE_BATCH, MLA_WIDE_SEQ + 1)).astype(
        np.int32)).to(dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, mets = model.loss_fn(params, batch)
        torch.cuda.synchronize()
        dt_loss = time.perf_counter() - t0
        terms = {k: float(v) for k, v in mets.items()}
        del loss, mets
        peaks["loss"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        blk = tfm._index(params["decoder"]["main"]["p0"]["ffn"], 0)
        x = torch.randn((MLA_WIDE_BATCH, MLA_WIDE_SEQ, cfg.d_model),
                        generator=torch.Generator(device=dev).manual_seed(4),
                        device=dev)
        y, aux = moe_forward(blk, x, cfg=cfg, act_name=cfg.act,
                             dropless=True)
        y_ref, aux_ref = moe_ref(blk, x, cfg=cfg, act_name=cfg.act)
        moe_diff = float(torch.max(torch.abs(y - y_ref)))
        moe_ok = (torch.allclose(y, y_ref, atol=2e-5, rtol=2e-5)
                  and abs(float(aux) - float(aux_ref)) <= 1e-6)
        del x, y, y_ref
    peaks["moe check"] = torch.cuda.max_memory_allocated()
    print(f"mla width loss ({card_line()}): {MLA_WIDE_BATCH} x "
          f"{MLA_WIDE_SEQ} tokens, {json.dumps(terms)} in {dt_loss:.3f}s; "
          f"moe_forward (dropless) against moe_ref: max |difference| "
          f"{moe_diff!r}, aux {float(aux)!r} against {float(aux_ref)!r}, "
          f"within 2e-5 + 2e-5 relative: {moe_ok}", flush=True)
    check(all(math.isfinite(v) for v in terms.values())
          and {"nll", "mtp", "aux"} <= set(terms),
          f"mla width: the loss or a term of it is missing or not finite: "
          f"{terms}")
    check(moe_ok, f"mla width: moe_forward differs from moe_ref by "
                  f"{moe_diff} (aux {float(aux)} against {float(aux_ref)})")
    torch.cuda.reset_peak_memory_stats()
    rec = {"params": n_params, "init_s": t_init, "loss_s": dt_loss,
           "terms": terms, "moe_diff": moe_diff,
           "mla_decode_diff": decode_check(
               torch, "deepseek width", decode_steps(torch, model,
                                                     params))[0]}
    peaks["decode check"] = torch.cuda.max_memory_allocated()
    rec["peaks"] = peaks
    print(f"mla width ({card_line()}): peak device memory (bytes) of each "
          f"step {json.dumps(peaks)}", flush=True)
    del params
    torch.cuda.empty_cache()
    return rec


def extras_on(torch, cfg, rows, seq, seed):
    """cell_extras for ``rows`` rows of ``seq`` tokens, as tensors on the
    card."""
    import numpy as np
    x = cell_extras(cfg, {"tokens": np.zeros((rows, seq), np.int32)}, seed)
    return {k: torch.from_numpy(v).to(torch.device("cuda"))
            for k, v in x.items()}


def key_paths(tree, at=""):
    """The tree with each leaf replaced by its path of keys ("/a/b")."""
    if isinstance(tree, dict):
        return {k: key_paths(v, f"{at}/{k}") for k, v in tree.items()}
    return at


def vlm_width_check(torch):
    """Phase 11, qwen2-vl-72b at its published widths cut to VLM_LAYERS
    layers, one model (no panel: see VLM_LAYERS), attn_block VLM_BLOCK: the
    weights drawn on the card from seed 0 (VLM_PARAMS of them); the loss
    and its gradient at batch 1 x (VLM_PREFIX seeded patch rows +
    VLM_TOKENS tokens), finite, with the flash kernels launched exactly
    once forward and once backward a layer (hd 128, 64 query heads on 8
    key heads, causal across the prefix); the same loss and gradient on the
    dense route (attn_block 0): the loss within 1e-5 relative, every
    gradient leaf within VLM_GRAD_RTOL relative in l2 (the flash route's
    gradient held in host memory meanwhile). The teacher-forced decode with
    a VLM_PREFIX-row prefix against the prefill, in float64 on the dense
    route (float64_model) at REC64_ATOL + REC64_RTOL (decode_check); the
    flash route's float32 prefill and decode logits against that float64
    prefill at VLM32_ATOL + VLM32_RTOL, the float32 readings against the
    serving tolerance 2e-5 + 1e-5 printed beside; then the engine
    (arch_serve, every other request without its prefix). Returns (counts
    of the loss and gradient, counts of the engine, record)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves, tree_map
    dev = torch.device("cuda")
    cfg = get_config("qwen2-vl-72b")
    cfg = cfg.replace(num_layers=VLM_LAYERS, dist=dataclasses.replace(
        cfg.dist, attn_block=VLM_BLOCK))
    check(cfg.mm_prefix == VLM_PREFIX,
          f"vlm width: the config's prefix {cfg.mm_prefix} != {VLM_PREFIX}")
    model = build_model(cfg)
    dense = build_model(cfg.replace(dist=dataclasses.replace(
        cfg.dist, attn_block=0)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    leaves = tree_leaves(params)
    paths = tree_leaves(key_paths(params))
    n_params = sum(t.numel() for t in leaves)
    a = cfg.attn
    print(f"vlm width ({card_line()}): {cfg.name} d_model {cfg.d_model}, "
          f"{cfg.num_layers} of 80 layers, heads {a.num_heads} (kv "
          f"{a.num_kv_heads}) x {a.head_dim}, M-RoPE {a.mrope_sections} "
          f"theta {a.rope_theta}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
          f"padded to {cfg.padded_vocab}, untied head, patch prefix "
          f"{cfg.mm_prefix}, attn_block {cfg.dist.attn_block}: {n_params} "
          f"parameters, init {t_init:.2f}s", flush=True)
    check(n_params == VLM_PARAMS,
          f"vlm width: {n_params} parameters != {VLM_PARAMS}")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(1, VLM_TOKENS + 1)).astype(np.int32)).to(dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             **extras_on(torch, cfg, 1, VLM_TOKENS, (EXTRAS_SEED, 99))}
    for t in leaves:
        t.requires_grad_(True)
    reset_launch_counts()
    t0 = time.perf_counter()
    loss, _ = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    dt_grad = time.perf_counter() - t0
    counts = launch_counts()
    loss = float(loss.detach())
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads))
    peak_grad = torch.cuda.max_memory_allocated()
    # the flash route's gradient waits in host memory (17.0 GB) while the
    # dense route's is taken
    grads = [g.cpu() for g in grads]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loss_dense, _ = dense.loss_fn(params, batch)
    dense_grads = torch.autograd.grad(loss_dense, leaves)
    torch.cuda.synchronize()
    dt_dense = time.perf_counter() - t0
    loss_dense = float(loss_dense.detach())
    for t in leaves:
        t.requires_grad_(False)
    rel = {}
    for path, g, gd in zip(paths, grads, dense_grads):
        n = float(torch.linalg.vector_norm(gd))
        e = float(torch.linalg.vector_norm(g.to(dev).sub_(gd)))
        rel[path] = e / n if n > 0 else e
    del grads, dense_grads, batch, g, gd
    torch.cuda.empty_cache()
    worst = max(rel, key=rel.get)
    print(f"vlm width loss ({card_line()}): 1 x ({VLM_PREFIX} patch rows "
          f"+ {VLM_TOKENS} tokens): loss {loss!r} (dense route "
          f"{loss_dense!r}), gradient norm {gnorm!r}, finite {finite}, "
          f"{dt_grad:.3f}s for the loss and gradient ({dt_dense:.3f}s on the "
          f"dense route); peak device memory {peak_grad} bytes; kernels "
          f"{json.dumps(counts)}", flush=True)
    print(f"vlm width gradient ({card_line()}): the flash route's against "
          f"the dense route's, relative l2 a leaf: largest {rel[worst]!r} "
          f"({worst}; tolerance {VLM_GRAD_RTOL}); {json.dumps(rel)}",
          flush=True)
    check(math.isfinite(loss) and finite and math.isfinite(gnorm),
          f"vlm width: loss {loss} or its gradient is not finite")
    check(abs(loss - loss_dense) <= 1e-5 * abs(loss_dense),
          f"vlm width: the flash route's loss {loss} differs from the "
          f"dense route's {loss_dense}")
    check(rel[worst] <= VLM_GRAD_RTOL,
          f"vlm width: the flash route's gradient of {worst} differs from "
          f"the dense route's by {rel[worst]} relative")
    check(counts["flash_attention_fwd"] == VLM_LAYERS
          and counts["flash_attention_bwd"] == VLM_LAYERS,
          f"vlm width: flash launches {counts} are not one forward and one "
          f"backward a layer ({VLM_LAYERS})")
    torch.cuda.reset_peak_memory_stats()
    rec = {"params": n_params, "init_s": t_init, "loss": loss,
           "loss_dense": loss_dense, "grad_norm": gnorm,
           "grad_s": dt_grad, "peak_grad": peak_grad,
           "grad_rel_max": rel[worst]}
    # the decode logic (the prefix's offset, M-RoPE's broadcast positions,
    # the cache) against the prefill in float64 on the dense route
    # (float64_model), at REC64_ATOL + REC64_RTOL: in float32 at d_model
    # 8192 the decode's one-row products and the prefill's batched ones
    # round ~4e-5 apart, past the serving tolerance 2e-5 + 1e-5 relative.
    # The flash route (the engine's prefills) is held in float32 against
    # that float64 prefill at VLM32_ATOL + VLM32_RTOL
    extras = extras_on(torch, cfg, 2, 0, (EXTRAS_SEED, 98))
    steps32 = {}
    for label, m_ in (("dense", dense), ("flash", model)):
        steps32[label] = decode_steps(torch, m_, params, extras)
        rec[f"{label}_float32_diff"], rec[f"{label}_float32_share"] = \
            decode_share(torch, f"qwen2-vl width, {label} prefill, float32,"
                         f" printed", steps32[label], 2e-5, 1e-5,
                         "vlm decode")
    params64 = tree_map(lambda t: t.double(), params)
    x64 = {k: v.double() for k, v in extras.items()}
    with float64_model(torch, dense.cfg):
        steps = decode_steps(torch, dense, params64, x64)
    del params64, x64
    torch.cuda.empty_cache()
    check(all(t.dtype == torch.float64 for st in steps for t in st),
          f"vlm decode: logits {steps[0][0].dtype}, not float64")
    exact = [ref for _, ref in steps]
    for label in ("dense", "flash"):
        for i, what in ((1, "prefill"), (0, "decode")):
            pairs = [(st[i], e) for st, e in zip(steps32[label], exact)]
            d, sh = tol_share(torch, pairs, 2e-5, 1e-5)
            _, sh32 = tol_share(torch, pairs, VLM32_ATOL, VLM32_RTOL)
            rec[f"{label}_float32_{what}_vs_float64"] = [d, sh, sh32]
            print(f"vlm decode (qwen2-vl width, phase 11, {card_line()}): "
                  f"the float32 {label} route's {what} against the float64 "
                  f"dense prefill: max |logit difference| {d!r}, largest "
                  f"share of 2e-05 + 1e-05 relative {sh!r}, of {VLM32_ATOL}"
                  f" + {VLM32_RTOL} relative {sh32!r}", flush=True)
            if label == "flash":
                check(sh32 <= 1.0,
                      f"vlm decode: the flash route's float32 {what} is "
                      f"{d} from the float64 dense prefill, past "
                      f"{VLM32_ATOL} + {VLM32_RTOL} relative")
    rec["decode_diff"], rec["decode_share"] = decode_check(
        torch, "qwen2-vl width, dense prefill, float64", steps,
        atol=REC64_ATOL, rtol=REC64_RTOL, what="vlm decode")
    del steps, steps32, exact, extras
    rec["peak_decode"] = torch.cuda.max_memory_allocated()
    serve_counts, rec["serve"] = arch_serve(torch, "qwen2-vl width", model,
                                            params, mixed=True)
    del params, leaves
    torch.cuda.empty_cache()
    return counts, serve_counts, rec


def route_check(torch, name, model, params, extras):
    """Phase 11, an attn_block cell's merged model: the prefill of
    decode_steps' sequence (MLA_PROMPT + MLA_STEPS tokens, 2 rows, seed 7,
    with ``extras``) on the flash route against the same prefill on the
    dense route (attn_block 0): the logits and every cache's keys and
    values (an encoder's output reaches the cross ones) within 2e-5 + 1e-5
    relative. decode_check holds decode against the flash route's own
    prefill, where a wrong encoder kernel would show on both sides; this
    holds the flash kernels against the dense attention on the cell's
    path. Returns (the largest difference, its share)."""
    import dataclasses

    import numpy as np

    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves
    cfg = model.cfg
    dense = build_model(cfg.replace(dist=dataclasses.replace(
        cfg.dist, attn_block=0)))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(2, MLA_PROMPT + MLA_STEPS)).astype(
        np.int32)).to(torch.device("cuda"))
    batch = {"tokens": toks, **extras}
    with torch.no_grad():
        logits, caches = model.prefill(params, batch)
        d_logits, d_caches = dense.prefill(params, batch)
    paths = tree_leaves(key_paths(caches))
    pairs = [(logits, d_logits)] + [
        (c, dc) for p, c, dc in zip(paths, tree_leaves(caches),
                                    tree_leaves(d_caches))
        if p.rsplit("/", 1)[-1] in ("k", "v")]
    diff, share = tol_share(torch, pairs, 2e-5, 1e-5)
    print(f"route ({name}, phase 11, {card_line()}): the flash route's "
          f"prefill ({MLA_PROMPT + MLA_STEPS} tokens, {len(pairs) - 1} "
          f"key and value caches, {sorted(extras)}) against the dense "
          f"route's: max |difference| {diff!r}, largest share of 2e-05 + "
          f"1e-05 relative {share!r}", flush=True)
    check(share <= 1.0, f"route ({name}): the flash route's prefill differs "
                        f"from the dense route's by {diff}")
    return diff, share


def mixer_share(torch, name, model, params):
    """Phase 11, a recurrent cell's merged model: one agent's local step
    (the loss's forward and backward at the cell's batch and seq) with CUDA
    events around each recurrent mixer inside it: its forward from the
    call to its return, its backward from the gradient reaching its output
    to the gradient leaving its input. The events come from wrappers put
    into transformer._RECURRENT for these steps only. A mixer kind's time
    is the sum of its layers' spans, its share that over the step's time:
    medians of 3 steps after a warmup, beside the step's time without the
    events (time_ms). Returns {"step_ms": t, "step_ms_bare": t, kind:
    {"ms": t, "layers": n, "share": x}}."""
    import numpy as np

    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    cfg = model.cfg
    _, _, _, batch, seq, _, _ = ARCH_CELLS[name]
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(
        0, min(DATA_VOCAB, cfg.vocab_size), size=(batch, seq + 1)).astype(
        np.int32)).to(dev)
    b = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    leaves, skel = tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    tree = tree_unflatten(skel, leaves)

    def step():
        torch.autograd.grad(model.loss_fn(tree, b)[0], leaves)

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    class Mark(torch.autograd.Function):
        """The identity; its backward records an event as span[at]."""

        @staticmethod
        def forward(ctx, x, span, at):
            ctx.span, ctx.at = span, at
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            ctx.span[ctx.at] = event()
            return g, None, None

    spans = []

    def timed(kind, fwd):
        def run(p, h, **kw):
            span = {"kind": kind}
            spans.append(span)
            h = Mark.apply(h, span, "bwd_end")
            span["fwd_start"] = event()
            y, state = fwd(p, h, **kw)
            span["fwd_end"] = event()
            return Mark.apply(y, span, "bwd_start"), state
        return run

    bare = time_ms(torch, step, reps=3, warmup=1)
    layers = {}
    for ls in cfg.layer_specs():
        if ls.mixer in tfm._RECURRENT:
            layers[ls.mixer] = layers.get(ls.mixer, 0) + 1
    step_ms, ms = [], {k: [] for k in layers}
    saved = dict(tfm._RECURRENT)
    try:
        tfm._RECURRENT.update({k: timed(k, f) for k, f in saved.items()})
        for rep in range(4):
            spans.clear()
            start = event()
            step()
            end = event()
            end.synchronize()
            check(sorted(s_["kind"] for s_ in spans)
                  == sorted(k for k, n in layers.items() for _ in range(n))
                  and all(len(s_) == 5 for s_ in spans),
                  f"mixer share ({name}): a step's mixer spans "
                  f"{[sorted(s_) for s_ in spans]} are not one forward and "
                  f"one backward a recurrent layer {layers}")
            if rep == 0:
                continue
            step_ms.append(start.elapsed_time(end))
            for k in layers:
                ms[k].append(sum(
                    s_["fwd_start"].elapsed_time(s_["fwd_end"])
                    + s_["bwd_start"].elapsed_time(s_["bwd_end"])
                    for s_ in spans if s_["kind"] == k))
    finally:
        tfm._RECURRENT.update(saved)
    rec_ = {"step_ms": statistics.median(step_ms), "step_ms_bare": bare}
    for k, n in layers.items():
        rec_[k] = {"ms": statistics.median(ms[k]), "layers": n,
                   "share": statistics.median(
                       t / st for t, st in zip(ms[k], step_ms))}
    del leaves, tree
    print(f"mixer share ({name}, phase 11, {card_line()}): one agent's "
          f"local step (loss forward and backward, batch {batch}, seq "
          f"{seq}) {rec_['step_ms']:.3f} ms with the mixers' events, "
          f"{bare:.3f} ms without; inside it "
          + "; ".join(f"{k} (forward and backward, {v['layers']} layers) "
                      f"{v['ms']:.3f} ms = {100 * v['share']:.1f}% of the "
                      f"step" for k, v in rec_.items()
                      if k not in ("step_ms", "step_ms_bare")),
          flush=True)
    torch.cuda.empty_cache()
    return rec_


def recurrent_depth_check(torch, arch):
    """Phase 11, a recurrent decoder at its published depth and widths
    (recurrentgemma-2b: 26 layers, 8 (RG-LRU, RG-LRU, local attention)
    periods and the 2-layer RG-LRU tail; xlstm-1.3b: 48 layers, 6 periods of
    7 mLSTM and 1 sLSTM), one model, no panel and no gradient: the weights
    drawn on the card from seed 0, the training loss at REC_DEPTH_BATCH
    rows of REC_DEPTH_SEQ tokens finite, then decode_check (the one-step
    decode of every layer's state against the prefill's scan and chunk
    loop). A stack with attention is checked in float32 (its flash kernels
    take no float64) at REC_ATOL + REC_RTOL relative. A stack without it
    is checked in float64 (float64_model) at REC64_ATOL + REC64_RTOL: the
    same decode against the same prefill with float32's rounding taken
    out, which at xlstm-1.3b's 48 layers puts the float32 logits
    themselves farther than REC_ATOL + REC_RTOL from exact arithmetic; its
    float32 reading at that tolerance is printed beside. Returns a
    record."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_leaves, tree_map
    dev = torch.device("cuda")
    cfg = get_config(arch)
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    segs = [(seg.name, seg.n_rep, [ls.mixer for ls in seg.specs])
            for seg in tfm.build_segments(cfg)]
    print(f"recurrent depth ({card_line()}): {cfg.name} d_model "
          f"{cfg.d_model}, {cfg.num_layers} layers {segs}, vocab "
          f"{cfg.vocab_size}: {n_params} parameters, init {t_init:.2f}s",
          flush=True)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(REC_DEPTH_BATCH, REC_DEPTH_SEQ + 1)).astype(
        np.int32)).to(dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(params, {"tokens": toks[:, :-1],
                                         "targets": toks[:, 1:]})
        loss = float(loss)
        dt_loss = time.perf_counter() - t0
    check(math.isfinite(loss),
          f"recurrent depth ({arch}): the loss {loss} is not finite")
    t0 = time.perf_counter()
    what = "recurrent decode"
    rec_ = {}
    attention = any(ls.mixer not in tfm._RECURRENT
                    for ls in cfg.layer_specs())
    if not attention:
        steps32 = decode_steps(torch, model, params)
        rec_["float32_diff"], rec_["float32_share"] = decode_share(
            torch, f"{arch} full depth, printed", steps32, REC_ATOL,
            REC_RTOL, what)
        params = tree_map(lambda t: t.double(), params)
        torch.cuda.empty_cache()
    with (contextlib.nullcontext() if attention
          else float64_model(torch, cfg)):
        steps = decode_steps(torch, model, params)
    dtype = torch.float32 if attention else torch.float64
    check(all(t.dtype == dtype for st in steps for t in st),
          f"recurrent decode ({arch}): logits {steps[0][0].dtype}, not "
          f"{dtype}")
    if not attention:
        d, sh = tol_share(torch, [(a[1], b[1]) for a, b in
                                  zip(steps32, steps)], REC_ATOL, REC_RTOL)
        rec_["float32_prefill_diff"], rec_["float32_prefill_share"] = d, sh
        print(f"{what} ({arch} full depth, phase 11, {card_line()}): the "
              f"float32 prefill against the float64 one: max |logit "
              f"difference| {d!r}, largest share of {REC_ATOL} + {REC_RTOL} "
              f"relative {sh!r}", flush=True)
        del steps32
    atol, rtol = ((REC_ATOL, REC_RTOL) if attention
                  else (REC64_ATOL, REC64_RTOL))
    rec_["decode_diff"], rec_["decode_share"] = decode_check(
        torch, f"{arch} full depth", steps, atol=atol, rtol=rtol, what=what)
    del steps
    dt_decode = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"recurrent depth ({arch}, {card_line()}): loss {loss!r} at "
          f"{REC_DEPTH_BATCH} x {REC_DEPTH_SEQ} tokens in {dt_loss:.3f}s; "
          f"the decode check {dt_decode:.3f}s; peak device memory {peak} "
          f"bytes", flush=True)
    del params
    torch.cuda.empty_cache()
    rec_.update(params=n_params, loss=loss, loss_s=dt_loss,
                decode_s=dt_decode, peak=peak, init_s=t_init,
                decode_dtype=str(dtype))
    return rec_


def arch_phase(torch):
    """Phase 11: every cell of ARCH_CELLS (drive_arch), the served ones
    through the engine (arch_serve; the recurrent ones then timed by
    mixer_share; the vlm's and the encoder-decoder's then held by
    decode_check with their prefix or frames), the MLA cell's teacher-forced
    decode (decode_check), qwen2-vl-72b at its published widths
    (vlm_width_check), deepseek-v3 at its published widths
    (mla_width_check), then the recurrent decoders at their published
    depth (recurrent_depth_check). Returns ({cell: counts}, {cell:
    record})."""
    counts, records = {}, {}
    for name in ARCH_CELLS:
        t0 = time.perf_counter()
        counts[name], records[name], merged, model = drive_arch(torch, name)
        if name in ARCH_SERVED:
            c, records[name]["serve"] = arch_serve(torch, name, model,
                                                   merged)
            counts[f"serve {name}"] = c
            if model.cfg.recurrent is not None:
                records[name]["mixers"] = mixer_share(torch, name, model,
                                                      merged)
            cfg = model.cfg
            if cfg.mm_prefix > 0 or cfg.encoder_layers:
                # the prefix's offset, the encoder's cross keys and values
                extras = extras_on(torch, cfg, 2, ARCH_SERVE_PROMPT // 2,
                                   (EXTRAS_SEED, 97))
                records[name]["decode_diff"] = decode_check(
                    torch, name, decode_steps(torch, model, merged, extras),
                    what="decode")[0]
                if cfg.dist.attn_block:
                    records[name]["route_diff"] = route_check(
                        torch, name, model, merged, extras)[0]
                del extras
        elif merged is not None:
            records[name]["mla_decode_diff"] = decode_check(
                torch, name, decode_steps(torch, model, merged))[0]
        del merged, model
        torch.cuda.empty_cache()
        print(f"time: phase 11 cell {name} {time.perf_counter() - t0:.1f}s",
              flush=True)
    t0 = time.perf_counter()
    (counts["qwen2vl width"], counts["serve qwen2vl width"],
     records["qwen2vl width"]) = vlm_width_check(torch)
    print(f"time: phase 11 qwen2-vl width {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    records["deepseek width"] = mla_width_check(torch)
    print(f"time: phase 11 deepseek width {time.perf_counter() - t0:.1f}s",
          flush=True)
    for arch in REC_DEPTH:
        t0 = time.perf_counter()
        records[f"{arch} depth"] = recurrent_depth_check(torch, arch)
        print(f"time: phase 11 {arch} depth "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    return counts, records


# phase 12f: one agent's local step split over its agent block (the
# param_shardings route, models/tensor_parallel.py). SPLIT_CELLS: label ->
# (mesh, agents); "olmo" is the main path's cell (full width, 2 layers,
# batch 4 x 512) on (1, 1, 2, 2): 4 ranks on the card, each agent's batch
# over 2 fsdp ranks and its heads, d_ff and vocabulary over 2 model ranks;
# "gemma" is gemma-2b reduced(d_model=512) (8 heads of 32 on one kv head)
# with attn_block 512 on (1, 1, 1, 2): the flash kernels on each rank's 4
# heads, the kv head whole. SPLIT_ROUNDS rounds (two before the merge: at
# m 4 a gossip round and an idle one, whose Xi launches the reduce), each
# cell against the same cell on one process on the replica route;
# SPLIT_RTOL the CPU tests' (tests/test_torch_tensor_parallel.py).
SPLIT_CELLS = {"olmo": ((1, 1, 2, 2), 4), "gemma": ((1, 1, 1, 2), 4)}
SPLIT_ROUNDS = 3
SPLIT_RTOL = {"losses": 5e-6, "grad_norms": 5e-5, "xis": 1e-6,
              "merged": 5e-5, "local": 5e-5}
# one local step's gradients leaf by leaf (relative l2); the first round
# and Xi every round at SPLIT_RTOL. Later rounds and the evals: at full
# width one process's own run moves past SPLIT_RTOL when its init moves
# one ulp (AdamW amplifies float32 differences: the nudged run printed
# beside), so they are held within SPLIT_SAME, the same trajectory
SPLIT_GRAD_RTOL = 1e-5
SPLIT_SAME = 1e-2
SPLIT_KERNELS = {"olmo": ("gossip_mix", "panel_mean_consensus"),
                 "gemma": ("gossip_mix", "panel_mean_consensus",
                           "flash_attention_fwd", "flash_attention_bwd")}


def split_config(label):
    """Phase 12f's model config of a cell of SPLIT_CELLS."""
    import dataclasses

    from repro_torch.configs import get_config
    if label == "olmo":
        return get_config("olmo-1b").replace(num_layers=2)
    cfg = get_config("gemma-2b").reduced(d_model=512)
    return cfg.replace(dist=dataclasses.replace(cfg.dist,
                                                attn_block=ATTN_BLOCK))


def split_run(torch, label, mesh=None, nudge=False):
    """Phase 12f's cell ``label`` for SPLIT_ROUNDS rounds from the seeded
    init: on ``mesh`` on the split route, else on one process on the
    replica route (``nudge``: its float32 init moved one ulp up, every
    element: the trajectory's float32 conditioning). Returns the per-round
    losses, Xi, grad norms and seconds, the evals, launch counts, the
    rank's peak, Mesh.stats and whether every agent's row is the same
    after the merge; on a mesh also ``grad_err`` (split_grad_check of the
    final state, after the peak and the collectives are read)."""
    from repro_torch.core import dsgd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import eval_local, eval_merged, to_device
    from repro_torch.models import build_model
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.optim import make_optimizer
    cfg = split_config(label)
    m = SPLIT_CELLS[label][1]
    dev = mesh.device if mesh is not None else torch.device("cuda")
    model = build_model(cfg)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=SPLIT_ROUNDS * H)
    per_round, eval_batch = segment_inputs(
        cfg, m, SPLIT_ROUNDS, data_vocab=min(DATA_VOCAB, cfg.vocab_size))
    eval_batch = to_device(eval_batch, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, spec = dsgd.init_panel_state(model.init_params, opt, m, gen,
                                        device=dev, mesh=mesh)
    if nudge:
        x = state["panel"]["float32"]
        x.copy_(torch.nextafter(x, torch.full_like(x, math.inf)))
        del x
    shardings = (None if mesh is None
                 else tp.train_shardings(model, mesh, m))
    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec,
                                  param_shardings=shardings)
    rec = {"losses": [], "xis": [], "grad_norms": [], "times": []}
    if mesh is not None:
        mesh.stats.update(dict.fromkeys(mesh.stats, 0))
        rec.update(rank=mesh.rank, coord=mesh.coord,
                   transport=mesh.transport, split=tp.describe(
                       tp.leaf_plan(cfg, tp.Split(mesh), shardings)))
    reset_launch_counts()
    for W, b, glob, _ in per_round:
        t0 = time.perf_counter()
        state, mets = seg(state, b, W, None, global_rounds=glob)
        torch.cuda.synchronize(dev)
        rec["times"].append(time.perf_counter() - t0)
        rec["losses"].append(float(mets["loss"][0]))
        rec["xis"].append(float(mets["consensus"][0]))
        rec["grad_norms"].append(float(mets["grad_norm"][0]))
    rec["counts"] = launch_counts()
    rec["merged"] = eval_merged(model.loss_fn, state["panel"], spec,
                                eval_batch)
    rec["local"] = eval_local(model.loss_fn, state["panel"], spec,
                              eval_batch)
    # a rank holds every agent's rows of its columns: its rows identical
    # are every row identical
    rec["rows_identical"] = rows_identical(torch, state["panel"])
    del seg
    rec["peak"] = torch.cuda.max_memory_allocated(dev)
    if mesh is not None:
        rec["comm"] = dict(mesh.stats)
        first = {k: v[0, 0] for k, v in per_round[0][1].items()}
        rec["grad_err"] = split_grad_check(torch, model, state, spec,
                                           shardings, first)
    del state
    return rec


def split_grad_check(torch, model, state, spec, shardings, batch):
    """One local step's gradient panel of the rank's agents at ``state`` on
    the split route against the replica route's (the rank's columns of one
    process's, bit for bit: 12b) on ``batch``: the largest relative l2
    error of a leaf's part in the rank's columns, over its agents."""
    from repro_torch.core import dsgd
    batch = {k: torch.as_tensor(v).to(spec.mesh.device)
             for k, v in batch.items()}
    loss_fn, split = dsgd.split_route(model.loss_fn, spec, shardings)
    got, _ = dsgd.panel_grads(loss_fn, state["panel"], spec, batch,
                              split=split)
    want, _ = dsgd.panel_grads(model.loss_fn, state["panel"], spec, batch)
    worst = 0.0
    for ls in spec.leaves:
        c0, c1 = spec.col_range(ls.group)
        lo, hi = max(ls.offset, c0), min(ls.offset + ls.size, c1)
        for r in range(got[ls.group].shape[0]):
            err = ref = 0.0
            # float64 sums a 2^22-column slab at a time (no (rows, D)
            # float64 temporary beside the ranks' states)
            for a in range(lo - c0, hi - c0, 1 << 22):
                b = min(a + (1 << 22), hi - c0)
                x = want[ls.group][r, a:b].double()
                err += float(torch.sum(torch.square(
                    got[ls.group][r, a:b].double() - x)))
                ref += float(torch.sum(torch.square(x)))
            if hi > lo:
                worst = max(worst, math.sqrt(err / max(ref, 1e-60)))
    return worst


def split_child(kind):
    """One rank of phase 12f (``split_<label>``), on the mesh of its cell
    (torch.distributed from the environment _run_ranks sets); prints one
    ``SHARD {json}`` line."""
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.launch import mesh as mesh_mod
    label = kind[len("split_"):]
    mesh = mesh_mod.make_mesh(SPLIT_CELLS[label][0])
    rec = split_run(torch, label, mesh)
    print("SHARD " + json.dumps(rec), flush=True)
    dist.destroy_process_group()


def split_phase(torch, reckoned):
    """Phase 12f: each cell of SPLIT_CELLS on its mesh (ranks sharing the
    card over CUDA IPC) on the split route, against the same cell on one
    process on the replica route, run first here, and again from its init
    moved one ulp up (the trajectory's float32 conditioning, printed).
    Gates: one local step's gradients on every rank within
    SPLIT_GRAD_RTOL of the replica route's, leaf by leaf; the first
    round's loss and grad norm and every round's Xi within SPLIT_RTOL of
    one process's, every round and the evals within SPLIT_SAME; Xi 0.0
    after the merge, every row the same, merged == local; the
    cell's kernels (SPLIT_KERNELS) launched on every rank; the olmo cell's
    peak a rank within DRY_PEAK_SHARE of ``reckoned`` (12e's reckon of it)
    and its collective calls and bytes equal to the reckoned."""
    import tempfile

    import numpy as np
    tmp = tempfile.mkdtemp(prefix="chip_smoke_split_")
    counts, out = {}, {}
    keys = ("losses", "grad_norms", "xis", "merged", "local")

    def dev(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))

    for label, (shape, m) in SPLIT_CELLS.items():
        t0 = time.perf_counter()
        one = split_run(torch, label)
        torch.cuda.empty_cache()
        ulp = split_run(torch, label, nudge=True)
        cond = {k: dev(ulp[k], one[k]) for k in keys}
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        recs = _run_ranks(f"split_{label}", int(np.prod(shape)), tmp)
        wall = time.perf_counter() - t1
        r0 = recs[0]
        gaps = {k: dev(r0[k], one[k]) for k in keys}
        print(f"split (phase 12f {label}, {card_line()}): one process's "
              f"run against its init one ulp up (relative, the largest "
              f"over the rounds): {cond}; rank 0's split run against one "
              f"process's: {gaps}; one step's gradients a rank (relative "
              f"l2, the worst leaf) {[r['grad_err'] for r in recs]}",
              flush=True)
        print(f"split (phase 12f {label}, {card_line()}): mesh {shape}, m "
              f"{m}, over {r0['transport']}; rounds (s) a rank "
              f"{[max(r['times'][t] for r in recs) for t in range(SPLIT_ROUNDS)]}"
              f" against one process's {one['times']} ({t1 - t0:.1f}s for "
              f"its two runs; the ranks {wall:.1f}s); peak a rank "
              f"{[r['peak'] for r in recs]} against {one['peak']}; "
              f"collectives a rank {[r['comm'] for r in recs]}; losses "
              f"{r0['losses']} against {one['losses']}; grad norms "
              f"{r0['grad_norms']} against {one['grad_norms']}; Xi "
              f"{r0['xis']} against {one['xis']}; evals {r0['merged']!r} "
              f"{r0['local']!r} against {one['merged']!r} {one['local']!r}; "
              f"split {r0['split']['split']}, whole {r0['split']['whole']},"
              f" summed {r0['split']['summed']}", flush=True)
        for r in recs:
            check(r["transport"] == "cuda ipc",
                  f"phase 12f {label}: rank {r['rank']} over "
                  f"{r['transport']}")
            for key, first in (("losses", 1), ("grad_norms", 1),
                               ("xis", SPLIT_ROUNDS)):
                gap = dev(r[key][:first], one[key][:first])
                check(gap <= SPLIT_RTOL[key],
                      f"phase 12f {label}: rank {r['rank']}'s {key} "
                      f"{r[key][:first]} against one process's "
                      f"{one[key][:first]}: {gap}, over {SPLIT_RTOL[key]}")
            for key in keys:
                gap = dev(r[key], one[key])
                check(gap <= SPLIT_SAME,
                      f"phase 12f {label}: rank {r['rank']}'s {key} "
                      f"{r[key]} against one process's {one[key]}: {gap}, "
                      f"over {SPLIT_SAME}")
            check(r["grad_err"] <= SPLIT_GRAD_RTOL,
                  f"phase 12f {label}: rank {r['rank']}'s gradients "
                  f"{r['grad_err']} from the replica route's")
            check(r["xis"][-1] == 0.0 and r["rows_identical"]
                  and abs(r["local"] - r["merged"])
                  <= 1e-6 * abs(r["merged"]),
                  f"phase 12f {label}: rank {r['rank']} after the merge: "
                  f"Xi {r['xis'][-1]}, rows identical {r['rows_identical']}"
                  f", evals {r['merged']} {r['local']}")
            for k in SPLIT_KERNELS[label]:
                check(r["counts"][k] > 0,
                      f"phase 12f {label}: rank {r['rank']} launched "
                      f"{k} {r['counts'][k]} times")
        if label == "olmo":
            peaks = [r["peak"] for r in recs]
            gaps = [(reckoned["peak"] - p) / p for p in peaks]
            calls = reckoned["run"]["calls"]
            nbytes = reckoned["run"]["bytes"]
            comm = [(int(r["comm"]["calls"]), int(r["comm"]["bytes"]))
                    for r in recs]
            print(f"split (phase 12f {label}, reckoned on the host; "
                  f"{card_line()}): peak a rank {reckoned['peak']} B "
                  f"against the measured {peaks} "
                  f"({[round(g, 4) for g in gaps]}); collectives {calls} "
                  f"calls, {nbytes} B against Mesh.stats {comm}; FLOPs a "
                  f"rank {reckoned['flops']}", flush=True)
            check(all(abs(g) <= DRY_PEAK_SHARE for g in gaps),
                  f"phase 12f: peak {reckoned['peak']} against {peaks}")
            check(all(c == (calls, nbytes) for c in comm),
                  f"phase 12f: collectives ({calls}, {nbytes}) against "
                  f"{comm}")
        counts[label] = {k: sum(r["counts"][k] for r in recs)
                         for k in recs[0]["counts"]}
        out[label] = {"recs": recs, "one": one, "wall": wall}
        torch.cuda.empty_cache()
    total = {k: sum(c[k] for c in counts.values()) for k in counts["olmo"]}
    return total, out


# phase 12g: the serve shapes split over the serve mesh (ROADMAP A16d's
# first item; models/tensor_parallel.py's serve route, the reference's
# build_serve layout: weights and caches as param_spec / cache_spec resolve
# under serve_rules, the batch's rows over the data line), ranks sharing
# the card over CUDA IPC. SERVE_CELLS: label -> (arch, serve mesh (pod,
# agent, fsdp = data, model), layers (None: all), param_dtype, attn_block,
# rows, prompt tokens, decode steps): (i) "olmo" olmo-1b at full width and
# depth in bfloat16 on (data 2, model 2): 2 rows a data rank; (iii)
# "gemma_sw" gemma-2b-sw at full width and depth in bfloat16 on (model 2):
# the flash bfloat16 forward at hd 256 on each rank's 4 heads, the one kv
# head whole, a prompt past the 4096 window and decode steps through the
# ring. Each rank draws the whole weights on the card from
# SERVE_CELL_SEED, cuts its pieces and frees the rest before its peak is
# read. Every step's logits (prefill, then the decode steps fed seeded
# tokens) against one process's on the same weights and both against a
# float32 forward of those bfloat16 weights: the split's relative l2 gap
# at most SERVE_FACTOR times one process's (the model line sums two
# bfloat16 partial products where one process rounds one sum), and the
# split's gap to one process at most SERVE_DIRECT times one process's gap
# to the float32 forward. A control (cell (i)): SERVE_FAULT_STEPS decode
# steps from the same prefill with a fault planted on model rank 1
# (SERVE_FAULTS: "partial", layer 0's MLP partial sum counted twice;
# "cache", layer 0's cached k and v blocks rolled by one kv head); the
# gates must reject both. Measured (H100, 700 W): sound, the largest
# ratios 1.09 and 1.065, the split's gap to one process at most 1.107 and
# 1.128 times one process's; the planted faults 27.3 ("partial") and 50.7
# ("cache") on both gates
SERVE_CELLS = {"olmo": ("olmo-1b", (1, 1, 2, 2), None, "bfloat16", 512, 4,
                        4096, 64),
               "gemma_sw": ("gemma-2b-sw", (1, 1, 1, 2), None, "bfloat16",
                            512, 1, 5120, 16)}
SERVE_CELL_SEED = 21
SERVE_FACTOR = 1.3
SERVE_DIRECT = 1.3
SERVE_FAULT_STEPS = 4
SERVE_FAULTS = ("partial", "cache")
# (ii) the engine in float32: phase 9's merged model (olmo-1b, 2 layers)
# on (data 1, model 2) serves phase 9's requests (SERVE_C slots, dense
# prefill); every request's tokens equal one process's engine's, and a
# probe (SERVE_PROBE_REQS requests, prefill and SERVE_PROBE decode steps
# fed one process's tokens) within the serving tolerance
SERVE_ENGINE_MESH = (1, 1, 1, 2)
SERVE_PROBE_REQS = 2
SERVE_ATOL, SERVE_RTOL = 2e-5, 1e-5


def serve_cell(label):
    """The cell ``label`` of SERVE_CELLS (phase 12g) or SERVE_H_CELLS
    (phase 12h)."""
    return SERVE_CELLS[label] if label in SERVE_CELLS else SERVE_H_CELLS[
        label]


def serve_cell_config(label):
    """Phase 12g's or 12h's model config of a serve cell (arctic's banks
    cut to phase 11's ARCH_CELLS experts)."""
    import dataclasses

    from repro_torch.configs import get_config
    arch, _, layers, dtype, block = serve_cell(label)[:5]
    cfg = get_config(arch).replace(param_dtype=dtype)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, num_experts=ARCH_CELLS["arctic"][6]))
    return cfg.replace(dist=dataclasses.replace(cfg.dist, attn_block=block))


def plant_fault(torch, name, mesh, caches):
    """Phase 12g's control: fault ``name`` of SERVE_FAULTS planted on model
    rank 1 of a split model on ``mesh`` ("partial": a Split whose second
    ``reduce_out`` of each forward, layer 0's MLP, sums this rank's
    partial twice; "cache": layer 0's cached k and v blocks rolled by one
    kv head, in place). Returns (the Split, a function to call before
    each decode step)."""
    from repro_torch.models import tensor_parallel as tp
    calls = [0]

    class Planted(tp.Split):
        def reduce_out(self, y):
            calls[0] += 1
            if name == "partial" and calls[0] == 2 and self.model_rank == 1:
                y = 2 * y
            return super().reduce_out(y)

    split = Planted(mesh)
    if name == "cache" and split.model_rank == 1:
        mixer = next(iter(caches.values()))["p0"]["mixer"]
        for k in ("k", "v"):
            mixer[k][0].copy_(torch.roll(mixer[k][0], 1, dims=2))

    def step():
        calls[0] = 0
    return split, step


def serve_cell_run(torch, label, mesh=None, float32=False, faults=()):
    """Serve cell ``label`` (serve_cell): the whole weights drawn on the
    card from SERVE_CELL_SEED; on ``mesh`` the rank's pieces cut from them
    (the rest freed), its data rows, the split model; else one process's
    whole model (``float32``: those bfloat16 weights widened, a float32
    forward). A prefill of the seeded prompts (after a seeded patch prefix
    where the model takes one, cell_extras), then the decode steps fed
    seeded tokens, each row at its own position; then, for each fault of
    ``faults`` (on ``mesh``), SERVE_FAULT_STEPS decode steps from the
    prefill's caches (kept on the host) with it planted (plant_fault).
    Returns {"logits" (steps + 1, rows, V) float32 on the host, "faults"
    {name: (SERVE_FAULT_STEPS, rows, V)}, "rows", "peak" (after the pieces
    are cut, before the faults), "counts", "comm", "prefill_s",
    "decode_s"}."""
    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.utils.tree import tree_map
    _, _, _, _, _, B, prompt, steps = serve_cell(label)
    cfg = serve_cell_config(label)
    dev = mesh.device if mesh is not None else torch.device("cuda")
    whole = build_model(cfg)

    def draw():
        return whole.init_params(
            torch.Generator(device=dev).manual_seed(SERVE_CELL_SEED), dev)
    rng = np.random.default_rng(SERVE_CELL_SEED)
    tokens = rng.integers(0, cfg.vocab_size, (B, prompt)).astype(np.int32)
    fed = rng.integers(0, cfg.vocab_size, (steps, B, 1)).astype(np.int32)
    extras = cell_extras(cfg, {"tokens": tokens}, SERVE_CELL_SEED)
    P = max(0, cfg.mm_prefix)  # the positions before the prompt's
    rows = slice(0, B)
    if mesh is not None:
        import torch.distributed as dist
        split = tp.Split(mesh)
        model = build_model(cfg, split=split)
        # the ranks sharing the card draw the whole weights one at a time,
        # each keeping its pieces (qwen2-vl's 8.5 GB and the draw's float32
        # transients, on four ranks at once, would not fit)
        for turn in range(dist.get_world_size()):
            if turn == mesh.rank:
                params = tp.serve_pieces(draw(), mesh,
                                         tp.serve_shardings(whole, mesh))
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
            dist.barrier()
        rows = split.data_rows(B)
    elif float32:
        model = build_model(cfg.replace(param_dtype="float32"))
        params = tree_map(lambda x: x.float(), draw())
    else:
        model = whole
        params = draw()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    if mesh is not None:
        mesh.stats.update(dict.fromkeys(mesh.stats, 0))
    logits = []
    # the prefix in the cell's dtype (the float32 forward widens it)
    batch = {k: torch.from_numpy(v[rows]).to(dev, getattr(
        torch, cfg.param_dtype)) for k, v in extras.items()}
    batch["tokens"] = torch.from_numpy(tokens[rows]).to(dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        lg, caches = model.prefill(params, batch, max_len=P + prompt + steps)
        logits.append(lg.float().cpu())
        t1 = time.perf_counter()
        kept = tree_map(lambda x: x.cpu(), caches) if faults else None
        t1d = time.perf_counter()

        def decode(caches, n, before=lambda: None):
            out = []
            for i in range(n):
                pos = torch.full((rows.stop - rows.start,), P + prompt + i,
                                 dtype=torch.int32, device=dev)
                before()
                lg, caches = model.decode_step(
                    params, caches, torch.from_numpy(fed[i][rows]).to(dev),
                    pos)
                out.append(lg.float().cpu())
            return out, caches

        got, caches = decode(caches, steps)
        logits += got
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        rec = {"logits": torch.stack(logits), "rows": [rows.start, rows.stop],
               "peak": torch.cuda.max_memory_allocated(dev),
               "counts": launch_counts(), "prefill_s": t1 - t0,
               "decode_s": t2 - t1d, "faults": {}}
        if mesh is not None:
            rec.update(comm=dict(mesh.stats), transport=mesh.transport,
                       rank=mesh.rank, coord=dict(mesh.coord))
        for name in faults:
            del caches
            caches = tree_map(lambda x: x.to(dev), kept)
            split, step = plant_fault(torch, name, mesh, caches)
            model = build_model(cfg, split=split)
            got, caches = decode(caches, SERVE_FAULT_STEPS, step)
            rec["faults"][name] = torch.stack(got)
    del params, caches, kept
    torch.cuda.empty_cache()
    return rec


def serve_engine_run(torch, merged, mesh=None, fed=None):
    """Phase 12g (ii): phase 9's merged olmo-1b (float32, 2 layers, dense
    prefill) served by the engine (SERVE_C slots, phase 9's requests), on
    ``mesh`` split (the rank's pieces), else on one process; then the probe:
    the first SERVE_PROBE_REQS requests' prefill and SERVE_PROBE decode
    steps fed ``fed`` (one process's served tokens; None: its own).
    Returns {"tokens": {rid: list}, "probe" (requests, steps + 1, V)
    float32 on the host, "seconds", "counts", "comm"}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.serving import ServingEngine
    from repro_torch.utils.tree import tree_map
    cfg = get_config("olmo-1b").replace(num_layers=2)
    dev = mesh.device if mesh is not None else torch.device("cuda")
    params = tree_map(lambda x: x.to(dev), merged)
    model = build_model(cfg)
    if mesh is not None:
        params = tp.serve_pieces(params, mesh,
                                 tp.serve_shardings(model, mesh))
        model = build_model(cfg, split=tp.Split(mesh))
        mesh.stats.update(dict.fromkeys(mesh.stats, 0))
    max_len = max(SERVE_PROMPTS) + SERVE_NEW
    reqs = serve_requests(cfg, SERVE_REQUESTS)
    reset_launch_counts()
    t0 = time.perf_counter()
    eng = ServingEngine(model, params, max_concurrency=SERVE_C,
                        max_len=max_len)
    out = eng.serve(reqs)
    torch.cuda.synchronize(dev)
    rec = {"tokens": {int(k): [int(t) for t in v] for k, v in out.items()},
           "seconds": time.perf_counter() - t0, "counts": launch_counts()}
    del eng
    fed = fed or rec["tokens"]
    probe = []
    with torch.no_grad():
        for r in reqs[:SERVE_PROBE_REQS]:
            lg, caches = model.prefill(
                params, {"tokens": torch.from_numpy(r.tokens[None]).to(dev)},
                max_len=max_len)
            got = [lg.cpu()]
            for i in range(SERVE_PROBE):
                tok = torch.tensor([[fed[r.rid][i]]], dtype=torch.int32,
                                   device=dev)
                lg, caches = model.decode_step(params, caches, tok,
                                               len(r.tokens) + i)
                got.append(lg.cpu())
            probe.append(torch.cat(got))
    rec["probe"] = torch.stack(probe)
    if mesh is not None:
        rec.update(comm=dict(mesh.stats), transport=mesh.transport,
                   rank=mesh.rank)
    del params
    torch.cuda.empty_cache()
    return rec


def serve_child(kind):
    """One rank of phase 12g (``serve_olmo``: cell (i) on its mesh;
    ``serve_pair``: (ii) and (iii) on (data 1, model 2)); its logits and
    probes go to files in SHARD_TMP, the rest in one ``SHARD {json}``
    line."""
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.launch import mesh as mesh_mod
    tmp = os.environ["SHARD_TMP"]
    labels = ["olmo"] if kind == "serve_olmo" else ["engine", "gemma_sw"]
    shape = SERVE_CELLS["olmo"][1] if kind == "serve_olmo" \
        else SERVE_ENGINE_MESH
    mesh = mesh_mod.make_mesh(shape)
    out = {}
    for label in labels:
        if label == "engine":
            merged = torch.load(os.path.join(tmp, "merged.pt"),
                                weights_only=True)
            fed = json.load(open(os.path.join(tmp, "fed.json")))
            rec = serve_engine_run(torch, merged, mesh,
                                   {int(k): v for k, v in fed.items()})
            torch.save(rec.pop("probe"), os.path.join(
                tmp, f"engine_probe_{mesh.rank}.pt"))
            del merged
        else:
            rec = serve_cell_run(torch, label, mesh, faults=(
                SERVE_FAULTS if label == "olmo" else ()))
            torch.save(rec.pop("logits"), os.path.join(
                tmp, f"{label}_logits_{mesh.rank}.pt"))
            torch.save(rec.pop("faults"), os.path.join(
                tmp, f"{label}_faults_{mesh.rank}.pt"))
        out[label] = rec
    print("SHARD " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def _rel_gap(torch, a, b):
    return float(torch.linalg.vector_norm((a.double() - b.double()))
                 / torch.linalg.vector_norm(b.double()))


def split_serve_phase(torch, merged, reckoned):
    """Phase 12g: (i) and (iii) of SERVE_CELLS and (ii) the engine, each
    split over ranks sharing the card (CUDA IPC) against one process run
    first here. Gates: (i), (iii) every step's logits finite, the model
    ranks of a data rank bit for bit, the split's relative l2 gap to the
    float32 forward at most SERVE_FACTOR times one process's, its gap to
    one process at most SERVE_DIRECT times one process's gap to the
    float32 forward, each of (i)'s planted faults failing one of the
    two; each rank's peak within DRY_PEAK_SHARE of launch/dryrun.py:reckon_serve's for its
    layout (``reckoned``: {label: the reckoning}, traced on the host in
    12e's child); the flash forward's bfloat16 entry launched once a
    layer; (ii)
    every request's tokens equal one process's engine's, the probe's
    logits within SERVE_ATOL + SERVE_RTOL. Returns ({label: launch counts
    summed over the ranks}, records)."""
    import shutil
    import tempfile

    from repro_torch.utils.tree import tree_map
    tmp = tempfile.mkdtemp(prefix=".serve_ckpt_12g_", dir=ROOT)
    counts, out = {}, {}
    try:
        for label in ("olmo", "gemma_sw"):
            t0 = time.perf_counter()
            one = serve_cell_run(torch, label)
            f32 = serve_cell_run(torch, label, float32=True)
            out[label] = {"one": {k: v for k, v in one.items()
                                  if k != "logits"},
                          "one_s": time.perf_counter() - t0,
                          "reckoned": reckoned[label]}
            out[label]["logits"] = (one["logits"], f32["logits"])
            del one, f32
            torch.cuda.empty_cache()
        fed_one = serve_engine_run(torch, merged)
        with open(os.path.join(tmp, "fed.json"), "w") as f:
            json.dump(fed_one["tokens"], f)
        torch.save(tree_map(lambda x: x.contiguous(), merged),
                   os.path.join(tmp, "merged.pt"))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        recs = {"olmo": _run_ranks("serve_olmo", 4, tmp)}
        pair = _run_ranks("serve_pair", 2, tmp)
        wall = time.perf_counter() - t0
        recs["engine"] = [r["engine"] for r in pair]
        recs["gemma_sw"] = [r["gemma_sw"] for r in pair]
        recs["olmo"] = [r["olmo"] for r in recs["olmo"]]
        for label in ("olmo", "gemma_sw"):
            _serve_cell_gates(torch, label, recs[label], out[label], tmp)
            counts[label] = {k: sum(r["counts"][k] for r in recs[label])
                             for k in recs[label][0]["counts"]}
        _serve_engine_gates(torch, fed_one, recs["engine"], tmp)
        counts["engine"] = {k: sum(r["counts"][k] for r in recs["engine"])
                            for k in recs["engine"][0]["counts"]}
        out["engine"] = {"one_s": fed_one["seconds"],
                         "split_s": [r["seconds"] for r in recs["engine"]]}
        out["wall"] = wall
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, out


def _serve_cell_gates(torch, label, recs, one, tmp):
    """Phase 12g (i) / (iii)'s and 12h (ii)'s gates (split_serve_phase,
    split_h_phase)."""
    arch, shape, _, _, _, B, prompt, steps = serve_cell(label)
    cfg = serve_cell_config(label)
    one_lg, f32_lg = one.pop("logits")
    got = torch.zeros_like(one_lg)
    by_rows = {}
    for r in recs:
        lg = torch.load(os.path.join(tmp, f"{label}_logits_{r['rank']}.pt"))
        lo, hi = r["rows"]
        check(bool(torch.isfinite(lg).all()),
              f"phase 12g {label}: rank {r['rank']}'s logits not finite")
        first = by_rows.setdefault((lo, hi), lg)
        check(torch.equal(first, lg),
              f"phase 12g {label}: the model ranks of rows {lo}-{hi} "
              f"disagree")
        got[:, lo:hi] = lg
        check(r["transport"] == "cuda ipc",
              f"phase 12g {label}: rank {r['rank']} over {r['transport']}")
    gaps = [(_rel_gap(torch, got[t], f32_lg[t]),
             _rel_gap(torch, one_lg[t], f32_lg[t]),
             _rel_gap(torch, got[t], one_lg[t])) for t in range(steps + 1)]
    ratio = max(s_ / o_ for s_, o_, _ in gaps)
    direct = max(d_ / o_ for _, o_, d_ in gaps)
    planted = {}
    for name in (SERVE_FAULTS if label == "olmo" else ()):
        bad = torch.zeros((SERVE_FAULT_STEPS,) + one_lg.shape[1:])
        for r in recs:
            lo, hi = r["rows"]
            bad[:, lo:hi] = torch.load(os.path.join(
                tmp, f"{label}_faults_{r['rank']}.pt"))[name]
        fg = [(_rel_gap(torch, bad[i], f32_lg[i + 1]), gaps[i + 1][1],
               _rel_gap(torch, bad[i], one_lg[i + 1]))
              for i in range(SERVE_FAULT_STEPS)]
        planted[name] = (max(s_ / o_ for s_, o_, _ in fg),
                         max(d_ / o_ for _, o_, d_ in fg))
    reck = one["reckoned"]
    peaks = [r["peak"] for r in recs]
    pgap = [(reck["peak"] - p) / p for p in peaks]
    flash = [r["counts"]["flash_attention_fwd_bf16"] for r in recs]
    print(f"serve split (phase {one.get('phase', '12g')} {label}, "
          f"{card_line()}): {arch}, "
          f"{cfg.num_layers} layers, {cfg.param_dtype}, attn_block "
          f"{cfg.dist.attn_block}, mesh {shape}, {B} rows x {prompt} prompt "
          f"tokens, {steps} decode steps; prefill s a rank "
          f"{[round(r['prefill_s'], 3) for r in recs]} (one process "
          f"{one['one']['prefill_s']:.3f}), decode s "
          f"{[round(r['decode_s'], 3) for r in recs]} (one process "
          f"{one['one']['decode_s']:.3f}); relative l2 gap to the float32 "
          f"forward, split / one process, prefill {gaps[0][0]:.4g} / "
          f"{gaps[0][1]:.4g}, the decode steps' largest "
          f"{max(g[0] for g in gaps[1:]):.4g} / "
          f"{max(g[1] for g in gaps[1:]):.4g}; the largest ratio {ratio:.4g}"
          f" (gate {SERVE_FACTOR}); split against one process at most "
          f"{max(g[2] for g in gaps):.4g}, at most {direct:.4g} times one "
          f"process's gap (gate {SERVE_DIRECT}); planted faults (the "
          f"largest ratio, the largest split against one process as a "
          f"share of one process's gap) "
          f"{ {k: [round(x, 4) for x in v] for k, v in planted.items()} }; "
          f"peak a rank {peaks} against the "
          f"reckoned {reck['peak']} ({[round(g, 4) for g in pgap]}; one "
          f"process {one['one']['peak']}); params {reck['param_bytes']} and "
          f"cache {reck['cache_bytes']} B a rank reckoned; collectives a "
          f"rank {[r['comm'] for r in recs]}; flash forward bf16 launches "
          f"a rank {flash}", flush=True)
    check(ratio <= SERVE_FACTOR,
          f"phase 12g {label}: the split's gap to the float32 forward "
          f"{[g[0] for g in gaps]} against one process's "
          f"{[g[1] for g in gaps]} (factor {SERVE_FACTOR})")
    check(direct <= SERVE_DIRECT,
          f"phase 12g {label}: the split's gap to one process "
          f"{[g[2] for g in gaps]} against one process's to the float32 "
          f"forward {[g[1] for g in gaps]} (factor {SERVE_DIRECT})")
    for name, (r_, d_) in planted.items():
        check(r_ > SERVE_FACTOR or d_ > SERVE_DIRECT,
              f"phase 12g {label}: the gates pass the planted fault {name}"
              f" ({r_}, {d_})")
    check(all(abs(g) <= DRY_PEAK_SHARE for g in pgap),
          f"phase 12g {label}: peak {reck['peak']} reckoned against "
          f"{peaks}")
    check(all(n == cfg.num_layers for n in flash),
          f"phase 12g {label}: flash forward bf16 launches {flash}, not "
          f"one a layer")
    one.update(gaps=gaps, ratio=ratio, direct=direct, planted=planted,
               peaks=peaks, peak_gaps=pgap, recs=recs)


def _serve_engine_gates(torch, one, recs, tmp):
    """Phase 12g (ii)'s gates (split_serve_phase)."""
    for r in recs:
        probe = torch.load(os.path.join(tmp, f"engine_probe_{r['rank']}.pt"))
        diff = float(torch.max(torch.abs(probe - one["probe"])))
        # (a rank's record came through JSON: its request ids are strings)
        same = [rid for rid, v in one["tokens"].items()
                if r["tokens"][str(rid)] == v]
        print(f"serve split (phase 12g engine, {card_line()}): rank "
              f"{r['rank']} over {r['transport']}: {len(same)} of "
              f"{len(one['tokens'])} requests' tokens equal one process's "
              f"engine's; probe max |logit difference| {diff!r}; "
              f"{r['seconds']:.3f}s (one process {one['seconds']:.3f}s); "
              f"collectives {r['comm']}", flush=True)
        check(len(same) == len(one["tokens"]),
              f"phase 12g engine: rank {r['rank']}'s tokens differ from "
              f"one process's")
        check(torch.allclose(probe, one["probe"], atol=SERVE_ATOL,
                             rtol=SERVE_RTOL),
              f"phase 12g engine: rank {r['rank']}'s probe logits "
              f"{diff} from one process's")


# phase 12h: the split route's MoE FFN and M-RoPE with the patch prefix
# (ROADMAP A16d item 2, first part: models/moe.py's split route,
# models/model.py's split loss and serve route with the prefix), ranks
# sharing the card over CUDA IPC. (i) SPLIT_H_CELLS: label -> (arch, mesh,
# layers, capacity factor, rows, tokens): one agent's loss and gradient on
# the split route at the published widths cut in depth (arctic-480b: 1
# layer and phase 11's 8 of its 128 experts, 2 a model rank, at capacity
# factor 1.0 so experts overflow; qwen2-vl-72b: VLM_LAYERS layers, a
# VLM_PREFIX-row seeded patch prefix before the tokens), float32 at
# attn_block ATTN_BLOCK (the flash kernels on each rank's heads), no panel
# (a panel of either does not fit the card): each rank draws the whole
# weights from SPLIT_H_SEED, cuts its pieces (tensor_parallel.train_pieces)
# and frees the rest; its gradients are summed as their rules say (a split
# or whole leaf over fsdp, a summed one over the block); then model rank 0
# redraws the whole weights and runs one process's loss and gradient on
# the same batch, and each leaf (a split one gathered over the model line)
# is held to it (relative l2) within SPLIT_GRAD_RTOL or SPLIT_H_FACTOR
# times the float32 yardstick, whichever is larger: one process's
# gradient on the flash route against its own on the dense attention
# route (step_yardstick, the worst leaf; the same numbers in exact
# arithmetic: at qwen2-vl's widths any float32 reordering moves a leaf
# ~1e-5, its rows differentiated one at a time and summed 6.2e-6-8.5e-6,
# the dense route 4.8e-6-6.9e-6, over olmo's 3.3e-6 that set
# SPLIT_GRAD_RTOL); the loss and the aux within SPLIT_RTOL["losses"],
# arctic's dropped assignments counted and equal (and some dropped).
# SPLIT_H_SEG: the split segment of both at reduced() on SPLIT_H_SEG_MESH,
# m SPLIT_H_M, SPLIT_H_ROUNDS rounds (a gossip round and the merge): Xi
# 0.0, every row the same, merged == local, the mix and the reduce
# launched on every rank. (ii) SERVE_H_CELLS
# (serve_cell's format): both at the published widths cut in depth, in
# bfloat16, on (data 2, model 2) (big: the weights' fsdp dim over the
# data line; arctic's experts kept over model), 2 rows a data rank, 12g's
# gates against one process and a float32 forward. (iii) each rank's peak
# within DRY_PEAK_SHARE of launch/dryrun.py's reckon_step / reckon_serve,
# traced in 12e's host child
SPLIT_H_CELLS = {"arctic": ("arctic-480b", (1, 1, 2, 2), 1, 1.0, 4, 512),
                 "qwen2vl": ("qwen2-vl-72b", (1, 1, 1, 2), VLM_LAYERS, None,
                             2, 512)}
SPLIT_H_SEED = 23
SPLIT_H_SEG = ("arctic", "qwen2vl")
SPLIT_H_SEG_MESH, SPLIT_H_M, SPLIT_H_ROUNDS = (1, 1, 2, 2), 4, 2
SERVE_H_CELLS = {"arctic": ("arctic-480b", (1, 1, 2, 2), 1, "bfloat16",
                            ATTN_BLOCK, 4, 2048, 16),
                 "qwen2vl": ("qwen2-vl-72b", (1, 1, 2, 2), VLM_LAYERS,
                             "bfloat16", ATTN_BLOCK, 4, 2048, 16)}
SPLIT_H_KERNELS = ("gossip_mix", "panel_mean_consensus")
SPLIT_H_FACTOR = 2.0


def split_h_config(label, reduced=False):
    """Phase 12h's config of a cell of SPLIT_H_CELLS: at its cut (float32,
    attn_block ATTN_BLOCK), or (``reduced``) its arch's reduced()."""
    import dataclasses

    from repro_torch.configs import get_config
    arch, _, layers, cap = SPLIT_H_CELLS[label][:4]
    cfg = get_config(arch)
    if reduced:
        return cfg.reduced()
    cfg = cfg.replace(num_layers=layers)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, num_experts=ARCH_CELLS["arctic"][6],
            capacity_factor=cap))
    return cfg.replace(dist=dataclasses.replace(cfg.dist,
                                                attn_block=ATTN_BLOCK))


def split_h_batch(torch, cfg, rows, tokens, dev):
    """An agent's seeded batch of ``rows`` x ``tokens`` (after the seeded
    patch prefix where the model takes one) on ``dev``."""
    import numpy as np
    rng = np.random.default_rng(SPLIT_H_SEED)
    ids = rng.integers(0, min(DATA_VOCAB, cfg.vocab_size),
                       (rows, tokens + 1)).astype(np.int32)
    batch = {"tokens": ids[:, :-1], "targets": ids[:, 1:],
             "mask": np.ones((rows, tokens), np.float32)}
    batch.update(cell_extras(cfg, batch, SPLIT_H_SEED))
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def step_yardstick(torch, label):
    """Phase 12h (i)'s float32 yardstick of SPLIT_H_CELLS' ``label``: one
    process's gradient of the seeded batch on the flash route against the
    same on the dense attention route (attn_block 0), the worst leaf's
    relative l2 gap."""
    import dataclasses

    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_flatten
    _, _, _, _, rows, tokens = SPLIT_H_CELLS[label]
    cfg = split_h_config(label)
    dev = torch.device("cuda")
    batch = split_h_batch(torch, cfg, rows, tokens, dev)
    grads = []
    for c in (cfg, cfg.replace(dist=dataclasses.replace(cfg.dist,
                                                        attn_block=0))):
        model = build_model(c)
        params = model.init_params(torch.Generator(device=dev).manual_seed(
            SPLIT_H_SEED), dev)
        leaves = [x.requires_grad_(True) for x in tree_flatten(params)[0]]
        loss, _ = model.loss_fn(params, batch)
        grads.append(torch.autograd.grad(loss, leaves))
        del params, leaves, loss
    worst = max(_rel_l2(torch, a, b) for a, b in zip(*grads))
    del grads
    torch.cuda.empty_cache()
    return worst


def split_step_run(torch, label, mesh):
    """Phase 12h (i): one agent's loss and gradient of SPLIT_H_CELLS'
    ``label`` on ``mesh`` (split_h_phase's comment): the rank's step (its
    seconds, peak, collectives, launches, kept assignments), its
    gradients summed by their rules, then on model rank 0 one process's
    step and the leaves' relative l2 errors (every rank takes part in the
    gathers). Returns the rank's record."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model, moe
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.utils.tree import tree_flatten
    _, _, _, _, rows, tokens = SPLIT_H_CELLS[label]
    cfg = split_h_config(label)
    dev = mesh.device
    split = tp.Split(mesh)
    whole = build_model(cfg)
    model = build_model(cfg, split=split)
    plan = tp.leaf_plan(cfg, split, tp.train_shardings(whole, mesh, 1))
    rules = tree_flatten(plan)[0]
    batch = split_h_batch(torch, cfg, rows, tokens, dev)
    pieces = tp.train_pieces(whole.init_params(torch.Generator(
        device=dev).manual_seed(SPLIT_H_SEED), dev), plan, split)
    leaves = [x.requires_grad_(True) for x in tree_flatten(pieces)[0]]
    kept = []
    orig = moe.split_dispatch

    def record(*a, **kw):
        out = orig(*a, **kw)
        kept.append(torch.sum(out[2]))
        return out
    moe.split_dispatch = record
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    mesh.stats.update(dict.fromkeys(mesh.stats, 0))
    reset_launch_counts()
    t0 = time.perf_counter()
    loss, mets = model.loss_fn(pieces, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize(dev)
    rec = {"step_s": time.perf_counter() - t0,
           "peak": torch.cuda.max_memory_allocated(dev),
           "comm": dict(mesh.stats), "counts": launch_counts(),
           "loss": float(mets["loss"]), "aux": float(mets["aux"]),
           "rank": mesh.rank, "coord": dict(mesh.coord),
           "transport": mesh.transport, "split": tp.describe(plan)}
    moe.split_dispatch = orig
    n_kept = torch.stack(kept).sum() if kept else torch.zeros(
        (), dtype=torch.int64, device=dev)
    rec["kept"] = int(split.block_sum(n_kept.clone()))
    # a whole leaf no model rank but 0 differentiates (the lookup's table)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    del pieces, leaves, loss, mets
    for g, rule in zip(grads, rules):
        (split.block_sum if rule.kind == "sum" else split.fsdp_sum)(g)
    torch.cuda.empty_cache()
    one = {}
    if mesh.rank == 0:  # one process's step, on the same weights and batch
        params = whole.init_params(torch.Generator(device=dev).manual_seed(
            SPLIT_H_SEED), dev)
        wleaves = [x.requires_grad_(True) for x in tree_flatten(params)[0]]
        valid = []
        orig = moe.dispatch_ranks

        def record_one(sel, C):
            out = orig(sel, C)
            valid.append(torch.sum(out[2]))
            return out
        moe.dispatch_ranks = record_one
        loss1, mets1 = whole.loss_fn(params, batch)
        want = torch.autograd.grad(loss1, wleaves)
        moe.dispatch_ranks = orig
        one = {"loss": float(mets1["loss"].detach()),
               "aux": float(mets1["aux"].detach()),
               "kept": int(torch.stack(valid).sum()) if valid else 0}
        del params, wleaves, loss1, mets1
        torch.cuda.empty_cache()
    errs = {}
    names = [".".join(p) for p, _ in tp._paths(plan)]
    for i, (g, rule) in enumerate(zip(grads, rules)):
        if rule.kind == "split":
            g = split.gather(g, "model", rule.dim)
        if mesh.rank == 0:
            errs[names[i]] = _rel_l2(torch, g, want[i])
        del g
    rec["one"] = one
    rec["grad_errs"] = errs
    # the assignments of the agent's tokens: layers x tokens x top-k
    moe_layers = sum(s_.ffn == "moe" for s_ in cfg.layer_specs())
    rec["assignments"] = (moe_layers * rows * tokens * cfg.moe.top_k
                          if cfg.moe else 0)
    del grads
    torch.cuda.empty_cache()
    return rec


def split_h_segment(torch, label, mesh):
    """Phase 12h (i)'s split segment of ``label`` at reduced() on ``mesh``:
    m SPLIT_H_M, SPLIT_H_ROUNDS rounds from the seeded init, the batches
    with the model's other inputs (cell_extras). Returns the per-round
    losses, Xi and seconds, the evals, launch counts (the rounds' and the
    evals'), whether every row is the same after the merge and Mesh.stats
    (the rounds')."""
    from repro_torch.core import dsgd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import eval_local, eval_merged, to_device
    from repro_torch.models import build_model
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.optim import make_optimizer
    cfg = split_h_config(label, reduced=True)
    dev = mesh.device
    model = build_model(cfg)
    opt = make_optimizer("adamw", 3e-3, weight_decay=5e-4,
                         total_steps=SPLIT_H_ROUNDS * H)
    per_round, eval_batch = segment_inputs(
        cfg, SPLIT_H_M, SPLIT_H_ROUNDS,
        data_vocab=min(DATA_VOCAB, cfg.vocab_size))
    for t, (_, b, _, _) in enumerate(per_round):
        b.update(cell_extras(cfg, b, (EXTRAS_SEED, t)))
    eval_batch.update(cell_extras(cfg, eval_batch,
                                  (EXTRAS_SEED, SPLIT_H_ROUNDS)))
    eval_batch = to_device(eval_batch, dev)
    state, spec = dsgd.init_panel_state(
        model.init_params, opt, SPLIT_H_M,
        torch.Generator(device=dev).manual_seed(0), device=dev, mesh=mesh)
    seg = dsgd.make_panel_segment(model.loss_fn, opt, H, spec,
                                  param_shardings=tp.train_shardings(
                                      model, mesh, SPLIT_H_M))
    mesh.stats.update(dict.fromkeys(mesh.stats, 0))
    reset_launch_counts()
    rec = {"losses": [], "xis": [], "times": []}
    for W, b, glob, _ in per_round:
        t0 = time.perf_counter()
        state, mets = seg(state, b, W, None, global_rounds=glob)
        torch.cuda.synchronize(dev)
        rec["times"].append(time.perf_counter() - t0)
        rec["losses"].append(float(mets["loss"][0]))
        rec["xis"].append(float(mets["consensus"][0]))
    rec["comm"] = dict(mesh.stats)
    rec["merged"] = eval_merged(model.loss_fn, state["panel"], spec,
                                eval_batch)
    rec["local"] = eval_local(model.loss_fn, state["panel"], spec,
                              eval_batch)
    rec["counts"] = launch_counts()  # the merged eval's reduce included
    rec["rows_identical"] = rows_identical(torch, state["panel"])
    del state, seg
    torch.cuda.empty_cache()
    return rec


def split_h_child(kind):
    """One rank of phase 12h: ``splith_a`` on (1, 1, 2, 2): arctic's step,
    the reduced segments and the serve cells (their logits to files in
    SHARD_TMP); ``splith_b`` on (1, 1, 1, 2): qwen2-vl's step. Prints one
    ``SHARD {json}`` line."""
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.launch import mesh as mesh_mod
    tmp = os.environ["SHARD_TMP"]
    out = {}
    if kind == "splith_a":
        mesh = mesh_mod.make_mesh(SPLIT_H_CELLS["arctic"][1])
        out["step arctic"] = split_step_run(torch, "arctic", mesh)
        for label in SPLIT_H_SEG:
            out[f"seg {label}"] = split_h_segment(torch, label, mesh)
        for label in SERVE_H_CELLS:
            rec = serve_cell_run(torch, label, mesh)
            torch.save(rec.pop("logits"), os.path.join(
                tmp, f"{label}_logits_{mesh.rank}.pt"))
            rec.pop("faults")
            out[f"serve {label}"] = rec
    else:
        mesh = mesh_mod.make_mesh(SPLIT_H_CELLS["qwen2vl"][1])
        out["step qwen2vl"] = split_step_run(torch, "qwen2vl", mesh)
    print("SHARD " + json.dumps(out), flush=True)
    dist.destroy_process_group()


def split_h_phase(torch, reckoned):
    """Phase 12h (the comment above SPLIT_H_CELLS): (ii)'s one-process
    runs here first, then the ranks, ``splith_a`` on 4 and ``splith_b`` on
    2; then the gates. ``reckoned``: {"step <label>", "serve <label>": 12e's
    reckon of each}. Returns ({"step", "segment", "serve": launch counts
    summed over the ranks}, records)."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix=".serve_ckpt_12h_", dir=ROOT)
    out, counts = {}, {}
    try:
        yard = {label: step_yardstick(torch, label) for label in SPLIT_H_CELLS}
        for label in SERVE_H_CELLS:
            t0 = time.perf_counter()
            one = serve_cell_run(torch, label)
            f32 = serve_cell_run(torch, label, float32=True)
            out[f"serve {label}"] = {
                "one": {k: v for k, v in one.items() if k != "logits"},
                "one_s": time.perf_counter() - t0, "phase": "12h",
                "reckoned": reckoned[f"serve {label}"],
                "logits": (one["logits"], f32["logits"])}
            del one, f32
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        recs = _run_ranks("splith_a", 4, tmp)
        t1 = time.perf_counter()
        recs_b = _run_ranks("splith_b", 2, tmp)
        walls = (t1 - t0, time.perf_counter() - t1)
        steps = {"arctic": [r["step arctic"] for r in recs],
                 "qwen2vl": [r["step qwen2vl"] for r in recs_b]}
        for label, rs in steps.items():
            _split_step_gates(label, rs, reckoned[f"step {label}"],
                              yard[label])
        for label in SPLIT_H_SEG:
            _split_h_seg_gates(label, [r[f"seg {label}"] for r in recs])
        for label in SERVE_H_CELLS:
            srecs = [r[f"serve {label}"] for r in recs]
            _serve_cell_gates(torch, label, srecs, out[f"serve {label}"],
                              tmp)
            out[f"serve {label}"]["recs"] = srecs
        counts["step"] = {k: sum(r["counts"][k] for rs in steps.values()
                                 for r in rs)
                          for k in steps["arctic"][0]["counts"]}
        seg_recs = [r[f"seg {label}"] for r in recs for label in SPLIT_H_SEG]
        counts["segment"] = {k: sum(r["counts"][k] for r in seg_recs)
                             for k in seg_recs[0]["counts"]}
        serve_recs = [r[f"serve {label}"] for r in recs
                      for label in SERVE_H_CELLS]
        counts["serve"] = {k: sum(r["counts"][k] for r in serve_recs)
                           for k in serve_recs[0]["counts"]}
        out.update(steps=steps, walls=walls, yardsticks=yard)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dt = time.perf_counter() - t_phase
    print(f"split MoE and M-RoPE (phase 12h, {card_line()}): {dt:.1f}s "
          f"(the ranks {walls[0]:.1f}s on 4 and {walls[1]:.1f}s on 2); "
          f"launches {counts}", flush=True)
    out["seconds"] = dt
    return counts, out


def _split_step_gates(label, recs, reckoned, yard):
    """Phase 12h (i)'s gates on one cell's ranks (split_step_run; ``yard``
    the cell's step_yardstick)."""
    arch, shape, _, _, rows, tokens = SPLIT_H_CELLS[label]
    r0 = recs[0]
    one = r0["one"]
    peaks = [r["peak"] for r in recs]
    pgap = [(reckoned["peak"] - p) / p for p in peaks]
    comm = [(int(r["comm"]["calls"]), int(r["comm"]["bytes"]))
            for r in recs]
    worst = max(r0["grad_errs"].values())
    bound = max(SPLIT_GRAD_RTOL, SPLIT_H_FACTOR * yard)
    drops = (r0["assignments"] - r0["kept"],
             r0["assignments"] - one["kept"])
    flash = [(r["counts"]["flash_attention_fwd"],
              r["counts"]["flash_attention_bwd"]) for r in recs]
    print(f"split step (phase 12h {label}, {card_line()}): {arch} at its "
          f"published widths, {split_h_config(label).num_layers} layers, "
          f"mesh {shape}, {rows} rows x {tokens} tokens; step s a rank "
          f"{[round(r['step_s'], 3) for r in recs]}; loss "
          f"{[r['loss'] for r in recs]} against one process's "
          f"{one['loss']!r}, aux {[r['aux'] for r in recs]} against "
          f"{one['aux']!r}; gradients (relative l2) the worst leaf {worst:.3g}"
          f" ({max(r0['grad_errs'], key=r0['grad_errs'].get)}; bound "
          f"{bound:.3g}: one process's flash route against its dense one "
          f"{yard:.3g}); each leaf "
          f"{ {k: float(f'{v:.3g}') for k, v in r0['grad_errs'].items()} }; "
          f"dropped "
          f"assignments split / one process {drops} of "
          f"{r0['assignments']}; peak a rank {peaks} against the reckoned "
          f"{reckoned['peak']} ({[round(g, 4) for g in pgap]}); "
          f"collectives a rank {comm} (reckoned {reckoned['run']['calls']}"
          f" calls, {reckoned['run']['bytes']} B); flash fwd / bwd a rank "
          f"{flash}; split {r0['split']['split']}, summed "
          f"{r0['split']['summed']}", flush=True)
    for r in recs:
        check(r["transport"] == "cuda ipc",
              f"phase 12h {label}: rank {r['rank']} over {r['transport']}")
        for key in ("loss", "aux"):
            check(abs(r[key] - one[key]) <= SPLIT_RTOL["losses"]
                  * abs(one[key]),
                  f"phase 12h {label}: rank {r['rank']}'s {key} {r[key]!r}"
                  f" against one process's {one[key]!r}")
        check(r["counts"]["flash_attention_fwd"] > 0
              and r["counts"]["flash_attention_bwd"] > 0,
              f"phase 12h {label}: rank {r['rank']} launched the flash "
              f"kernels {flash}")
    check(worst <= bound,
          f"phase 12h {label}: gradients {r0['grad_errs']} from one "
          f"process's, over {bound}")
    check(drops[0] == drops[1] and (r0["assignments"] == 0 or drops[0] > 0),
          f"phase 12h {label}: dropped assignments {drops}")
    check(all(abs(g) <= DRY_PEAK_SHARE for g in pgap),
          f"phase 12h {label}: peak {reckoned['peak']} reckoned against "
          f"{peaks}")
    check(all(c == (reckoned["run"]["calls"], reckoned["run"]["bytes"])
              for c in comm),
          f"phase 12h {label}: collectives {comm} against the reckoned "
          f"{reckoned['run']}")


def _split_h_seg_gates(label, recs):
    """Phase 12h (i)'s reduced segment's gates on the ranks
    (split_h_segment)."""
    r0 = recs[0]
    print(f"split segment (phase 12h {label} reduced(), {card_line()}): "
          f"mesh {SPLIT_H_SEG_MESH}, m {SPLIT_H_M}; rounds (s) a rank "
          f"{[[round(t, 3) for t in r['times']] for r in recs]}; losses "
          f"{r0['losses']}, Xi {r0['xis']}; evals {r0['merged']!r} "
          f"{r0['local']!r}; collectives a rank "
          f"{[int(r['comm']['calls']) for r in recs]}", flush=True)
    for r in recs:
        check(r["xis"][-1] == 0.0 and r["rows_identical"]
              and abs(r["local"] - r["merged"]) <= 1e-6 * abs(r["merged"]),
              f"phase 12h {label} segment: after the merge Xi "
              f"{r['xis'][-1]}, rows identical {r['rows_identical']}, evals"
              f" {r['merged']} {r['local']}")
        check(all(math.isfinite(x) for x in r["losses"]),
              f"phase 12h {label} segment: losses {r['losses']}")
        for k in SPLIT_H_KERNELS:
            check(r["counts"][k] > 0,
                  f"phase 12h {label} segment: {k} launched "
                  f"{r['counts'][k]} times")


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
    report = build.build(SOURCES + ("philox_check", "ipc_buffer"))
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)
    for name, log in report.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    cfg = get_config("olmo-1b").replace(num_layers=2)
    D = panel_mod.make_spec(build_model(cfg).init_params(None, "meta"),
                            rows=M).width
    t_mark = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        print(f"time: {what} {now - t_mark[0]:.1f}s (script "
              f"{now - t_start:.1f}s)", flush=True)
        t_mark[0] = now

    measured = {}
    for checks in (kernel_checks, wire_checks, native_checks, int4_checks,
                   merge_checks, residency_checks):
        measured.update(checks(torch, D))
        lap(f"phase 3 {checks.__name__}")
    measured.update(flash_checks(torch))
    lap("phase 3 flash_checks")
    measured.update(flash16_checks(torch))
    lap("phase 3 flash16_checks")
    small_parity(torch)
    lap("phase 4")
    counts, records = {}, {}
    for path in PATH_KERNELS:
        if path == "tree":
            counts[path], records[path] = drive_tree_path(torch,
                                                          records["f32"])
        else:
            counts[path], records[path] = drive_path(torch, path)
        lap(f"path {path}")
        if path == "f32":
            counts["serve"], serve_rec = serve_phase(
                torch, records[path].pop("state"), records[path].pop("spec"))
            lap("phase 9")
        check(records[path]["width"] == D,
              f"{path} path D {records[path]['width']} != checked D {D}")
        if path == "residency int8 unfused":
            compare_fused_unfused(torch, records.pop("residency int8"),
                                  records[path], records["f32"]["peak"])
            records[path].pop("panel")
            records[path].pop("opt")
            torch.cuda.empty_cache()
    figure_phase(torch)
    lap("phase 8")
    counts["launcher"], launcher_rec = launcher_phase(torch, records["f32"])
    lap("phase 10")
    reckoning = start_reckon()  # phase 12e's host work, beside the card's
    try:
        counts["arch"], _ = arch_phase(torch)
        lap("phase 11")
        counts["bf16 params"], _ = bf16_params_phase(torch, records["f32"])
        lap("phase 12a")
        counts["sharded"], sharded_rec = sharded_phase(torch, records["f32"])
        lap("phase 12b")
        counts["sharded options"], options_rec = options_phase(
            torch, records["f32"], sharded_rec)
        lap("phase 12c")
        torch.cuda.empty_cache()
        counts["sharded checkpoint"], ckpt_rec = ckpt_phase(
            torch, {**launcher_rec, "width": D})
        lap("phase 12d")
        reckoned = dryrun_phase(torch, reckoning, sharded_rec, options_rec,
                                ckpt_rec)
        lap("phase 12e")
        counts["split"], _ = split_phase(torch, reckoned["12f"])
        lap("phase 12f")
        counts["split serve"], _ = split_serve_phase(
            torch, serve_rec.pop("merged_cpu"),
            {label: reckoned[f"12g {label}"] for label in SERVE_CELLS})
        lap("phase 12g")
        counts["split moe"], _ = split_h_phase(torch, {
            k[len("12h "):]: v for k, v in reckoned.items()
            if k.startswith("12h ")})
        lap("phase 12h")
    finally:
        if reckoning[0].poll() is None:
            reckoning[0].kill()
            reckoning[0].wait()
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
    # sub-rows: the round-to-nearest quantizes, the bf16 and f16 variants
    # of the mix and the reduce. A variant's launches are its count in its
    # own path's run (the bf16 wire's path for bf16, the row's main path
    # for f16: no path runs a float16 group), its launches_phase12 its
    # counts in phase 12's runs; each a count of that variant alone
    p12 = counts["bf16 params"]
    variants = {"quantize_int8": [("rtn", "quantize_int8_rtn", None)],
                "quantize_int4": [("rtn", "quantize_int4_rtn", None)],
                "quantize_int8_grouped": [("rtn", "quantize_int8_grouped_rtn",
                                           None)],
                "gossip_mix": [("bf16", "gossip_mix_bf16", counts["bf16"]),
                               ("f16", "gossip_mix_f16", counts["f32"])],
                "panel_mean_consensus": [
                    ("bf16", "panel_mean_consensus_bf16", counts["bf16"]),
                    ("f16", "panel_mean_consensus_f16", counts["f32"])],
                # the 16-bit flash libraries: bf16's launches in phase
                # 12a's attn_block cell (and 12g, launches_phase12), f16's
                # on the main path's (no path runs a float16 group)
                "flash_attention_fwd": [
                    ("bf16", "flash_attention_fwd_bf16", p12),
                    ("f16", "flash_attention_fwd_f16",
                     counts[f"attn_block {ATTN_BLOCK}"])],
                "flash_attention_bwd": [
                    ("bf16", "flash_attention_bwd_bf16", p12),
                    ("f16", "flash_attention_bwd_f16",
                     counts[f"attn_block {ATTN_BLOCK}"])]}
    kernels = []
    for name, (src, replaces, run) in kernels_of.items():
        r = measured[name]
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}",
               "replaces": f"src/repro/kernels/{replaces}",
               "launches": run[name], "max_abs_err": r["max_abs_err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"],
               "launches_serve": counts["serve"][name],
               "launches_arch": {c: n[name]
                                 for c, n in counts["arch"].items()}}
        for extra in ("sq_rel_err", "max_abs_err_bf16", "supplied",
                      "kernels_ms", "hd96", "hd256", "hd256_h10"):
            if extra in r:
                row[extra] = r[extra]
        for key, sub, launches in variants.get(name, ()):
            row[key] = {k: measured[sub][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")}
            if name.startswith("flash_attention"):  # the 16-bit kernels
                row[key]["source"] = FLASH16_SOURCE
            for extra in ("hd256", "worst_ratio", "route_ops", "route_ms",
                          "kernels_ms"):
                if extra in measured[sub]:
                    row[key][extra] = measured[sub][extra]
            if launches is not None:
                row[key]["launches"] = launches[sub]
                row[key]["launches_phase12"] = {
                    "bf16_params": p12[sub],
                    "sharded": counts["sharded"][sub],
                    "sharded_options": counts["sharded options"][sub],
                    "sharded_checkpoint": counts["sharded checkpoint"][sub],
                    "split": counts["split"][sub],
                    "split_serve": {c: n[sub] for c, n in
                                    counts["split serve"].items()},
                    "split_moe_mrope": {c: n[sub] for c, n in
                                        counts["split moe"].items()}}
        row["launches_phase12"] = {
            "bf16_params": p12[name], "sharded": counts["sharded"][name],
            "sharded_options": counts["sharded options"][name],
            "sharded_checkpoint": counts["sharded checkpoint"][name],
            "split": counts["split"][name],
            "split_serve": {c: n[name] for c, n in
                            counts["split serve"].items()},
            "split_moe_mrope": {c: n[name] for c, n in
                                counts["split moe"].items()}}
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
