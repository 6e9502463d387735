"""Time the flash attention kernels on the card.

  python -m repro_torch.kernels.flash_bench

At the attn_block path's shape (B 2, S 2048, H 16, hd 128, causal), a GQA
shape (H 32 on Kv 8) and a head dim of 64, it holds the forward and the
backward kernels against their plain versions (2e-5 and 1e-4), then prints
each one's median time over 20 launches (CUDA events, after 3 warm-up
launches) and its share of the operation bound (float32 operations over
the visible pairs at 67 TFLOP/s, the H100's published float32 rate), the
compiler's register report, and the card's name and power limit. It exits
2 without a card, 1 if a kernel disagrees.
"""
from __future__ import annotations

import statistics
import subprocess
import sys

import torch

FP32_FLOPS = 67e12
SHAPES = ((2, 2048, 16, 16, 128), (2, 2048, 32, 8, 128),
          (4, 1024, 16, 16, 64))  # (B, S, H, Kv, hd)


def time_ms(fn, reps=20, warmup=3):
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


def main():
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (TF32 off)
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_fwd_ref)
    log = build.build(["flash_attention"]).get("flash_attention", "")
    print("\n".join(line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line))
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for B, S, H, Kv, hd in SHAPES:
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda")
        k = torch.randn((B, S, Kv, hd), generator=gen, device="cuda")
        v = torch.randn((B, S, Kv, hd), generator=gen, device="cuda")
        do = torch.randn((B, S, H, hd), generator=gen, device="cuda")
        pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S)
        o, lse = flash_attention_fwd(q, k, v, pos, pos)
        grads = flash_attention_bwd(q, k, v, o, lse, do, pos, pos)
        agree = (torch.allclose(o, flash_attention_fwd_ref(q, k, v, pos,
                                                           pos)[0],
                                atol=2e-5, rtol=2e-5)
                 and all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                         for a, b in zip(grads, flash_attention_bwd_ref(
                             q, k, v, do, pos, pos))))
        ok = ok and agree
        fwd = time_ms(lambda: flash_attention_fwd(q, k, v, pos, pos))
        bwd = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, pos,
                                                  pos))
        work = hd * (S * (S + 1) // 2) * B * H  # per product, causal
        print(f"B={B} S={S} H={H} Kv={Kv} hd={hd}: agree {agree}; forward "
              f"{fwd:.4f} ms ({100 * 4 * work / FP32_FLOPS * 1e3 / fwd:.1f}% "
              f"of its bound), backward {bwd:.4f} ms "
              f"({100 * 10 * work / FP32_FLOPS * 1e3 / bwd:.1f}%)",
              flush=True)
        del q, k, v, do, o, lse, grads
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
