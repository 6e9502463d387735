"""Time the flash attention kernels on the card.

  python -m repro_torch.kernels.flash_bench

First each kernel's resources at hd 128: registers and local (spill)
bytes a thread from the CUDA runtime's function attributes, blocks per SM
and dynamic shared memory from its occupancy calculator. Then, at the
attn_block path's shape (B 2, S 2048, H 16, hd 128, causal), a GQA shape
(H 32 on Kv 8) and a head dim of 64, it holds the forward and the
backward kernels against their plain versions (2e-5 and 1e-4) and prints
each one's median time over 20 launches (CUDA events, after 3 warm-up
launches) beside two operation bounds over the visible pairs: the float32
CUDA cores' (the operations at 67 TFLOP/s) and that of the route the
kernels take, three TF32 tensor-core products a float32 product (3 x the
operations at 495 TFLOP/s); the H100's published dense rates. The share
printed is of the tensor-core bound. (The library's time on the same
inputs is ``chip_smoke.py``'s, phase 3.) Beside the times, each output's
(out, lse, dq, dk, dv) worst error as a share of its tolerance against a
dense float64 answer, for the kernels and for the plain versions. Last,
the card's name and power limit. It exits 2 without a card, 1 if a kernel
disagrees.
"""
from __future__ import annotations

import statistics
import subprocess
import sys

import torch

FP32_FLOPS = 67e12   # float32 on the CUDA cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores, dense
SPLIT = 3            # TF32 products a float32 product (hi hi, hi lo, lo hi)
SHAPES = ((2, 2048, 16, 16, 128), (2, 2048, 32, 8, 128),
          (4, 1024, 16, 16, 64))  # (B, S, H, Kv, hd)
TOLS = (2e-5, 2e-5, 1e-4, 1e-4, 1e-4)  # out, lse, dq, dk, dv


def bounds_ms(ops):
    """(float32 CUDA-core bound, split-TF32 tensor-core bound) in ms of
    ``ops`` float32 operations."""
    return 1e3 * ops / FP32_FLOPS, 1e3 * SPLIT * ops / TF32_FLOPS


def flops(B, S, H, hd, pairs):
    """(forward, backward) float32 operations over ``pairs`` visible pairs
    a head: 4 hd a pair (QK^T, PV), 10 hd (S, dP, dV, dK, dQ)."""
    return 4 * hd * pairs * B * H, 10 * hd * pairs * B * H


def resource_lines(hd=128, S=2048):
    """One line a kernel: its resources at head dim ``hd`` and sequence
    length ``S`` (``flash_attention.occupancy``)."""
    from repro_torch.kernels.flash_attention import occupancy
    return [f"  {name} (hd {hd}): {r['registers']} registers, "
            f"{r['local_bytes']} B local (spills) a thread, "
            f"{r['blocks_per_sm']} blocks ({4 * r['blocks_per_sm']} warps) "
            f"per SM, {r['smem']} B shared memory"
            for name, r in occupancy(hd, S).items()]


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


def dense64(q, k, v, do):
    """(out, lse, dq, dk, dv) of causal attention in float64 (dense, K and
    V expanded for GQA; lse (B, H, S)): the yardstick of the errors."""
    q, k, v = (t.double().requires_grad_(True) for t in (q, k, v))
    G = q.shape[2] // k.shape[2]
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(G, 2))
    s = s / q.shape[-1] ** 0.5
    i = torch.arange(S, device=q.device)
    s = s.masked_fill(i[None, :] > i[:, None], float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                       v.repeat_interleave(G, 2))
    grads = torch.autograd.grad(out, (q, k, v), do.double())
    return (out.detach(), torch.logsumexp(s.detach(), -1)) + grads


def tolerance_shares(got, want):
    """Each output's worst |got - want| / (tol + tol |want|)."""
    return [float(torch.max(torch.abs(a.double() - b) / (t + t * b.abs())))
            for a, b, t in zip(got, want, TOLS)]


def main():
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (TF32 off)
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_fwd_ref)
    print("\n".join(resource_lines()), flush=True)
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
        plain = (flash_attention_fwd_ref(q, k, v, pos, pos)
                 + tuple(flash_attention_bwd_ref(q, k, v, do, pos, pos)))
        agree = all(torch.allclose(a, b, atol=t, rtol=t) for a, b, t in
                    zip((o, lse) + tuple(grads), plain, TOLS))
        ok = ok and agree
        want = dense64(q, k, v, do)
        shares = (tolerance_shares((o, lse) + tuple(grads), want),
                  tolerance_shares(plain, want))
        del plain, want
        fwd = time_ms(lambda: flash_attention_fwd(q, k, v, pos, pos))
        bwd = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, pos,
                                                  pos))
        line = f"B={B} S={S} H={H} Kv={Kv} hd={hd}: agree {agree}"
        for name, ms, ops in zip(("forward", "backward"), (fwd, bwd),
                                 flops(B, S, H, hd, S * (S + 1) // 2)):
            fp32, tc = bounds_ms(ops)
            line += (f"; {name} {ms:.4f} ms (bounds "
                     f"{fp32:.4f} float32, {tc:.4f} split TF32: "
                     f"{100 * tc / ms:.1f}% of it)")
        print(line, flush=True)
        print("  worst error / tolerance against float64 (out, lse, dq, dk, "
              "dv): kernels " + " ".join(f"{x:.3g}" for x in shares[0])
              + "; plain versions " + " ".join(f"{x:.3g}" for x in shares[1]),
              flush=True)
        del q, k, v, do, o, lse, grads
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
