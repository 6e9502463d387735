"""Time the flash attention kernels on the card.

  python -m repro_torch.kernels.flash_bench [--parent DIR]

First each kernel's resources at hd 128 and 256: registers and local
(spill) bytes a thread from the CUDA runtime's function attributes, blocks
and warps per SM and dynamic shared memory from its occupancy calculator.
Then, at the attn_block path's shape (B 2, S 2048, H 16, hd 128, causal),
a GQA shape (H 32 on Kv 8), a head dim of 64 (B 4, S 1024, H 16:
seamless-m4t-medium's, causal as in its decoder and not causal as in its
encoder), gemma-2b's (H 8 on Kv 1, hd 256) and recurrentgemma-2b's local
attention (H 10 on Kv 1, hd 256), it
holds the forward and the backward kernels against their plain versions
(2e-5 and 1e-4) and prints each one's median time over 20 launches (CUDA
events, after 3 warm-up launches) beside two operation bounds over the
visible pairs: the float32 CUDA cores' (the operations at 67 TFLOP/s) and
that of the route the kernels take, three TF32 tensor-core products a
float32 product (3 x the operations at 495 TFLOP/s); the H100's published
dense rates. The share printed is of the tensor-core bound. Beside them,
torch's ``scaled_dot_product_attention`` on the same float32 tensors
(forward, and its backward on a retained graph): the library's time, used
nowhere in the port. Then the backward's own kernels (row sums, dK/dV, the
reduction of dK/dV's partial sums where there is one, dQ): each one's
device time a backward call and its share, from a ``torch.profiler``
trace of 10 calls. Beside the times, each output's (out, lse, dq, dk, dv)
worst error as a share of its tolerance against a dense float64 answer,
for the kernels and for the plain versions.

Then the bfloat16 and float16 kernels (``csrc/flash_attention16.cu``) at
hd 128 (B 2, S 2048, H 16), gemma-2b's hd 256 (H 8 on Kv 1) and
phi3-mini's hd 96 (H 32), causal:
the forward's and the backward's median times beside
``scaled_dot_product_attention`` on the same 16-bit tensors and the
function's bound (4 hd and 10 hd operations a visible pair at the dense
16-bit 989 TFLOP/s), and the backward's kernels' shares. With
``--parent DIR`` (an unpacked tree of another commit, e.g. ``git archive``
of the parent into a directory that ``.gitignore`` lists) it builds that
tree's three flash libraries into DIR's own build directory and times
them in turns with this tree's (parent, new, new, parent), the shares of
both; and it runs both float32 libraries on the same inputs at four
shapes and prints max |new - parent| over out, lse, dq, dk, dv, which must
be 0. Every timed line ends with the card's name and power limit. It exits
2 without a card, 1 if a kernel disagrees or the float32 results differ.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.hardware import BF16_FLOPS, FP32_FLOPS, TF32_FLOPS
from repro_torch.kernels import build

SPLIT = 3            # TF32 products a float32 product (hi hi, hi lo, lo hi)
SHAPES = ((2, 2048, 16, 16, 128, True), (2, 2048, 32, 8, 128, True),
          (4, 1024, 16, 16, 64, True), (4, 1024, 16, 16, 64, False),
          (2, 2048, 8, 1, 256, True),
          (2, 2048, 10, 1, 256, True))  # (B, S, H, Kv, hd, causal)
TOLS = (2e-5, 2e-5, 1e-4, 1e-4, 1e-4)  # out, lse, dq, dk, dv
# the 16-bit kernels' shapes (B, S, H, Kv, hd; causal), and the float32
# shapes held against another tree's float32 kernels bit for bit
SHAPES16 = ((2, 2048, 16, 16, 128), (2, 2048, 8, 1, 256),
            (2, 2048, 32, 32, 96))
SAME32 = ((2, 2048, 16, 16, 128, True), (4, 1024, 16, 16, 64, False),
          (2, 2048, 8, 1, 256, True), (2, 300, 8, 4, 96, True))
# the backward's kernels by a piece of their names, in the order tried
BWD_KERNELS = (("delta_kernel", "row sums"), ("reduce", "dK/dV reduction"),
               ("dkdv", "dK/dV"), ("dq", "dQ"))


def bounds_ms(ops):
    """(float32 CUDA-core bound, split-TF32 tensor-core bound) in ms of
    ``ops`` float32 operations."""
    return 1e3 * ops / FP32_FLOPS, 1e3 * SPLIT * ops / TF32_FLOPS


def flops(B, S, H, hd, pairs):
    """(forward, backward) float32 operations over ``pairs`` visible pairs
    a head: 4 hd a pair (QK^T, PV), 10 hd (S, dP, dV, dK, dQ)."""
    return 4 * hd * pairs * B * H, 10 * hd * pairs * B * H


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def resource_lines(hd=128, S=2048):
    """One line a kernel: its resources at head dim ``hd`` and sequence
    length ``S`` (``flash_attention.occupancy``)."""
    from repro_torch.kernels.flash_attention import occupancy
    return [f"  {name} (hd {hd}): {r['registers']} registers, "
            f"{r['local_bytes']} B local (spills) a thread, "
            f"{r['blocks_per_sm']} blocks ({r['warps_per_sm']} warps) per "
            f"SM, {r['smem']} B shared memory"
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


def kernel_ms(fn, reps=10):
    """{kernel name: mean device ms a call} of the CUDA kernels that
    ``fn`` launches, from the Chrome trace of a ``torch.profiler`` run of
    ``reps`` calls (after one warm-up call); {} when the trace holds no
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            name = e.get("name", "?")
            out[name] = out.get(name, 0.0) + float(e.get("dur", 0)) / 1e3
    return {k: v / reps for k, v in out.items()}


def backward_kernel_ms(fn, reps=10):
    """{"row sums", "dK/dV reduction", "dK/dV", "dQ": mean device ms a
    call} of the flash backward ``fn`` (``kernel_ms``, its kernels told
    apart by ``BWD_KERNELS``; a kernel it did not launch is absent, any
    other kernel is "other"); {} when the profiler saw no kernel."""
    out = {}
    for name, ms in kernel_ms(fn, reps).items():
        label = next((lab for piece, lab in BWD_KERNELS if piece in name),
                     "other")
        out[label] = out.get(label, 0.0) + ms
    return out


def shares_line(per):
    """The backward's kernels, each one's ms and share of their sum."""
    if not per:
        return "not measured (the profiler saw no kernel)"
    total = sum(per.values())
    return ", ".join(f"{k} {ms:.4f} ms ({100 * ms / total:.1f}%)"
                     for k, ms in per.items()) + f"; sum {total:.4f} ms"


def library_ms(q, k, v, do, causal=True):
    """(forward, backward) ms of ``scaled_dot_product_attention``
    (is_causal as ``causal``, enable_gqa where Kv < H) on the same float32
    tensors in its
    (B, H, S, hd) layout, the backward on a retained graph; (None, None)
    where it does not run on float32."""
    F = torch.nn.functional
    ql, kl, vl = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dol = do.transpose(1, 2).contiguous()
    kw = dict(is_causal=causal)
    if k.shape[2] < q.shape[2]:
        kw["enable_gqa"] = True
    try:
        lo = F.scaled_dot_product_attention(ql, kl, vl, **kw)
        fwd = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl,
                                                             **kw))
        bwd = time_ms(lambda: torch.autograd.grad(lo, (ql, kl, vl), dol,
                                                  retain_graph=True))
        return fwd, bwd
    except (RuntimeError, NotImplementedError) as exc:
        print(f"library: scaled_dot_product_attention does not run on "
              f"float32 here ({type(exc).__name__}: "
              f"{str(exc).splitlines()[0]})", flush=True)
        return None, None


def dense64(q, k, v, do, causal=True):
    """(out, lse, dq, dk, dv) of (causal) attention in float64 (dense, K
    and V expanded for GQA; lse (B, H, S)): the yardstick of the errors."""
    q, k, v = (t.double().requires_grad_(True) for t in (q, k, v))
    G = q.shape[2] // k.shape[2]
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(G, 2))
    s = s / q.shape[-1] ** 0.5
    if causal:
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


def flash_tree(tree=None):
    """(libraries, forward, backward) of this tree or of the tree at
    ``tree``: {library name: loaded library} of its three flash libraries
    (built from its ``src/repro_torch/kernels/csrc`` into its own
    ``_build``) and the wrappers of its ``kernels/flash_attention.py``
    (loaded under another name: its own workspace rule for its own C
    interface); call them inside ``build.using(libs)``."""
    import importlib.util

    from repro_torch.kernels import flash_attention as mod
    if tree is not None:
        kernels = Path(tree) / "src" / "repro_torch" / "kernels"
        spec = importlib.util.spec_from_file_location(
            "flash_attention_of_" + Path(tree).name,
            kernels / "flash_attention.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    names = tuple(mod.LIBRARIES.values())
    if tree is None:
        libs = {n: build.load(n, mod._SIGNATURES) for n in names}
    else:
        csrc, out = kernels / "csrc", kernels / "_build"
        build.build(names, csrc, out)
        libs = {n: build.open_library(build.library_path(n, csrc, out),
                                      mod._SIGNATURES) for n in names}
    return libs, mod.flash_attention_fwd, mod.flash_attention_bwd


def sixteen_bit(card, parent=None):
    """The 16-bit kernels at SHAPES16 in bfloat16 and float16: one line a
    shape and type (this tree's kernels and, with ``parent``'s
    (``flash_tree``), theirs in turns: parent, new, new, parent), then the
    backward's kernels' shares of each."""
    new = flash_tree()
    fwd_new = new[1]
    turns = ([("parent", parent), ("new", new), ("new", new),
              ("parent", parent)] if parent else [("new", new)])
    gen = torch.Generator(device="cuda").manual_seed(16)
    for dtype in (torch.bfloat16, torch.float16):
        for B, S, H, Kv, hd in SHAPES16:
            q, k, v, do = (torch.randn((B, S, n, hd), generator=gen,
                                       device="cuda").to(dtype)
                           for n in (H, Kv, Kv, H))
            pos = torch.arange(S, dtype=torch.int32,
                               device="cuda").expand(B, S)
            o, lse = fwd_new(q, k, v, pos, pos)
            times, shares = [], {}
            for label, (libs, fwd, bwd_of) in turns:

                def bwd():
                    return bwd_of(q, k, v, o, lse, do, pos, pos)

                with build.using(libs):
                    times.append((label, time_ms(
                        lambda: fwd(q, k, v, pos, pos)), time_ms(bwd)))
                    shares.setdefault(label, backward_kernel_ms(bwd))
            lib = library_ms(q, k, v, do)
            pairs = S * (S + 1) // 2
            bound = [1e3 * ops / BF16_FLOPS for ops in (
                4 * hd * pairs * B * H, 10 * hd * pairs * B * H)]
            tag = f"{str(dtype)[6:]} B={B} S={S} H={H} Kv={Kv} hd={hd} causal"
            for i, name in enumerate(("forward", "backward")):
                print(f"{tag}: {name} ms " + ", ".join(
                          f"{t[0]} {t[1 + i]:.4f}" for t in times)
                      + f"; library {lib[i]} ms; bound {bound[i]:.4f} ms "
                      f"(the function's operations at 989 TFLOP/s); "
                      f"{card}", flush=True)
            for label, per in shares.items():
                print(f"  {tag} backward's kernels, {label} (torch.profiler,"
                      f" a call): {shares_line(per)}; {card}", flush=True)
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()


def same_float32(card, parent):
    """max |new - parent| over (out, lse, dq, dk, dv) of the float32
    kernels of this tree and of ``parent``'s (``flash_tree``) on the same
    inputs at SAME32's shapes, one line a shape; True if every one is 0."""
    new = flash_tree()
    gen = torch.Generator(device="cuda").manual_seed(32)
    same = True
    for B, S, H, Kv, hd, causal in SAME32:
        q, k, v, do = (torch.randn((B, S, n, hd), generator=gen,
                                   device="cuda") for n in (H, Kv, Kv, H))
        pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S)
        runs = []
        for libs, fwd, bwd in (parent, new):
            with build.using(libs):
                o, lse = fwd(q, k, v, pos, pos, causal=causal)
                runs.append((o, lse) + tuple(bwd(
                    q, k, v, o, lse, do, pos, pos, causal=causal)))
        delta = max(float((a - b).abs().max()) for a, b in zip(*runs))
        same = same and delta == 0.0
        print(f"float32 B={B} S={S} H={H} Kv={Kv} hd={hd}"
              + ("" if causal else " not causal")
              + f": max |new - parent| over out, lse, dq, dk, dv {delta}; "
              f"{card}", flush=True)
    return same


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked tree of another commit "
                    "whose flash kernels to time and compare with")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (TF32 off)
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_fwd_ref)
    card = card_line()
    for hd in (128, 256):
        print("\n".join(resource_lines(hd)), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for B, S, H, Kv, hd, causal in SHAPES:
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda")
        k = torch.randn((B, S, Kv, hd), generator=gen, device="cuda")
        v = torch.randn((B, S, Kv, hd), generator=gen, device="cuda")
        do = torch.randn((B, S, H, hd), generator=gen, device="cuda")
        pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S)
        kw = dict(causal=causal)
        o, lse = flash_attention_fwd(q, k, v, pos, pos, **kw)
        grads = flash_attention_bwd(q, k, v, o, lse, do, pos, pos, **kw)
        plain = (flash_attention_fwd_ref(q, k, v, pos, pos, **kw)
                 + tuple(flash_attention_bwd_ref(q, k, v, do, pos, pos,
                                                 **kw)))
        agree = all(torch.allclose(a, b, atol=t, rtol=t) for a, b, t in
                    zip((o, lse) + tuple(grads), plain, TOLS))
        ok = ok and agree
        want = dense64(q, k, v, do, causal)
        shares = (tolerance_shares((o, lse) + tuple(grads), want),
                  tolerance_shares(plain, want))
        del plain, want
        torch.cuda.empty_cache()

        def bwd():
            return flash_attention_bwd(q, k, v, o, lse, do, pos, pos, **kw)

        fwd_ms = time_ms(lambda: flash_attention_fwd(q, k, v, pos, pos,
                                                     **kw))
        bwd_ms = time_ms(bwd)
        lib = library_ms(q, k, v, do, causal)
        shape = (f"B={B} S={S} H={H} Kv={Kv} hd={hd}"
                 + ("" if causal else " not causal"))
        line = f"{shape}: agree {agree}"
        for name, ms, ops, lib_ms in zip(
                ("forward", "backward"), (fwd_ms, bwd_ms),
                flops(B, S, H, hd, S * (S + 1) // 2 if causal else S * S),
                lib):
            fp32, tc = bounds_ms(ops)
            line += (f"; {name} {ms:.4f} ms (bounds "
                     f"{fp32:.4f} float32, {tc:.4f} split TF32: "
                     f"{100 * tc / ms:.1f}% of it; library "
                     + (f"{lib_ms:.4f} ms)" if lib_ms is not None
                        else "none)"))
        print(f"{line}; {card}", flush=True)
        print(f"  {shape} backward's kernels (torch.profiler, a call): "
              f"{shares_line(backward_kernel_ms(bwd))}; {card}", flush=True)
        print("  worst error / tolerance against float64 (out, lse, dq, dk, "
              "dv): kernels " + " ".join(f"{x:.3g}" for x in shares[0])
              + "; plain versions " + " ".join(f"{x:.3g}" for x in shares[1]),
              flush=True)
        del q, k, v, do, o, lse, grads
        torch.cuda.empty_cache()
    parent = flash_tree(args.parent) if args.parent else None
    sixteen_bit(card, parent)
    if parent:
        ok = same_float32(card, parent) and ok
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
