"""Gossip mix ``W @ theta``: the CUDA kernel's wrapper.

Replaces the Pallas TPU kernel ``gossip_mix_panel``
(``src/repro/kernels/gossip_mix.py``); the kernel is
``csrc/gossip_mix.cu``, with a float32, a bfloat16 (the bf16 wire's
payload, or a bfloat16 parameter group) and a float16 variant (a float16
group); each writes float32. For a CPU tensor the wrapper runs the
plain version (``kernels/ref.py:gossip_mix_ref``); for a CUDA tensor it
launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import gossip_mix_ref

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_SIGNATURES = {"gossip_mix_f32": (ctypes.c_int, _ARGS),
               "gossip_mix_bf16": (ctypes.c_int, _ARGS),
               "gossip_mix_f16": (ctypes.c_int, _ARGS)}
# theta's dtype -> the kernel's entry point
_ENTRY = {torch.float32: "gossip_mix_f32", torch.bfloat16: "gossip_mix_bf16",
          torch.float16: "gossip_mix_f16"}

MAX_ROWS = 32  # the kernel's bound on m (agents)


def _check(W, theta):
    if W.dtype != torch.float32 or theta.dtype not in _ENTRY:
        raise TypeError(f"gossip_mix takes float32 W and float32, bfloat16 "
                        f"or float16 theta, got {W.dtype} and {theta.dtype}")
    if W.dim() != 2 or theta.dim() != 2:
        raise ValueError(f"W must be (n, m) and theta (m, D), got "
                         f"{tuple(W.shape)} and {tuple(theta.shape)}")
    n, m = W.shape
    if theta.shape[0] != m or not 1 <= m <= MAX_ROWS or not 1 <= n <= m + 1:
        raise ValueError(f"gossip_mix takes W (n, m) with 1 <= m <= "
                         f"{MAX_ROWS}, n <= m + 1 and theta (m, D); got W "
                         f"{tuple(W.shape)}, theta {tuple(theta.shape)}")
    if theta.shape[1] < 1:
        raise ValueError("theta has no columns")
    if not (W.is_contiguous() and theta.is_contiguous()):
        raise ValueError("gossip_mix takes contiguous W and theta")


def gossip_mix(W, theta):
    """W: (n, m) float32; theta: (m, D) float32, bfloat16 or float16 ->
    (n, D) float32 W @ theta, accumulated in float32.

    n == m for a mixing matrix; n == m + 1 when W carries the folded
    1^T/m row, whose output row is the column mean."""
    if W.device != theta.device:
        raise ValueError(f"W on {W.device} but theta on {theta.device}")
    if theta.device.type == "cpu":
        return gossip_mix_ref(W, theta)
    if theta.device.type != "cuda":
        raise ValueError(f"gossip_mix runs on cpu or cuda, got "
                         f"{theta.device}")
    _check(W, theta)
    n, m = W.shape
    D = theta.shape[1]
    out = torch.empty((n, D), dtype=torch.float32, device=theta.device)
    lib = build.load("gossip_mix", _SIGNATURES)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    rc = getattr(lib, _ENTRY[theta.dtype])(W.data_ptr(), theta.data_ptr(),
                                           out.data_ptr(), n, m, D, stream)
    if rc != 0:
        raise RuntimeError(f"gossip_mix kernel launch failed: CUDA error "
                           f"{rc}")
    gossip_mix.launches += 1
    if theta.dtype == torch.bfloat16:
        gossip_mix.launches_bf16 += 1
    elif theta.dtype == torch.float16:
        gossip_mix.launches_f16 += 1
    return out


# kernel launches since the counts were last set to 0: all of them, and of
# those the bf16 and the f16 variants'
gossip_mix.launches = 0
gossip_mix.launches_bf16 = 0
gossip_mix.launches_f16 = 0
