"""Panel statistics (column mean + total squared deviation): the CUDA
kernels' wrapper.

Replaces the Pallas TPU kernel ``panel_mean_consensus``
(``src/repro/kernels/panel_reduce.py``), which takes any dtype; the
kernels are ``csrc/panel_reduce.cu``, instantiated for float32, bfloat16
and float16 panels (a first pass writing the means and one partial
sum per block, a second summing the partials in fixed order). For a CPU
tensor the wrapper runs the plain version
(``kernels/ref.py:panel_mean_consensus_ref``); for a CUDA tensor it
launches the kernels or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import panel_mean_consensus_ref

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_SIGNATURES = {
    "panel_mean_consensus_f32": (ctypes.c_int, _ARGS),
    "panel_mean_consensus_bf16": (ctypes.c_int, _ARGS),
    "panel_mean_consensus_f16": (ctypes.c_int, _ARGS),
    "panel_reduce_partials": (ctypes.c_longlong, [ctypes.c_longlong]),
}
# theta's dtype -> the kernel's entry point
_ENTRY = {torch.float32: "panel_mean_consensus_f32",
          torch.bfloat16: "panel_mean_consensus_bf16",
          torch.float16: "panel_mean_consensus_f16"}

MAX_ROWS = 32  # the kernel's bound on m (agents)


def panel_mean_consensus(theta):
    """theta: (m, D) float32, bfloat16 or float16 -> (mean (D,) float32,
    sq () float32), with sq = sum_{k,j} (theta_kj - mean_j)^2 over the
    values widened to float32; the consensus distance is sqrt(sq / m)."""
    if theta.device.type == "cpu":
        return panel_mean_consensus_ref(theta)
    if theta.device.type != "cuda":
        raise ValueError(f"panel_mean_consensus runs on cpu or cuda, got "
                         f"{theta.device}")
    if theta.dtype not in _ENTRY:
        raise TypeError(f"panel_mean_consensus takes a float32, bfloat16 or "
                        f"float16 panel, got {theta.dtype}")
    if theta.dim() != 2 or not 1 <= theta.shape[0] <= MAX_ROWS \
            or theta.shape[1] < 1:
        raise ValueError(f"panel_mean_consensus takes (m, D) with 1 <= m <= "
                         f"{MAX_ROWS}, got {tuple(theta.shape)}")
    if not theta.is_contiguous():
        raise ValueError("panel_mean_consensus takes a contiguous panel")
    m, D = theta.shape
    lib = build.load("panel_reduce", _SIGNATURES)
    nparts = lib.panel_reduce_partials(D)
    dev = theta.device
    mean = torch.empty((D,), dtype=torch.float32, device=dev)
    partial = torch.empty((nparts,), dtype=torch.float64, device=dev)
    sq = torch.empty((), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, _ENTRY[theta.dtype])(theta.data_ptr(), mean.data_ptr(),
                                           partial.data_ptr(), nparts,
                                           sq.data_ptr(), m, D, stream)
    if rc != 0:
        raise RuntimeError(f"panel_mean_consensus kernel launch failed: CUDA "
                           f"error {rc}")
    panel_mean_consensus.launches += 1
    if theta.dtype == torch.bfloat16:
        panel_mean_consensus.launches_bf16 += 1
    elif theta.dtype == torch.float16:
        panel_mean_consensus.launches_f16 += 1
    return mean, sq


# kernel launches since the counts were last set to 0: all of them, and of
# those the bf16 variant's and the f16 variant's
panel_mean_consensus.launches = 0
panel_mean_consensus.launches_bf16 = 0
panel_mean_consensus.launches_f16 = 0
