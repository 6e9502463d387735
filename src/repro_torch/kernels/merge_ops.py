"""The merge operators' column reductions: the CUDA kernels' wrappers.

Replaces the Pallas TPU kernels ``weighted_colmerge`` and
``ties_colmerge`` (``src/repro/kernels/merge_ops.py``); the kernels are
``csrc/merge_ops.cu``. The TIES thresholds (``ref.ties_thresh_ref``) are
computed by the caller outside the kernel, as in the reference. For CPU
tensors each wrapper runs its plain version (``kernels/ref.py``); for CUDA
tensors it launches its kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ties_colmerge_ref, weighted_colmerge_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "weighted_colmerge_f32": (ctypes.c_int, [_P, _P, _P, _I, _L, _P]),
    "ties_colmerge_f32": (ctypes.c_int, [_P, _P, _P, _I, _L, _P]),
}

MAX_ROWS = 32  # the kernels' bound on m (agents)


def _check(name, panel, other, other_shape):
    """Device, dtype, shape and contiguity of a CUDA call's arguments: a
    float32 (m, D) panel and a float32 second operand of ``other_shape``."""
    if panel.device != other.device:
        raise ValueError(f"{name}: arguments on {panel.device} and "
                         f"{other.device}")
    if panel.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {panel.device}")
    if panel.dtype != torch.float32 or other.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 tensors, got {panel.dtype} "
                        f"and {other.dtype}")
    if panel.dim() != 2 or not 1 <= panel.shape[0] <= MAX_ROWS \
            or panel.shape[1] < 1:
        raise ValueError(f"{name} takes an (m, D) panel with 1 <= m <= "
                         f"{MAX_ROWS}, got {tuple(panel.shape)}")
    if tuple(other.shape) != other_shape:
        raise ValueError(f"{name}: second operand must be {other_shape}, "
                         f"got {tuple(other.shape)}")
    if not (panel.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def _launch(name, fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


def weighted_colmerge(x, w):
    """x: (m, D) float32 panel; w: (m, D) float32 positive weights -> (D,)
    float32 sum_k w_kj x_kj / sum_k w_kj (the var and fisher merges)."""
    if _on_cpu(x, w):
        return weighted_colmerge_ref(x, w)
    _check("weighted_colmerge", x, w, tuple(x.shape))
    m, D = x.shape
    out = torch.empty((D,), dtype=torch.float32, device=x.device)
    lib = build.load("merge_ops", _SIGNATURES)
    _launch("weighted_colmerge", lib.weighted_colmerge_f32, x.data_ptr(),
            w.data_ptr(), out.data_ptr(), m, D,
            torch.cuda.current_stream(x.device).cuda_stream)
    weighted_colmerge.launches += 1
    return out


def ties_colmerge(tau, thresh):
    """tau: (m, D) float32 deviations; thresh: (m, 1) float32 per-row trim
    thresholds (``ref.ties_thresh_ref``) -> (D,) float32 sign-elected
    agreeing mean of the trimmed deviations (0 where nothing survives)."""
    if _on_cpu(tau, thresh):
        return ties_colmerge_ref(tau, thresh)
    _check("ties_colmerge", tau, thresh, (tau.shape[0], 1))
    m, D = tau.shape
    out = torch.empty((D,), dtype=torch.float32, device=tau.device)
    lib = build.load("merge_ops", _SIGNATURES)
    _launch("ties_colmerge", lib.ties_colmerge_f32, tau.data_ptr(),
            thresh.data_ptr(), out.data_ptr(), m, D,
            torch.cuda.current_stream(tau.device).cuda_stream)
    ties_colmerge.launches += 1
    return out


# kernel launches since the counts were last set to 0
weighted_colmerge.launches = 0
ties_colmerge.launches = 0
