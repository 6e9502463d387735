"""The wire codecs' kernels: int8 quantize and dequantize against a per-row
scale, and the top-k sparsifier against a per-row threshold.

Replaces the Pallas TPU kernels ``quantize_int8_panel``,
``dequantize_int8_panel`` and ``sparsify_topk_panel``
(``src/repro/kernels/wire_quant.py``); the kernels are
``csrc/wire_quant.cu``. The per-row scale (``ref.int8_scale_ref``) and
threshold (``ref.topk_threshold_ref``) are computed by the caller outside
the kernels, as in the reference. For CPU tensors each wrapper runs its
plain version (``kernels/ref.py``); for CUDA tensors it launches its kernel
or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (dequantize_int8_ref, quantize_int8_ref,
                                     sparsify_topk_ref)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "quantize_int8_f32": (ctypes.c_int, [_P, _P, _P, _P, _I, _L, _P]),
    "dequantize_int8_f32": (ctypes.c_int, [_P, _P, _P, _I, _L, _P]),
    "sparsify_topk_f32": (ctypes.c_int, [_P, _P, _P, _I, _L, _P]),
}

MAX_ROWS = 65535  # the kernels' bound on m (one grid row per agent)


def _check(name, panel, dtype, row_vec, extra=()):
    """Device, dtype, shape and contiguity of a CUDA call's arguments."""
    tensors = (panel, row_vec) + tuple(t for t in extra if t is not None)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: arguments on several devices {devs}")
    if panel.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {panel.device}")
    if panel.dtype != dtype:
        raise TypeError(f"{name} takes a {dtype} panel, got {panel.dtype}")
    if panel.dim() != 2 or not 1 <= panel.shape[0] <= MAX_ROWS \
            or panel.shape[1] < 1:
        raise ValueError(f"{name} takes an (m, D) panel with 1 <= m <= "
                         f"{MAX_ROWS}, got {tuple(panel.shape)}")
    if row_vec.dtype != torch.float32 or \
            tuple(row_vec.shape) != (panel.shape[0], 1):
        raise ValueError(f"{name} takes a float32 (m, 1) row vector, got "
                         f"{row_vec.dtype} {tuple(row_vec.shape)}")
    for t in extra:
        if t is not None and (t.dtype != torch.float32
                              or t.shape != panel.shape):
            raise ValueError(f"{name}: u must be float32 of the panel's "
                             f"shape, got {t.dtype} {tuple(t.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def _launch(name, fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _on_cpu(*tensors):
    return all(t is None or t.device.type == "cpu" for t in tensors)


def quantize_int8(x, scale, u=None):
    """x: (m, D) float32; scale: (m, 1) float32; u: (m, D) float32 uniforms
    in [0, 1) or None -> int8 (m, D) in [-127, 127]: floor(x / scale + u)
    with u, else x / scale rounded to nearest (ties to even)."""
    if _on_cpu(x, scale, u):
        return quantize_int8_ref(x, scale, u)
    _check("quantize_int8", x, torch.float32, scale, (u,))
    m, D = x.shape
    q = torch.empty((m, D), dtype=torch.int8, device=x.device)
    lib = build.load("wire_quant", _SIGNATURES)
    _launch("quantize_int8", lib.quantize_int8_f32, x.data_ptr(),
            scale.data_ptr(), None if u is None else u.data_ptr(),
            q.data_ptr(), m, D, torch.cuda.current_stream(x.device)
            .cuda_stream)
    quantize_int8.launches += 1
    return q


def dequantize_int8(q, scale):
    """q: (m, D) int8; scale: (m, 1) float32 -> float32 (m, D) q * scale."""
    if _on_cpu(q, scale):
        return dequantize_int8_ref(q, scale)
    _check("dequantize_int8", q, torch.int8, scale)
    m, D = q.shape
    y = torch.empty((m, D), dtype=torch.float32, device=q.device)
    lib = build.load("wire_quant", _SIGNATURES)
    _launch("dequantize_int8", lib.dequantize_int8_f32, q.data_ptr(),
            scale.data_ptr(), y.data_ptr(), m, D,
            torch.cuda.current_stream(q.device).cuda_stream)
    dequantize_int8.launches += 1
    return y


def sparsify_topk(x, thresh):
    """x: (m, D) float32; thresh: (m, 1) float32 -> float32 (m, D) with
    every entry below its row's threshold in magnitude set to 0 (ties at
    the threshold survive)."""
    if _on_cpu(x, thresh):
        return sparsify_topk_ref(x, thresh)
    _check("sparsify_topk", x, torch.float32, thresh)
    m, D = x.shape
    y = torch.empty((m, D), dtype=torch.float32, device=x.device)
    lib = build.load("wire_quant", _SIGNATURES)
    _launch("sparsify_topk", lib.sparsify_topk_f32, x.data_ptr(),
            thresh.data_ptr(), y.data_ptr(), m, D,
            torch.cuda.current_stream(x.device).cuda_stream)
    sparsify_topk.launches += 1
    return y


# kernel launches since the counts were last set to 0
quantize_int8.launches = 0
dequantize_int8.launches = 0
sparsify_topk.launches = 0
