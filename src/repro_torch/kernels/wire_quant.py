"""The wire codecs' kernels: int8 quantize (with supplied uniforms, or with
its uniforms drawn on the chip from a seed) and dequantize against a per-row
scale, the top-k sparsifier against a per-row threshold, the int4 family
(quantize and dequantize against grouped scales, nibble pack and unpack),
and the grouped int8 pair of the residency storages.

Replaces the Pallas TPU kernels ``quantize_int8_panel``,
``dequantize_int8_panel``, ``sparsify_topk_panel`` (``csrc/wire_quant.cu``),
``quantize_int4_panel``, ``dequantize_int4_panel``, ``pack_int4_panel``,
``unpack_int4_panel`` (``csrc/wire_int4.cu``),
``quantize_int8_grouped_panel`` and ``dequantize_int8_grouped_panel``
(``csrc/wire_int8g.cu``) and ``quantize_int8_panel_native``
(``csrc/wire_native.cu``) of ``src/repro/kernels/wire_quant.py``. The
scales (``ref.int8_scale_ref``, ``ref.int4_group_scale_ref``,
``ref.int8_group_scale_ref``) and the threshold
(``ref.topk_threshold_ref``) are computed by the caller outside the
kernels, as in the reference. For CPU tensors each wrapper runs its plain
version (``kernels/ref.py``); for CUDA tensors it launches its kernel or
raises — there is no fallback. The grouped int8 pair takes rows with a
stride, so a column slab of a wider panel is processed in place.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (NATIVE_BLOCK, dequantize_int4_ref,
                                     dequantize_int8_grouped_ref,
                                     dequantize_int8_ref, pack_int4_ref,
                                     quantize_int4_ref,
                                     quantize_int8_grouped_ref,
                                     quantize_int8_native_ref,
                                     quantize_int8_ref, sparsify_topk_ref,
                                     unpack_int4_ref)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "quantize_int8_f32": (ctypes.c_int, [_P, _P, _P, _P, _I, _L, _P]),
    "dequantize_int8_f32": (ctypes.c_int, [_P, _P, _P, _I, _L, _P]),
    "sparsify_topk_f32": (ctypes.c_int, [_P, _P, _P, _I, _L, _P]),
}
_SIGNATURES_INT4 = {
    "quantize_int4_f32": (ctypes.c_int, [_P, _P, _P, _P, _I, _L, _I, _I,
                                         _P]),
    "dequantize_int4_f32": (ctypes.c_int, [_P, _P, _P, _I, _L, _I, _I, _P]),
    "pack_int4_i8": (ctypes.c_int, [_P, _P, _I, _L, _P]),
    "unpack_int4_u8": (ctypes.c_int, [_P, _P, _I, _L, _P]),
}

_SIGNATURES_INT8G = {
    "quantize_int8g_f32": (ctypes.c_int, [_P, _P, _P, _P, _I, _L, _I, _I, _L,
                                          _L, _L, _L, _P]),
    "dequantize_int8g_f32": (ctypes.c_int, [_P, _P, _P, _I, _L, _I, _I, _L,
                                            _L, _L, _P]),
}

_SIGNATURES_NATIVE = {
    "quantize_int8_native_f32": (ctypes.c_int, [_P, _P, _P, _P, _I, _L, _I,
                                                 _L, _P]),
    "philox4x32_10_u32": (ctypes.c_int, [_P, _P, _P, _I, _P]),
}

MAX_ROWS = 65535  # the kernels' bound on m (one grid row per agent)
MAX_COLS = 2 ** 31 - 1  # the int4 kernels' bound on D (31-bit columns)


def _check(name, panel, dtype, scale=None, cols=1, extra=()):
    """Device, dtype, shape and contiguity of a CUDA call's arguments:
    ``scale`` (the scale or threshold) is float32 (m, cols), every tensor
    of ``extra`` float32 of the panel's shape."""
    tensors = tuple(t for t in (panel, scale) + tuple(extra)
                    if t is not None)
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
    if scale is not None and (scale.dtype != torch.float32 or tuple(
            scale.shape) != (panel.shape[0], cols)):
        raise ValueError(f"{name} takes float32 ({panel.shape[0]}, {cols}) "
                         f"scales, got {scale.dtype} {tuple(scale.shape)}")
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
    _check("quantize_int8", x, torch.float32, scale, extra=(u,))
    m, D = x.shape
    q = torch.empty((m, D), dtype=torch.int8, device=x.device)
    lib = build.load("wire_quant", _SIGNATURES)
    _launch("quantize_int8", lib.quantize_int8_f32, x.data_ptr(),
            scale.data_ptr(), None if u is None else u.data_ptr(),
            q.data_ptr(), m, D, torch.cuda.current_stream(x.device)
            .cuda_stream)
    quantize_int8.launches += 1
    return q


def quantize_int8_native(x, scale, seed, row0: int = 0, col0: int = 0):
    """x: (m, D) float32; scale: (m, 1) float32; seed: a 1-element int32
    tensor on x's device -> int8 (m, D) in [-127, 127]: floor(x / scale + u)
    with u drawn inside the kernel by Philox4x32-10 from (seed, the 512-column
    block) and (row, column) (``ref.native_uniforms_ref``); no uniform panel
    is read or made. The seed stays on the device: nothing waits for the
    host. ``x`` may be the block of a wider panel whose first row is
    ``row0`` and first column ``col0`` (a multiple of 512: a rank's shard):
    the block then quantizes to the wider panel's bits."""
    if col0 % NATIVE_BLOCK or row0 < 0 or col0 < 0:
        raise ValueError(f"quantize_int8_native takes a block at row0 >= 0 "
                         f"and a column col0 that is a multiple of "
                         f"{NATIVE_BLOCK}, got ({row0}, {col0})")
    if _on_cpu(x, scale, seed):
        return quantize_int8_native_ref(x, scale, seed, row0=row0, col0=col0)
    _check("quantize_int8_native", x, torch.float32, scale)
    if seed.device != x.device or seed.dtype != torch.int32 \
            or seed.numel() != 1:
        raise ValueError(f"quantize_int8_native takes a 1-element int32 seed "
                         f"on {x.device}, got {seed.dtype} "
                         f"{tuple(seed.shape)} on {seed.device}")
    m, D = x.shape
    _check_cols("quantize_int8_native", col0 + D)
    q = torch.empty((m, D), dtype=torch.int8, device=x.device)
    lib = build.load("wire_native", _SIGNATURES_NATIVE)
    _launch("quantize_int8_native", lib.quantize_int8_native_f32,
            x.data_ptr(), scale.data_ptr(), seed.data_ptr(), q.data_ptr(), m,
            D, row0, col0, torch.cuda.current_stream(x.device).cuda_stream)
    quantize_int8_native.launches += 1
    return q


def philox4x32(ctr, key):
    """The native quantize's Philox4x32-10 on the card, for checks: ctr
    (n, 4) and key (n, 2) int32 CUDA tensors holding uint32 bits -> (n, 4)
    int32 words. Not a kernel of any path (no launch count)."""
    n = ctr.shape[0]
    if ctr.device.type != "cuda" or ctr.shape != (n, 4) \
            or key.shape != (n, 2) or ctr.dtype != torch.int32 \
            or key.dtype != torch.int32:
        raise ValueError("philox4x32 takes int32 CUDA (n, 4) counters and "
                         "(n, 2) keys")
    out = torch.empty((n, 4), dtype=torch.int32, device=ctr.device)
    lib = build.load("wire_native", _SIGNATURES_NATIVE)
    _launch("philox4x32", lib.philox4x32_10_u32, ctr.contiguous().data_ptr(),
            key.contiguous().data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(ctr.device).cuda_stream)
    return out


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


def _n_groups(D, group):
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    return -(-D // group)


def _check_cols(name, D):
    if D > MAX_COLS:
        raise ValueError(f"{name} takes at most {MAX_COLS} columns, got {D}")


def quantize_int4(x, scale, u=None, group: int = 128):
    """x: (m, D) float32; scale: (m, ceil(D / group)) float32 grouped
    scales; u: (m, D) float32 uniforms in [0, 1) or None -> int8 (m, D) in
    [-7, 7]: floor(x / s + u) with u, else x / s rounded to nearest (ties
    to even), s the scale of the column's group."""
    if _on_cpu(x, scale, u):
        return quantize_int4_ref(x, scale, u, group)
    _check("quantize_int4", x, torch.float32, scale,
           _n_groups(x.shape[-1], group), (u,))
    m, D = x.shape
    _check_cols("quantize_int4", D)
    q = torch.empty((m, D), dtype=torch.int8, device=x.device)
    lib = build.load("wire_int4", _SIGNATURES_INT4)
    _launch("quantize_int4", lib.quantize_int4_f32, x.data_ptr(),
            scale.data_ptr(), None if u is None else u.data_ptr(),
            q.data_ptr(), m, D, scale.shape[1], group,
            torch.cuda.current_stream(x.device).cuda_stream)
    quantize_int4.launches += 1
    return q


def dequantize_int4(q, scale, group: int = 128):
    """q: (m, D) int4-valued int8; scale: (m, ceil(D / group)) float32 ->
    float32 (m, D) q * s, s the scale of the column's group."""
    if _on_cpu(q, scale):
        return dequantize_int4_ref(q, scale, group)
    _check("dequantize_int4", q, torch.int8, scale,
           _n_groups(q.shape[-1], group))
    m, D = q.shape
    _check_cols("dequantize_int4", D)
    y = torch.empty((m, D), dtype=torch.float32, device=q.device)
    lib = build.load("wire_int4", _SIGNATURES_INT4)
    _launch("dequantize_int4", lib.dequantize_int4_f32, q.data_ptr(),
            scale.data_ptr(), y.data_ptr(), m, D, scale.shape[1], group,
            torch.cuda.current_stream(q.device).cuda_stream)
    dequantize_int4.launches += 1
    return y


def pack_int4(q):
    """(m, D) int4-valued int8 -> (m, ceil(D / 2)) uint8 packed nibbles,
    row by row: the even column in the low nibble, an odd tail against a
    zero nibble (the wire's byte layout)."""
    if _on_cpu(q):
        return pack_int4_ref(q)
    _check("pack_int4", q, torch.int8)
    m, D = q.shape
    _check_cols("pack_int4", D)
    p = torch.empty((m, (D + 1) // 2), dtype=torch.uint8, device=q.device)
    lib = build.load("wire_int4", _SIGNATURES_INT4)
    _launch("pack_int4", lib.pack_int4_i8, q.data_ptr(), p.data_ptr(), m, D,
            torch.cuda.current_stream(q.device).cuda_stream)
    pack_int4.launches += 1
    return p


def unpack_int4(p, D: int):
    """(m, ceil(D / 2)) uint8 packed nibbles -> (m, D) int8, each nibble
    sign-extended: the exact inverse of :func:`pack_int4` on [-8, 7]."""
    if _on_cpu(p):
        return unpack_int4_ref(p, D)
    _check("unpack_int4", p, torch.uint8)
    m = p.shape[0]
    if D < 1 or p.shape[1] != (D + 1) // 2:
        raise ValueError(f"unpack_int4: {tuple(p.shape)} packed bytes do "
                         f"not hold D = {D} columns")
    _check_cols("unpack_int4", D)
    q = torch.empty((m, D), dtype=torch.int8, device=p.device)
    lib = build.load("wire_int4", _SIGNATURES_INT4)
    _launch("unpack_int4", lib.unpack_int4_u8, p.data_ptr(), q.data_ptr(), m,
            D, torch.cuda.current_stream(p.device).cuda_stream)
    unpack_int4.launches += 1
    return q


def check_rows(name, t, dtype, shape, device):
    """A CUDA operand given as rows with a stride: ``dtype`` of ``shape``
    on ``device``, unit column stride (a column slab of a wider panel is
    fine) and rows that do not overlap."""
    if t.device != device:
        raise ValueError(f"{name}: arguments on several devices "
                         f"{{{t.device}, {device}}}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} takes {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1) \
            or (t.shape[0] > 1 and t.stride(0) < t.shape[1]):
        raise ValueError(f"{name} takes rows with a unit column stride, "
                         f"got strides {t.stride()}")


def row_stride(t):
    """The row stride (leading dimension) a kernel is given for ``t``."""
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _grouped_panel(name, x, dtype, group):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {x.device}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS or x.shape[1] < 1:
        raise ValueError(f"{name} takes an (m, D) panel with 1 <= m <= "
                         f"{MAX_ROWS}, got {tuple(x.shape)}")
    _check_cols(name, x.shape[1])
    m, D = x.shape
    G = _n_groups(D, group)
    check_rows(name, x, dtype, (m, D), x.device)
    return m, D, G


def quantize_int8_grouped(x, scale, u=None, group: int = 128, out=None):
    """x: (m, D) float32; scale: (m, ceil(D / group)) float32 grouped
    scales; u: (m, D) float32 uniforms in [0, 1) or None -> int8 (m, D) in
    [-127, 127]: floor(x / s + u) with u, else x / s rounded to nearest
    (ties to even), s the scale of the column's group.

    Every tensor may be a column slab of a wider panel (rows with a stride,
    unit column stride), so a slab of whole groups is quantized in place;
    ``out`` (int8 (m, D)) receives q when given."""
    if _on_cpu(x, scale, u, out):
        q = quantize_int8_grouped_ref(x, scale, u, group)
        return q if out is None else out.copy_(q)
    m, D, G = _grouped_panel("quantize_int8_grouped", x, torch.float32,
                             group)
    check_rows("quantize_int8_grouped", scale, torch.float32, (m, G),
               x.device)
    if u is not None:
        check_rows("quantize_int8_grouped", u, torch.float32, (m, D),
                   x.device)
    if out is None:
        out = torch.empty((m, D), dtype=torch.int8, device=x.device)
    check_rows("quantize_int8_grouped", out, torch.int8, (m, D), x.device)
    lib = build.load("wire_int8g", _SIGNATURES_INT8G)
    _launch("quantize_int8_grouped", lib.quantize_int8g_f32, x.data_ptr(),
            scale.data_ptr(), None if u is None else u.data_ptr(),
            out.data_ptr(), m, D, G, group, row_stride(x),
            row_stride(scale), 0 if u is None else row_stride(u),
            row_stride(out), torch.cuda.current_stream(x.device).cuda_stream)
    quantize_int8_grouped.launches += 1
    return out


def dequantize_int8_grouped(q, scale, group: int = 128, out=None):
    """q: (m, D) int8; scale: (m, ceil(D / group)) float32 -> float32
    (m, D) q * s, s the scale of the column's group (into ``out`` when
    given). Strided rows are taken as by :func:`quantize_int8_grouped`."""
    if _on_cpu(q, scale, out):
        y = dequantize_int8_grouped_ref(q, scale, group)
        return y if out is None else out.copy_(y)
    m, D, G = _grouped_panel("dequantize_int8_grouped", q, torch.int8,
                             group)
    check_rows("dequantize_int8_grouped", scale, torch.float32, (m, G),
               q.device)
    if out is None:
        out = torch.empty((m, D), dtype=torch.float32, device=q.device)
    check_rows("dequantize_int8_grouped", out, torch.float32, (m, D),
               q.device)
    lib = build.load("wire_int8g", _SIGNATURES_INT8G)
    _launch("dequantize_int8_grouped", lib.dequantize_int8g_f32,
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, D, G, group,
            row_stride(q), row_stride(scale), row_stride(out),
            torch.cuda.current_stream(q.device).cuda_stream)
    dequantize_int8_grouped.launches += 1
    return out


# kernel launches since the counts were last set to 0
quantize_int8.launches = 0
quantize_int8_native.launches = 0
dequantize_int8.launches = 0
sparsify_topk.launches = 0
quantize_int4.launches = 0
dequantize_int4.launches = 0
pack_int4.launches = 0
unpack_int4.launches = 0
quantize_int8_grouped.launches = 0
dequantize_int8_grouped.launches = 0
