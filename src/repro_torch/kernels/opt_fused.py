"""The fused AdamW step on grouped-int8 moments: decode, update and re-encode
in one sweep (``csrc/opt_fused.cu``).

Replaces the Pallas TPU kernel ``adamw_fused_int8_panel`` of
``src/repro/kernels/opt_fused.py``. The unfused path round-trips every
stored moment through a float32 panel each local step (decode, the
optimizer, encode); the kernel reads the int8 moments and their scales,
the gradient, the parameters and the uniforms once, and writes back only
the parameters, the int8 moments and their fresh scales. Every scale group
lies inside one warp's work, so the fresh amax / 127 scales are computed
and used without a second pass.

For CPU tensors the wrapper runs the plain version
(``ref.adamw_fused_int8_ref``) and copies its result into the arguments;
for CUDA tensors it launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import adamw_fused_int8_ref
from repro_torch.kernels.wire_quant import check_rows, row_stride

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_SIGNATURES = {
    "adamw_fused_int8_f32": (ctypes.c_int, [_P] * 11 + [_I, _L, _I, _I, _L,
                                                         _L, _L] + [_F] * 6
                             + [_I, _P]),
}

MAX_GROUP = 1024  # a warp holds one group, up to 32 values a lane
TRANSFORMS = {None: 0, "sqrt": 1}


def _col(a, m, device):
    """A scalar, (m,) or (m, 1) hyperparameter -> contiguous (m, 1)
    float32 column on ``device``."""
    a = torch.as_tensor(a, dtype=torch.float32, device=device)
    return a.reshape(-1, 1).expand(m, 1).contiguous()


def adamw_fused_int8(g, p, qm, sm, qv, sv, um, uv, lr, bc1, bc2, *,
                     group: int = 128, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8, weight_decay: float = 0.0,
                     transform=None):
    """One AdamW step on companded grouped-int8 moments, IN PLACE.

    g, p: (m, D) float32 gradients and parameters; qm, qv: (m, D) int8
    moments; sm, sv: (m, ceil(D / group)) float32 scales; um, uv: (m, D)
    uniforms in [0, 1) for the stochastic re-encode; lr, bc1, bc2: scalars,
    (m,) or (m, 1) per-agent columns; ``transform`` None or "sqrt"; the
    constants those of ``optim.adamw``. Writes the new p, qm, sm, qv, sv
    into the tensors given and returns them. Each tensor may be a column
    slab of whole groups of a wider panel (rows with a stride). Bit for bit
    the plain version ``ref.adamw_fused_int8_ref``."""
    if transform not in TRANSFORMS:
        raise ValueError(f"unknown transform {transform!r}")
    m, D = g.shape
    hp = dict(group=group, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              transform=transform)
    if all(t.device.type == "cpu" for t in (g, p, qm, sm, qv, sv, um, uv)):
        cols = [_col(a, m, "cpu") for a in (lr, bc1, bc2)]
        new = adamw_fused_int8_ref(g, p, qm, sm, qv, sv, um, uv, *cols, **hp)
        for dst, src in zip((p, qm, sm, qv, sv), new):
            dst.copy_(src)
        return p, qm, sm, qv, sv
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"adamw_fused_int8 runs on cpu or cuda, got {dev}")
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"adamw_fused_int8 takes groups of 1 to "
                         f"{MAX_GROUP} columns, got {group}")
    if g.dim() != 2 or m < 1 or D < 1 or D > 2 ** 31 - 1:
        raise ValueError(f"adamw_fused_int8 takes an (m, D) panel, got "
                         f"{tuple(g.shape)}")
    G = -(-D // group)
    name = "adamw_fused_int8"
    for t, dt, shape in ((g, torch.float32, (m, D)),
                         (p, torch.float32, (m, D)),
                         (qm, torch.int8, (m, D)), (qv, torch.int8, (m, D)),
                         (sm, torch.float32, (m, G)),
                         (sv, torch.float32, (m, G)),
                         (um, torch.float32, (m, D)),
                         (uv, torch.float32, (m, D))):
        check_rows(name, t, dt, shape, dev)
    ldx, lds, ldu = row_stride(g), row_stride(sm), row_stride(um)
    if {row_stride(t) for t in (p, qm, qv)} != {ldx} \
            or row_stride(sv) != lds or row_stride(uv) != ldu:
        raise ValueError(f"{name}: g, p, qm, qv share one row stride, sm "
                         "and sv another, um and uv a third")
    cols = [_col(a, m, dev) for a in (lr, bc1, bc2)]
    f32 = np.float32
    consts = [float(f32(b1)), float(f32(1 - b1)), float(f32(b2)),
              float(f32(1 - b2)), float(f32(eps)), float(f32(weight_decay))]
    lib = build.load("opt_fused", _SIGNATURES)
    rc = lib.adamw_fused_int8_f32(
        g.data_ptr(), p.data_ptr(), qm.data_ptr(), sm.data_ptr(),
        qv.data_ptr(), sv.data_ptr(), um.data_ptr(), uv.data_ptr(),
        *[c.data_ptr() for c in cols], m, D, G, group, ldx, lds, ldu,
        *consts, TRANSFORMS[transform],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    adamw_fused_int8.launches += 1
    return p, qm, sm, qv, sv


# kernel launches since the count was last set to 0
adamw_fused_int8.launches = 0
