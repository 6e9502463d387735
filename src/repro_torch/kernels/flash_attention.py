"""Flash attention, forward and backward: the CUDA kernels' wrappers.

Replaces the Pallas TPU kernel ``flash_attention_bh``
(``src/repro/kernels/flash_attention.py``) and its GQA wrapper
(``src/repro/kernels/ops.py:flash_attention``); the kernels are
``csrc/flash_attention.cu`` (float32) and ``csrc/flash_attention16.cu``
(bfloat16, float16): a forward kernel that also writes the
float32 log-sum-exp of each row, and a backward pass (a row-sum kernel,
then dK/dV and dQ), which the Pallas kernel does not have.
``FlashAttention`` ties the two together for autograd, and
``blockwise_attention`` is the route of ``models/attention.py`` when
``cfg.dist.attn_block > 0``.

For CPU tensors the wrappers run the plain versions
(``kernels/ref.py:flash_attention_ref`` and its forward/backward
companions); for CUDA tensors they launch the kernels or raise — there is
no fallback. The kernels take float32, bfloat16 and float16, forward and
backward (one library an element type; q, k, v, out, dO and the gradients
in that type, the log-sum-exp, the row sums and every sum float32, each
output rounded once), head dims 16, 32, 64, 96, 128 and 256, and (B, S,
heads, hd) tensors with hd contiguous and any other strides whose rows
start on 16 bytes (their tiles stream through 16-byte ``cp.async``; a
tensor whose base or strides break that is copied).

float32 (``csrc/flash_attention.cu``): products in split TF32 (three TF32
products a float32 product, see the source's note), so the results keep
the plain versions' tolerances. At hd 256 the forward and the backward
run 8-warp blocks of warp pairs, each warp a half of the columns, S (and
dP) computed once a pair; the dK/dV kernel takes two key tiles a block
and, where that leaves the grid short of two blocks an SM (MQA: gemma-2b,
recurrentgemma-2b), a part of each group's query heads (``bwd_parts``),
writing partial sums to a float32 workspace that the wrapper allocates
(parts x 2 x k's elements; 64 MiB at gemma's B 2, S 2048) and a second
kernel adds in order.

bfloat16 and float16 (``csrc/flash_attention16.cu``, built as
``csrc/flash_attention_bf16.cu`` / ``_f16.cu``): 16-bit tiles from device
memory to the tensor cores by ``cp.async``, products with float32 sums:
the forward by ``wgmma`` (warpgroups of 64 query rows, Q and K from
shared memory in its 128-byte swizzle, hd 16, 32 and 96 in whole 64-column
atoms, P from registers), the backward by ``mma.sync.m16n8k16`` from
``ldmatrix`` fragments; P rounded once to
v's type and dS to the inputs' type before their products, S and dP
float32, each output rounded once (nearer the float32 yardstick than the
plain 16-bit version, which rounds every einsum). dK/dV holds both
accumulators in registers up to hd 128; at hd 256 it runs two column
blocks and a ``bwd_parts`` workspace of its own grid's parts (32 MiB at
gemma's B 2, S 2048). Tiles of 32 to 128 query rows by 32 or 64 keys (see
the source); the plain version's ``block`` is the
key block of its loop, which the kernels do not need.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_fwd_ref,
                                     flash_attention_ref)

HEAD_DIMS = (16, 32, 64, 96, 128, 256)
TILE = 64  # the plain versions' key block on the CPU (the kernels' rows)
SMS = 132  # the H100's SMs, which the hd-256 dK/dV grid is sized for

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "flash_attention_fwd": (_I, [_P] * 7 + [_I] * 8
                            + [ctypes.c_float, _STRIDES, _P]),
    "flash_attention_bwd": (_I, [_P] * 13 + [_I] * 9
                            + [ctypes.c_float, _STRIDES, _P]),
    "flash_attention_occupancy": (_I, [_I, _I, _P]),
}
# each element type's library (csrc/<name>.cu), and the launch counters'
# suffixes of the 16-bit ones
LIBRARIES = {torch.float32: "flash_attention",
             torch.bfloat16: "flash_attention_bf16",
             torch.float16: "flash_attention_f16"}
_SUFFIX = {torch.bfloat16: "bf16", torch.float16: "f16"}
# a library's kernels, in the order flash_attention_occupancy reports
KERNELS = ("forward", "dK/dV", "dQ")


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def _window(window):
    """None -> -1 (the kernels' "no window"); a window must be >= 1."""
    if window is None:
        return -1
    if window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    return int(window)


def _rows(t):
    """``t`` itself when the kernels can read it in place: its last dim
    contiguous, its base and the strides of its other dims (those longer
    than 1) on 16 bytes, the rows' 16-byte copies; else a contiguous copy
    in a new allocation (``contiguous()`` would keep a misaligned base)."""
    step = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % step == 0 for s, n in zip(t.stride()[:-1],
                                                  t.shape[:-1]) if n > 1)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def bwd_parts(B, Sk, H, Kv, hd, dtype=torch.float32):
    """The parts into which the hd-256 dK/dV kernel of ``dtype``'s library
    splits each group's G = H / Kv query heads (1 up to hd 128, whose
    kernels take the whole group): the fewest, a divisor of G, that give
    its grid two blocks an SM, else G. A part's grid is B * Kv blocks of
    ceil(ceil(Sk / 64) / 2) key-tile pairs (float32) or of ceil(Sk / 64)
    key tiles by two column blocks (bfloat16, float16). Each part's block
    writes partial dK and dV sums to a float32 workspace, which a second
    kernel adds in ascending order of the part."""
    G = H // Kv
    if hd <= 128:
        return 1
    tiles = -(-Sk // TILE)
    base = B * Kv * (2 * tiles if dtype in _SUFFIX else (tiles + 1) // 2)
    return next((d for d in range(1, G + 1)
                 if G % d == 0 and base * d >= 2 * SMS), G)


def _positions(pos, B, S, device):
    """``pos`` as the kernels read it: int32 (B, S), contiguous, on
    ``device`` (itself when it is so already)."""
    if (pos.dtype == torch.int32 and pos.device == device
            and tuple(pos.shape) == (B, S) and pos.is_contiguous()):
        return pos
    return torch.broadcast_to(pos, (B, S)).to(device=device,
                                              dtype=torch.int32).contiguous()


def _both_positions(q_pos, k_pos, B, Sq, Sk, device):
    """The queries' and the keys' positions as the kernels read them; one
    tensor for both where the caller passed one."""
    qp = _positions(q_pos, B, Sq, device)
    if k_pos is q_pos and Sk == Sq:
        return qp, qp
    return qp, _positions(k_pos, B, Sk, device)


def _check(q, k, v):
    if q.dtype not in LIBRARIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32, bfloat16 or float16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention takes q (B, Sq, H, hd) and k, v "
                         f"(B, Sk, Kv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, Kv, hk = k.shape
    if k.shape[0] != B or hk != hd or H % Kv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         f"not match (batch, head dim, H % Kv == 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash attention kernels take head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if min(B, Sq, Sk) < 1 or max(B, H) > 65535:
        raise ValueError(f"flash attention shape out of range: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(dtype, entry, *args):
    lib = build.load(LIBRARIES[dtype], _SIGNATURES)
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{entry} ({dtype}) kernel launch failed: CUDA "
                           f"error {rc}")


def _count(fn, dtype):
    """One launch of ``fn`` on ``dtype``: its total and, for a 16-bit type,
    that type's own counter."""
    fn.launches += 1
    if dtype in _SUFFIX:
        name = f"launches_{_SUFFIX[dtype]}"
        setattr(fn, name, getattr(fn, name) + 1)


def flash_attention_fwd(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                        scale=None):
    """q (B, Sq, H, hd), k, v (B, Sk, Kv, hd), float32, bfloat16 or
    float16; positions (B, Sq), (B, Sk) -> (out (B, Sq, H, hd) in q's
    dtype, lse (B, H, Sq) float32). One launch of the forward kernel."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, q_pos, k_pos, causal=causal,
                                       window=window, scale=scale,
                                       block=TILE)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, got "
                         f"{q.device}")
    _check(q, k, v)
    q, k, v = _rows(q), _rows(k), _rows(v)
    B, Sq, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    qp, kp = _both_positions(q_pos, k_pos, B, Sq, Sk, q.device)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch(q.dtype, "flash_attention_fwd", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), qp.data_ptr(), kp.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, H, Kv, Sq, Sk, hd, int(causal),
            _window(window), scale, _strides(q, k, v, out), stream)
    _count(flash_attention_fwd, q.dtype)
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, q_pos, k_pos, *,
                        causal=True, window=None, scale=None):
    """The backward pass of ``flash_attention_fwd``: (dq, dk, dv) in q's
    dtype (float32, bfloat16 or float16), shaped as q, k, v. ``out`` and
    ``lse`` are the forward's outputs, ``dout`` the gradient of ``out``
    (both in q's dtype; lse float32). One launch of the backward pass (its
    row-sum, dK/dV and dQ kernels; at hd 256 with the heads split, the
    reduction of dK/dV's float32 partial sums too)."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, q_pos, k_pos,
                                       causal=causal, window=window,
                                       scale=scale, block=TILE)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, got "
                         f"{q.device}")
    _check(q, k, v)
    if out.dtype != q.dtype or dout.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise TypeError(f"the flash attention backward takes out and dout in "
                        f"q's dtype and a float32 lse, got {q.dtype} inputs, "
                        f"a {out.dtype} output, a {lse.dtype} lse and a "
                        f"{dout.dtype} gradient")
    B, Sq, H, hd = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    if (dout.shape != q.shape or out.shape != q.shape
            or lse.shape != (B, H, Sq)):
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be shaped as q "
                         f"{tuple(q.shape)}, lse {tuple(lse.shape)} as "
                         f"{(B, H, Sq)}")
    if any(t.device != q.device for t in (out, lse, dout)):
        raise ValueError("out, lse and dout must lie on q's device")
    q, k, v, out, dout = (_rows(t) for t in (q, k, v, out, dout))
    qp, kp = _both_positions(q_pos, k_pos, B, Sq, Sk, q.device)
    lse = lse.contiguous()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    parts = bwd_parts(B, Sk, H, Kv, hd, q.dtype)
    # dK/dV's float32 partial sums over the heads' parts: at hd 256 with
    # the heads split (added in order, and rounded once, by the reduction)
    ws = (torch.empty(parts * 2 * k.numel(), dtype=torch.float32,
                      device=q.device) if hd > 128 and parts > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launch(q.dtype, "flash_attention_bwd", q.data_ptr(), k.data_ptr(),
            v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), qp.data_ptr(), kp.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if ws is None else ws.data_ptr(), B, H, Kv,
            Sq, Sk, hd, int(causal), _window(window), parts, scale,
            _strides(q, k, v, out, dout, dq, dk, dv), stream)
    _count(flash_attention_bwd, q.dtype)
    return dq, dk, dv


def occupancy(hd, S):
    """{"<kernel> <dtype>": {"blocks_per_sm", "smem", "registers",
    "local_bytes", "threads", "warps_per_sm"}} of the forward, dK/dV and dQ
    kernels of each element type (float32, bfloat16, float16) at head dim
    ``hd`` and sequence length ``S``: blocks per SM and dynamic shared
    memory bytes from the CUDA runtime's occupancy calculator, registers
    and local memory bytes (spills) a thread from its function attributes,
    threads a block, and the warps per SM they make. Needs a card;
    launches nothing."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash attention kernels take head dims "
                         f"{HEAD_DIMS}, got {hd}")
    keys = ("blocks_per_sm", "smem", "registers", "local_bytes", "threads")
    out = {}
    for dtype in LIBRARIES:
        res = (ctypes.c_int * 15)()
        _launch(dtype, "flash_attention_occupancy", hd, S,
                ctypes.addressof(res))
        for i, name in enumerate(KERNELS):
            r = dict(zip(keys, res[5 * i:5 * i + 5]))
            r["warps_per_sm"] = r["blocks_per_sm"] * r["threads"] // 32
            out[f"{name} {str(dtype)[6:]}"] = r
    return out


# kernel launches since the counts were last set to 0 (all types), and the
# bfloat16 and float16 launches' own counts
for _fn in (flash_attention_fwd, flash_attention_bwd):
    _fn.launches = _fn.launches_bf16 = _fn.launches_f16 = 0


class FlashAttention(torch.autograd.Function):
    """Attention through the kernels on the card: the forward kernel, and
    the backward kernels for the gradient of q, k and v (none for the
    positions)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, scale):
        # the positions converted once, for the forward and the backward
        q_pos, k_pos = _both_positions(q_pos, k_pos, q.shape[0], q.shape[1],
                                       k.shape[1], q.device)
        out, lse = flash_attention_fwd(q, k, v, q_pos, k_pos, causal=causal,
                                       window=window, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, k_pos)
        ctx.opts = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, k_pos = ctx.saved_tensors
        causal, window, scale = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, q_pos,
                                         k_pos, causal=causal, window=window,
                                         scale=scale)
        return dq, dk, dv, None, None, None, None, None


def blockwise_attention(q, k, v, q_pos, k_pos, *, causal=True, window=None,
                        scale=None, block=TILE):
    """Online-softmax attention, differentiable. q (B, Sq, H, hd), k, v
    (B, Sk, Kv, hd), positions (B, Sq), (B, Sk) -> (B, Sq, H, hd). CPU
    tensors: the plain loop over key blocks of ``block``
    (``flash_attention_ref``), through torch autograd; CUDA tensors:
    ``FlashAttention``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                   window=window, scale=scale, block=block)
    return FlashAttention.apply(q, k, v, q_pos, k_pos, causal, window,
                                _scale(q, scale))


def flash_attention_bh(q, k, v, *, causal=True, window=None, scale=None,
                       block_q=128, block_k=128):
    """The counterpart of the reference's ``flash_attention_bh``: q, k, v
    (BH, S, hd), batch and heads merged -> (BH, S, hd). ``block_k`` is the
    plain version's key block (``block_q`` is accepted for signature
    parity); unlike the Pallas kernel, S need not be a multiple of either."""
    BH, S, _ = q.shape
    pos = torch.arange(S, dtype=torch.int32, device=q.device).expand(BH, S)
    out = blockwise_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                              pos, pos, causal=causal, window=window,
                              scale=scale, block=min(block_k, S))
    return out[:, :, 0]


def flash_attention(q, k, v, *, causal=True, window=None, block_q=128,
                    block_k=128):
    """The counterpart of the reference's ``kernels/ops.py:flash_attention``:
    q (B, S, H, hd), k, v (B, S, Kv, hd) with H % Kv == 0 -> (B, S, H, hd),
    scale 1 / sqrt(hd). GQA by index: K and V are not expanded."""
    B, S = q.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=q.device).expand(B, S)
    return blockwise_attention(q, k, v, pos, pos, causal=causal,
                               window=window, block=min(block_k, S))
