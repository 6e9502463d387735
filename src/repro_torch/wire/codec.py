"""Wire codecs: compression of the gossip payload (counterpart of
``repro/wire/codec.py``).

A codec decides how one dtype group's (m, D_g) panel travels during a
communication op without changing the state's storage dtype:

    xw, back, new_err = codec.encode(x, gen=..., err=..., u=...)

``xw`` is what the mix runs on — the receive-side view of the payload (for
``int8`` the dequantized panel, quantization error baked in; for ``topk``
the updated MIRROR panel). ``back`` restores the storage dtype after the
mix. ``new_err`` is the updated error-feedback state (``err`` passed through
untouched by residual-free codecs; a codec with error feedback REQUIRES
``err`` and raises without it).

Codecs (``CODECS``, the reference's registry):

* ``f32`` — identity: the payload is the storage dtype as it is.
* ``bf16`` — cast to bfloat16 for the exchange; the mix reads the bf16
  payload with float32 accumulation and its rows are cast back.
* ``int8`` — per-row (per-agent) symmetric scales amax/127 and stochastic
  rounding, 4x fewer payload bytes than f32. ``int8_ef`` adds error
  feedback: the residual (x + e) - dequant(quant(x + e)) is returned for the
  caller to carry (the engine keeps it as ``state["wire_err"]``).
* ``int4`` — packed nibbles (two values per wire byte, even column in the
  low nibble) against grouped scales, one float32 amax/7 per row per
  ``group`` (128) columns; stochastic rounding as int8, ``int4_ef`` adds the
  same error feedback. Encode rebuilds the mixing view from the actual wire
  bytes (quantize -> pack -> unpack -> dequantize), never from the unpacked
  values.
* ``topk`` — per-row top-k-by-magnitude sparse payload over a MIRROR panel
  x̂ (CHOCO style): ``err`` carries the mirror, seeded with a copy of the
  panel (``init_err``); each encode transmits the k largest entries of the
  innovation x - x̂ and returns the updated mirror x̂ + q as both the mixing
  view and ``new_err``. ``delta_mix`` tells the engine to mix as
  ``x + gamma (W - I) @ x̂``.

Randomness: stochastic rounding draws ``u`` uniform in [0, 1) with
``torch.rand`` from a ``torch.Generator`` (``gen=``) on the panel's device,
or takes the uniforms explicitly (``u=``, how the tests feed the
reference's draws). The port cannot reproduce ``jax.random``'s bits. An
``Int8Codec`` built with ``draws="kernel"`` (an instance, given to
``panel.with_wire``; no registry name) draws instead one int32 seed a call
from ``gen`` and quantizes through ``quantize_int8_native``, whose kernel
draws the uniforms on the chip: no (m, D) uniform panel is made.

Kernels: quantize, dequantize, pack, unpack and sparsify go through the
wrappers of ``kernels/wire_quant.py`` (the CUDA kernels on the card, the
plain versions on the CPU); the scales and the top-k threshold are plain
torch row passes, as the reference leaves them to XLA.

Sharded panels: ``encode(..., shard=)`` takes a rank's block of a group's
(m, D) panel (``panel.Shard``: its rows and columns in the panel and the
collectives over the ``fsdp`` line) and gives that block of what encode of
the whole panel gives, bit for bit: the per-row int8 scale is the max of
the column shards' amax over ``fsdp``; the uniforms of the generator route
are the whole (m, D) panel's, drawn and cut to the block (an (m, D)
float32 transient: at full width use the kernel's draws), ``u=`` of the
whole panel's shape is cut alike, and the kernel's draws take the block's
panel row and column (``quantize_int8_native(row0=, col0=)``, the first
column a multiple of 512); int4's group scales and nibble pairs are local
when every shard starts on a group boundary (``panel.shard_spec`` refuses
any other split); top-k takes k of the whole row width and its threshold
from the whole row: the row's |innovation| gathered over ``fsdp`` up to
``thresh_sample`` columns, beyond it the strided subsample in panel
columns, each rank's part gathered in column order.

Byte accounting: ``payload_bytes`` counts the transmitted values alone,
``total_bytes`` adds scales (per row for int8, per row and group for int4)
and packed top-k indices, and ``wire_payload``
builds the actual wire arrays, whose ``.nbytes`` the tests hold against
both.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import (amax_scale, int4_group_scale_ref,
                                     row_amax, topk_threshold_ref)
from repro_torch.kernels.wire_quant import (dequantize_int4, dequantize_int8,
                                            pack_int4, quantize_int4,
                                            quantize_int8,
                                            quantize_int8_native,
                                            sparsify_topk, unpack_int4)


def _identity(y):
    return y


def _storage_back(dtype):
    """back() for a codec whose mixing view is float32: restore storage."""
    if dtype == torch.float32:
        return _identity
    return lambda y: y.to(dtype)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from itself or its name ('float32')."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _itemsize(dtype) -> int:
    """Bytes per scalar of a torch dtype or a dtype name ('float32')."""
    return torch.empty((), dtype=_torch_dtype(dtype)).element_size()


class Codec:
    """Shared codec contract defaults (see the module docstring)."""

    needs_key = False
    error_feedback = False
    delta_mix = False

    def payload_bytes(self, rows: int, width: int, dtype) -> int:
        """Wire bytes of the transmitted VALUES alone for (rows, width)."""
        raise NotImplementedError

    def total_bytes(self, rows: int, width: int, dtype) -> int:
        """payload_bytes plus scale/index metadata — the full wire cost."""
        return self.payload_bytes(rows, width, dtype)

    def residual(self, x, err):
        """Effective error-feedback residual given the carried ``err``."""
        return err

    def init_err(self, x):
        """Initial error-feedback state of one (m, D_g) group panel: zeros
        for residual codecs (the topk mirror starts as a copy)."""
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

    def wire_payload(self, x, gen=None, err=None, u=None):
        """The actual wire arrays: (payload list, metadata list)."""
        raise NotImplementedError


class F32Codec(Codec):
    """Identity codec: the payload is the storage dtype, untouched."""
    name = "f32"

    def payload_bytes(self, rows: int, width: int, dtype) -> int:
        return rows * width * _itemsize(dtype)

    def encode(self, x, gen=None, err=None, u=None, shard=None):
        return x, _identity, err

    def wire_payload(self, x, gen=None, err=None, u=None):
        return [x], []


class DtypeCodec(Codec):
    """Cast-only codec (the reference's legacy ``wire_dtype`` lever): the
    payload travels as ``wire_dtype``, the mix reads it with float32
    accumulation, and ``back`` casts the result to the storage dtype."""

    def __init__(self, wire_dtype, name: str):
        self.wire_dtype = _torch_dtype(wire_dtype)
        self.name = name

    def payload_bytes(self, rows: int, width: int, dtype) -> int:
        return rows * width * _itemsize(self.wire_dtype)

    def encode(self, x, gen=None, err=None, u=None, shard=None):
        if x.dtype == self.wire_dtype:
            return x, _identity, err
        dtype = x.dtype
        return x.to(self.wire_dtype), lambda y: y.to(dtype), err

    def wire_payload(self, x, gen=None, err=None, u=None):
        return [x.to(self.wire_dtype)], []


def _require_err(codec, err):
    if codec.error_feedback and err is None:
        raise ValueError(
            f"codec '{codec.name}' uses error feedback and needs the "
            "residual panel (err=...); a silent fallback would drop the "
            "accumulated correction")


class _Quantized(Codec):
    """What the int8 and int4 codecs share: stochastic rounding (drawn
    from ``gen`` or given as ``u``) and error feedback (the residual
    returned to the caller)."""
    SCALE_BYTES = 4  # one float32 per scale

    def __init__(self, name: str, stochastic: bool = True,
                 error_feedback: bool = False):
        self.name = name
        self.stochastic = stochastic
        self.error_feedback = error_feedback

    @property
    def needs_key(self) -> bool:
        return self.stochastic

    def _carry_in(self, x, err):
        """The transmitted quantity: x, plus the residual for the EF
        variant (a new tensor then; a residual-free codec ignores err)."""
        x32 = x.to(torch.float32)
        if self.error_feedback and err is not None:
            x32 = x32 + err
        return x32

    def _uniforms(self, x32, gen, u, shard=None):
        """The stochastic rounding's uniforms (None rounds to nearest); on
        a ``shard`` the whole panel's, cut to the rank's block."""
        if not self.stochastic:
            return None
        if u is not None:
            return u if shard is None else shard.block(u)
        if gen is None:
            raise ValueError(
                f"codec '{self.name}' uses stochastic rounding and needs "
                "a torch.Generator (gen=...) or the uniforms (u=...)")
        if shard is None:
            return torch.rand(x32.shape, generator=gen, dtype=torch.float32,
                              device=x32.device)
        full = torch.rand((shard.m, shard.D), generator=gen,
                          dtype=torch.float32, device=x32.device)
        return shard.block(full)

    def _finish(self, x, x32, xhat32, err):
        """(view, back, new_err) of encode from the received panel."""
        if self.error_feedback and err is not None:
            # x32 is the fresh x + err: it becomes the new residual in place
            new_err = x32.sub_(xhat32)
        else:
            new_err = err
        if x.dtype == torch.float32:
            return xhat32, _identity, new_err
        return xhat32.to(x.dtype), _identity, new_err


class Int8Codec(_Quantized):
    """int8 payload with one scale per row.

    ``draws`` picks where stochastic rounding's uniforms come from:
    "generator" (the default, the reference's route) draws the (m, D)
    panel from ``gen`` (or takes ``u=``); "kernel" draws one int32 seed a
    call from ``gen`` on the panel's device and lets the
    ``quantize_int8_native`` kernel draw the uniforms (``u=`` is then
    refused)."""

    def __init__(self, name: str, stochastic: bool = True,
                 error_feedback: bool = False, draws: str = "generator"):
        super().__init__(name, stochastic, error_feedback)
        if draws not in ("generator", "kernel"):
            raise ValueError(f"draws must be 'generator' or 'kernel', got "
                             f"{draws!r}")
        self.draws = draws

    def payload_bytes(self, rows: int, width: int, dtype) -> int:
        return rows * width

    def total_bytes(self, rows: int, width: int, dtype) -> int:
        return rows * (width + self.SCALE_BYTES)

    def _scale(self, x32, shard):
        """Per-row amax / 127; on a shard the amax of the whole row (the
        column shards' max over ``fsdp``)."""
        amax = row_amax(x32)
        return amax_scale(amax if shard is None else shard.col_max(amax))

    def _quantize(self, x32, gen, u, shard=None):
        if self.stochastic and self.draws == "kernel":
            if u is not None:
                raise ValueError(
                    f"codec '{self.name}' draws its uniforms in the kernel "
                    "(draws='kernel') and takes no u=")
            if gen is None:
                raise ValueError(
                    f"codec '{self.name}' uses stochastic rounding and needs "
                    "a torch.Generator (gen=...) for its kernel's seed")
            seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=gen,
                                 dtype=torch.int32, device=x32.device)
            scale = self._scale(x32, shard)
            if shard is None:
                return quantize_int8_native(x32, scale, seed), scale
            return quantize_int8_native(x32, scale, seed, row0=shard.rows[0],
                                        col0=shard.cols[0]), scale
        u = self._uniforms(x32, gen, u, shard)
        scale = self._scale(x32, shard)
        return quantize_int8(x32, scale, u), scale

    def encode(self, x, gen=None, err=None, u=None, shard=None):
        _require_err(self, err)
        x32 = self._carry_in(x, err)
        q, scale = self._quantize(x32, gen, u, shard)
        xhat32 = dequantize_int8(q, scale)
        del q
        return self._finish(x, x32, xhat32, err)

    def wire_payload(self, x, gen=None, err=None, u=None):
        _require_err(self, err)  # as encode: never measure Q(x) when the
        # run would transmit Q(x + e)
        q, scale = self._quantize(self._carry_in(x, err), gen, u)
        return [q], [scale]


class Int4Codec(_Quantized):
    """Packed-nibble int4 payload with grouped scales: one float32 amax/7
    per row per ``group`` columns, two values per wire byte."""

    def __init__(self, name: str, stochastic: bool = True,
                 error_feedback: bool = False, group: int = 128):
        super().__init__(name, stochastic, error_feedback)
        self.group = group

    def n_groups(self, width: int) -> int:
        return -(-width // self.group)

    def payload_bytes(self, rows: int, width: int, dtype) -> int:
        return rows * ((width + 1) // 2)

    def total_bytes(self, rows: int, width: int, dtype) -> int:
        return (self.payload_bytes(rows, width, dtype)
                + rows * self.n_groups(width) * self.SCALE_BYTES)

    def _quantize(self, x32, gen, u, shard=None):
        # on a shard that starts on a group boundary the group scales are
        # the block's own (panel.shard_spec refuses any other split)
        u = self._uniforms(x32, gen, u, shard)
        scale = int4_group_scale_ref(x32, self.group)
        return quantize_int4(x32, scale, u, self.group), scale

    def encode(self, x, gen=None, err=None, u=None, shard=None):
        _require_err(self, err)
        x32 = self._carry_in(x, err)
        q, scale = self._quantize(x32, gen, u, shard)
        # the mixing view comes off the packed wire bytes, each transient
        # freed as it dies
        packed = pack_int4(q)
        del q
        qw = unpack_int4(packed, x.shape[1])
        del packed
        xhat32 = dequantize_int4(qw, scale, self.group)
        del qw
        return self._finish(x, x32, xhat32, err)

    def wire_payload(self, x, gen=None, err=None, u=None):
        _require_err(self, err)  # as Int8Codec.wire_payload
        q, scale = self._quantize(self._carry_in(x, err), gen, u)
        return [pack_int4(q)], [scale]


class TopKCodec(Codec):
    """Top-k sparsified payload over a mirror panel (see the module
    docstring). ``err`` carries the mirror x̂; encode transmits the k
    largest-magnitude entries of the innovation x - x̂ and returns the
    updated mirror as both the mixing view and the new carried state."""

    error_feedback = True   # the mirror IS the feedback state
    delta_mix = True
    needs_key = False       # values travel exact (float32)
    VALUE_BYTES = 4

    # panels wider than this estimate the selection threshold from a
    # strided column subsample instead of an exact full-row top-k (the
    # reference's THRESH_SAMPLE, same arithmetic)
    THRESH_SAMPLE = 1 << 16

    def __init__(self, name: str = "topk", density: float = 0.125,
                 gamma: float = None, thresh_sample: int = THRESH_SAMPLE):
        if not 0.0 < density <= 1.0:
            raise ValueError(f"density must be in (0, 1], got {density}")
        self.name = name
        self.density = density
        self.thresh_sample = thresh_sample
        # CHOCO consensus step: the delta mix is damped in proportion to
        # the compression (gamma = 1 diverges at density 1/8)
        self.gamma = min(1.0, 2.0 * density) if gamma is None else gamma

    def k_of(self, width: int) -> int:
        return max(1, int(width * self.density))

    def idx_bytes(self, width: int) -> int:
        """Bytes per packed index: the fewest whole bytes that address
        ``width`` columns."""
        bits = max(1, math.ceil(math.log2(max(width, 2))))
        return (bits + 7) // 8

    def payload_bytes(self, rows: int, width: int, dtype) -> int:
        return rows * self.k_of(width) * self.VALUE_BYTES

    def total_bytes(self, rows: int, width: int, dtype) -> int:
        return (self.payload_bytes(rows, width, dtype)
                + rows * self.k_of(width) * self.idx_bytes(width))

    def residual(self, x, err):
        """The effective EF residual is the untransmitted innovation."""
        if err is None:
            return None
        return x.to(torch.float32) - err

    def init_err(self, x):
        # a COPY of the panel: one full-precision sync at init, sparse
        # innovations from then on
        return x.to(torch.float32).clone()

    def _threshold(self, innov, shard=None):
        """Per-row selection threshold: the exact k-th largest |innov| up
        to ``thresh_sample`` columns, a strided-subsample estimate beyond.
        On a ``shard`` both read the whole row: its |innov| gathered over
        ``fsdp``, or the subsample's columns each rank holds, gathered in
        column order."""
        D = innov.shape[1] if shard is None else shard.D
        if D <= self.thresh_sample:
            mag = torch.abs(innov)
            if shard is not None:
                mag = shard.col_gather(mag)
            return topk_threshold_ref(mag, self.k_of(D))
        stride = D // self.thresh_sample
        if shard is None:
            sub = torch.abs(innov[:, ::stride].to(torch.float32))
        else:
            sub = torch.abs(shard.col_gather_strided(innov, stride)
                            .to(torch.float32))
        kk = max(1, int(sub.shape[1] * self.density))
        return torch.topk(sub, kk, dim=1).values[:, -1:].contiguous()

    def encode(self, x, gen=None, err=None, u=None, shard=None):
        _require_err(self, err)
        innov = x.to(torch.float32) - err
        q = sparsify_topk(innov, self._threshold(innov, shard))
        del innov
        mirror = q.add_(err)  # err + q, into the sparsified panel's memory
        return mirror, _storage_back(x.dtype), mirror

    def wire_payload(self, x, gen=None, err=None, u=None):
        _require_err(self, err)  # the innovation is defined against the
        # mirror only
        innov = x.to(torch.float32) - err
        D = x.shape[1]
        k = self.k_of(D)
        idx = torch.topk(torch.abs(innov), k, dim=1).indices
        vals = torch.gather(innov, 1, idx)
        nb = self.idx_bytes(D)
        shifts = torch.arange(nb, device=x.device) * 8
        packed_idx = ((idx[..., None] >> shifts) & 0xFF).to(torch.uint8)
        return [vals.to(torch.float32)], [packed_idx]


CODECS = {
    "f32": F32Codec(),
    "bf16": DtypeCodec(torch.bfloat16, "bf16"),
    "int8": Int8Codec("int8", stochastic=True, error_feedback=False),
    "int8_ef": Int8Codec("int8_ef", stochastic=True, error_feedback=True),
    "int4": Int4Codec("int4", stochastic=True, error_feedback=False),
    "int4_ef": Int4Codec("int4_ef", stochastic=True, error_feedback=True),
    "topk": TopKCodec("topk", density=0.125),
}


def get_codec(name):
    """Resolve a codec by registry name; codec instances pass through (so
    tests can build e.g. a round-to-nearest Int8Codec)."""
    if not isinstance(name, str) and hasattr(name, "encode"):
        return name
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown wire codec {name!r}; known: {sorted(CODECS)}"
        ) from None


def dtype_codec(wire_dtype):
    """Codec of the reference's legacy ``wire_dtype=`` argument (None ->
    identity): a torch dtype or its name."""
    if wire_dtype is None:
        return CODECS["f32"]
    wd = _torch_dtype(wire_dtype)
    if wd == torch.bfloat16:
        return CODECS["bf16"]
    return DtypeCodec(wd, str(wd).replace("torch.", ""))
