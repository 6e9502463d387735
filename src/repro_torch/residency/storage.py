"""Storage codecs: compressed residency of the engine's state panels
(counterpart of ``repro/residency/storage.py``).

Every agent holds 4+ float32 (m, D) rows of device memory (parameters, the
two AdamW moments, and the error-feedback and merge-statistics panels when
active), so resident bytes cap the agent count m per card. A residency
policy names a storage codec for each state-panel KIND (``moments``,
``stats``, ``wire_err``; parameters always keep their dtype), carried on
the spec (``panel.with_residency``, ``--residency moments=int8``).

Contract (each entry is a :class:`Storage`):

* ``init(x)`` — deterministic encode (round to nearest) of a float32
  (m, D) panel, used when the state is built;
* ``write(x, gen=..., u=...)`` — the encode of the training loop; a
  stochastic storage needs a ``torch.Generator`` (``gen``) or the uniforms
  themselves (``u``, the shape of x, how the tests feed the reference's
  draws) and raises without both, as the reference's ``write`` raises
  without ``key=``;
* ``read(stored)`` — decode to the float32 compute view; ``maybe_read``
  lets an already decoded float32 panel pass;
* ``zero_like(stored)`` / ``zeros(rows, width, device)`` — the canonical
  zero, bit for bit ``init(zeros)``: int8 stores q = 0 at scale 1/127;
* ``resident_bytes(rows, width)`` — exact bytes of the stored form of a
  float32 (rows, width) panel, scales included.

Stored forms: ``f32`` is the identity (an f32 policy is no policy),
``bf16`` the cast panel, the int8 entries ``{"q": int8 (m, D), "scale":
float32}`` with one scale per row (``int8r``, linear, through the per-row
int8 kernels of the wire) or one per row per ``group`` columns (``int8``,
g = 128, and ``int8g``, g = 32, through the grouped int8 kernels). The
grouped entries compand: they quantize sign(x) * sqrt(|x|) and decode
sign(z) * z^2, so Adam's small second moments keep relative precision
(linear int8 rounds them to zero and the next step divides by eps); SR is
unbiased in that domain.

Random bits (where the port departs from the reference's layout): the
reference draws each stochastic encode's uniforms as one (m, D) panel. At
olmo-1b's width that is a 7.6 GB panel per moment per local step, more
than int8 moments save. Here an encode draws them a column slab of
``SLAB`` (2^22, a whole number of 128- and 32-column groups) at a time and
quantizes that slab before the next is drawn, so every scale group lies
inside one slab and a write holds one slab of uniforms. The draws come
from one ``torch.Generator`` per (state kind, tick, entry, dtype group):
:func:`storage_generators`, the counterpart of ``storage_keys``, seeds it
with a mix of the segment's seed and those words, so the residency draws
never touch the wire codec's generator, every local step (tick) draws
fresh bits, and two paths that draw the same slabs from the same streams
(the fused and the unfused moment update) see the same uniforms.

Sharded panels: ``init``/``write`` take ``shard=`` (``panel.Shard``), a
rank's block of the (m, D) panel, and store that block of the whole
panel's stored form bit for bit. The slabs are the panel's: each slab
that overlaps the block is drawn whole, (m, SLAB) from its generator, and
cut to the block; the slabs before it are drawn and dropped, so the
stream stands where it stands for the whole panel (:func:`slab_draws`).
The grouped scales are the block's own when the block starts on a group
boundary (``panel.shard_spec`` refuses any other split), and sit beside
its columns; the per-row scale of ``int8r`` is the whole row's (the
column shards' amax, max over ``fsdp``), held by every column shard of
the row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import (amax_scale, div_exact,
                                     int8_group_scale_ref, row_amax,
                                     signed_sqrt, signed_square)
from repro_torch.kernels.wire_quant import (dequantize_int8,
                                            dequantize_int8_grouped,
                                            quantize_int8,
                                            quantize_int8_grouped)
from repro_torch.optim.optim import _CHUNK

# state-panel kinds a residency policy may name; parameters are not a kind
KINDS = ("moments", "stats", "wire_err")

# columns per slab of a stochastic encode's uniform draw
SLAB = _CHUNK


class Storage:
    """Base storage codec: the float32 identity (panels pass through)."""

    name = "f32"
    needs_key = False  # write() draws stochastic rounding bits
    # whether the stored form supports the fused optimizer update
    # (kernels/opt_fused.py): grouped int8 only, whose fresh scales are
    # local to a group
    fused_update = False

    def init(self, x, shard=None):
        """Deterministic encode (state build); ``shard``: x is a rank's
        block of the panel."""
        return x

    def write(self, x, gen=None, u=None, shard=None):
        """Encode of the training loop."""
        return x

    def read(self, stored):
        """Decode to the float32 compute view."""
        return stored

    def maybe_read(self, v):
        """``read`` that lets an already decoded float32 panel pass."""
        return v

    def transform_fwd(self, x):
        """The domain the quantizer works in (identity for linear codecs)."""
        return x

    def transform_inv(self, y):
        return y

    def zero_like(self, stored):
        """Canonical zero stored form (bit for bit ``init(zeros)``)."""
        return torch.zeros_like(stored)

    def zeros(self, rows: int, width: int, device):
        """The canonical zero of a (rows, width) panel, made without a
        float32 panel."""
        return torch.zeros((rows, width), dtype=torch.float32, device=device)

    def resident_bytes(self, rows: int, width: int) -> int:
        """Exact bytes of the stored form of a float32 (rows, width) panel,
        scales included."""
        return rows * width * 4


class F32Storage(Storage):
    """The identity: byte for byte the engine without a policy."""


class Bf16Storage(Storage):
    """bf16 cast storage: 2 bytes a value, no scales."""

    name = "bf16"

    def init(self, x, shard=None):
        return x.to(torch.bfloat16)

    def write(self, x, gen=None, u=None, shard=None):
        return x.to(torch.bfloat16)

    def read(self, stored):
        return stored.to(torch.float32)

    def maybe_read(self, v):
        # state panels are float32, so a bf16 panel is this storage's form
        return v.to(torch.float32) if v.dtype == torch.bfloat16 else v

    def zeros(self, rows: int, width: int, device):
        return torch.zeros((rows, width), dtype=torch.bfloat16,
                           device=device)

    def resident_bytes(self, rows: int, width: int) -> int:
        return rows * width * 2


class Int8Storage(Storage):
    """Symmetric int8 storage with float32 scales: 1 byte a value and 4
    bytes a scale. ``group=None`` keeps one scale per row (m, 1), an int
    ``group`` one per ``group`` columns (m, ceil(D / group)). Stored form
    ``{"q": int8 (m, D), "scale": float32}``. ``write`` rounds
    stochastically (unbiased: round to nearest would shrink the EMA
    moments), ``init`` to nearest. ``transform="sqrt"`` quantizes
    sign(x) * sqrt(|x|) and decodes sign(z) * z^2."""

    SCALE_BYTES = 4
    needs_key = True

    def __init__(self, name: str = "int8", group=None, transform=None):
        if transform not in (None, "sqrt"):
            raise ValueError(f"unknown transform {transform!r}")
        if group is not None and group < 1:
            raise ValueError(f"group must be >= 1, got {group}")
        self.name = name
        self.group = group
        self.transform = transform
        # grouped scales are local to a group, so the fused kernel can
        # compute them; a per-row scale needs the whole row first
        self.fused_update = group is not None

    def transform_fwd(self, x):
        return x if self.transform is None else signed_sqrt(x)

    def transform_inv(self, y):
        return y if self.transform is None else signed_square(y)

    def slab(self) -> int:
        """Columns per slab: ``SLAB``, cut to whole groups."""
        if self.group is None:
            return SLAB
        return max(SLAB // self.group, 1) * self.group

    def _encode(self, x, gen, u, stochastic, shard=None):
        m, D = x.shape
        dev = x.device
        q = torch.empty((m, D), dtype=torch.int8, device=dev)
        if self.group is None:
            amax = row_amax(self.transform_fwd(x))
            scale = amax_scale(amax if shard is None else shard.col_max(amax))
        else:
            scale = torch.empty((m, self.scale_count(D)),
                                dtype=torch.float32, device=dev)
        c0 = 0 if shard is None else shard.cols[0]
        if stochastic and u is not None and shard is not None:
            u = shard.block(u)
        draws = (slab_draws(gen, m, D, self.slab(), shard, dev)
                 if stochastic and u is None else None)
        for lo, hi in slab_ranges(D, self.slab(), c0):
            sl, w = slice(lo, hi), hi - lo
            z = self.transform_fwd(x[:, sl].to(torch.float32))
            uu = None
            if stochastic:
                uu = u[:, sl] if u is not None else next(draws)
            if self.group is None:
                q[:, sl] = quantize_int8(
                    z.contiguous(), scale,
                    None if uu is None else uu.contiguous())
            else:
                g0 = lo // self.group
                s = scale[:, g0:g0 + self.scale_count(w)]
                s.copy_(int8_group_scale_ref(z, self.group))
                quantize_int8_grouped(z, s, uu, self.group, out=q[:, sl])
            del z, uu
        return {"q": q, "scale": scale}

    def init(self, x, shard=None):
        return self._encode(x, None, None, stochastic=False, shard=shard)

    def write(self, x, gen=None, u=None, shard=None):
        if gen is None and u is None:
            raise ValueError(
                f"storage '{self.name}' uses stochastic rounding and needs "
                "a torch.Generator (gen=...) or the uniforms (u=...); use "
                "init() for the deterministic encode")
        return self._encode(x, gen, u, stochastic=True, shard=shard)

    def read(self, stored):
        q, scale = stored["q"], stored["scale"]
        if self.group is None:
            y = dequantize_int8(q, scale)
        else:
            y = dequantize_int8_grouped(q, scale, self.group)
        if self.transform is not None:  # in place, a slab at a time
            for lo in range(0, y.shape[1], SLAB):
                ys = y[:, lo:lo + SLAB]
                ys.copy_(self.transform_inv(ys))
        return y

    def maybe_read(self, v):
        return self.read(v) if isinstance(v, dict) else v

    def zero_like(self, stored):
        # q = 0 at scale 1/127 IS init(zeros): the scale rules map an
        # all-zero row or group to 1/127, and the companding fixes 0
        return {"q": torch.zeros_like(stored["q"]),
                "scale": torch.full_like(stored["scale"], 1.0 / 127.0)}

    def zeros(self, rows: int, width: int, device):
        return {"q": torch.zeros((rows, width), dtype=torch.int8,
                                 device=device),
                "scale": div_exact(torch.ones(
                    (rows, self.scale_count(width)), dtype=torch.float32,
                    device=device), 127.0)}

    def scale_count(self, width: int) -> int:
        return 1 if self.group is None else -(-width // self.group)

    def resident_bytes(self, rows: int, width: int) -> int:
        return rows * (width + self.scale_count(width) * self.SCALE_BYTES)


def slab_ranges(D: int, step: int, c0: int = 0):
    """[lo, hi) column ranges of a block of ``D`` columns whose first
    column is the panel's ``c0``: its parts in each ``step``-column slab of
    the panel (the whole block's slabs when c0 = 0)."""
    lo = 0
    while lo < D:
        hi = min(D, (c0 + lo) // step * step + step - c0)
        yield lo, hi
        lo = hi


def slab_draws(gen, m: int, D: int, step: int, shard, device):
    """The uniforms of each range of :func:`slab_ranges` in turn, drawn
    from ``gen`` as an encode of the whole panel draws them: (m, w) a slab.
    On a ``shard`` every slab of the panel up to the block's last is drawn
    whole, (shard.m, slab width), those before the block dropped, and the
    overlapping ones cut to the block's rows and columns."""
    if shard is None:
        for lo, hi in slab_ranges(D, step):
            yield torch.rand((m, hi - lo), generator=gen,
                             dtype=torch.float32, device=device)
        return
    (r0, r1), (c0, c1) = shard.rows, shard.cols
    for lo in range(0, c1, step):
        hi = min(lo + step, shard.D)
        full = torch.rand((shard.m, hi - lo), generator=gen,
                          dtype=torch.float32, device=device)
        if hi > c0:
            yield full[r0:r1, max(lo, c0) - lo:min(hi, c1) - lo] \
                .contiguous()
        del full


STORAGE = {
    "f32": F32Storage(),
    "bf16": Bf16Storage(),
    # moment-safe int8: signed-sqrt companded, grouped scales; int8g pays
    # more scales (g = 32) for tighter groups
    "int8": Int8Storage("int8", group=128, transform="sqrt"),
    "int8g": Int8Storage("int8g", group=32, transform="sqrt"),
    # linear per-row int8 (the wire codec's layout): for parameter-scaled
    # panels (wire_err, stats), unsafe for Adam's moments
    "int8r": Int8Storage("int8r"),
}


def get_storage(name):
    """A storage codec by registry name; Storage instances pass through."""
    if not isinstance(name, str) and hasattr(name, "resident_bytes"):
        return name
    try:
        return STORAGE[name]
    except KeyError:
        raise ValueError(
            f"unknown storage codec {name!r}; known: {sorted(STORAGE)}"
        ) from None


def parse_policy(policy):
    """CLI residency policy -> {kind: storage name}.

    None or empty -> {}; 'kind=name,kind=name' pairs (``--residency
    moments=int8,stats=bf16``); a bare storage name applies to the moments.
    Kinds and names are checked here, so a typo fails at parse time."""
    if not policy:
        return {}
    if isinstance(policy, dict):
        mapping = dict(policy)
    elif "=" in policy:
        mapping = {}
        for part in policy.split(","):
            kind, _, name = part.partition("=")
            mapping[kind.strip()] = name.strip()
    else:
        mapping = {"moments": policy.strip()}
    unknown = set(mapping) - set(KINDS)
    if unknown:
        raise ValueError(
            f"residency policy names unknown state kinds "
            f"{sorted(unknown)}; known kinds: {list(KINDS)}")
    for name in mapping.values():
        get_storage(name)
    return mapping


_MASK = (1 << 64) - 1
_KIND_WORD = {"moments": 0, "stats": 1, "wire_err": 2}


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def stream_seed(seed: int, *words: int) -> int:
    """A 63-bit generator seed mixed from ``seed`` and ``words``."""
    h = _splitmix64(int(seed) & _MASK)
    for w in words:
        h = _splitmix64(h ^ (int(w) & _MASK))
    return h >> 1


def storage_generators(sts: dict, seed, tick: int, kind: str, entry: int,
                       device):
    """{dtype group: torch.Generator or None}: one stream per stored group
    that rounds stochastically, for one encode of ``kind`` at ``tick`` (a
    local step or a round) of state entry ``entry`` (the moment or the
    statistic, by its place in sorted order). Groups are numbered in sorted
    order. Raises when a group needs bits and ``seed`` is None (the
    counterpart of ``storage_keys``)."""
    names = sorted(k for k, s in sts.items() if s.needs_key)
    if names and seed is None:
        raise ValueError(
            f"storage codecs for groups {names} use stochastic rounding "
            "and need a seed (the segment's rng=)")
    out = {k: None for k in sts}
    for i, k in enumerate(names):
        out[k] = torch.Generator(device=device).manual_seed(stream_seed(
            seed, _KIND_WORD[kind], tick, entry, i))
    return out
