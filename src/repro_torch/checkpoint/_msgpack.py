"""The subset of msgpack that the checkpoint blob uses, with ``struct``.

Maps with ``str`` keys (insertion order), ``str``, ``bytes`` (bin 8/16/32),
integers (the 64-bit range) and lists of them. :func:`packb` picks the
smallest encoding of each value, as ``msgpack.packb`` does with its defaults
(``use_bin_type=True``), so a blob packed here is byte for byte the one the
``msgpack`` package packs from the same objects. :func:`unpackb` reads that
subset back; ``bytes`` come back as ``memoryview`` slices of the input (no
copy of the arrays' data), and anything else raises ``ValueError``.
"""
from __future__ import annotations

import struct


def _int(x: int, out: list) -> None:
    if x < -(1 << 5):
        if x < -(1 << 31):
            if x < -(1 << 63):
                raise ValueError(f"integer {x} is out of msgpack's range")
            out.append(struct.pack(">Bq", 0xD3, x))
        elif x < -(1 << 15):
            out.append(struct.pack(">Bi", 0xD2, x))
        elif x < -(1 << 7):
            out.append(struct.pack(">Bh", 0xD1, x))
        else:
            out.append(struct.pack(">Bb", 0xD0, x))
    elif x < (1 << 7):
        out.append(struct.pack(">b", x))  # positive and negative fixint
    elif x < (1 << 8):
        out.append(struct.pack(">BB", 0xCC, x))
    elif x < (1 << 16):
        out.append(struct.pack(">BH", 0xCD, x))
    elif x < (1 << 32):
        out.append(struct.pack(">BI", 0xCE, x))
    elif x < (1 << 64):
        out.append(struct.pack(">BQ", 0xCF, x))
    else:
        raise ValueError(f"integer {x} is out of msgpack's range")


def _header(n: int, fix: int, fix_max: int, codes, out: list) -> None:
    """The length header of a str / bin / array / map of ``n`` items:
    ``fix | n`` up to ``fix_max`` (None: no fix form), then the 8-, 16- and
    32-bit forms (a code of None: no such form)."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack(">B", fix | n))
    elif codes[0] is not None and n < (1 << 8):
        out.append(struct.pack(">BB", codes[0], n))
    elif n < (1 << 16):
        out.append(struct.pack(">BH", codes[1], n))
    elif n < (1 << 32):
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"a msgpack object of {n} items or bytes is too long")


def _pack(obj, out: list) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"the checkpoint's msgpack subset has no {obj!r}")
    if isinstance(obj, int):
        _int(obj, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _header(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(b)
    elif isinstance(obj, Pieces):
        _header(obj.nbytes, None, 0, (0xC4, 0xC5, 0xC6), out)
        out.extend(obj.parts)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        _header(n, None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {k!r}")
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"the checkpoint's msgpack subset has no "
                        f"{type(obj).__name__}")


class Pieces:
    """A bin whose bytes are the concatenation of ``parts`` (bytes-like),
    packed without joining them."""

    def __init__(self, parts):
        self.parts = list(parts)
        self.nbytes = sum(memoryview(p).nbytes for p in self.parts)


def pack_pieces(obj) -> list:
    """``obj`` packed, as the list of pieces whose concatenation is
    ``packb(obj)`` (a leaf's data a piece of its own, not copied)."""
    out: list = []
    _pack(obj, out)
    return out


def packb(obj) -> bytes:
    """``obj`` packed; the pieces (a leaf's data among them) are joined
    once, so the result is the only copy of the data made."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_INT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
        0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.num(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if b in _INT:
            return self.num(_INT[b])
        if b in _STR:
            return self.str(self.num(_STR[b]))
        if b in _BIN:
            return self.take(self.num(_BIN[b]))
        if b in _ARRAY:
            return [self.obj() for _ in range(self.num(_ARRAY[b]))]
        if b in _MAP:
            return self.map(self.num(_MAP[b]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the "
                         "checkpoint's subset")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a str")
            out[k] = self.obj()
        return out


def unpackb(buf):
    """The object packed in ``buf`` (bytes-like); ValueError on truncated,
    trailing or unsupported data."""
    r = _Reader(buf)
    obj = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after "
                         "the msgpack object")
    return obj
