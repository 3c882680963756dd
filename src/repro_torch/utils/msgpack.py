"""A msgpack codec of the port's own, for the subset a checkpoint manifest
uses: dicts with ``str`` keys (insertion order), lists and tuples, ``str``,
``bool``, ``None`` and ``int`` in [-2^63, 2^64 - 1].

``packb`` chooses every encoding as msgpack >= 1.0's ``packb`` does with
its defaults (the smallest width; strings in the str family, str8 included,
as ``use_bin_type=True`` gives), so the bytes are the library's. Anything
else (floats, bytes, other types) raises ``TypeError``: the codec never
writes a form the library would write otherwise. ``unpackb`` reads every
form ``packb`` writes, each at any width.
"""
from __future__ import annotations

import struct

_POS = ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"), (0xFFFFFFFF, 0xCE, ">I"),
        (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"))
_NEG = ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
        (-0x80000000, 0xD2, ">i"), (-0x8000000000000000, 0xD3, ">q"))
# (fix limit, fix tag, ((max, tag, fmt) for the wider forms))
_STR = (31, 0xA0, ((0xFF, 0xD9, ">B"), (0xFFFF, 0xDA, ">H"),
                   (0xFFFFFFFF, 0xDB, ">I")))
_ARRAY = (15, 0x90, ((0xFFFF, 0xDC, ">H"), (0xFFFFFFFF, 0xDD, ">I")))
_MAP = (15, 0x80, ((0xFFFF, 0xDE, ">H"), (0xFFFFFFFF, 0xDF, ">I")))


def _int(n: int, out: list):
    if 0 <= n < 0x80:
        out.append(bytes((n,)))
        return
    if -0x20 <= n < 0:
        out.append(struct.pack(">b", n))
        return
    for bound, tag, fmt in (_POS if n > 0 else _NEG):
        if (n <= bound) if n > 0 else (n >= bound):
            out.append(bytes((tag,)) + struct.pack(fmt, n))
            return
    raise OverflowError(f"integer {n} is outside [-2^63, 2^64 - 1]")


def _head(n: int, family, out: list):
    fix_max, fix_tag, wide = family
    if n <= fix_max:
        out.append(bytes((fix_tag | n,)))
        return
    for bound, tag, fmt in wide:
        if n <= bound:
            out.append(bytes((tag,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"{n} entries or bytes is too many for msgpack")


def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _int(obj, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(len(raw), _STR, out)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _head(len(obj), _ARRAY, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _head(len(obj), _MAP, out)
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r} is not a str")
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} {obj!r}")


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_UINT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
        0xDE: ">H", 0xDF: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def fmt(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if tag in _UINT:
            return self.fmt(_UINT[tag])
        if tag == 0xC0:
            return None
        if tag in (0xC2, 0xC3):
            return tag == 0xC3
        if 0xA0 <= tag <= 0xBF or tag in (0xD9, 0xDA, 0xDB):
            n = tag & 0x1F if tag <= 0xBF else self.fmt(_LEN[tag])
            return str(self.take(n), "utf-8")
        if 0x90 <= tag <= 0x9F or tag in (0xDC, 0xDD):
            n = tag & 0x0F if tag <= 0x9F else self.fmt(_LEN[tag])
            return [self.obj() for _ in range(n)]
        if 0x80 <= tag <= 0x8F or tag in (0xDE, 0xDF):
            n = tag & 0x0F if tag <= 0x8F else self.fmt(_LEN[tag])
            out = {}
            for _ in range(n):
                k = self.obj()
                if not isinstance(k, str):
                    raise ValueError(f"map key {k!r} is not a str")
                out[k] = self.obj()
            return out
        raise ValueError(f"msgpack type 0x{tag:02x} is outside the subset")


def unpackb(data: bytes):
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the object")
    return obj
