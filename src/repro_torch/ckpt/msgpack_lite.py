"""A msgpack encoder and decoder for checkpoint manifests.

The reference writes its manifest with ``msgpack.packb``; the card's
machine has no ``msgpack``, so the port carries this subset: dict, list
(and tuple), str, int, bool and None.  ``packb`` gives the same bytes as
``msgpack.packb`` for such values (the smallest encoding of each int,
string, array and map length; map keys in the dict's order), and
``unpackb`` reads them back as ``msgpack.unpackb`` does (lists for
arrays).  Anything else raises ``TypeError`` or ``ValueError``.
"""
from __future__ import annotations

import struct


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return bytes([n & 0xFF])
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)),
                               (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack's 64 bits")


def _head(n: int, fix: int, fix_max: int, wide: tuple) -> bytes:
    """The header of a str, array or map of length ``n``: the fix form
    below ``fix_max``, else the first wide form that holds ``n``."""
    if n < fix_max:
        return bytes([fix | n])
    for code, fmt, top in wide:
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit msgpack's 32 bits")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += [_head(len(raw), 0xA0, 32, _STR), raw]
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 16, _ARRAY))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 16, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack_lite cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
        0xDE: ">H", 0xDF: ">I"}


def _unpack(buf: bytes, i: int):
    """(value, next offset) of the object at ``buf[i]``."""
    c = buf[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if c == 0xC0:
        return None, i
    if c in (0xC2, 0xC3):
        return c == 0xC3, i
    if c in _FIXED:
        fmt = _FIXED[c]
        return struct.unpack_from(fmt, buf, i)[0], i + struct.calcsize(fmt)
    if 0xA0 <= c < 0xC0:
        n, kind = c & 0x1F, "str"
    elif 0x90 <= c < 0xA0:
        n, kind = c & 0x0F, "array"
    elif 0x80 <= c < 0x90:
        n, kind = c & 0x0F, "map"
    elif c in _LEN:
        fmt = _LEN[c]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        kind = "str" if c <= 0xDB else "array" if c <= 0xDD else "map"
    else:
        raise ValueError(f"msgpack_lite cannot unpack type byte {c:#04x}")
    if kind == "str":
        return buf[i:i + n].decode("utf-8"), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            out.append(v)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


def unpackb(buf: bytes):
    value, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"msgpack_lite: {len(buf) - end} bytes of extra data")
    return value
