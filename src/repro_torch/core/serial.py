"""Serializing wire format — the by-value payload of the fallback route.

Everything RPCool avoids on the CXL route: arguments are flattened to
bytes, copied across the link, and rebuilt on the far side (§5.6 copy
semantics). The format is a compact tag-length-value encoding over the
same object model as ``containers``, byte-identical to the reference
package's.
"""

from __future__ import annotations

import struct
from typing import Any, Optional

_TAG_NONE = 0
_TAG_INT = 1
_TAG_FLOAT = 2
_TAG_STR = 3
_TAG_LIST = 4
_TAG_DICT = 5
_TAG_BYTES = 6


def encode(obj: Any, out: Optional[bytearray] = None) -> bytes:
    buf = out if out is not None else bytearray()
    _enc(obj, buf)
    return bytes(buf)


def _enc(obj: Any, buf: bytearray) -> None:
    if obj is None:
        buf.append(_TAG_NONE)
    elif isinstance(obj, bool):
        buf.append(_TAG_INT)
        buf += struct.pack("<q", int(obj))
    elif isinstance(obj, int):
        buf.append(_TAG_INT)
        buf += struct.pack("<q", obj)
    elif isinstance(obj, float):
        buf.append(_TAG_FLOAT)
        buf += struct.pack("<d", obj)
    elif isinstance(obj, str):
        raw = obj.encode()
        buf.append(_TAG_STR)
        buf += struct.pack("<I", len(raw))
        buf += raw
    elif isinstance(obj, (bytes, bytearray)):
        buf.append(_TAG_BYTES)
        buf += struct.pack("<I", len(obj))
        buf += obj
    elif isinstance(obj, (list, tuple)):
        buf.append(_TAG_LIST)
        buf += struct.pack("<I", len(obj))
        for v in obj:
            _enc(v, buf)
    elif isinstance(obj, dict):
        buf.append(_TAG_DICT)
        buf += struct.pack("<I", len(obj))
        for k, v in obj.items():
            _enc(str(k), buf)
            _enc(v, buf)
    else:
        raise TypeError(f"cannot serialize {type(obj)}")


def decode(raw: bytes) -> Any:
    obj, _ = _dec(raw, 0)
    return obj


def _dec(raw: bytes, off: int):
    tag = raw[off]
    off += 1
    if tag == _TAG_NONE:
        return None, off
    if tag == _TAG_INT:
        return struct.unpack_from("<q", raw, off)[0], off + 8
    if tag == _TAG_FLOAT:
        return struct.unpack_from("<d", raw, off)[0], off + 8
    if tag == _TAG_STR:
        n = struct.unpack_from("<I", raw, off)[0]
        off += 4
        return raw[off : off + n].decode(), off + n
    if tag == _TAG_BYTES:
        n = struct.unpack_from("<I", raw, off)[0]
        off += 4
        return bytes(raw[off : off + n]), off + n
    if tag == _TAG_LIST:
        n = struct.unpack_from("<I", raw, off)[0]
        off += 4
        out = []
        for _ in range(n):
            v, off = _dec(raw, off)
            out.append(v)
        return out, off
    if tag == _TAG_DICT:
        n = struct.unpack_from("<I", raw, off)[0]
        off += 4
        out = {}
        for _ in range(n):
            k, off = _dec(raw, off)
            v, off = _dec(raw, off)
            out[k] = v
        return out, off
    raise ValueError(f"corrupt wire tag {tag}")
