"""Serializing wire format — the by-value payload of the fallback route,
and the gRPC/Thrift-analogue baseline (§2).

Everything RPCool avoids on the CXL route: arguments are flattened to
bytes, copied across the link, and rebuilt on the far side (§5.6 copy
semantics). The format is a compact tag-length-value encoding over the
same object model as ``containers``, byte-identical to the reference
package's. ``SerialChannel`` is the legacy copy-based endpoint the
Table 1a / Fig. 11 comparisons measure against.
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Any, Callable, Dict, Optional

from .errors import ChannelError

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


class SerialChannel:
    """Copy-based RPC endpoint: args serialized into a message buffer.

    ``msg_capacity`` bounds a single message (like gRPC's max message
    size). A background listen thread mirrors the zero-copy channel's
    busy-wait loop so RTT comparisons are apples-to-apples.
    """

    R_EMPTY, R_REQ, R_DONE, R_ERR = 0, 1, 2, 3

    def __init__(self, msg_capacity: int = 1 << 20,
                 link_latency_us: float = 0.0):
        self.functions: Dict[int, Callable[[Any], Any]] = {}
        self._req = bytearray(msg_capacity)
        self._resp = bytearray(msg_capacity)
        self._req_len = 0
        self._resp_len = 0
        self._fn_id = 0
        self._state = self.R_EMPTY
        self._stop = threading.Event()
        self.link_latency_us = link_latency_us
        self.bytes_sent = 0
        self.n_calls = 0

    def add(self, fn_id: int, fn: Callable[[Any], Any]) -> None:
        self.functions[fn_id] = fn

    def call(self, fn_id: int, obj: Any, timeout: float = 10.0) -> Any:
        wire = encode(obj)  # serialize
        if len(wire) > len(self._req):
            raise ChannelError("message too large")
        self._req[: len(wire)] = wire  # copy onto the "network"
        self._req_len = len(wire)
        self._fn_id = fn_id
        self.bytes_sent += len(wire)
        if self.link_latency_us:
            time.sleep(self.link_latency_us * 1e-6)
        self._state = self.R_REQ
        deadline = time.monotonic() + timeout
        while self._state == self.R_REQ:
            if time.monotonic() > deadline:
                raise ChannelError("serial RPC timeout")
            time.sleep(0)  # GIL yield — same spin discipline as rpcool
        if self._state == self.R_ERR:
            self._state = self.R_EMPTY
            raise ChannelError("remote error")
        if self.link_latency_us:
            time.sleep(self.link_latency_us * 1e-6)
        out = decode(bytes(self._resp[: self._resp_len]))  # deserialize
        self._state = self.R_EMPTY
        self.n_calls += 1
        return out

    def serve_once(self) -> int:
        if self._state != self.R_REQ:
            return 0
        try:
            obj = decode(bytes(self._req[: self._req_len]))  # deserialize
            ret = self.functions[self._fn_id](obj)
            wire = encode(ret)  # serialize the reply
            self._resp[: len(wire)] = wire
            self._resp_len = len(wire)
            self.bytes_sent += len(wire)
            self._state = self.R_DONE
        except Exception:
            self._state = self.R_ERR
        return 1

    def listen_in_thread(self) -> threading.Thread:
        def loop():
            while not self._stop.is_set():
                if not self.serve_once():
                    time.sleep(0)  # GIL yield between idle polls
        t = threading.Thread(target=loop, daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()
