"""Heap-resident containers — the Boost.Interprocess analogue (§4.1).

RPCool hands applications STL-like containers that live directly in shared
memory so that pointer-rich structures (JSON-ish documents, trees, lists)
can be built once and *referenced* by RPCs instead of serialized.

Encoding (all little-endian, 8-byte aligned):

* Value (16 B)          = ``[tag u32][pad u32][payload u64]``
    - T_I64 / T_F64     payload = raw 64-bit value bits
    - T_STR             payload = GlobalAddr of a String node
    - T_VEC             payload = GlobalAddr of a Vec node
    - T_MAP             payload = GlobalAddr of a Map node
* String node           = ``[u32 T_STR][u32 len][len bytes]``
* Bytes node            = ``[u32 T_BYTES][u32 len][len bytes]``
* Vec node              = ``[u32 T_VEC][u32 len][len × Value]``
* Map node (assoc list) = ``[u32 T_MAP][u32 n][n × (key GlobalAddr, Value)]``
  — a map entry's Value uses its pad word to cache the key's byte
  length, so ``map_get`` scans the entry table with ONE read and only
  dereferences length-matching keys (a hash-free point lookup).

Every pointer is a ``GlobalAddr`` — valid in any process that maps the heap
(§4.1 globally-unique address spaces). Reads go through a *reader*:
anything with ``read(addr, nbytes) -> buffer`` — the raw heap (trusted), a
``Sandbox`` or ``FastReader`` (untrusted — every dereference is
bounds-checked; a wild pointer raises the SIGSEGV-analogue instead of
leaking server memory, §4.3's linked-list-to-secret-key attack), a
``ServerCtx``, or a fallback ``DSMNode``.

``deep_copy`` reproduces ``conn.copy_from(ptr)`` (§5.6): a structural
traversal that rebuilds the object graph inside a different heap or
scope (a ``GraphRef`` passed to a connection of another heap, or under a
seal or sandbox that covers only the call scope).

The encoding is the reference package's byte for byte: the same Python
value built into the same scope gives the same bytes at the same offsets.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Iterator, List, Optional, Tuple, Union

from . import addr as gaddr
from .errors import InvalidPointer
from .scope import Scope

T_NULL = 0
T_I64 = 1
T_F64 = 2
T_STR = 3
T_VEC = 4
T_MAP = 5
T_BYTES = 6   # raw byte string — same node layout as T_STR

_VALUE_FMT = "<IIQ"
VALUE_SIZE = struct.calcsize(_VALUE_FMT)  # 16
_HDR_FMT = "<II"
HDR_SIZE = struct.calcsize(_HDR_FMT)  # 8
_ENTRY_SIZE = 8 + VALUE_SIZE  # map entry: key addr + value

Value = Tuple[int, int]  # (tag, payload)


# ---------------------------------------------------------------------------
# construction (writer side — always trusted, it's your own scope)
# ---------------------------------------------------------------------------
def _pack_f64(x: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", x))[0]


def _unpack_f64(bits: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


def build_value(scope: Scope, obj: Any, pid: int = 0,
                fast: bool = False) -> Value:
    """Recursively build a python object graph inside ``scope``.

    ``fast`` uses the bounds-only write path — valid only for freshly
    created private scopes (nothing sealed, nothing foreign).
    """
    w = scope.heap.write_fast if fast else \
        (lambda a, d: scope.heap.write(a, d, pid=pid))
    if obj is None:
        return (T_NULL, 0)
    if isinstance(obj, bool):
        return (T_I64, int(obj))
    if isinstance(obj, int):
        # the value domain is signed 64-bit, same as the serial wire
        # format — both routes must reject the same inputs (§5.6)
        if not -(1 << 63) <= obj < (1 << 63):
            raise TypeError(f"int out of i64 range: {obj}")
        return (T_I64, obj & 0xFFFFFFFFFFFFFFFF)
    if isinstance(obj, float):
        return (T_F64, _pack_f64(obj))
    if isinstance(obj, str):
        raw = obj.encode()
        a = scope.alloc(HDR_SIZE + len(raw))
        w(a, struct.pack(_HDR_FMT, T_STR, len(raw)) + raw)
        return (T_STR, a)
    if isinstance(obj, (bytes, bytearray)):
        raw = bytes(obj)
        a = scope.alloc(HDR_SIZE + len(raw))
        w(a, struct.pack(_HDR_FMT, T_BYTES, len(raw)) + raw)
        return (T_BYTES, a)
    if isinstance(obj, (list, tuple)):
        vals = [build_value(scope, v, pid, fast) for v in obj]
        a = scope.alloc(HDR_SIZE + len(vals) * VALUE_SIZE)
        body = struct.pack(_HDR_FMT, T_VEC, len(vals)) + b"".join(
            struct.pack(_VALUE_FMT, t, 0, p) for t, p in vals
        )
        w(a, body)
        return (T_VEC, a)
    if isinstance(obj, dict):
        entries = []
        for k, v in obj.items():
            raw = str(k).encode()   # encode ONCE: node bytes + length
            ka = scope.alloc(HDR_SIZE + len(raw))
            w(ka, struct.pack(_HDR_FMT, T_STR, len(raw)) + raw)
            vt, vp = build_value(scope, v, pid, fast)
            entries.append((ka, vt, len(raw), vp))
        a = scope.alloc(HDR_SIZE + len(entries) * _ENTRY_SIZE)
        body = struct.pack(_HDR_FMT, T_MAP, len(entries)) + b"".join(
            struct.pack("<Q", ka) + struct.pack(_VALUE_FMT, vt, klen, vp)
            for ka, vt, klen, vp in entries
        )
        w(a, body)
        return (T_MAP, a)
    raise TypeError(f"unsupported object type {type(obj)}")


def build_vec(scope: Scope, vals: List[Value], pid: int = 0,
              fast: bool = False) -> Value:
    """Assemble a Vec node from *pre-built* Values.

    The marshaller uses this for the RPC argument tuple: each argument is
    built (or pointer-embedded, for same-heap graphs) independently, then
    the tuple node references them — no re-serialization of the elements.
    """
    w = scope.heap.write_fast if fast else \
        (lambda a, d: scope.heap.write(a, d, pid=pid))
    a = scope.alloc(HDR_SIZE + len(vals) * VALUE_SIZE)
    body = struct.pack(_HDR_FMT, T_VEC, len(vals)) + b"".join(
        struct.pack(_VALUE_FMT, t, 0, p) for t, p in vals
    )
    w(a, body)
    return (T_VEC, a)


def build_doc(scope: Scope, obj: dict, pid: int = 0,
              fast: bool = False) -> int:
    """Build a JSON-like document; returns the root GlobalAddr."""
    tag, payload = build_value(scope, obj, pid, fast)
    if tag != T_MAP:
        raise TypeError("document root must be a dict")
    return payload


# ---------------------------------------------------------------------------
# traversal (reader side — heap for trusted, Sandbox for untrusted)
# ---------------------------------------------------------------------------
class Reader:
    """Anything with ``read(addr, nbytes) -> buffer``: SharedHeap, Sandbox,
    ServerCtx, or a fallback DSMNode."""


class FastReader:
    """Range-checked-ONCE raw reader — the MPK semantics, faithfully.

    Hardware MPK pays the permission check in the TLB: after the key is
    set, loads cost nothing extra. The generic ``Sandbox.read`` pays a
    Python-level check per dereference (~µs), which inverts the paper's
    zero-copy-vs-serialize comparison on this substrate. FastReader
    restores the hardware cost model: one range check at construction
    (= key assignment), then raw-view loads with a single integer
    comparison (= the MMU's fault check).
    """

    def __init__(self, heap, start_page: int = 0,
                 num_pages: Optional[int] = None):
        num_pages = heap.num_pages - start_page if num_pages is None \
            else num_pages
        self.heap = heap
        self.page_size = heap.page_size
        self._lo = start_page * heap.page_size
        self._hi = (start_page + num_pages) * heap.page_size
        self._view = memoryview(heap.buf)
        self._heap_id = heap.heap_id

    def read(self, a: int, nbytes: int):
        if a >> (gaddr.PAGE_BITS + gaddr.OFF_BITS) != self._heap_id:
            raise InvalidPointer(f"wild pointer {a:#x} escapes heap")
        lin = ((a >> gaddr.OFF_BITS) & ((1 << gaddr.PAGE_BITS) - 1)) \
            * self.page_size + (a & ((1 << gaddr.OFF_BITS) - 1))
        if lin < self._lo or lin + nbytes > self._hi:
            raise InvalidPointer(
                f"pointer {a:#x} outside sandboxed range (SIGSEGV)")
        return self._view[lin : lin + nbytes]


def fast_reader_for_sandbox(sb) -> FastReader:
    """FastReader bound to an entered Sandbox's page range."""
    return FastReader(sb.mgr.heap, sb.start_page, sb.num_pages)


def _read_hdr(reader, a: int) -> Tuple[int, int]:
    raw = bytes(reader.read(a, HDR_SIZE))
    return struct.unpack(_HDR_FMT, raw)


def read_str(reader, a: int) -> str:
    tag, n = _read_hdr(reader, a)
    if tag != T_STR:
        raise InvalidPointer(f"expected string node at {a:#x}, tag={tag}")
    return bytes(reader.read(gaddr.add(a, HDR_SIZE, _psize(reader)), n)).decode()


def read_bytes(reader, a: int) -> bytes:
    tag, n = _read_hdr(reader, a)
    if tag != T_BYTES:
        raise InvalidPointer(f"expected bytes node at {a:#x}, tag={tag}")
    return bytes(reader.read(gaddr.add(a, HDR_SIZE, _psize(reader)), n))


def vec_len(reader, a: int) -> int:
    tag, n = _read_hdr(reader, a)
    if tag != T_VEC:
        raise InvalidPointer(f"expected vec node at {a:#x}, tag={tag}")
    return n


def vec_get(reader, a: int, i: int) -> Value:
    n = vec_len(reader, a)
    if not (0 <= i < n):
        raise InvalidPointer(f"vec index {i} out of range {n}")
    off = HDR_SIZE + i * VALUE_SIZE
    raw = bytes(reader.read(gaddr.add(a, off, _psize(reader)), VALUE_SIZE))
    t, _, p = struct.unpack(_VALUE_FMT, raw)
    return (t, p)


def map_len(reader, a: int) -> int:
    tag, n = _read_hdr(reader, a)
    if tag != T_MAP:
        raise InvalidPointer(f"expected map node at {a:#x}, tag={tag}")
    return n


def map_items(reader, a: int) -> Iterator[Tuple[str, Value]]:
    tag, n = _read_hdr(reader, a)
    if tag != T_MAP:
        raise InvalidPointer(f"expected map node at {a:#x}, tag={tag}")
    ps = _psize(reader)
    # the whole entry table in one checked read, then in-memory scan
    table = bytes(reader.read(gaddr.add(a, HDR_SIZE, ps), n * _ENTRY_SIZE))
    for i in range(n):
        off = i * _ENTRY_SIZE
        ka = struct.unpack_from("<Q", table, off)[0]
        vt, _, vp = struct.unpack_from(_VALUE_FMT, table, off + 8)
        yield read_str(reader, ka), (vt, vp)


def map_get(reader, a: int, key: str) -> Union[Value, None]:
    """Point lookup: ONE read of the entry table, then a length-filtered
    scan — only keys whose cached byte length matches are dereferenced
    and compared, the rest are skipped without touching their nodes."""
    tag, n = _read_hdr(reader, a)
    if tag != T_MAP:
        raise InvalidPointer(f"expected map node at {a:#x}, tag={tag}")
    ps = _psize(reader)
    kb = key.encode()
    want_len = len(kb)
    table = bytes(reader.read(gaddr.add(a, HDR_SIZE, ps), n * _ENTRY_SIZE))
    for i in range(n):
        off = i * _ENTRY_SIZE
        vt, klen, vp = struct.unpack_from(_VALUE_FMT, table, off + 8)
        if klen != want_len:
            continue
        ka = struct.unpack_from("<Q", table, off)[0]
        # ONE read covers the key node's header AND bytes; the header is
        # validated against the entry's cached length so a corrupt or
        # hostile map surfaces InvalidPointer instead of a silent miss
        raw = bytes(reader.read(ka, HDR_SIZE + klen))
        ktag, klen2 = struct.unpack_from(_HDR_FMT, raw)
        if ktag != T_STR or klen2 != klen:
            raise InvalidPointer(f"map key at {ka:#x} is not a string "
                                 f"of the cached length")
        if raw[HDR_SIZE:] != kb:
            continue
        return (vt, vp)
    return None


def to_python(reader, value: Value) -> Any:
    tag, p = value
    if tag == T_NULL:
        return None
    if tag == T_I64:
        return p - (1 << 64) if p >= (1 << 63) else p
    if tag == T_F64:
        return _unpack_f64(p)
    if tag == T_STR:
        return read_str(reader, p)
    if tag == T_BYTES:
        return read_bytes(reader, p)
    if tag == T_VEC:
        return [to_python(reader, vec_get(reader, p, i))
                for i in range(vec_len(reader, p))]
    if tag == T_MAP:
        return {k: to_python(reader, v) for k, v in map_items(reader, p)}
    raise InvalidPointer(f"corrupt value tag {tag}")


def _psize(reader) -> int:
    heap = getattr(reader, "heap", None)
    if heap is not None and not callable(heap):
        return heap.page_size
    if callable(heap):  # ServerCtx.heap()
        return heap().page_size
    return getattr(reader, "page_size")


# ---------------------------------------------------------------------------
# deep copy — conn.copy_from(ptr) (§5.6)
# ---------------------------------------------------------------------------
def deep_copy(src_reader, dst_scope: Scope, value: Value,
              pid: int = 0) -> Value:
    """Structurally copy an object graph into another heap's scope."""
    return build_value(dst_scope, to_python(src_reader, value), pid)


# ---------------------------------------------------------------------------
# predicate search over documents
# ---------------------------------------------------------------------------
def doc_matches(reader, root: int, path: List[str],
                pred: Callable[[Any], bool]) -> bool:
    """Walk ``path`` through nested maps from ``root`` and apply ``pred`` to
    the leaf (pointer chasing in shared memory — no deserialization of the
    rest of the document)."""
    cur: Value = (T_MAP, root)
    for comp in path:
        if cur[0] != T_MAP:
            return False
        nxt = map_get(reader, cur[1], comp)
        if nxt is None:
            return False
        cur = nxt
    return pred(to_python(reader, cur))
