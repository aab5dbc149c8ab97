"""The msgpack subset of a checkpoint shard: one map of str keys to bin
values.

This is what ``msgpack.packb(payload, use_bin_type=True)`` writes for a
``{str: bytes}`` payload, byte for byte: every length takes the smallest
header that holds it (map: fixmap, map16, map32; str: fixstr, str8,
str16, str32; bin: bin8, bin16, bin32; lengths big-endian). The port
carries its own codec so that it needs no ``msgpack`` package, and
writes the shard as a stream of chunks so that a state never exists
twice in host memory.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterable, Iterator, Sequence, Tuple

__all__ = ["map_header", "str_header", "bin_header", "packed_chunks",
           "packed_size", "unpackb"]

def _header(n: int, fix: int, fix_max: int, tags: Sequence[Tuple[int, str]],
            what: str) -> bytes:
    if n < 0:
        raise ValueError(f"negative {what} length {n}")
    if fix and n <= fix_max:
        return bytes([fix | n])
    for tag, fmt in tags:
        if n <= (1 << (8 * struct.calcsize(fmt))) - 1:
            return bytes([tag]) + struct.pack(">" + fmt, n)
    raise ValueError(f"{what} of length {n} exceeds msgpack's 2**32 - 1")


def map_header(n: int) -> bytes:
    return _header(n, 0x80, 15, ((0xDE, "H"), (0xDF, "I")), "map")


def str_header(n: int) -> bytes:
    return _header(n, 0xA0, 31, ((0xD9, "B"), (0xDA, "H"), (0xDB, "I")), "str")


def bin_header(n: int) -> bytes:
    return _header(n, 0, 0, ((0xC4, "B"), (0xC5, "H"), (0xC6, "I")), "bin")


def packed_chunks(count: int, items: Iterable[Tuple[str, Any]]) -> Iterator[Any]:
    """The packed map of ``items``, ``count`` ``(key, buffer)`` pairs in
    order, as a stream: headers and keys as bytes, each value as the
    buffer it was given (anything with the buffer protocol,
    C-contiguous). ``items`` is read one pair at a time."""
    yield map_header(count)
    for key, value in items:
        k = key.encode("utf-8")
        yield str_header(len(k)) + k
        yield bin_header(memoryview(value).nbytes)
        yield value


def packed_size(items: Sequence[Tuple[str, int]]) -> int:
    """Bytes of the packed map of ``(key, value length)`` pairs."""
    total = len(map_header(len(items)))
    for key, n in items:
        k = len(key.encode("utf-8"))
        total += len(str_header(k)) + k + len(bin_header(n)) + n
    return total


_MAP = {0xDE: 2, 0xDF: 4}
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}


def _length(buf: memoryview, pos: int, fix: int, fix_mask: int,
            tags: Dict[int, int], what: str) -> Tuple[int, int]:
    if pos >= len(buf):
        raise ValueError(f"truncated shard: {what} header past the end")
    tag = buf[pos]
    if fix and tag & ~fix_mask & 0xFF == fix:
        return tag & fix_mask, pos + 1
    width = tags.get(tag)
    if width is None:
        raise ValueError(f"shard byte {pos}: 0x{tag:02x} is no msgpack {what} "
                         "header (a checkpoint shard is a map of str to bin)")
    if pos + 1 + width > len(buf):
        raise ValueError(f"truncated shard: {what} length past the end")
    return int.from_bytes(buf[pos + 1:pos + 1 + width], "big"), pos + 1 + width


def unpackb(buf: Any) -> Dict[str, memoryview]:
    """The map packed in ``buf``: each key with a view of its value's
    bytes in ``buf`` (no copy). Raises ``ValueError`` on anything but one
    map of str to bin filling the whole buffer."""
    mv = memoryview(buf).cast("B")
    n, pos = _length(mv, 0, 0x80, 0x0F, _MAP, "map")
    out: Dict[str, memoryview] = {}
    for _ in range(n):
        klen, pos = _length(mv, pos, 0xA0, 0x1F, _STR, "str")
        if pos + klen > len(mv):
            raise ValueError("truncated shard: key past the end")
        key = bytes(mv[pos:pos + klen]).decode("utf-8")
        vlen, pos = _length(mv, pos + klen, 0, 0, _BIN, "bin")
        if pos + vlen > len(mv):
            raise ValueError(f"truncated shard: value of {key!r} past the end")
        out[key] = mv[pos:pos + vlen]
        pos += vlen
    if pos != len(mv):
        raise ValueError(f"shard holds {len(mv) - pos} bytes after its map")
    return out
