"""Pure-Python snappy codec with xerial stream framing (copy of
``pinot_tpu.utils.snappy``).

Kafka 0.8-era producers commonly compressed MessageSets with snappy;
the port depends on no snappy library, so the block format
(https://github.com/google/snappy/blob/main/format_description.txt)
is implemented directly: varint uncompressed length, then a tag stream
of literals and back-references.  Kafka wraps snappy in snappy-java's
"xerial" framing (magic header + [uncompressed_len? no — chunked
compressed blocks]); ``decompress`` detects and unwraps it.

``decompress`` is what consuming from a broker whose producers chose
snappy needs; ``compress`` emits a valid literal-only encoding, for the
protocol shim's snappy message sets and the tests.
"""
from __future__ import annotations

import struct

_XERIAL_MAGIC = b"\x82SNAPPY\x00"


def _decompress_block(data: bytes) -> bytes:
    if not data:
        raise ValueError("snappy: empty block")
    pos = 0
    # varint: uncompressed length
    shift = 0
    length = 0
    while True:
        b = data[pos]
        pos += 1
        length |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 0x03
        if kind == 0:  # literal
            ln = (tag >> 2) + 1
            if ln > 60:
                extra = ln - 60
                ln = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            out += data[pos : pos + ln]
            pos += ln
            continue
        if kind == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x07) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("snappy: invalid back-reference")
        start = len(out) - offset
        if offset >= ln:
            out += out[start : start + ln]  # non-overlapping: one slice
        else:
            # overlapping copies are defined byte-by-byte
            for i in range(ln):
                out.append(out[start + i])
    if len(out) != length:
        raise ValueError(f"snappy: length mismatch {len(out)} != {length}")
    return bytes(out)


def decompress(data: bytes) -> bytes:
    """Snappy block data, or a snappy-java (xerial) framed stream of
    blocks as Kafka on-the-wire snappy uses."""
    if data.startswith(_XERIAL_MAGIC):
        pos = len(_XERIAL_MAGIC) + 8  # magic + version + compat ints
        blocks = []
        while pos < len(data):
            (size,) = struct.unpack(">i", data[pos : pos + 4])
            pos += 4
            blocks.append(_decompress_block(data[pos : pos + size]))
            pos += size
        return b"".join(blocks)
    return _decompress_block(data)


# -- compression (for tests / symmetric tooling): all-literal encoding
# is valid snappy, just uncompressed-size — fine for protocol tests.


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def compress(data: bytes) -> bytes:
    """Valid (literal-only) snappy encoding, decodable by any snappy
    implementation (the shim's snappy message sets, the tests)."""
    out = bytearray(_varint(len(data)))
    pos = 0
    while pos < len(data):
        chunk = data[pos : pos + 65536]
        ln = len(chunk) - 1
        if ln < 60:
            out.append(ln << 2)
        else:
            out.append(61 << 2)  # tag 61: 2-byte length literal
            out += (ln).to_bytes(2, "little")
        out += chunk
        pos += len(chunk)
    return bytes(out)
