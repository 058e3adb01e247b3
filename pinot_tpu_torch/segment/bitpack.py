"""Fixed-bit packing of dictIds, the segment file's forward-index codec
(copy of ``pinot_tpu.segment.bitpack``, numpy only).

DictIds are stored with ``ceil(log2(cardinality))`` bits each, little-
endian bit order within each byte.  The reference calls its g++ codec
for arrays of 4096 values or more when one is built, else slices bits
with uint64 shifts; the port packs with ``np.unpackbits`` /
``np.packbits`` over each value's bytes, which writes the same bytes in
far fewer passes over the data, and unpacks with eight strided word
reads (a segment's load was 90 % bit-unpacking before them).
"""
from __future__ import annotations

import numpy as np

# values packed per numpy pass: bounds the [n, nbits] bit matrix
_CHUNK = 1 << 20


def bits_required(cardinality: int) -> int:
    """Minimum bits to store dictIds in [0, cardinality)."""
    if cardinality <= 1:
        return 1
    return int(cardinality - 1).bit_length()


def _pack(values: np.ndarray, nbits: int) -> np.ndarray:
    # each value's little-endian bytes -> its bits, low bit first; keep the
    # low nbits of each, then pack the stream 8 bits a byte, low bit first
    v = np.ascontiguousarray(values, dtype="<u4")
    bits = np.unpackbits(v.view(np.uint8).reshape(-1, 4), axis=1, bitorder="little")[:, :nbits]
    return np.packbits(bits.reshape(-1), bitorder="little")


def pack_bits(values: np.ndarray, nbits: int) -> np.ndarray:
    """Pack non-negative int values (below 2^nbits, nbits <= 32) into a
    uint8 byte stream, little-endian bit order.  Packed in chunks of a
    multiple of 8 values, so each chunk ends on a byte boundary and the
    chunks concatenate to the one-pass bytes."""
    values = np.asarray(values).reshape(-1)
    n = values.size
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    if n <= _CHUNK:
        return _pack(values, nbits)
    return np.concatenate([_pack(values[i : i + _CHUNK], nbits) for i in range(0, n, _CHUNK)])


def _unpack(packed: np.ndarray, nbits: int, count: int) -> np.ndarray:
    # eight values span nbits bytes, so value j of every group of eight
    # starts at the same bit of its group: read the 8 bytes from there as
    # one little-endian word (a view striding nbits bytes over the
    # zero-padded stream), shift and mask
    groups = -(-count // 8)
    need = groups * nbits
    buf = np.zeros(need + 8, dtype=np.uint8)
    n = min(need, packed.size)
    buf[:n] = packed[:n]
    mask = np.uint64((1 << nbits) - 1)
    out = np.empty((groups, 8), dtype=np.int32)
    for j in range(8):
        bit = j * nbits
        words = np.ndarray((groups,), dtype="<u8", buffer=buf, offset=bit >> 3, strides=(nbits,))
        out[:, j] = (words >> np.uint64(bit & 7)) & mask
    return out.reshape(-1)[:count]


def unpack_bits(packed: np.ndarray, nbits: int, count: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`; returns an int32 array of length count."""
    if count == 0:
        return np.zeros(0, dtype=np.int32)
    packed = np.asarray(packed, dtype=np.uint8).reshape(-1)
    if count <= _CHUNK:
        return _unpack(packed, nbits, count)
    step = _CHUNK * nbits // 8  # bytes per chunk of _CHUNK values
    return np.concatenate([
        _unpack(packed[(i // _CHUNK) * step :], nbits, min(_CHUNK, count - i))
        for i in range(0, count, _CHUNK)
    ])
