"""Pure-Python LZ4 codec, frame and block formats (copy of
``pinot_tpu.utils.lz4``).

Kafka producers using codec 3 compress MessageSets with LZ4.  Kafka's
own wrapping is the standard LZ4 *frame* format (magic ``0x184D2204``)
— with the historical quirk that pre-0.10 clients computed the frame
header checksum over the wrong bytes (KAFKA-3160).  The port depends on
no lz4 library, so both formats are implemented directly from the
public spec (https://github.com/lz4/lz4/blob/dev/doc):

- ``decompress_block``: the raw block format — a sequence of
  (literals, back-reference) pairs.  Overlapping matches (offset <
  length) replicate bytes, e.g. offset 1 is RLE.
- ``decompress_frame``: frame descriptor + data blocks.  Checksums
  are parsed and *skipped*, not verified — this makes the reader
  compatible with both the correct and the KAFKA-3160-broken header
  checksum; CRC integrity for Kafka messages is already enforced
  per-message by ``decode_message_set``.
- ``compress_block`` / ``compress_frame``: a correct greedy
  hash-table compressor emitting spec-valid frames (real xxHash32
  header checksum, so conformant external readers accept the output).
  It exists for round-trip testing and for the protocol-compat shim's
  producers; ratio is not the point.

Reference behavior target: Kafka's lz4 MessageSet codec as consumed by
``core/realtime/impl/kafka/SimpleConsumerWrapper.java`` (which defers
to kafka-clients' ``KafkaLZ4BlockInputStream``).
"""
from __future__ import annotations

import struct

FRAME_MAGIC = 0x184D2204
_SKIP_MAGIC_MIN = 0x184D2A50
_SKIP_MAGIC_MAX = 0x184D2A5F

_MIN_MATCH = 4


def _decode_block_into(
    out: bytearray, data: bytes, window_start: int, max_len: int | None
) -> None:
    """Decode one raw LZ4 block, appending to ``out``.  Matches may
    reach back to ``out[window_start:]`` (the frame's linked-block
    window — ``window_start == len(out)`` means an independent block);
    ``max_len`` bounds the total ``out`` length BEFORE any copy runs,
    so attacker-shaped length fields can't balloon memory."""
    pos = 0
    n = len(data)
    while pos < n:
        token = data[pos]
        pos += 1
        # literals ------------------------------------------------------
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if pos >= n:
                    raise ValueError("lz4: truncated literal length")
                b = data[pos]
                pos += 1
                lit_len += b
                if b != 255:
                    break
        if pos + lit_len > n:
            raise ValueError("lz4: literal run past end of block")
        if max_len is not None and len(out) + lit_len > max_len:
            raise ValueError("lz4: output exceeds declared size")
        out += data[pos : pos + lit_len]
        pos += lit_len
        if pos == n:
            break  # last sequence carries only literals
        # match ---------------------------------------------------------
        if pos + 2 > n:
            raise ValueError("lz4: truncated match offset")
        offset = data[pos] | (data[pos + 1] << 8)
        pos += 2
        if offset == 0:
            raise ValueError("lz4: zero match offset")
        if offset > len(out) - window_start:
            raise ValueError("lz4: match offset outside window")
        match_len = (token & 0x0F) + _MIN_MATCH
        if (token & 0x0F) == 15:
            while True:
                if pos >= n:
                    raise ValueError("lz4: truncated match length")
                b = data[pos]
                pos += 1
                match_len += b
                if b != 255:
                    break
        if max_len is not None and len(out) + match_len > max_len:
            raise ValueError("lz4: output exceeds declared size")
        start = len(out) - offset
        if offset >= match_len:
            out += out[start : start + match_len]
        else:
            # overlapping match: replicate the period by doubling
            # slices instead of per-byte appends (offset 1 == RLE)
            chunk = bytes(out[start:])
            reps = match_len // len(chunk) + 1
            out += (chunk * reps)[:match_len]


def decompress_block(data: bytes, max_output: int | None = None) -> bytes:
    """Decode one standalone raw LZ4 block."""
    out = bytearray()
    _decode_block_into(out, data, 0, max_output)
    return bytes(out)


def decompress_frame(data: bytes) -> bytes:
    """Decode a standard LZ4 frame (possibly preceded by skippable
    frames); trailing bytes after the EndMark are ignored."""
    pos = 0
    n = len(data)
    while True:
        if pos + 4 > n:
            raise ValueError("lz4: truncated frame magic")
        magic = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        if _SKIP_MAGIC_MIN <= magic <= _SKIP_MAGIC_MAX:
            if pos + 4 > n:
                raise ValueError("lz4: truncated skippable frame")
            size = struct.unpack_from("<I", data, pos)[0]
            pos += 4 + size
            continue
        if magic != FRAME_MAGIC:
            raise ValueError(f"lz4: bad frame magic 0x{magic:08x}")
        break
    if pos + 2 > n:
        raise ValueError("lz4: truncated frame descriptor")
    flg = data[pos]
    bd = data[pos + 1]
    pos += 2
    version = (flg >> 6) & 0x03
    if version != 1:
        raise ValueError(f"lz4: unsupported frame version {version}")
    block_indep = bool(flg & 0x20)
    block_checksum = bool(flg & 0x10)
    content_size_flag = bool(flg & 0x08)
    content_checksum = bool(flg & 0x04)
    if flg & 0x01:
        raise ValueError("lz4: dictionary frames not supported")
    bs_code = (bd >> 4) & 0x07
    if bs_code < 4:
        raise ValueError(f"lz4: invalid block max-size code {bs_code}")
    block_max = 1 << (8 + 2 * bs_code)  # 4:64KB 5:256KB 6:1MB 7:4MB
    content_size = None
    if content_size_flag:
        if pos + 8 > n:
            raise ValueError("lz4: truncated content size")
        content_size = struct.unpack_from("<Q", data, pos)[0]
        pos += 8
    pos += 1  # HC byte — parsed, not verified (KAFKA-3160 tolerance)

    out = bytearray()
    while True:
        if pos + 4 > n:
            raise ValueError("lz4: truncated block header")
        raw = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        if raw == 0:  # EndMark
            break
        uncompressed = bool(raw & 0x80000000)
        size = raw & 0x7FFFFFFF
        if size > block_max:
            raise ValueError("lz4: block larger than frame's declared max")
        if pos + size > n:
            raise ValueError("lz4: truncated data block")
        block = data[pos : pos + size]
        pos += size
        if block_checksum:
            pos += 4  # parsed, not verified
        if uncompressed:
            out += block
        else:
            # linked blocks (librdkafka's LZ4F default) may back-
            # reference up to 64KB into prior blocks' output
            window_start = len(out) if block_indep else max(0, len(out) - 65536)
            _decode_block_into(out, block, window_start, len(out) + block_max)
    if content_checksum:
        pos += 4  # parsed, not verified
    if content_size is not None and len(out) != content_size:
        raise ValueError(
            f"lz4: content size mismatch ({len(out)} != {content_size})"
        )
    return bytes(out)


def decompress(data: bytes) -> bytes:
    """Frame-or-block entry point: frames are self-identifying by magic;
    anything else is treated as one raw block."""
    if len(data) >= 4:
        magic = struct.unpack_from("<I", data, 0)[0]
        if magic == FRAME_MAGIC or _SKIP_MAGIC_MIN <= magic <= _SKIP_MAGIC_MAX:
            return decompress_frame(data)
    return decompress_block(data)


# -- compression (testing + shim producers) ----------------------------


def compress_block(data: bytes) -> bytes:
    """Greedy single-pass LZ4 block compressor.

    Spec-conformant output: matches are >= 4 bytes, the final sequence
    is literals-only, and (as the reference encoder guarantees) the
    last 5 bytes are always emitted as literals with no match starting
    within 12 bytes of the end.
    """
    n = len(data)
    out = bytearray()

    def emit(lit_start: int, lit_end: int, offset: int, match_len: int) -> None:
        lit_len = lit_end - lit_start
        ml = 0 if match_len == 0 else match_len - _MIN_MATCH
        token_lit = 15 if lit_len >= 15 else lit_len
        token_ml = 15 if ml >= 15 else ml
        out.append((token_lit << 4) | token_ml)
        rem = lit_len - 15
        while rem >= 0:
            out.append(min(rem, 255))
            if rem < 255:
                break
            rem -= 255
        out.extend(data[lit_start:lit_end])
        if match_len:
            out.append(offset & 0xFF)
            out.append(offset >> 8)
            rem = ml - 15
            while rem >= 0:
                out.append(min(rem, 255))
                if rem < 255:
                    break
                rem -= 255

    if n < 13:  # too short for any legal match placement
        emit(0, n, 0, 0)
        return bytes(out)

    table: dict[bytes, int] = {}
    anchor = 0
    i = 0
    limit = n - 12  # no match may start past here
    match_limit = n - 5  # matches must end before the last 5 bytes
    while i < limit:
        key = data[i : i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF and data[cand : cand + 4] == key:
            m = i + 4
            c = cand + 4
            while m < match_limit and data[m] == data[c]:
                m += 1
                c += 1
            emit(anchor, i, i - cand, m - i)
            anchor = i = m
            continue
        i += 1
    emit(anchor, n, 0, 0)
    return bytes(out)


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (https://github.com/Cyan4973/xxHash/blob/dev/doc/
    xxhash_spec.md) — needed so emitted frame header checksums are
    spec-valid for conformant external readers."""
    P1, P2, P3, P4, P5 = (
        2654435761, 2246822519, 3266489917, 668265263, 374761393,
    )
    M = 0xFFFFFFFF

    def rotl(x: int, r: int) -> int:
        return ((x << r) | (x >> (32 - r))) & M

    n = len(data)
    i = 0
    if n >= 16:
        v1, v2, v3, v4 = (seed + P1 + P2) & M, (seed + P2) & M, seed & M, (seed - P1) & M
        while i + 16 <= n:
            lanes = struct.unpack_from("<IIII", data, i)
            v1 = (rotl((v1 + lanes[0] * P2) & M, 13) * P1) & M
            v2 = (rotl((v2 + lanes[1] * P2) & M, 13) * P1) & M
            v3 = (rotl((v3 + lanes[2] * P2) & M, 13) * P1) & M
            v4 = (rotl((v4 + lanes[3] * P2) & M, 13) * P1) & M
            i += 16
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i + 4 <= n:
        h = (rotl((h + struct.unpack_from("<I", data, i)[0] * P3) & M, 17) * P4) & M
        i += 4
    while i < n:
        h = (rotl((h + data[i] * P5) & M, 11) * P1) & M
        i += 1
    h ^= h >> 15
    h = (h * P2) & M
    h ^= h >> 13
    h = (h * P3) & M
    h ^= h >> 16
    return h


def compress_frame(data: bytes) -> bytes:
    """Wrap compressed blocks in a minimal standard frame (4MB-max
    blocks, content size present, block/content checksums absent,
    spec-correct header checksum)."""
    out = bytearray(struct.pack("<I", FRAME_MAGIC))
    flg = (1 << 6) | 0x08 | 0x20  # version 1, content size, block indep
    bd = 7 << 4  # 4MB max block
    descriptor = bytes([flg, bd]) + struct.pack("<Q", len(data))
    out += descriptor
    out.append((xxh32(descriptor) >> 8) & 0xFF)
    view = memoryview(data)
    block_cap = 4 << 20
    for start in range(0, len(data), block_cap):
        chunk = bytes(view[start : start + block_cap])
        comp = compress_block(chunk)
        if len(comp) < len(chunk):
            out += struct.pack("<I", len(comp)) + comp
        else:
            out += struct.pack("<I", 0x80000000 | len(chunk)) + chunk
    out += struct.pack("<I", 0)  # EndMark
    return bytes(out)
