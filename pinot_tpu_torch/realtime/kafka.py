"""Kafka binary wire protocol (v0): client, StreamProvider, and a
protocol-compat server shim (copy of ``pinot_tpu.realtime.kafka``).

The reference consumes real Kafka through
``core/realtime/impl/kafka/SimpleConsumerWrapper.java`` (LLC: Metadata
to find partition leaders, ListOffsets for earliest/latest, Fetch by
exact offset) and the high-level consumer for HLC.  The port depends on
no Kafka client library, so this module implements the wire
protocol itself — the v0 request/response encodings every Kafka broker
since 0.8 answers:

  Metadata    (api_key 3, v0): topics -> brokers + partition leaders
  ListOffsets (api_key 2, v0): (topic, partition, time -1|-2) -> offsets
  Fetch       (api_key 1, v0): (topic, partition, offset) -> MessageSet

MessageSet v0 is a raw byte stream of [offset int64 | size int32 |
crc int32 | magic int8 | attrs int8 | key bytes | value bytes]; a
truncated trailing message (the broker cuts at max_bytes) is dropped,
as the protocol requires.

``KafkaStreamProvider`` adapts the client to the offset-addressed
``StreamProvider`` interface the LLC/HLC machinery consumes (rows are
JSON message values, the ``KafkaJSONMessageDecoder`` analog).

``KafkaProtocolShim`` serves the SAME wire protocol over an in-process
``StreamBrokerServer``'s topic logs, so the client integration-tests
against real sockets without a Kafka deployment — the
``FileBasedStreamProviderImpl.java`` test-fake pattern, upgraded to
wire compatibility.  Pointing ``KafkaStreamProvider`` at a real Kafka
0.8+ broker is the same code path.
"""
from __future__ import annotations

import gzip
import io
import json
import socket
import struct
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

from pinot_tpu_torch.realtime.stream import Row, StreamProvider

API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3

EARLIEST = -2
LATEST = -1

ERR_NONE = 0
ERR_UNKNOWN_TOPIC = 3
ERR_OFFSET_OUT_OF_RANGE = 1
# shim-specific (outside the v0 error range): the addressed partition
# stores verbatim columnar blocks, which the row-oriented Kafka wire
# protocol cannot serve.  Mirrors the netstream broker's typed
# '{"error": "columnar partition"}' rejection — without it a populated
# columnar partition silently reported high-watermark 0 and consumers
# idled forever believing the partition empty.
ERR_COLUMNAR_PARTITION = 87


class ColumnarPartitionError(IOError):
    """A Kafka-protocol fetch/offsets request addressed a columnar-mode
    partition; consume it via the netstream fetchc transport instead."""


# -- primitive encoders ------------------------------------------------


def _i8(v: int) -> bytes:
    return struct.pack(">b", v)


def _i16(v: int) -> bytes:
    return struct.pack(">h", v)


def _i32(v: int) -> bytes:
    return struct.pack(">i", v)


def _i64(v: int) -> bytes:
    return struct.pack(">q", v)


def _string(s: Optional[str]) -> bytes:
    if s is None:
        return _i16(-1)
    b = s.encode()
    return _i16(len(b)) + b


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return _i32(-1)
    return _i32(len(b)) + b


class _Reader:
    def __init__(self, data: bytes) -> None:
        self._io = io.BytesIO(data)

    def _take(self, n: int) -> bytes:
        b = self._io.read(n)
        if len(b) != n:
            raise EOFError("short read")
        return b

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        return None if n < 0 else self._take(n).decode()

    def bytes(self) -> Optional[bytes]:
        n = self.i32()
        return None if n < 0 else self._take(n)

    def remaining(self) -> bytes:
        return self._io.read()


# -- MessageSet v0 -----------------------------------------------------


def encode_message(
    offset: int, value: bytes, key: Optional[bytes] = None, codec: int = 0
) -> bytes:
    body = _i8(0) + _i8(codec & 0x07) + _bytes(key) + _bytes(value)  # magic 0
    msg = _i32(_signed_crc(body)) + body
    return _i64(offset) + _i32(len(msg)) + msg


_CODEC_IDS = {"gzip": 1, "snappy": 2, "lz4": 3}


def compress_message_set(data: bytes, codec_name: str) -> bytes:
    """Compress an inner MessageSet with the named codec, producing the
    bytes a producer puts in the wrapper message's value."""
    if codec_name == "gzip":
        return gzip.compress(data)
    if codec_name == "snappy":
        from pinot_tpu_torch.utils.snappy import compress as snappy_compress

        return snappy_compress(data)
    if codec_name == "lz4":
        from pinot_tpu_torch.utils.lz4 import compress_frame

        return compress_frame(data)
    raise ValueError(f"unknown codec {codec_name!r}")


def _signed_crc(b: bytes) -> int:
    c = zlib.crc32(b) & 0xFFFFFFFF
    return c - (1 << 32) if c >= (1 << 31) else c


def decode_message_set(data: bytes) -> List[Tuple[int, Optional[bytes], bytes]]:
    """-> [(offset, key, value)]; silently drops a truncated tail (the
    broker cuts MessageSets at max_bytes mid-message by design)."""
    out: List[Tuple[int, Optional[bytes], bytes]] = []
    pos = 0
    n = len(data)
    while pos + 12 <= n:
        offset, size = struct.unpack(">qi", data[pos : pos + 12])
        if pos + 12 + size > n:
            break  # truncated tail
        r = _Reader(data[pos + 12 : pos + 12 + size])
        crc = r.i32()
        body = data[pos + 16 : pos + 12 + size]
        if _signed_crc(body) != crc:
            raise ValueError(f"message CRC mismatch at offset {offset}")
        r.i8()  # magic
        attrs = r.i8()
        key = r.bytes()
        value = r.bytes()
        codec = attrs & 0x07
        if codec == 0:
            out.append((offset, key, value if value is not None else b""))
        elif codec == 1:  # gzip wrapper: value is an inner MessageSet
            out.extend(decode_message_set(gzip.decompress(value or b"")))
        elif codec == 2:  # snappy (incl. xerial framing): pure-Python
            from pinot_tpu_torch.utils.snappy import decompress as snappy_decompress

            out.extend(decode_message_set(snappy_decompress(value or b"")))
        elif codec == 3:  # lz4 frame (incl. KAFKA-3160 header tolerance)
            from pinot_tpu_torch.utils.lz4 import decompress as lz4_decompress

            out.extend(decode_message_set(lz4_decompress(value or b"")))
        else:
            # fail loudly instead of handing compressed bytes to the
            # row decoder
            raise ValueError(
                f"unsupported message compression codec {codec} at offset "
                f"{offset} (gzip=1, snappy=2, lz4=3 are supported)"
            )
        pos += 12 + size
    return out


# -- client ------------------------------------------------------------


class KafkaWireClient:
    """Blocking single-connection Kafka v0 client (the
    ``SimpleConsumerWrapper.java`` analog)."""

    def __init__(self, host: str, port: int, client_id: str = "pinot-tpu", timeout: float = 30.0) -> None:
        self.host, self.port = host, port
        self.client_id = client_id
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._corr = 0
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port), timeout=self.timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _roundtrip(self, api_key: int, body: bytes) -> _Reader:
        with self._lock:
            self._corr += 1
            corr = self._corr
            header = _i16(api_key) + _i16(0) + _i32(corr) + _string(self.client_id)
            payload = header + body
            try:
                s = self._connect()
                s.sendall(_i32(len(payload)) + payload)
                resp = self._read_frame(s)
            except (OSError, EOFError):
                # one reconnect ride-through (broker restart / idle reap)
                self.close()
                s = self._connect()
                s.sendall(_i32(len(payload)) + payload)
                resp = self._read_frame(s)
        r = _Reader(resp)
        got = r.i32()
        if got != corr:
            raise ValueError(f"correlation mismatch: sent {corr} got {got}")
        return r

    @staticmethod
    def _read_frame(s: socket.socket) -> bytes:
        hdr = b""
        while len(hdr) < 4:
            chunk = s.recv(4 - len(hdr))
            if not chunk:
                raise EOFError("connection closed")
            hdr += chunk
        (n,) = struct.unpack(">i", hdr)
        buf = b""
        while len(buf) < n:
            chunk = s.recv(min(65536, n - len(buf)))
            if not chunk:
                raise EOFError("connection closed mid-frame")
            buf += chunk
        return buf

    # -- api calls -----------------------------------------------------
    def metadata(self, topics: Optional[List[str]] = None) -> Dict[str, Any]:
        ts = topics or []
        body = _i32(len(ts)) + b"".join(_string(t) for t in ts)
        r = self._roundtrip(API_METADATA, body)
        brokers = []
        for _ in range(r.i32()):
            node = r.i32()
            host = r.string()
            port = r.i32()
            brokers.append({"nodeId": node, "host": host, "port": port})
        topics_out = {}
        for _ in range(r.i32()):
            terr = r.i16()
            name = r.string()
            parts = {}
            for _ in range(r.i32()):
                perr = r.i16()
                pid = r.i32()
                leader = r.i32()
                replicas = [r.i32() for _ in range(r.i32())]
                isr = [r.i32() for _ in range(r.i32())]
                parts[pid] = {
                    "error": perr,
                    "leader": leader,
                    "replicas": replicas,
                    "isr": isr,
                }
            topics_out[name] = {"error": terr, "partitions": parts}
        return {"brokers": brokers, "topics": topics_out}

    def list_offsets(self, topic: str, partition: int, time: int = LATEST) -> List[int]:
        body = (
            _i32(-1)  # replica_id
            + _i32(1)
            + _string(topic)
            + _i32(1)
            + _i32(partition)
            + _i64(time)
            + _i32(1)  # max_num_offsets
        )
        r = self._roundtrip(API_LIST_OFFSETS, body)
        offsets: List[int] = []
        for _ in range(r.i32()):
            r.string()  # topic
            for _ in range(r.i32()):
                r.i32()  # partition
                err = r.i16()
                got = [r.i64() for _ in range(r.i32())]
                if err == ERR_COLUMNAR_PARTITION:
                    raise ColumnarPartitionError(
                        f"columnar partition {topic}/{partition}: not servable "
                        "over the row-oriented Kafka protocol (use fetchc)"
                    )
                if err != ERR_NONE:
                    raise IOError(f"ListOffsets error {err} for {topic}/{partition}")
                offsets.extend(got)
        return offsets

    MAX_FETCH_BYTES = 64 << 20  # growth cap for a single oversized message

    def fetch(
        self, topic: str, partition: int, offset: int, max_bytes: int = 1 << 20
    ) -> List[Tuple[int, Optional[bytes], bytes]]:
        while True:
            msgs, raw_len, decoded_any = self._fetch_once(
                topic, partition, offset, max_bytes
            )
            if msgs or raw_len == 0:
                return msgs
            # bytes came back but nothing usable decoded.  Two cases,
            # both cured by growing max_bytes (the reference
            # SimpleConsumer loop does the same): a single message
            # larger than max_bytes (truncated by the broker), or a
            # stored compressed wrapper wholly below the requested
            # offset with the NEXT wrapper cut off (decoded_any) —
            # growing lets that next wrapper fit.
            if max_bytes >= self.MAX_FETCH_BYTES:
                why = (
                    "below-offset wrapper region"
                    if decoded_any
                    else "message"
                )
                raise IOError(
                    f"{why} at {topic}/{partition}@{offset} exceeds "
                    f"{self.MAX_FETCH_BYTES} bytes"
                )
            max_bytes = min(max_bytes * 2, self.MAX_FETCH_BYTES)

    def _fetch_once(
        self, topic: str, partition: int, offset: int, max_bytes: int
    ) -> Tuple[List[Tuple[int, Optional[bytes], bytes]], int, bool]:
        body = (
            _i32(-1)  # replica_id
            + _i32(100)  # max_wait_ms
            + _i32(0)  # min_bytes
            + _i32(1)
            + _string(topic)
            + _i32(1)
            + _i32(partition)
            + _i64(offset)
            + _i32(max_bytes)
        )
        r = self._roundtrip(API_FETCH, body)
        msgs: List[Tuple[int, Optional[bytes], bytes]] = []
        raw_len = 0
        decoded_any = False
        for _ in range(r.i32()):
            r.string()  # topic
            for _ in range(r.i32()):
                r.i32()  # partition
                err = r.i16()
                r.i64()  # high watermark
                size = r.i32()
                data = r._take(size)
                if err == ERR_OFFSET_OUT_OF_RANGE:
                    raise IndexError(f"offset {offset} out of range for {topic}/{partition}")
                if err == ERR_COLUMNAR_PARTITION:
                    raise ColumnarPartitionError(
                        f"columnar partition {topic}/{partition}: not servable "
                        "over the row-oriented Kafka protocol (use fetchc)"
                    )
                if err != ERR_NONE:
                    raise IOError(f"Fetch error {err} for {topic}/{partition}")
                raw_len += len(data)
                # a REAL broker serves stored compressed wrappers whose
                # inner set may start BEFORE the requested offset (the
                # wrapper is the log unit); skip the below-offset inner
                # messages or they would re-ingest as duplicates
                decoded = decode_message_set(data)
                decoded_any = decoded_any or bool(decoded)
                msgs.extend(m for m in decoded if m[0] >= offset)
        return msgs, raw_len, decoded_any


class KafkaStreamProvider(StreamProvider):
    """LLC-shaped provider over the wire client: JSON message values
    decode to rows (``KafkaJSONMessageDecoder`` analog)."""

    def __init__(self, host: str, port: int, topic: str) -> None:
        self.host, self.port, self.topic = host, int(port), topic
        self.client = KafkaWireClient(host, int(port))

    def describe(self) -> Dict[str, Any]:
        return {"type": "kafka", "host": self.host, "port": self.port, "topic": self.topic}

    def partition_count(self) -> int:
        meta = self.client.metadata([self.topic])
        t = meta["topics"].get(self.topic)
        if t is None or t["error"] != ERR_NONE:
            raise IOError(f"topic {self.topic!r} metadata error: {t}")
        return len(t["partitions"])

    def fetch(self, partition: int, offset: int, max_rows: int) -> Tuple[List[Row], int]:
        # size the request to the row budget (adaptive avg message size)
        # instead of always pulling 1MB and discarding past max_rows —
        # otherwise the same tail bytes cross the socket every step
        est = getattr(self, "_avg_msg_bytes", 512)
        max_bytes = max(16384, min(1 << 20, max_rows * est * 2))
        msgs = self.client.fetch(self.topic, partition, offset, max_bytes=max_bytes)
        rows: List[Row] = []
        nxt = offset
        total_b = 0
        for moff, _key, value in msgs[:max_rows]:
            rows.append(json.loads(value.decode()))
            total_b += len(value) + 26  # + v0 header/crc overhead
            nxt = moff + 1
        if rows:
            self._avg_msg_bytes = max(64, total_b // len(rows))
        return rows, nxt

    def latest_offset(self, partition: int) -> int:
        offs = self.client.list_offsets(self.topic, partition, LATEST)
        return offs[0] if offs else 0


# -- protocol-compat server shim --------------------------------------


class KafkaProtocolShim:
    """Kafka v0 wire protocol served over a ``StreamBrokerServer``'s
    topic logs: the integration seam that lets the wire client run
    against real sockets without a Kafka deployment."""

    def __init__(
        self,
        stream_broker,
        host: str = "127.0.0.1",
        port: int = 0,
        compression: Optional[str] = None,
    ) -> None:
        from pinot_tpu_torch.realtime.kafka_group import GroupCoordinator

        if compression is not None and compression not in _CODEC_IDS:
            raise ValueError(f"unknown compression {compression!r}")
        self.compression = compression  # fetch batches ship compressed
        self.broker = stream_broker
        self.coordinator = GroupCoordinator()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.address = self._srv.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)

    def start(self) -> "KafkaProtocolShim":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    frame = KafkaWireClient._read_frame(conn)
                except (EOFError, OSError):
                    return
                r = _Reader(frame)
                api_key = r.i16()
                r.i16()  # api_version (v0 assumed)
                corr = r.i32()
                r.string()  # client_id
                if api_key == API_METADATA:
                    body = self._metadata(r)
                elif api_key == API_LIST_OFFSETS:
                    body = self._list_offsets(r)
                elif api_key == API_FETCH:
                    body = self._fetch(r)
                else:
                    body = self._group_api(api_key, r)
                    if body is None:
                        return  # unsupported api: drop the connection
                payload = _i32(corr) + body
                conn.sendall(_i32(len(payload)) + payload)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _group_api(self, api_key: int, r: _Reader) -> Optional[bytes]:
        """Consumer-group coordinator APIs (kafka_group.py)."""
        from pinot_tpu_torch.realtime import kafka_group as kg

        c = self.coordinator
        if api_key == kg.API_FIND_COORDINATOR:
            return c.find_coordinator(r, self.address)
        if api_key == kg.API_JOIN_GROUP:
            return c.join_group(r)
        if api_key == kg.API_SYNC_GROUP:
            return c.sync_group(r)
        if api_key == kg.API_HEARTBEAT:
            return c.heartbeat(r)
        if api_key == kg.API_LEAVE_GROUP:
            return c.leave_group(r)
        if api_key == kg.API_OFFSET_COMMIT:
            return c.offset_commit(r)
        if api_key == kg.API_OFFSET_FETCH:
            return c.offset_fetch(r)
        return None

    # topic access over the stream broker's internal state
    def _topic(self, name: str):
        return self.broker._topics.get(name)

    def _metadata(self, r: _Reader) -> bytes:
        want = [r.string() for _ in range(r.i32())]
        with self.broker._lock:
            names = list(self.broker._topics) if not want else [w for w in want]
        host, port = self.address
        out = _i32(1) + _i32(0) + _string(host) + _i32(port)  # one broker, node 0
        body = _i32(len(names))
        for name in names:
            t = self._topic(name)
            if t is None:
                body += _i16(ERR_UNKNOWN_TOPIC) + _string(name) + _i32(0)
                continue
            nparts = len(t.raw)
            body += _i16(ERR_NONE) + _string(name) + _i32(nparts)
            for p in range(nparts):
                body += (
                    _i16(ERR_NONE) + _i32(p) + _i32(0) + _i32(1) + _i32(0) + _i32(1) + _i32(0)
                )
        return out + body

    def _list_offsets(self, r: _Reader) -> bytes:
        r.i32()  # replica_id
        body = b""
        ntopics = r.i32()
        body += _i32(ntopics)
        for _ in range(ntopics):
            name = r.string()
            nparts = r.i32()
            body += _string(name) + _i32(nparts)
            t = self._topic(name)
            for _ in range(nparts):
                pid = r.i32()
                time = r.i64()
                r.i32()  # max_num_offsets
                if t is None or pid >= len(t.raw):
                    body += _i32(pid) + _i16(ERR_UNKNOWN_TOPIC) + _i32(0)
                    continue
                if t.columnar is not None and t.columnar.counts[pid]:
                    body += _i32(pid) + _i16(ERR_COLUMNAR_PARTITION) + _i32(0)
                    continue
                off = 0 if time == EARLIEST else len(t.raw[pid])
                body += _i32(pid) + _i16(ERR_NONE) + _i32(1) + _i64(off)
        return body

    def _fetch(self, r: _Reader) -> bytes:
        r.i32()  # replica_id
        r.i32()  # max_wait
        r.i32()  # min_bytes
        ntopics = r.i32()
        body = _i32(ntopics)
        for _ in range(ntopics):
            name = r.string()
            nparts = r.i32()
            body += _string(name) + _i32(nparts)
            t = self._topic(name)
            for _ in range(nparts):
                pid = r.i32()
                offset = r.i64()
                max_bytes = r.i32()
                if t is None or pid >= len(t.raw):
                    body += _i32(pid) + _i16(ERR_UNKNOWN_TOPIC) + _i64(0) + _i32(0)
                    continue
                if t.columnar is not None and t.columnar.counts[pid]:
                    # typed rejection, not a silent empty reply: the
                    # partition HAS data, just not row-protocol data
                    body += _i32(pid) + _i16(ERR_COLUMNAR_PARTITION) + _i64(0) + _i32(0)
                    continue
                log = t.raw[pid]  # stored serialized bytes, verbatim
                hw = len(log)
                if offset > hw:
                    body += _i32(pid) + _i16(ERR_OFFSET_OUT_OF_RANGE) + _i64(hw) + _i32(0)
                    continue
                parts = []  # complete encodings, shared by both paths
                size = 0
                tail = b""  # truncated partial message (raw path only)
                o = offset
                while o < hw:
                    m = encode_message(o, log[o])
                    if size + len(m) > max_bytes:
                        # real-broker behavior: cut the MessageSet at
                        # max_bytes, leaving a truncated partial message
                        # the client must drop (and grow+retry when it
                        # was the FIRST message)
                        tail = m[: max(0, max_bytes - size)]
                        break
                    parts.append(m)
                    size += len(m)
                    o += 1
                msgs = b"".join(parts) + tail
                if self.compression is not None and o > offset:
                    # producer-style wrapper: inner set compressed, the
                    # wrapper carries the LAST inner offset (the 0.8/0.9
                    # convention) and the codec bits in attrs; like the
                    # raw path, an over-budget wrapper is CUT at
                    # max_bytes (the stored-compressed-log behavior) so
                    # the client's grow+retry handling still engages.
                    # (A real broker's stored wrapper may also START
                    # below the requested offset — the client filters
                    # below-offset inner messages, _fetch_once.)
                    # An incompressible payload can make the wrapper
                    # exceed max_bytes even though the raw set fit — at
                    # the client's MAX_FETCH_BYTES ceiling that would
                    # turn a servable batch into a permanent truncation
                    # Re-pack with fewer messages until
                    # the wrapper fits; only a single message that still
                    # doesn't fit gets cut (the grow+retry case).
                    while True:
                        wrapper = encode_message(
                            offset + len(parts) - 1,
                            compress_message_set(b"".join(parts), self.compression),
                            codec=_CODEC_IDS[self.compression],
                        )
                        if len(wrapper) <= max_bytes or len(parts) <= 1:
                            break
                        parts.pop()
                    msgs = wrapper[:max_bytes]
                body += _i32(pid) + _i16(ERR_NONE) + _i64(hw) + _i32(len(msgs)) + msgs
        return body
