"""Network stream broker: a TCP log of offset-addressed partitions for
realtime ingestion (port of ``pinot_tpu.realtime.netstream``, without
the consumer groups).

The reference pulls from Kafka by exact offset (``SimpleConsumerWrapper.java``);
here a stream-broker server holds topics of append-only partition logs,
served over the 4-byte length-framed TCP transport of the query data
plane (``transport/tcp.py``), and ``NetworkStreamProvider`` is the client
the LLC consumers read through.  The frames are the reference's byte for
byte: a port provider talks to a reference broker and the other way
round.

Protocol: one JSON object a frame.
  {"op": "create",  "topic": t, "partitions": n}
  {"op": "produce", "topic": t, "partition": p, "rows": [{...}, ...]}
      -> {"firstOffset": o, "nextOffset": o'}
  {"op": "fetch",   "topic": t, "partition": p, "offset": o, "maxRows": m}
      -> {"rows": [...], "nextOffset": o'}
  {"op": "latest",  "topic": t, "partition": p} -> {"offset": o}
  {"op": "meta",    "topic": t} -> {"partitions": n}
and the columnar blocks (``COLUMNAR_MAGIC``, a JSON header, the column
buffers): ``producec`` stores a block verbatim, ``fetchc`` serves the
block that covers an offset.  A partition is row-mode or columnar from
its first produce.

With ``log_dir`` every row-mode partition is an append-only JSONL log
replayed when the broker restarts.  Left out, ROADMAP queue 1 item 29:
the consumer-group ops (join, heartbeat, commit, ...) and ``HLConsumer``.
"""
from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.realtime.stream import StreamProvider
from pinot_tpu_torch.transport.tcp import TcpServer, TcpTransport
from pinot_tpu_torch.utils.fileio import atomic_write

logger = logging.getLogger(__name__)

Row = Dict[str, Any]


class _Topic:
    """Partition logs stored as serialized per-row JSON bytes: rows are
    encoded once at produce, and a fetch reply is a byte splice with no
    re-serialization."""

    def __init__(self, partitions: int, log_paths: Optional[List[str]] = None) -> None:
        self.raw: List[List[bytes]] = [[] for _ in range(partitions)]
        self.columnar: Optional["_ColumnarLog"] = None  # created on first producec
        self.log_paths = log_paths
        self._log_files = None
        if log_paths is not None:
            for p, path in enumerate(log_paths):
                if os.path.exists(path):
                    self.raw[p] = self._recover(path)
            self._log_files = [open(path, "ab") for path in log_paths]

    def count(self, partition: int) -> int:
        if self.columnar is not None and self.columnar.counts[partition]:
            return self.columnar.counts[partition]
        return len(self.raw[partition])

    @staticmethod
    def _recover(path: str) -> List[bytes]:
        """Replay a partition log, truncating a torn tail: a crash
        (SIGKILL mid-append) can leave a partial last line, which must
        not stop the broker from coming back up (Kafka log recovery
        semantics).  Only a torn FINAL line is dropped; corruption
        earlier in the log still raises."""
        raw: List[bytes] = []
        lines = open(path, "rb").read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    # drop the torn tail atomically: a crash *during
                    # recovery* must not lose the whole log
                    atomic_write(
                        path, b"".join(l + b"\n" for l in lines[:i]), binary=True
                    )
                    break
                raise
            else:
                raw.append(bytes(line))
        return raw

    def append(self, partition: int, rows: Sequence[Row]) -> int:
        first = len(self.raw[partition])
        encoded = [
            json.dumps(row, separators=(",", ":")).encode("utf-8") for row in rows
        ]
        self.raw[partition].extend(encoded)
        if self._log_files is not None:
            f = self._log_files[partition]
            f.write(b"".join(b + b"\n" for b in encoded))
            f.flush()
        return first

    def fetch_frame(self, partition: int, offset: int, max_rows: int) -> bytes:
        """One fetch reply frame spliced from stored bytes."""
        chunk = self.raw[partition][offset : offset + max_rows]
        return (
            b'{"rows":[' + b",".join(chunk) + b'],"nextOffset":'
            + str(offset + len(chunk)).encode() + b"}"
        )

    def close(self) -> None:
        if self._log_files is not None:
            for f in self._log_files:
                f.close()


COLUMNAR_MAGIC = b"\xffC"  # cannot open a JSON frame


def pack_columnar(header: Dict[str, Any], buffers: Sequence[bytes]) -> bytes:
    hj = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return COLUMNAR_MAGIC + struct.pack("<I", len(hj)) + hj + b"".join(buffers)


def unpack_columnar(frame: bytes):
    """-> (header dict, buffer bytes after the header)."""
    (hlen,) = struct.unpack_from("<I", frame, 2)
    header = json.loads(frame[6 : 6 + hlen].decode("utf-8"))
    return header, frame[6 + hlen :]


class _ColumnarLog:
    """Columnar block log for one topic: whole produce blocks stored
    verbatim (start-offset keyed), served back as fetch frames with no
    re-encoding: the high-throughput ingest transport (a row-JSON log
    decodes every row; a columnar block decodes with np.frombuffer).
    A partition is row-mode or columnar-mode from its
    first produce; mixing is an error."""

    def __init__(self, partitions: int) -> None:
        # per partition: list of (start, n, cols_spec, buffers bytes)
        self.blocks: List[List[tuple]] = [[] for _ in range(partitions)]
        self.counts: List[int] = [0] * partitions

    def append(self, partition: int, n: int, cols_spec, buffers: bytes) -> int:
        first = self.counts[partition]
        self.blocks[partition].append((first, n, cols_spec, buffers))
        self.counts[partition] = first + n
        return first

    def fetch_frame(self, partition: int, offset: int) -> bytes:
        # blocks are consumed whole: a consumer always passes back the
        # nextOffset the previous reply carried, so binary-search the
        # block whose start covers the requested offset
        blocks = self.blocks[partition]
        lo, hi = 0, len(blocks)
        while lo < hi:
            mid = (lo + hi) // 2
            if blocks[mid][0] + blocks[mid][1] <= offset:
                lo = mid + 1
            else:
                hi = mid
        if lo >= len(blocks):
            return pack_columnar(
                {"n": 0, "start": offset, "nextOffset": offset, "cols": []}, []
            )
        start, n, cols_spec, buffers = blocks[lo]
        return pack_columnar(
            {"n": n, "start": start, "nextOffset": start + n, "cols": cols_spec},
            [buffers],
        )


class StreamBrokerServer:
    """The broker process: topics of offset-addressed partition logs."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        log_dir: Optional[str] = None,
    ) -> None:
        self.log_dir = log_dir
        self._topics: Dict[str, _Topic] = {}
        self._lock = threading.Lock()
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            # recover topics from on-disk logs
            for name in sorted(os.listdir(log_dir)):
                tdir = os.path.join(log_dir, name)
                if not os.path.isdir(tdir):
                    continue
                # order by numeric partition index: lexicographic sort
                # would put p10 before p2 and scramble the mapping
                indexed = []
                for f in os.listdir(tdir):
                    if f.startswith("p") and f.endswith(".jsonl"):
                        try:
                            indexed.append((int(f[1 : -len(".jsonl")]), f))
                        except ValueError:
                            continue
                paths = [
                    os.path.join(tdir, f) for _, f in sorted(indexed)
                ]
                if paths:
                    self._topics[name] = _Topic(len(paths), paths)
        self.server = TcpServer(self._handle, host=host, port=port)

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()
        with self._lock:
            for t in self._topics.values():
                t.close()

    # -- topic management (also usable in-process) ---------------------
    def create_topic(self, topic: str, partitions: int) -> None:
        with self._lock:
            if topic in self._topics:
                return
            log_paths = None
            if self.log_dir is not None:
                tdir = os.path.join(self.log_dir, topic)
                os.makedirs(tdir, exist_ok=True)
                log_paths = [
                    os.path.join(tdir, f"p{p}.jsonl") for p in range(partitions)
                ]
            self._topics[topic] = _Topic(partitions, log_paths)

    def _handle(self, payload: bytes) -> bytes:
        if payload[:2] == COLUMNAR_MAGIC:
            return self._handle_columnar(payload)
        req = json.loads(payload.decode("utf-8"))
        op = req.get("op")
        try:
            if op == "create":
                self.create_topic(req["topic"], int(req.get("partitions", 1)))
                return json.dumps({"status": "ok"}).encode()
            with self._lock:
                topic = self._topics.get(req.get("topic", ""))
                if topic is None:
                    return json.dumps({"error": "unknown topic"}).encode()
                if op == "produce":
                    p = int(req.get("partition", 0))
                    if topic.columnar is not None and topic.columnar.counts[p]:
                        return json.dumps(
                            {"error": "partition already columnar-mode"}
                        ).encode()
                    first = topic.append(p, req.get("rows", []))
                    return json.dumps(
                        {"firstOffset": first, "nextOffset": len(topic.raw[p])}
                    ).encode()
                if op == "fetch":
                    p = int(req.get("partition", 0))
                    off = int(req.get("offset", 0))
                    m = int(req.get("maxRows", 1000))
                    if topic.columnar is not None and topic.columnar.counts[p]:
                        return json.dumps({"error": "columnar partition"}).encode()
                    return topic.fetch_frame(p, off, m)
                if op == "fetchc":
                    p = int(req.get("partition", 0))
                    off = int(req.get("offset", 0))
                    if len(topic.raw[p]):
                        return json.dumps({"error": "row-mode partition"}).encode()
                    columnar = topic.columnar
                    if columnar is None:
                        return pack_columnar(
                            {"n": 0, "start": off, "nextOffset": off, "cols": []},
                            [],
                        )
                elif op == "latest":
                    p = int(req.get("partition", 0))
                    return json.dumps({"offset": topic.count(p)}).encode()
                elif op == "meta":
                    return json.dumps({"partitions": len(topic.raw)}).encode()
                else:
                    return json.dumps({"error": f"unknown op {op!r}"}).encode()
            # fetchc reaches here: splice the reply OUTSIDE the broker
            # lock — packing a multi-megabyte block frame under it
            # would serialize every partition-parallel consumer on one
            # fetch (the block list is append-only, so a concurrent
            # produce is at worst not-yet-visible, never torn)
            return columnar.fetch_frame(p, off)
        except (KeyError, IndexError, ValueError) as e:
            return json.dumps({"error": str(e)}).encode()
        except Exception as e:  # never kill the connection on a bad frame
            logger.warning("stream broker op %r failed", op, exc_info=True)
            return json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()

    def _handle_columnar(self, payload: bytes) -> bytes:
        """Binary columnar produce: the block is stored VERBATIM and
        served back by fetchc with zero broker-side (de)serialization."""
        try:
            header, buffers = unpack_columnar(payload)
            if header.get("op") != "producec":
                return json.dumps({"error": "bad columnar op"}).encode()
            p = int(header.get("partition", 0))
            expect = sum(
                int(header["n"]) * np.dtype(dt).itemsize
                for _, dt in header["cols"]
            )
            if expect != len(buffers):
                return json.dumps(
                    {"error": f"columnar buffer size mismatch: {len(buffers)} != {expect}"}
                ).encode()
            with self._lock:
                topic = self._topics.get(header.get("topic", ""))
                if topic is None:
                    return json.dumps({"error": "unknown topic"}).encode()
                if topic.log_paths is not None:
                    return json.dumps(
                        {"error": "columnar produce unsupported on durable-log topics"}
                    ).encode()
                if len(topic.raw[p]):
                    return json.dumps(
                        {"error": "partition already row-mode"}
                    ).encode()
                if topic.columnar is None:
                    topic.columnar = _ColumnarLog(len(topic.raw))
                first = topic.columnar.append(
                    p, int(header["n"]), header["cols"], buffers
                )
                return json.dumps(
                    {"firstOffset": first, "nextOffset": topic.columnar.counts[p]}
                ).encode()
        except Exception as e:
            logger.warning("columnar produce failed", exc_info=True)
            return json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()


class NetworkStreamProvider(StreamProvider):
    """LLC-shaped consumer client of a StreamBrokerServer — the
    SimpleConsumerWrapper analog (exact-offset fetch over TCP)."""

    def __init__(self, host: str, port: int, topic: str) -> None:
        self.host = host
        self.port = int(port)
        self.topic = topic
        self._transport = TcpTransport()

    _IDEMPOTENT_OPS = ("create", "fetch", "latest", "meta")

    def _call(self, req: Dict[str, Any]) -> Dict[str, Any]:
        payload = json.dumps({"topic": self.topic, **req}).encode()
        try:
            raw = self._transport.request((self.host, self.port), payload)
        except Exception:
            # connection resets happen under fd/process churn; all ops
            # except produce are idempotent (group commits are
            # monotonic), so one retry on a fresh connection is safe
            if req.get("op") not in self._IDEMPOTENT_OPS:
                raise
            time.sleep(0.05)
            raw = self._transport.request((self.host, self.port), payload)
        reply = json.loads(raw.decode("utf-8"))
        if "error" in reply:
            raise RuntimeError(f"stream broker: {reply['error']}")
        return reply

    def describe(self) -> Dict[str, Any]:
        """Descriptor for the controller property store, so recovered
        controllers (and remote consumers) can reconnect."""
        return {
            "type": "network",
            "host": self.host,
            "port": self.port,
            "topic": self.topic,
        }

    def partition_count(self) -> int:
        return int(self._call({"op": "meta"})["partitions"])

    def fetch(self, partition: int, offset: int, max_rows: int) -> Tuple[List[Row], int]:
        out = self._call(
            {"op": "fetch", "partition": partition, "offset": offset, "maxRows": max_rows}
        )
        return out["rows"], int(out["nextOffset"])

    def latest_offset(self, partition: int) -> int:
        return int(self._call({"op": "latest", "partition": partition})["offset"])

    def produce(self, row: Row, partition: int = 0) -> int:
        """Producer convenience (tests/quickstarts)."""
        return int(
            self._call({"op": "produce", "partition": partition, "rows": [row]})[
                "firstOffset"
            ]
        )

    def produce_batch(self, rows: Sequence[Row], partition: int = 0) -> int:
        return int(
            self._call({"op": "produce", "partition": partition, "rows": list(rows)})[
                "firstOffset"
            ]
        )

    def create_topic(self, partitions: int) -> None:
        self._call({"op": "create", "partitions": partitions})

    # -- columnar fast path -------------------------------------------
    def produce_columns(self, cols: Dict[str, Any], partition: int = 0) -> int:
        """Produce one columnar block (dict of equal-length numpy
        arrays).  Stored verbatim broker-side; the matching consumer
        call is :meth:`fetch_columns`."""
        names = list(cols)
        arrays = [np.ascontiguousarray(cols[c]) for c in names]
        n = len(arrays[0]) if arrays else 0
        if any(len(a) != n for a in arrays):
            raise ValueError("columnar block arrays must share one length")
        header = {
            "op": "producec",
            "topic": self.topic,
            "partition": partition,
            "n": n,
            "cols": [[c, a.dtype.str] for c, a in zip(names, arrays)],
        }
        frame = pack_columnar(header, [a.tobytes() for a in arrays])
        raw = self._transport.request((self.host, self.port), frame)
        reply = json.loads(raw.decode("utf-8"))
        if "error" in reply:
            raise RuntimeError(f"stream broker: {reply['error']}")
        return int(reply["firstOffset"])

    def fetch_columns(self, partition: int, offset: int):
        """-> (cols dict of numpy arrays, n, nextOffset): one whole
        produced block, decoded with np.frombuffer (no row objects)."""
        payload = json.dumps(
            {"op": "fetchc", "topic": self.topic, "partition": partition, "offset": offset}
        ).encode()
        raw = self._transport.request((self.host, self.port), payload)
        if raw[:2] != COLUMNAR_MAGIC:
            reply = json.loads(raw.decode("utf-8"))
            raise RuntimeError(f"stream broker: {reply.get('error', 'bad reply')}")
        header, buffers = unpack_columnar(raw)
        n = int(header["n"])
        out: Dict[str, Any] = {}
        pos = 0
        for name, dt in header["cols"]:
            dtype = np.dtype(dt)
            size = n * dtype.itemsize
            out[name] = np.frombuffer(buffers[pos : pos + size], dtype=dtype)
            pos += size
        # blocks serve whole: a resume offset landing MID-block trims
        # the rows before it so no consumer ever re-ingests duplicates
        start = int(header.get("start", offset))
        if n and start < offset:
            skip = offset - start
            out = {c: a[skip:] for c, a in out.items()}
            n -= skip
        return out, n, int(header["nextOffset"])
