"""Stream providers: offset-addressed row sources for realtime ingestion
(port of ``pinot_tpu.realtime.stream``).

The reference consumes Kafka by exact partition offset (LLC,
``SimpleConsumerWrapper.java``) and ships a file-backed fake for tests
(``FileBasedStreamProviderImpl.java``).  Every provider here speaks that
interface: ``fetch(partition, offset, max_rows) -> (rows, next_offset)``.
The network provider is ``realtime/netstream.py``, the Kafka wire-protocol
provider ``realtime/kafka.py``; the high-level consumers of a consumer
group are ``netstream.HLConsumer`` and ``kafka_group.KafkaGroupConsumer``.
"""
from __future__ import annotations

import json
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

Row = Dict[str, Any]


class LagProbe:
    """Consumer lag, TTL-cached: the latest offset of the partition minus
    the consumed offset.  ``latest_offset`` may be a stream-broker call
    and the probe runs on every metrics scrape, so the value is kept for
    ``TTL_S`` (dropped when the consumer advances) and a failed probe
    answers the last known value."""

    TTL_S = 5.0

    def __init__(self, stream: "StreamProvider", partition: int, offset_fn) -> None:
        self.stream = stream
        self.partition = partition
        self.offset_fn = offset_fn  # () -> consumed offset, read live
        self._cache: Optional[Tuple[Optional[int], float, int]] = None

    def __call__(self) -> Optional[int]:
        now = time.monotonic()
        offset = int(self.offset_fn())
        c = self._cache
        if c is not None and c[2] == offset and now - c[1] < self.TTL_S:
            return c[0]
        try:
            latest = int(self.stream.latest_offset(self.partition))
        except Exception:
            return c[0] if c is not None else None
        val = max(0, latest - offset)
        self._cache = (val, now, offset)
        return val


class StreamProvider:
    """Offset-addressed partition reader."""

    def partition_count(self) -> int:
        raise NotImplementedError

    def fetch(self, partition: int, offset: int, max_rows: int) -> Tuple[List[Row], int]:
        """Return (rows, next_offset) starting at ``offset``."""
        raise NotImplementedError

    def latest_offset(self, partition: int) -> int:
        raise NotImplementedError


class MemoryStreamProvider(StreamProvider):
    """In-memory partitions; producers append, consumers fetch by offset."""

    def __init__(self, num_partitions: int = 1) -> None:
        self._partitions: List[List[Row]] = [[] for _ in range(num_partitions)]
        self._lock = threading.Lock()

    def produce(self, row: Row, partition: int = 0) -> int:
        with self._lock:
            self._partitions[partition].append(row)
            return len(self._partitions[partition]) - 1

    def partition_count(self) -> int:
        return len(self._partitions)

    def fetch(self, partition: int, offset: int, max_rows: int) -> Tuple[List[Row], int]:
        with self._lock:
            rows = self._partitions[partition][offset : offset + max_rows]
        return list(rows), offset + len(rows)

    def latest_offset(self, partition: int) -> int:
        with self._lock:
            return len(self._partitions[partition])


class FileBasedStreamProvider(StreamProvider):
    """One JSONL file a partition; the offset is the line number."""

    def __init__(self, paths: Sequence[str]) -> None:
        self.paths = list(paths)

    def partition_count(self) -> int:
        return len(self.paths)

    def _read(self, partition: int) -> List[Row]:
        rows: List[Row] = []
        with open(self.paths[partition]) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        return rows

    def fetch(self, partition: int, offset: int, max_rows: int) -> Tuple[List[Row], int]:
        take = self._read(partition)[offset:][:max_rows]
        return take, offset + len(take)

    def latest_offset(self, partition: int) -> int:
        return len(self._read(partition))


class FlakyStreamProvider(StreamProvider):
    """A provider with injected failures: a seeded share of ``fetch``
    calls raise, and successful ones may return short batches.  Consumers
    that retry must still ingest every row exactly once."""

    def __init__(self, inner: StreamProvider, fail_rate: float = 0.5, seed: int = 0) -> None:
        self.inner = inner
        self.fail_rate = fail_rate
        self._rng = random.Random(seed)
        self.failures = 0

    def partition_count(self) -> int:
        return self.inner.partition_count()

    def latest_offset(self, partition: int) -> int:
        return self.inner.latest_offset(partition)

    def fetch(self, partition: int, offset: int, max_rows: int) -> Tuple[List[Row], int]:
        if self._rng.random() < self.fail_rate:
            self.failures += 1
            raise RuntimeError("injected stream failure")
        if max_rows > 1 and self._rng.random() < 0.5:
            max_rows = self._rng.randint(1, max_rows)  # short read
        return self.inner.fetch(partition, offset, max_rows)


def stream_provider_from_config(stream_config) -> StreamProvider:
    """A provider from a table's ``StreamConfig``, so a REALTIME table can
    be created over REST."""
    t = stream_config.stream_type
    props = stream_config.properties or {}
    if t == "network":
        from pinot_tpu_torch.realtime.netstream import NetworkStreamProvider

        return NetworkStreamProvider(props.get("host", "127.0.0.1"), int(props["port"]), stream_config.topic)
    if t == "kafka":
        # the Kafka v0 wire protocol, no client library (realtime/kafka.py)
        from pinot_tpu_torch.realtime.kafka import KafkaStreamProvider

        return KafkaStreamProvider(props.get("host", "127.0.0.1"), int(props["port"]), stream_config.topic)
    if t == "file":
        return FileBasedStreamProvider(props["paths"])
    if t == "memory":
        return MemoryStreamProvider(int(props.get("partitions", 1)))
    raise ValueError(f"unknown stream type {t!r}")


def describe_stream(provider: StreamProvider) -> Optional[Dict[str, Any]]:
    """A provider's JSON descriptor: it rides in every CONSUMING message,
    so a server process can open the stream itself.  A memory stream
    describes its shape only (its rows live in one process)."""
    if isinstance(provider, FileBasedStreamProvider):
        return {"type": "file", "paths": list(provider.paths)}
    if isinstance(provider, MemoryStreamProvider):
        return {"type": "memory", "partitions": provider.partition_count()}
    describe = getattr(provider, "describe", None)
    if callable(describe):
        return describe()
    return None


def stream_from_descriptor(desc: Dict[str, Any]) -> StreamProvider:
    t = desc.get("type")
    if t == "file":
        return FileBasedStreamProvider(desc["paths"])
    if t == "memory":
        return MemoryStreamProvider(int(desc.get("partitions", 1)))
    if t == "network":
        from pinot_tpu_torch.realtime.netstream import NetworkStreamProvider

        return NetworkStreamProvider(desc["host"], int(desc["port"]), desc["topic"])
    if t == "kafka":
        from pinot_tpu_torch.realtime.kafka import KafkaStreamProvider

        return KafkaStreamProvider(desc["host"], int(desc["port"]), desc["topic"])
    raise ValueError(f"unknown stream descriptor {desc!r}")
