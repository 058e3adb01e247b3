"""Ingest-aware per-server result cache (copy of
``pinot_tpu.engine.rescache``).

A cached answer must be as fresh as a re-execution.  Two fences:

1. **Key fence (correctness):** entries key on ``(raw table, plan-shape
   digest, literal digest, ((segment, staging token), ...))``: the whole
   query identity (``engine/plandigest.py``) times the exact data
   generation it ran over.  Staging tokens are process-unique per
   segment instance (``segment/immutable.py``): a consuming segment's
   snapshot at a new watermark gets a new token, and so do a reloaded or
   replaced copy and a segment patched with default columns.  A lookup
   over fresher data computes a different key and cannot match a stale
   entry.

2. **Offset fence (eagerness):** the LLC consumers (``realtime/llc.py``
   and the networked ``RemoteConsumer``) call ``on_offset_advance``
   whenever a partition's offset moves, and a segment's add or removal
   calls ``invalidate_table``, so dead entries leave at once
   (``rescache.staleEvictions``).

Entries are stored PICKLED, host data only: a hit unpickles a fresh
``IntermediateResult`` (byte-identical to the execution that stored it)
whose cost is exactly ``{"rescacheHits": 1}``, so a hit records no
device or host work and launches nothing.

Opt-in: ``PINOT_TPU_RESULT_CACHE=1`` (default off: a result cache
changes observable execution counts).  ``PINOT_TPU_RESCACHE_N`` /
``PINOT_TPU_RESCACHE_BYTES`` bound the LRU."""
from __future__ import annotations

import io
import os
import pickle
import threading
from collections import OrderedDict
from typing import Any, Dict, Hashable, Optional, Sequence, Tuple

import torch

from pinot_tpu_torch.common.conf import env_int
from pinot_tpu_torch.engine.plandigest import (
    _raw_table,
    plan_literal_digest,
    plan_shape_digest,
)


class _HostOnlyPickler(pickle.Pickler):
    """Pickles a result holding host data only: a tensor (on the card or
    not) in a result to be cached raises, so no entry ever pins device
    memory or a stream's pending work."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            raise TypeError(f"a {obj.device} tensor in a result to be cached")
        return NotImplemented


def _dumps_host_only(obj) -> bytes:
    buf = io.BytesIO()
    _HostOnlyPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def cache_enabled() -> bool:
    return os.environ.get("PINOT_TPU_RESULT_CACHE", "0") not in ("0", "", "false")


def _fence(views: Sequence[Any]) -> Optional[tuple]:
    """The views' sorted (segment, staging token) pairs, or None for a
    view without token identity (uncacheable)."""
    try:
        return tuple(sorted((v.segment_name, int(v.staging_token)) for v in views))
    except (AttributeError, TypeError):
        return None


def _scan_key(request, views: Sequence[Any], table: str) -> Optional[Hashable]:
    fence = _fence(views)
    if fence is None:
        return None
    return (
        _raw_table(table),
        plan_shape_digest(request),
        plan_literal_digest(request),
        fence,
    )


class ResultCache:
    """Bounded LRU of pickled ``IntermediateResult`` payloads (module
    docstring).  Thread-safe: the scheduler worker pool reads and
    writes concurrently; LLC consumer threads invalidate."""

    def __init__(
        self,
        metrics=None,
        enabled: Optional[bool] = None,
        max_entries: Optional[int] = None,
        max_bytes: Optional[int] = None,
    ) -> None:
        self.enabled = cache_enabled() if enabled is None else bool(enabled)
        self.max_entries = env_int("PINOT_TPU_RESCACHE_N", 512) if max_entries is None else int(max_entries)
        self.max_bytes = env_int("PINOT_TPU_RESCACHE_BYTES", 64 << 20) if max_bytes is None else int(max_bytes)
        self.metrics = metrics
        self._lock = threading.Lock()
        # key -> (payload bytes, raw table attribution tuple, nbytes)
        self._entries: "OrderedDict[Hashable, Tuple[bytes, str, int]]" = OrderedDict()
        self._bytes = 0
        if metrics is not None:
            # pre-registered at construction (scrape gap != "no cache")
            for m in (
                "rescache.hits",
                "rescache.misses",
                "rescache.puts",
                "rescache.invalidations",
                "rescache.staleEvictions",
            ):
                metrics.meter(m)
            metrics.gauge("rescache.entries").set_fn(self.entry_count)
            metrics.gauge("rescache.bytes").set_fn(lambda: self._bytes)
            metrics.gauge("rescache.enabled").set(1 if self.enabled else 0)

    # -- keying --------------------------------------------------------
    @staticmethod
    def key_for(request, views: Sequence[Any], table: str) -> Optional[Hashable]:
        """Cache key for a parsed request over the exact segment views
        being served, or None when the query is uncacheable (EXPLAIN
        modes).  Traced requests ARE cacheable — the tail sampler
        arms tracing on every query, so excluding them would
        disable the cache outright; stored entries carry no trace (put
        strips it) and a hit records a ``rescacheHit`` event on the
        live span tree instead.  The view tuple is sorted by name so
        routing order can't fork one logical cover into several keys."""
        if request.explain is not None:
            return None
        return _scan_key(request, views, table)

    @staticmethod
    def key_for_join(
        request,
        probe_views: Sequence[Any],
        build_views: Sequence[Any],
        probe_table: str,
        build_table: str,
    ) -> Optional[Hashable]:
        """Cache key for a COLOCATED join execution: the semantic query
        identity times BOTH sides' exact resident data generations.  An
        ingest advance / segment change on EITHER table mints new
        staging tokens, so a stale joined answer is structurally
        unreachable; the entry is attributed to both raw tables so
        either side's eager invalidation drops it.
        Broadcast/shuffle executions are never cached server-side —
        their build payloads are broker-shipped per query."""
        if request.explain is not None:
            return None
        fence_p, fence_b = _fence(probe_views), _fence(build_views)
        if fence_p is None or fence_b is None:
            return None
        return (
            (_raw_table(probe_table), _raw_table(build_table)),
            plan_shape_digest(request),
            plan_literal_digest(request),
            fence_p,
            fence_b,
        )

    # -- read/write ----------------------------------------------------
    def _mark(self, name: str, n: int = 1) -> None:
        if self.metrics is not None and n:
            self.metrics.meter(name).mark(n)

    def get(self, key: Hashable):
        """A fresh ``IntermediateResult`` clone for the key, or None.
        The clone's cost vector is exactly ``{"rescacheHits": 1}`` —
        zero device work, one attributed cache hit."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
        if entry is None:
            self._mark("rescache.misses")
            return None
        result = pickle.loads(entry[0])
        result.cost = {"rescacheHits": 1}
        self._mark("rescache.hits")
        return result

    def put(self, key: Hashable, result) -> None:
        """Store a successful execution's result.  Callers must only
        pass complete, exception-free results (no partial covers) —
        cached partial answers would replay an outage after it healed.
        The stored copy carries NO trace: replaying one query's span
        tree under another's requestId would be a lie."""
        saved_trace = result.trace
        try:
            result.trace = {}
            payload = _dumps_host_only(result)
        except Exception:
            return  # an unpicklable result is simply not cacheable
        finally:
            result.trace = saved_trace
        nbytes = len(payload)
        if nbytes > max(1, self.max_bytes) // 4:
            return  # one oversized answer must not churn the whole LRU
        raw = key[0] if isinstance(key, tuple) and key else ""
        # entries attribute to one raw table (scans) or several (joins:
        # the key's first element is a tuple of both sides)
        raw = tuple(raw) if isinstance(raw, tuple) else (str(raw),)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[2]
            self._entries[key] = (payload, raw, nbytes)
            self._bytes += nbytes
            while self._entries and (
                self._bytes > self.max_bytes or len(self._entries) > self.max_entries
            ):
                _, (_, _, old_bytes) = self._entries.popitem(last=False)
                self._bytes -= old_bytes
        self._mark("rescache.puts")

    # -- invalidation (the offset fence) -------------------------------
    def invalidate_table(self, table: str, reason: str = "segments") -> int:
        """Drop every entry for ``table`` (raw name; physical
        ``_OFFLINE``/``_REALTIME`` suffixes stripped).  Returns the
        number of entries evicted.  ``reason`` is attribution only —
        "offset" marks LLC watermark advancement, "segments" a segment
        set change."""
        raw = _raw_table(table)
        dropped = 0
        with self._lock:
            victims = [k for k, e in self._entries.items() if raw in e[1]]
            for k in victims:
                _, _, nbytes = self._entries.pop(k)
                self._bytes -= nbytes
                dropped += 1
        if dropped or reason == "offset":
            self._mark("rescache.invalidations")
        self._mark("rescache.staleEvictions", dropped)
        return dropped

    def on_offset_advance(self, table: str, partition: int, offset: int) -> int:
        """LLC watermark hook: a partition's consume/commit offset
        advanced, so every cached answer over this table's previous
        watermark is superseded.  (The key fence already makes those
        entries unreachable — this drops them eagerly.)"""
        return self.invalidate_table(table, reason="offset")

    def contains(self, request, views: Sequence[Any], table: str) -> bool:
        """EXPLAIN probe: would this exact query over these exact views
        hit right now?  Ignores the request's explain mode (the probe
        asks about the EXECUTABLE twin) and marks no hit/miss meters —
        EXPLAIN must never skew the hit-rate series."""
        if not self.enabled:
            return False
        key = _scan_key(request, views, table)
        if key is None:
            return False
        with self._lock:
            return key in self._entries

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    # -- observability -------------------------------------------------
    def entry_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            entries = len(self._entries)
            nbytes = self._bytes
        out = {
            "enabled": self.enabled,
            "entries": entries,
            "bytes": nbytes,
            "maxEntries": self.max_entries,
            "maxBytes": self.max_bytes,
        }
        if self.metrics is not None:
            for short, name in (
                ("hits", "rescache.hits"),
                ("misses", "rescache.misses"),
                ("puts", "rescache.puts"),
                ("invalidations", "rescache.invalidations"),
                ("staleEvictions", "rescache.staleEvictions"),
            ):
                out[short] = self.metrics.meter(name).count
            denom = out["hits"] + out["misses"]
            out["hitRate"] = round(out["hits"] / denom, 4) if denom else 0.0
        return out
