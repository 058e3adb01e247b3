"""Per-plan-digest workload statistics registry (copy of
``pinot_tpu.utils.planstats``).

One rolling entry per plan SHAPE (``engine/plandigest.py`` — literals
erased), accumulating: execution count, a latency sample window (for
percentiles), the additive cost-vector sums (so per-digest tier mixes
reconcile exactly with the cost meters), coalesce/shed/failure counts,
and first/last-seen timestamps.

Two deployments of the same class:

- **server** (``ServerInstance.plan_stats``): records every executed
  instance request; served at ``/debug/plans`` and in ``status()``.
- **broker** (``BrokerRequestHandler.planstats``): records every merged
  response; served at ``/debug/workload`` as top-K by frequency and by
  cost — the direct input to the question "which plan shapes should we
  batch?" question (cross-query batched serving wants the highest
  frequency x cost shapes first).

Plain EXPLAIN queries are never recorded (they execute nothing);
EXPLAIN ANALYZE is (it did the work).  Eviction is least-recently-seen
beyond ``capacity`` — a bounded registry, not a log.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from pinot_tpu_torch.utils.metrics import interpolated_percentile as _percentile

_LAT_WINDOW = 256  # latency samples kept per digest


class _Entry:
    __slots__ = (
        "digest", "summary", "table", "count", "shed_count", "failed_count",
        "coalesce_hits", "docs_scanned", "cost", "latency", "first_seen",
        "last_seen", "device_lat", "host_lat", "device_execs", "device_info",
        "exemplar",
    )

    def __init__(self, digest: str, summary: str, table: str, now: float) -> None:
        self.digest = digest
        self.summary = summary
        self.table = table
        # one representative query text per shape (first writer wins,
        # bounded): literals are erased from the digest, so ANY member
        # query re-parses to the digest's exact plan shape — this is
        # what lets a prewarming server rebuild and compile the shape
        # without ever having served it (the warm-start plane)
        self.exemplar = ""
        self.count = 0
        self.shed_count = 0
        self.failed_count = 0
        self.coalesce_hits = 0
        self.docs_scanned = 0
        self.cost: Dict[str, float] = {}
        self.latency: Deque[float] = deque(maxlen=_LAT_WINDOW)
        # per-tier execution-time windows (utilization plane): device
        # kernel ms and host-path ms recorded separately so /debug/plans
        # tier mixes carry comparable latency on BOTH tiers
        self.device_lat: Deque[float] = deque(maxlen=_LAT_WINDOW)
        self.host_lat: Deque[float] = deque(maxlen=_LAT_WINDOW)
        # unbounded device-tier exec count (device_lat is a capped
        # sample window): the flops multiplier must track the same
        # accumulation horizon as e.cost["deviceMs"], and must NOT
        # count host-fallback/shed/failed queries that ran no kernel
        self.device_execs = 0
        # device-plan identity + static cost analysis (last writer
        # wins): {"digest", "flops", "bytesAccessed", ...} or None
        self.device_info: Optional[Dict[str, Any]] = None
        self.first_seen = now
        self.last_seen = now


class PlanStatsStore:
    def __init__(self, capacity: int = 512) -> None:
        self.capacity = max(8, capacity)
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()
        self.total_recorded = 0

    @staticmethod
    def _tier_latency(samples) -> Dict[str, Any]:
        s = sorted(samples)
        return {
            "p50Ms": round(_percentile(s, 50), 3),
            "p95Ms": round(_percentile(s, 95), 3),
            "samples": len(s),
        }

    @staticmethod
    def _roofline(e: "_Entry") -> Optional[Dict[str, Any]]:
        """Achieved-vs-peak roofline for one plan shape: measured device
        wall ms (the SAME deviceMs the phase timers / cost vector
        report) under the bytes the kernel read and the static flops
        the lane's cost analysis declared.  None when the shape never
        ran on device.  Coalesced waiters each record their own fetch
        window, so the sums are per-QUERY attribution, not raw device
        seconds — consistent with every other cost-vector surface."""
        dev_ms = float(e.cost.get("deviceMs", 0) or 0)
        # device_execs is only set by the SERVER store (record(device_ms=...)
        # on a locally measured launch); the broker records fleet-MERGED
        # cost vectors, and a sum-over-servers rate divided by THIS
        # process's platform peak is not a roofline — skip it there
        if dev_ms <= 0 or not e.device_execs:
            return None
        dev_bytes = float(e.cost.get("deviceBytes", 0) or 0)
        out: Dict[str, Any] = {
            "deviceMs": round(dev_ms, 3),
            "deviceBytes": int(dev_bytes),
            "achievedBytesPerSec": round(dev_bytes * 1000.0 / dev_ms, 3),
        }
        info = e.device_info or {}
        if info.get("digest"):
            out["deviceDigest"] = info["digest"]
        flops = info.get("flops")
        if isinstance(flops, (int, float)) and flops > 0 and e.device_execs:
            out["staticFlopsPerExec"] = float(flops)
            # multiplier is DEVICE execs only: a mixed-tier shape's host
            # queries add to e.count but execute zero kernel flops
            out["achievedFlopsPerSec"] = round(
                float(flops) * e.device_execs * 1000.0 / dev_ms, 3
            )
        if isinstance(info.get("bytesAccessed"), (int, float)):
            out["staticBytesPerExec"] = float(info["bytesAccessed"])
        from pinot_tpu_torch.utils.platform import roofline_fractions

        out.update(
            roofline_fractions(
                out["achievedBytesPerSec"], out.get("achievedFlopsPerSec")
            )
        )
        return out

    # -- write side ----------------------------------------------------
    def record(
        self,
        digest: str,
        summary: str = "",
        table: str = "",
        latency_ms: float = 0.0,
        cost: Optional[Dict[str, float]] = None,
        num_docs: int = 0,
        shed: bool = False,
        failed: bool = False,
        device_ms: Optional[float] = None,
        host_ms: Optional[float] = None,
        device_info: Optional[Dict[str, Any]] = None,
        pql: str = "",
    ) -> None:
        now = time.time()
        with self._lock:
            e = self._entries.get(digest)
            if e is None:
                if len(self._entries) >= self.capacity:
                    # evict least-recently-seen: the workload head stays
                    victim = min(self._entries.values(), key=lambda x: x.last_seen)
                    self._entries.pop(victim.digest, None)
                e = self._entries[digest] = _Entry(digest, summary, table, now)
            if summary and not e.summary:
                e.summary = summary
            if table and not e.table:
                e.table = table
            if pql and not e.exemplar:
                e.exemplar = str(pql)[:2048]
            e.last_seen = now
            self.total_recorded += 1
            if shed:
                e.shed_count += 1
                return
            e.count += 1
            if failed:
                e.failed_count += 1
            e.latency.append(float(latency_ms))
            if device_ms:
                e.device_lat.append(float(device_ms))
                e.device_execs += 1
            if host_ms:
                e.host_lat.append(float(host_ms))
            if device_info is not None:
                e.device_info = dict(device_info)
            e.docs_scanned += int(num_docs)
            for k, v in (cost or {}).items():
                e.cost[k] = e.cost.get(k, 0) + v
            if (cost or {}).get("coalesceHits"):
                e.coalesce_hits += int(cost["coalesceHits"])

    # -- read side -----------------------------------------------------
    def digest_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def _entry_dict(self, e: _Entry) -> Dict[str, Any]:
        lat = sorted(e.latency)
        per_query_cost = {
            k: round(v / e.count, 3) if e.count else 0 for k, v in e.cost.items()
        }
        # tier mix straight from the additive cost sums: reconciles with
        # the cost-vector tier counters by construction
        tier_mix = {
            k: int(v) for k, v in e.cost.items() if k.startswith("segments")
        }
        return {
            "digest": e.digest,
            "summary": e.summary,
            "table": e.table,
            "exemplarPql": e.exemplar,
            "count": e.count,
            "shedCount": e.shed_count,
            "failedCount": e.failed_count,
            "coalesceHits": e.coalesce_hits,
            "docsScanned": e.docs_scanned,
            "cost": {
                k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in sorted(e.cost.items())
            },
            "tierMix": tier_mix,
            "perQueryCost": per_query_cost,
            "latencyMs": {
                "p50": round(_percentile(lat, 50), 3),
                "p95": round(_percentile(lat, 95), 3),
                "p99": round(_percentile(lat, 99), 3),
                "samples": len(lat),
            },
            # per-tier execution time so a shape's device vs host cost
            # reads side by side (the tier-mix comparability contract)
            "tierLatencyMs": {
                "device": self._tier_latency(e.device_lat),
                "host": self._tier_latency(e.host_lat),
            },
            # cross-query batching + result-cache per-shape view (from
            # the additive cost sums, so it reconciles with the merged
            # cost vectors by construction): batchRate answers "does
            # this shape actually batch?" on /debug/plans and the
            # broker's /debug/workload top-K
            "batching": self._batching(e),
            "roofline": self._roofline(e),
            "firstSeen": round(e.first_seen, 3),
            "lastSeen": round(e.last_seen, 3),
        }

    @staticmethod
    def _batching(e: _Entry) -> Dict[str, Any]:
        batched = int(e.cost.get("batchHits", 0) or 0)
        cached = int(e.cost.get("rescacheHits", 0) or 0)
        n = max(e.count, 1)
        return {
            "batchedQueries": batched,
            "batchRate": round(batched / n, 4),
            "cacheHits": cached,
            "cacheHitRate": round(cached / n, 4),
        }

    @staticmethod
    def _cost_key(d: Dict[str, Any]) -> float:
        c = d.get("cost") or {}
        # total work proxy: bytes + ms-weighted kernel time; the
        # batching question ranks by frequency x unit cost, both served
        return float(c.get("bytesScanned", 0)) + 1e6 * (
            float(c.get("deviceMs", 0)) + float(c.get("hostMs", 0))
        )

    def top(
        self, k: int = 20, by: str = "count", tables=None
    ) -> List[Dict[str, Any]]:
        # record() sits on the per-query response path and shares this
        # lock, so the O(digests) ranking runs on cheap scalar keys and
        # the expensive dicts (percentiles over the sample window) are
        # built only for the k survivors
        if tables is not None:
            # physical-suffix-insensitive: a prewarming server asks with
            # the raw names it hosts, the broker records logical names
            from pinot_tpu_torch.engine.plandigest import _raw_table

            wanted = {_raw_table(t) for t in tables}
        with self._lock:
            entries = [
                e
                for e in self._entries.values()
                if tables is None or _raw_table(e.table) in wanted
            ]
            if by == "cost":
                keyed = [
                    (self._cost_key({"cost": e.cost}), e) for e in entries
                ]
            else:
                keyed = [((e.count, e.last_seen), e) for e in entries]
        keyed.sort(key=lambda pair: pair[0], reverse=True)
        survivors = [e for _, e in keyed[:k]]
        with self._lock:
            return [
                self._entry_dict(e)
                for e in survivors
                if self._entries.get(e.digest) is e  # evicted between locks
            ]

    def get(self, digest: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            e = self._entries.get(digest)
            return self._entry_dict(e) if e is not None else None

    def estimate(self, digest: str) -> Optional[Dict[str, Any]]:
        """Historical per-query estimate for EXPLAIN's estimatedCost:
        mean cost vector + latency percentiles over the rolling window,
        or None when this shape has never executed here."""
        with self._lock:
            e = self._entries.get(digest)
            if e is None or e.count == 0:
                return None
            lat = sorted(e.latency)
            out = {
                "execCount": e.count,
                "latencyP50Ms": round(_percentile(lat, 50), 3),
                "latencyP95Ms": round(_percentile(lat, 95), 3),
                "perQuery": {
                    k: round(v / e.count, 3) for k, v in sorted(e.cost.items())
                },
            }
            # achieved utilization for shapes that ran on device — rides
            # into EXPLAIN's history estimate so explain_dump can render
            # the roofline footer next to the static flops/bytes
            roof = self._roofline(e)
            if roof is not None:
                out["roofline"] = roof
            return out

    def snapshot(self, top: int = 50, by: str = "count") -> Dict[str, Any]:
        return {
            "digests": self.digest_count(),
            "totalRecorded": self.total_recorded,
            "capacity": self.capacity,
            "orderedBy": by,
            "plans": self.top(top, by=by),
        }
