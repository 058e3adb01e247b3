"""Tail-based trace sampling (copy of ``pinot_tpu.utils.tailsample``).

Every query runs with the lightweight span tree armed (the broker
enables tracing for each request), and the *retention* decision happens
at completion, when the outcome is known:

- kept when the query was **slow** (``PINOT_TPU_TAIL_SLOW_MS``, default
  250 ms), **failed**, or **partial**;
- plus an unconditional **1-in-N** sample (``PINOT_TPU_TAIL_SAMPLE_N``,
  default 128; 0 disables).

Retained traces land in a bounded ring (``PINOT_TPU_TAIL_RING_N``,
default 64), keyed by requestId (the slow-query log's entries carry
``traceRetained`` / ``traceRef`` to it), and feed a critical-path
aggregator keyed by the literal-erased plan-shape digest: per phase SELF
time (a span's ms minus its children's), so ``/debug/tails`` answers
"for this shape, the tail is 70 % laneWait".

On the not-retained path the decision reads scalars only: the span-tree
merge, the ring entry and the aggregator run only after a keep verdict
(``TAIL_ALLOCATIONS`` counts the retained entries built).
``PINOT_TPU_TAIL_TRACE=0`` turns the always-on tracing off, and an
untraced query then allocates no spans at all."""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from pinot_tpu_torch.common.conf import env_float
from pinot_tpu_torch.utils.metrics import interpolated_percentile as _percentile

# module-wide count of retained tail entries ever built — the
# not-retained-path zero-overhead guard (tests assert no delta)
TAIL_ALLOCATIONS = 0

_AGG_WINDOW = 128  # per-digest retained-tail sample window


def phase_self_ms(scopes: Dict[str, List[Dict[str, Any]]]) -> Dict[str, float]:
    """Merged span scopes -> per-span-name SELF milliseconds.

    Self time = a span's ms minus the sum of its direct children's ms
    (floored at 0 — children overlapping a parent via concurrency must
    not go negative).  Summing self times by span name attributes the
    whole wall once: a 100ms serverQuery holding a 70ms laneWait
    contributes 30 to serverQuery and 70 to laneWait, never 170."""
    spans = [s for span_list in scopes.values() for s in span_list]
    child_ms: Dict[str, float] = {}
    for s in spans:
        parent = s.get("parent")
        if parent is not None:
            child_ms[parent] = child_ms.get(parent, 0.0) + float(s.get("ms") or 0.0)
    out: Dict[str, float] = {}
    for s in spans:
        ms = float(s.get("ms") or 0.0)
        self_ms = max(0.0, ms - child_ms.get(s.get("id"), 0.0))
        if self_ms <= 0.0:
            continue
        name = s.get("span") or "?"
        out[name] = out.get(name, 0.0) + self_ms
    return {k: round(v, 3) for k, v in out.items()}


class _DigestAgg:
    __slots__ = ("digest", "summary", "table", "tails", "totals", "phases")

    def __init__(self, digest: str, summary: str, table: str) -> None:
        self.digest = digest
        self.summary = summary
        self.table = table
        self.tails = 0
        self.totals: Deque[float] = deque(maxlen=_AGG_WINDOW)
        # per-phase self-ms sums over the SAME retained window: fractions
        # are phase_sum / all_phase_sum, so they add to ~1 by construction
        self.phases: Deque[Dict[str, float]] = deque(maxlen=_AGG_WINDOW)


class TailSampler:
    def __init__(
        self,
        enabled: Optional[bool] = None,
        slow_ms: Optional[float] = None,
        sample_n: Optional[int] = None,
        capacity: Optional[int] = None,
        metrics=None,
    ) -> None:
        if enabled is None:
            enabled = os.environ.get("PINOT_TPU_TAIL_TRACE", "1") != "0"
        self.enabled = enabled
        self.slow_ms = (
            env_float("PINOT_TPU_TAIL_SLOW_MS", 250.0) if slow_ms is None else slow_ms
        )
        self.sample_n = (
            int(env_float("PINOT_TPU_TAIL_SAMPLE_N", 128))
            if sample_n is None
            else sample_n
        )
        self.capacity = max(
            1,
            int(env_float("PINOT_TPU_TAIL_RING_N", 64)) if capacity is None else capacity,
        )
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=self.capacity)
        self._by_digest: Dict[str, _DigestAgg] = {}
        self._seen = 0
        self._lock = threading.Lock()
        self.metrics = metrics
        if metrics is not None:
            metrics.meter("tails.observed")
            metrics.meter("tails.retained")
            metrics.gauge("tails.ring").set_fn(lambda: len(self._ring))

    @property
    def armed(self) -> bool:
        """True when every query should run with the span tree enabled."""
        return self.enabled

    # -- decision (scalar-only: the zero-overhead half) ----------------
    def decide(
        self, time_used_ms: float, failed: bool, partial: bool
    ) -> Optional[str]:
        """Retention verdict for one completed query.  Reads and writes
        scalars only — no dicts, no lists, no span access — so the
        not-retained path costs one lock and two integer ops."""
        with self._lock:
            self._seen += 1
            sampled = self.sample_n > 0 and self._seen % self.sample_n == 0
        if self.metrics is not None:
            self.metrics.meter("tails.observed").mark()
        if failed:
            return "failed"
        if partial:
            return "partial"
        if time_used_ms >= self.slow_ms:
            return "slow"
        if sampled:
            return "sampled"
        return None

    # -- retention (allocates: only reached on a keep verdict) ---------
    def retain(
        self,
        request_id: str,
        reason: str,
        time_used_ms: float,
        scopes: Dict[str, List[Dict[str, Any]]],
        table: str = "",
        plan_digest: str = "",
        summary: str = "",
    ) -> Dict[str, Any]:
        global TAIL_ALLOCATIONS
        phases = phase_self_ms(scopes)
        entry = {
            "requestId": request_id,
            "ts": round(time.time(), 3),
            "reason": reason,
            "timeUsedMs": round(time_used_ms, 3),
            "table": table,
            "planDigest": plan_digest,
            "summary": summary,
            "phaseSelfMs": phases,
            "scopes": scopes,
        }
        with self._lock:
            self._ring.append(entry)
            if plan_digest:
                agg = self._by_digest.get(plan_digest)
                if agg is None:
                    if len(self._by_digest) >= 4 * self.capacity:
                        # bounded like the ring: evict the least-tailed
                        victim = min(
                            self._by_digest.values(), key=lambda a: a.tails
                        )
                        self._by_digest.pop(victim.digest, None)
                    agg = self._by_digest[plan_digest] = _DigestAgg(
                        plan_digest, summary, table
                    )
                agg.tails += 1
                agg.totals.append(float(time_used_ms))
                agg.phases.append(phases)
            TAIL_ALLOCATIONS += 1
        if self.metrics is not None:
            self.metrics.meter("tails.retained").mark()
        return entry

    def observe(
        self,
        request_id: str,
        time_used_ms: float,
        failed: bool,
        partial: bool,
        scopes_fn: Callable[[], Dict[str, List[Dict[str, Any]]]],
        table: str = "",
        plan_digest: str = "",
        summary: str = "",
    ) -> Optional[str]:
        """Decision + conditional retention.  ``scopes_fn`` is called
        ONLY on a keep verdict — the span-tree merge never runs for a
        dropped tail."""
        reason = self.decide(time_used_ms, failed, partial)
        if reason is None:
            return None
        self.retain(
            request_id,
            reason,
            time_used_ms,
            scopes_fn(),
            table=table,
            plan_digest=plan_digest,
            summary=summary,
        )
        return reason

    # -- read side -----------------------------------------------------
    def get(self, request_id: str) -> Optional[Dict[str, Any]]:
        """Full retained entry (scopes included) by requestId — the
        ``/debug/queries`` -> ``/debug/tails?requestId=`` hop."""
        with self._lock:
            for entry in reversed(self._ring):
                if entry["requestId"] == request_id:
                    return dict(entry)
        return None

    def _agg_dict(self, a: _DigestAgg) -> Dict[str, Any]:
        totals = sorted(a.totals)
        phase_sums: Dict[str, float] = {}
        for p in a.phases:
            for name, ms in p.items():
                phase_sums[name] = phase_sums.get(name, 0.0) + ms
        all_ms = sum(phase_sums.values())
        attribution = (
            {
                name: round(ms / all_ms, 4)
                for name, ms in sorted(
                    phase_sums.items(), key=lambda kv: -kv[1]
                )
            }
            if all_ms > 0
            else {}
        )
        top = next(iter(attribution), None)
        return {
            "digest": a.digest,
            "summary": a.summary,
            "table": a.table,
            "tails": a.tails,
            "windowTails": len(totals),
            "latencyMs": {
                "p50": round(_percentile(totals, 50), 3),
                "p99": round(_percentile(totals, 99), 3),
            },
            "phaseMs": {k: round(v, 3) for k, v in phase_sums.items()},
            "attribution": attribution,
            "topPhase": top,
        }

    def snapshot(
        self, top: int = 20, include_traces: bool = False
    ) -> Dict[str, Any]:
        """``/debug/tails`` payload: config + the retained ring (newest
        first, span trees elided unless asked — they are fetchable per
        requestId) + the per-digest tail attribution, worst p99 first."""
        with self._lock:
            entries = [dict(e) for e in reversed(self._ring)]
            aggs = [self._agg_dict(a) for a in self._by_digest.values()]
            seen = self._seen
        if not include_traces:
            for e in entries:
                e.pop("scopes", None)
        aggs.sort(key=lambda d: -d["latencyMs"]["p99"])
        return {
            "enabled": self.enabled,
            "slowMs": self.slow_ms,
            "sampleN": self.sample_n,
            "capacity": self.capacity,
            "observed": seen,
            "retained": len(entries),
            "entries": entries,
            "byDigest": aggs[: max(1, top)],
        }
