"""Metrics: meters, timers, gauges per role + Prometheus exposition
(trimmed copy of ``pinot_tpu.utils.metrics``: the registries, the
exposition, and a catalog of the series the port's server and broker
mark).

The Yammer-metrics analog (pinot-common
``common/metrics/AbstractMetrics.java`` with ``BrokerMeter``,
``ServerMeter``, ``ServerQueryPhase`` etc.): typed registries per role;
timers keep recent samples for percentile queries; everything is
thread-safe and cheap.  ``Meter`` keeps a 1-minute EWMA rate next to
the lifetime average, ``Timer.percentile`` interpolates between ranks
over a cached sort, ``Gauge`` supports callable providers (``set_fn``),
and ``prometheus_text`` renders registries in the Prometheus text
exposition format (``ServerInstance.metrics_text``).
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Sequence

_EWMA_TICK_S = 5.0
_EWMA_ALPHA_1M = 1.0 - math.exp(-_EWMA_TICK_S / 60.0)


def interpolated_percentile(s: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile over a SORTED sample sequence —
    shared by Timer and the plan-stats registry (utils/planstats.py) so
    /metrics and /debug/plans percentiles can never drift apart."""
    if not s:
        return 0.0
    if len(s) == 1:
        return s[0]
    rank = (len(s) - 1) * min(max(p, 0.0), 100.0) / 100.0
    lo = int(rank)
    frac = rank - lo
    if lo + 1 >= len(s):
        return s[-1]
    return s[lo] + frac * (s[lo + 1] - s[lo])


class Meter:
    def __init__(self) -> None:
        self.count = 0
        self._t0 = time.time()
        self._lock = threading.Lock()
        # 1-minute EWMA state (Yammer Meter semantics): marks accumulate
        # in _uncounted; every 5s tick folds them into the decayed rate
        self._uncounted = 0
        self._ewma = 0.0  # events per second
        self._ewma_init = False
        self._last_tick = time.monotonic()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            self._tick_locked(time.monotonic())
            self.count += n
            self._uncounted += n

    def _tick_locked(self, now: float) -> None:
        elapsed = now - self._last_tick
        if elapsed < _EWMA_TICK_S:
            return
        ticks = int(elapsed // _EWMA_TICK_S)
        # first tick consumes the accumulated marks; the rest decay
        instant = self._uncounted / _EWMA_TICK_S
        self._uncounted = 0
        if not self._ewma_init:
            self._ewma = instant
            self._ewma_init = True
            ticks -= 1
        else:
            self._ewma += _EWMA_ALPHA_1M * (instant - self._ewma)
            ticks -= 1
        for _ in range(min(ticks, 64)):  # cap idle catch-up work
            self._ewma += _EWMA_ALPHA_1M * (0.0 - self._ewma)
        if ticks > 64:
            self._ewma = 0.0
        self._last_tick += (int(elapsed // _EWMA_TICK_S)) * _EWMA_TICK_S

    @property
    def rate(self) -> float:
        """Lifetime average events/second (process-age denominator)."""
        dt = time.time() - self._t0
        return self.count / dt if dt > 0 else 0.0

    @property
    def rate_1m(self) -> float:
        """1-minute EWMA events/second — the windowed rate that tracks
        what the meter is doing NOW, not since process start."""
        with self._lock:
            self._tick_locked(time.monotonic())
            if not self._ewma_init:
                # under one tick of life: instantaneous average so short
                # tests/bursts still see a sane number
                dt = time.monotonic() - self._last_tick
                return self._uncounted / dt if dt > 0 else 0.0
            return self._ewma


class Timer:
    def __init__(self, window: int = 4096) -> None:
        self.count = 0
        self.total_ms = 0.0
        self._samples: Deque[float] = deque(maxlen=window)
        self._sorted: Optional[List[float]] = None  # cache, dropped on update
        self._lock = threading.Lock()

    def update(self, ms: float) -> None:
        with self._lock:
            self.count += 1
            self.total_ms += ms
            self._samples.append(ms)
            self._sorted = None

    def _sorted_locked(self) -> List[float]:
        if self._sorted is None:
            self._sorted = sorted(self._samples)
        return self._sorted

    # the ONE percentile implementation (module level above): timers
    # and the plan-stats registry must never drift apart
    _interp = staticmethod(interpolated_percentile)

    def percentile(self, p: float) -> float:
        with self._lock:
            return self._interp(self._sorted_locked(), p)

    def percentiles(self, ps: Iterable[float]) -> List[float]:
        """All requested percentiles from ONE cached sort/lock hold."""
        with self._lock:
            s = self._sorted_locked()
            return [self._interp(s, p) for p in ps]

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0

    def samples(self) -> List[float]:
        """The samples in the window, oldest first."""
        with self._lock:
            return list(self._samples)


class Gauge:
    def __init__(self) -> None:
        self._value: Any = 0
        self._fn = None
        self._lock = threading.Lock()

    def set(self, v: Any) -> None:
        with self._lock:
            self._value = v
            self._fn = None

    def set_fn(self, fn) -> None:
        """Callable provider: the gauge reads live on every snapshot."""
        with self._lock:
            self._fn = fn

    def clear_fn(self, fn) -> None:
        """Detach a provider IF it is still the attached one (resets the
        gauge to 0).  The equality guard makes detach safe against a
        successor that already replaced the provider: last writer wins,
        a stale owner's detach is a no-op."""
        with self._lock:
            if self._fn == fn:
                self._fn = None
                self._value = 0

    @property
    def value(self) -> Any:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return fn()
        except Exception:
            return None


class MetricsRegistry:
    """Per-role metrics registry (AbstractMetrics analog)."""

    role = ""  # catalog key; set by typed subclasses

    def __init__(self, scope: str) -> None:
        self.scope = scope
        self._meters: Dict[str, Meter] = {}
        self._timers: Dict[str, Timer] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._lock = threading.Lock()

    def meter(self, name: str) -> Meter:
        with self._lock:
            m = self._meters.get(name)
            if m is None:
                m = self._meters[name] = Meter()
            return m

    def timer(self, name: str) -> Timer:
        with self._lock:
            t = self._timers.get(name)
            if t is None:
                t = self._timers[name] = Timer()
            return t

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            meters = dict(self._meters)
            timers = dict(self._timers)
            gauges = dict(self._gauges)
        out: Dict[str, Any] = {
            "scope": self.scope,
            "meters": {
                k: {
                    "count": m.count,
                    "rate": round(m.rate, 3),
                    "rate1m": round(m.rate_1m, 3),
                }
                for k, m in meters.items()
            },
            "timers": {},
            "gauges": {k: g.value for k, g in gauges.items()},
        }
        for k, t in timers.items():
            p50, p95, p99 = t.percentiles((50, 95, 99))
            out["timers"][k] = {
                "count": t.count,
                "meanMs": round(t.mean_ms, 3),
                "p50Ms": round(p50, 3),
                "p95Ms": round(p95, 3),
                "p99Ms": round(p99, 3),
            }
        return out


class ServerMetrics(MetricsRegistry):
    """ServerMeter/ServerTimer/ServerQueryPhase namespace."""

    role = "server"


class BrokerMetrics(MetricsRegistry):
    """BrokerMeter/BrokerQueryPhase namespace."""

    role = "broker"


class ControllerMetrics(MetricsRegistry):
    """ControllerMeter/ControllerGauge namespace."""

    role = "controller"


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------


def _prom_name(name: str) -> str:
    """Metric name -> legal Prometheus name component."""
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _prom_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_value(v: Any) -> Optional[str]:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, float)):
        if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
            return str(v)
        return repr(float(v)) if isinstance(v, float) else str(v)
    return None  # non-numeric gauges are skipped in the exposition


def prometheus_text(registries, prefix: str = "pinot_tpu") -> str:
    """Render registries as Prometheus text format 0.0.4.

    Meters -> ``<prefix>_<role>_<name>_total`` counters (plus a
    ``..._rate1m`` gauge), timers -> summary-style ``..._ms`` families
    (``_count``/``_sum`` + quantile series), gauges -> gauges.  The
    registry scope rides as the ``scope`` label so multiple instances
    of a role can share one scrape."""
    if isinstance(registries, MetricsRegistry):
        registries = [registries]
    lines: List[str] = []
    typed: set = set()

    def _family(name: str, kind: str, help_text: str = "") -> None:
        if name in typed:
            return
        typed.add(name)
        if help_text:
            lines.append(f"# HELP {name} {_prom_label(help_text)}")
        lines.append(f"# TYPE {name} {kind}")

    for reg in registries:
        role = reg.role or "generic"
        catalog = METRIC_CATALOGS.get(role, {})
        base = f"{prefix}_{_prom_name(role)}"
        label = f'{{scope="{_prom_label(reg.scope)}"}}'
        snap_lock = reg._lock
        with snap_lock:
            meters = dict(reg._meters)
            timers = dict(reg._timers)
            gauges = dict(reg._gauges)
        for name in sorted(meters):
            m = meters[name]
            fam = f"{base}_{_prom_name(name)}"
            _family(f"{fam}_total", "counter", catalog.get(name, ""))
            lines.append(f"{fam}_total{label} {m.count}")
            _family(f"{fam}_rate1m", "gauge")
            lines.append(f"{fam}_rate1m{label} {m.rate_1m:.6g}")
        for name in sorted(timers):
            t = timers[name]
            fam = f"{base}_{_prom_name(name)}_ms"
            _family(fam, "summary", catalog.get(name, ""))
            p50, p95, p99 = t.percentiles((50, 95, 99))
            for q, v in (("0.5", p50), ("0.95", p95), ("0.99", p99)):
                lines.append(
                    f'{fam}{{scope="{_prom_label(reg.scope)}",quantile="{q}"}} {v:.6g}'
                )
            lines.append(f"{fam}_sum{label} {t.total_ms:.6g}")
            lines.append(f"{fam}_count{label} {t.count}")
        for name in sorted(gauges):
            v = _prom_value(gauges[name].value)
            if v is None:
                continue
            fam = f"{base}_{_prom_name(name)}"
            _family(fam, "gauge", catalog.get(name, ""))
            lines.append(f"{fam}{label} {v}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Per-role metric-name catalogs: name -> one-line description (rendered as
# Prometheus HELP).  ``*`` stands for a dynamic name part.
# ---------------------------------------------------------------------------

BROKER_METRIC_CATALOG: Dict[str, str] = {
    "queries": "queries received",
    "failoverRetries": "scatter batches re-issued to an alternate replica",
    "queryTotal": "end-to-end broker latency per query",
    "phase.parse": "PQL parse + optimize time",
    "phase.route": "routing-table lookup + batch build time",
    "scatterGather": "scatter-gather wall time per query",
    "reduce": "partial-merge + finalize time per query",
    "serverLatency": "per-attempt server round-trip latency",
    "cost.docsScanned": "documents scanned, summed over merged responses",
    "cost.bytesScanned": "column bytes touched, summed over merged responses",
    "cost.deviceMs": "per-query device-section ms (merged cost vector)",
    "cost.hostMs": "per-query host-tier ms (merged cost vector)",
    "table.*.docsScanned": "per-table documents scanned",
    "table.*.bytesScanned": "per-table column bytes touched",
}

SERVER_METRIC_CATALOG: Dict[str, str] = {
    "queries": "instance requests handled",
    "queriesShed": "requests shed by a saturated scheduler (210)",
    "queriesAbandoned": "requests whose deadline expired in the queue",
    "segmentsMissedServing": "requested segments the server did not hold",
    "queryExecution": "end-to-end server handle_request latency",
    "scheduler.pending": "queries queued-or-running on the scheduler",
    "phase.schedulerWait": "time from submit to worker dequeue",
    "fairshare.activeTables": "tables with a non-empty scheduler queue",
    "fairshare.shed": "submits shed by the global or per-table cap",
    "phase.*": "per-stage executor phase timers (indexPath, bitslicedPath, "
    "tierDecision, staging, planBuild, laneWait, planExec, finalize, hostPath, "
    "hostFailover)",
    "heal.deviceFailures": "device launch failures (classified)",
    "heal.deviceRetries": "transient device failures retried on the device",
    "heal.hostFailovers": "queries served by the host tier after a device error",
    "heal.poisonSkips": "queries that skipped a quarantined device plan",
    "heal.resourceExhausted": "device allocation failures (retried once, "
    "then the host tier)",
    "heal.stickyFaults": "sticky CUDA faults that took the lane off the device",
    "lane.depth": "device-lane queue depth",
    "lane.inflight": "device-lane launches inside the launch call",
    "lane.open": "completed dispatches still coalescible (kernel running)",
    "lane.dispatches": "kernel launches issued by the device lane",
    "lane.coalesced": "queries coalesced onto an identical in-flight dispatch",
    "lane.shed": "lane waiters shed at dequeue (deadline expired)",
    "lane.deviceFailures": "launch failures surfaced by the lane",
    "lane.restarts": "lane threads restarted by the stall watchdog",
    "phase.laneDispatch": "wall time inside the lane's launch call",
    "cost.docsScanned": "documents scanned per reply, summed",
    "cost.bytesScanned": "column bytes touched per reply, summed",
    "cost.deviceMs": "per-query device-section ms",
    "cost.hostMs": "per-query host-tier ms",
    "cost.tier.*": "segments served per tier (cost-vector segment counts)",
}

METRIC_CATALOGS: Dict[str, Dict[str, str]] = {
    "broker": BROKER_METRIC_CATALOG,
    "server": SERVER_METRIC_CATALOG,
}
