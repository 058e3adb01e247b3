"""Per-table SLOs evaluated as multi-window burn rates over history
(copy of ``pinot_tpu.utils.slo``).

Objectives per table (a table config's ``slo`` block over env defaults):

- **latency**: the fraction of queries answering under ``latencyMs``
  must stay >= ``latencyTarget`` (default 99 % under 500 ms);
- **availability**: the fraction answering without exceptions (sheds
  included: a 429 is unavailability to the client) must stay >=
  ``availabilityTarget`` (default 99.9 %);
- **freshness**: the fraction of realtime answers with ``freshnessMs``
  under ``freshnessMs`` must stay >= ``freshnessTarget`` (threshold 0,
  the default, turns it off).

Burn rate over a window W is ``bad_fraction(W) / (1 - target)``.  A
table is **burning** only when BOTH the fast (default 5 m) and slow
(default 1 h) windows reach ``PINOT_TPU_SLO_BURN_THRESHOLD`` (default
1.0): a fast-window spike alone does not page.

The window math reads the ``HistoryRecorder`` ring: the tracker
publishes cumulative per-table counters as history series
(``slo.<table>.total/latencyBreaches/failures/freshnessBreaches``) and
the burn rates are windowed deltas of those.

Env knobs: ``PINOT_TPU_SLO_LATENCY_MS`` (500),
``PINOT_TPU_SLO_LATENCY_TARGET`` (0.99),
``PINOT_TPU_SLO_AVAILABILITY_TARGET`` (0.999),
``PINOT_TPU_SLO_FRESHNESS_MS`` (0), ``PINOT_TPU_SLO_FRESHNESS_TARGET``
(0.99), ``PINOT_TPU_SLO_FAST_WINDOW_S`` (300),
``PINOT_TPU_SLO_SLOW_WINDOW_S`` (3600), ``PINOT_TPU_SLO_BURN_THRESHOLD``
(1.0).  The reported names stay ``burnRate5m`` / ``burnRate1h`` whatever
the windows are."""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.common.conf import env_float


def default_objective() -> Dict[str, float]:
    return {
        "latencyMs": env_float("PINOT_TPU_SLO_LATENCY_MS", 500.0),
        "latencyTarget": env_float("PINOT_TPU_SLO_LATENCY_TARGET", 0.99),
        "availabilityTarget": env_float("PINOT_TPU_SLO_AVAILABILITY_TARGET", 0.999),
        # event-time freshness objective: fraction of
        # realtime-serving queries with freshnessMs under the threshold
        # must stay >= freshnessTarget.  Threshold 0 (the default)
        # disables the objective — its budget contributes no burn entry
        # (the _burn budget<=0 guard), so pure-offline fleets see no
        # behavior change.
        "freshnessMs": env_float("PINOT_TPU_SLO_FRESHNESS_MS", 0.0),
        "freshnessTarget": env_float("PINOT_TPU_SLO_FRESHNESS_TARGET", 0.99),
    }


class _Counts:
    __slots__ = ("total", "latency_breaches", "failures", "freshness_breaches")

    def __init__(self) -> None:
        self.total = 0
        self.latency_breaches = 0
        self.failures = 0
        self.freshness_breaches = 0


class SloTracker:
    """Broker-side per-table SLO state: cumulative counters fed per
    query, objectives fed from table config, burn rates evaluated over
    the bound ``HistoryRecorder``."""

    def __init__(
        self,
        history=None,
        metrics=None,
        fast_window_s: Optional[float] = None,
        slow_window_s: Optional[float] = None,
        burn_threshold: Optional[float] = None,
    ) -> None:
        self.history = history
        self.metrics = metrics
        self.fast_window_s = (
            env_float("PINOT_TPU_SLO_FAST_WINDOW_S", 300.0)
            if fast_window_s is None
            else fast_window_s
        )
        self.slow_window_s = (
            env_float("PINOT_TPU_SLO_SLOW_WINDOW_S", 3600.0)
            if slow_window_s is None
            else slow_window_s
        )
        self.burn_threshold = (
            env_float("PINOT_TPU_SLO_BURN_THRESHOLD", 1.0)
            if burn_threshold is None
            else burn_threshold
        )
        self._counts: Dict[str, _Counts] = {}
        self._objectives: Dict[str, Dict[str, float]] = {}  # table overrides
        # env defaults resolved ONCE: observe() runs on the broker's
        # per-query response path and must not re-read os.environ
        self._default_obj = default_objective()
        self._burning: set = set()
        self._lock = threading.Lock()
        if metrics is not None:
            # pre-registered so /metrics shows zeros before first use
            metrics.gauge("slo.burning").set(0)
            metrics.gauge("slo.worstBurnRate5m").set(0.0)
            metrics.gauge("slo.worstBurnRate1h").set(0.0)

    # -- write side ----------------------------------------------------
    def observe(
        self,
        table: str,
        latency_ms: float,
        failed: bool,
        freshness_ms: Optional[float] = None,
    ) -> None:
        """Fold one finished query into the table's cumulative counters
        (called on the broker response path — scalars only).
        ``freshness_ms`` is the response's event-time staleness (None
        for offline-only answers, which never breach freshness)."""
        if not table:
            return
        with self._lock:
            obj = self._objectives.get(table) or self._default_obj
            c = self._counts.get(table)
            if c is None:
                c = self._counts[table] = _Counts()
            c.total += 1
            if failed:
                c.failures += 1
                # a failed query never answered under the latency bar
                c.latency_breaches += 1
            elif latency_ms >= obj["latencyMs"]:
                c.latency_breaches += 1
            threshold = obj.get("freshnessMs") or 0.0
            if (
                threshold > 0
                and freshness_ms is not None
                and freshness_ms >= threshold
            ):
                c.freshness_breaches += 1

    def set_objective(self, table: str, obj: Optional[Dict[str, Any]]) -> None:
        """Table-config override (None clears back to env defaults).
        Unset fields inside a present block fall back per-field."""
        with self._lock:
            if not obj:
                self._objectives.pop(table, None)
                return
            base = self._default_obj
            self._objectives[table] = {
                "latencyMs": float(obj.get("latencyMs") or base["latencyMs"]),
                "latencyTarget": float(
                    obj.get("latencyTarget") or base["latencyTarget"]
                ),
                "availabilityTarget": float(
                    obj.get("availabilityTarget") or base["availabilityTarget"]
                ),
                "freshnessMs": float(
                    obj.get("freshnessMs") or base["freshnessMs"]
                ),
                "freshnessTarget": float(
                    obj.get("freshnessTarget") or base["freshnessTarget"]
                ),
            }

    def objective(self, table: str) -> Dict[str, float]:
        with self._lock:
            obj = self._objectives.get(table)
        return dict(obj) if obj is not None else dict(self._default_obj)

    def objective_tables(self) -> List[str]:
        """Tables holding a config override — the propagation paths use
        this to clear objectives of tables that left the cluster state
        (a table with an ``slo`` block but no QPS quota has no quota
        bucket to piggyback stale-clearing on)."""
        with self._lock:
            return list(self._objectives)

    # -- history feed --------------------------------------------------
    def series(self) -> Dict[str, float]:
        """Cumulative per-table counters as flat history series — the
        provider registered on the role's HistoryRecorder."""
        with self._lock:
            out: Dict[str, float] = {}
            for table, c in self._counts.items():
                out[f"slo.{table}.total"] = c.total
                out[f"slo.{table}.latencyBreaches"] = c.latency_breaches
                out[f"slo.{table}.failures"] = c.failures
                out[f"slo.{table}.freshnessBreaches"] = c.freshness_breaches
            return out

    # -- evaluation ----------------------------------------------------
    def _burn(
        self, table: str, bad_series: str, budget: float, window_s: float
    ) -> Optional[Dict[str, Any]]:
        if self.history is None or budget <= 0:
            return None
        total = self.history.window_delta(f"slo.{table}.total", window_s)
        bad = self.history.window_delta(f"slo.{table}.{bad_series}", window_s)
        if total is None or bad is None or total[0] <= 0:
            return None
        frac = max(0.0, bad[0]) / total[0]
        return {
            "windowS": round(total[1], 3),
            "queries": int(total[0]),
            "bad": int(max(0.0, bad[0])),
            "badFraction": round(frac, 6),
            "burnRate": round(frac / budget, 3),
        }

    def evaluate(self, consume_crossings: bool = True) -> Dict[str, Any]:
        """Burn rates for every observed table over both windows; updates
        the slo.* gauges and returns the snapshot plus the set of tables
        that CROSSED into burning since the last evaluation (the flight-
        recorder trigger).  ``consume_crossings=False`` (the read-only
        ``snapshot()`` path: /debug/slo, fleet rollups, flight-recorder
        sources) leaves the edge state untouched — a poll between two
        history ticks must not eat the crossing the sloBurn trigger
        fires on."""
        with self._lock:
            tables = list(self._counts.keys())
        results: Dict[str, Any] = {}
        worst5 = 0.0
        worst1h = 0.0
        burning: List[str] = []
        for table in tables:
            obj = self.objective(table)
            lat_budget = 1.0 - obj["latencyTarget"]
            avail_budget = 1.0 - obj["availabilityTarget"]
            # the third objective rides the same multi-window machinery:
            # a zero threshold zeroes the budget, and the _burn guard
            # then contributes no entry at all
            fresh_budget = (
                1.0 - obj.get("freshnessTarget", 0.99)
                if (obj.get("freshnessMs") or 0.0) > 0
                else 0.0
            )
            entry: Dict[str, Any] = {"objective": obj, "windows": {}}
            rates5: List[float] = []
            rates1h: List[float] = []
            for wname, window_s, sink in (
                ("burnRate5m", self.fast_window_s, rates5),
                ("burnRate1h", self.slow_window_s, rates1h),
            ):
                lat = self._burn(table, "latencyBreaches", lat_budget, window_s)
                avail = self._burn(table, "failures", avail_budget, window_s)
                fresh = self._burn(
                    table, "freshnessBreaches", fresh_budget, window_s
                )
                entry["windows"][wname] = {
                    "latency": lat,
                    "availability": avail,
                    "freshness": fresh,
                }
                for b in (lat, avail, fresh):
                    if b is not None:
                        sink.append(b["burnRate"])
            b5 = max(rates5, default=0.0)
            b1h = max(rates1h, default=0.0)
            entry["burnRate5m"] = b5
            entry["burnRate1h"] = b1h
            entry["burning"] = (
                b5 >= self.burn_threshold and b1h >= self.burn_threshold
            )
            if entry["burning"]:
                burning.append(table)
            worst5 = max(worst5, b5)
            worst1h = max(worst1h, b1h)
            results[table] = entry
        with self._lock:
            crossed = [t for t in burning if t not in self._burning]
            if consume_crossings:
                self._burning = set(burning)
        if self.metrics is not None:
            self.metrics.gauge("slo.burning").set(len(burning))
            self.metrics.gauge("slo.worstBurnRate5m").set(round(worst5, 3))
            self.metrics.gauge("slo.worstBurnRate1h").set(round(worst1h, 3))
        # worst-burning tables first: the fleet rollup and the dashboard
        # lead with the table an operator should look at
        ranked = sorted(
            results.items(),
            key=lambda kv: -max(kv[1]["burnRate5m"], kv[1]["burnRate1h"]),
        )
        return {
            "config": {
                "fastWindowS": self.fast_window_s,
                "slowWindowS": self.slow_window_s,
                "burnThreshold": self.burn_threshold,
                "defaults": dict(self._default_obj),
            },
            "tables": dict(results),
            "burningTables": sorted(burning),
            "worstBurning": [t for t, _ in ranked[:10]],
            "crossed": crossed,
        }

    def snapshot(self) -> Dict[str, Any]:
        """``/debug/slo`` payload (evaluation is cheap: a few windowed
        deltas per observed table).  Read-only: never consumes the
        crossing edge the flight-recorder trigger depends on."""
        out = self.evaluate(consume_crossings=False)
        out.pop("crossed", None)
        return out
