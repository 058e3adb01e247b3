"""Broker adaptive admission control, the front door of overload
protection (copy of ``pinot_tpu.broker.admission``).

The per-table QPS token bucket (``broker/quota.py``) knows a table's
configured rate and nothing of the cluster's saturation: a flooding
tenant inside its rate would be scattered at saturated servers until
they shed with 210.  Three checks, all per table and O(1), in
``BrokerRequestHandler.handle_request``:

1. **QPS token bucket** (``QueryQuotaManager``).
2. **Per-table in-flight cap**: at most ``max_inflight_per_table``
   queries of one table inside the broker at once.
3. **AIMD per-server concurrency windows**: each server's window grows
   additively on a healthy reply and shrinks multiplicatively on a
   saturated one (a 210 reply, a transport failure, or the reply's
   backpressure snapshot, ``IntermediateResult.backpressure``, past the
   high-water fraction).  When no server of a query's routing cover has
   window headroom left, the broker sheds it before any scatter.

Every refusal is ``ErrorCode.TOO_MANY_REQUESTS`` (429) with a message
naming its tier, counted by the ``admission.*`` meters."""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from pinot_tpu_torch.broker.quota import QueryQuotaManager
from pinot_tpu_torch.common.conf import env_float


class AdmissionDecision:
    """Outcome of ``try_admit``: ``admitted`` plus a shed tier + message
    when refused.  An admitted decision MUST be released (the in-flight
    cap is a counted resource)."""

    __slots__ = ("admitted", "tier", "message")

    def __init__(self, admitted: bool, tier: str = "", message: str = "") -> None:
        self.admitted = admitted
        self.tier = tier
        self.message = message


class _ServerWindow:
    """AIMD congestion window for one server, tracked at the broker.

    ``inflight`` counts this broker's outstanding attempts; ``window``
    moves additively up on success (+increase per reply, capped) and
    multiplicatively down on saturation evidence (x decrease_factor,
    floored at min_window).  The window never blocks an attempt that is
    already routed — it only feeds the pre-scatter admission check and
    observability; a wrong guess degrades to the plain behavior
    (the server sheds with 210 and the broker fails over)."""

    __slots__ = ("window", "inflight", "saturations")

    def __init__(self, initial: float) -> None:
        self.window = initial
        self.inflight = 0
        self.saturations = 0


class AdmissionController:
    def __init__(
        self,
        quota: Optional[QueryQuotaManager] = None,
        max_inflight_per_table: Optional[int] = None,
        initial_window: Optional[float] = None,
        min_window: float = 1.0,
        max_window: Optional[float] = None,
        increase: float = 0.5,
        decrease_factor: float = 0.5,
        pending_high_water: Optional[float] = None,
        metrics=None,
    ) -> None:
        self.quota = quota or QueryQuotaManager()
        self.max_inflight_per_table = int(
            max_inflight_per_table
            if max_inflight_per_table is not None
            else env_float("PINOT_TPU_ADMISSION_TABLE_INFLIGHT", 32)
        )
        self.initial_window = float(
            initial_window
            if initial_window is not None
            else env_float("PINOT_TPU_ADMISSION_WINDOW_INIT", 8)
        )
        self.min_window = min_window
        self.max_window = float(
            max_window
            if max_window is not None
            else env_float("PINOT_TPU_ADMISSION_WINDOW_MAX", 64)
        )
        self.increase = increase
        self.decrease_factor = decrease_factor
        # fraction of scheduler.maxPending beyond which a reply's
        # backpressure snapshot counts as saturation evidence
        self.pending_high_water = float(
            pending_high_water
            if pending_high_water is not None
            else env_float("PINOT_TPU_ADMISSION_PENDING_HIGH", 0.8)
        )
        self.metrics = metrics
        self._lock = threading.Lock()
        self._table_inflight: Dict[str, int] = {}
        self._windows: Dict[str, _ServerWindow] = {}
        if metrics is not None:
            for m in (
                "admission.shedQuota",
                "admission.shedConcurrency",
                "admission.shedOverload",
                "admission.windowDecreases",
            ):
                metrics.meter(m)
            metrics.gauge("admission.inflight").set_fn(self._total_inflight)

    def _total_inflight(self) -> int:
        with self._lock:
            return sum(self._table_inflight.values())

    # -- front door ----------------------------------------------------
    def try_admit(self, table: str) -> AdmissionDecision:
        """Tier 1+2: QPS bucket, then the per-table in-flight cap.  On
        admit the table's in-flight count is taken and MUST be released
        via ``release``."""
        if not self.quota.allow(table):
            self._mark("admission.shedQuota")
            return AdmissionDecision(
                False,
                "quota",
                f"query rate on table {table} exceeds the configured quota",
            )
        with self._lock:
            n = self._table_inflight.get(table, 0)
            if n >= self.max_inflight_per_table:
                self._mark_locked("admission.shedConcurrency")
                return AdmissionDecision(
                    False,
                    "concurrency",
                    f"table {table} has {n} queries in flight >= "
                    f"per-table cap {self.max_inflight_per_table}",
                )
            self._table_inflight[table] = n + 1
        return AdmissionDecision(True)

    def release(self, table: str) -> None:
        with self._lock:
            n = self._table_inflight.get(table, 0) - 1
            if n > 0:
                self._table_inflight[table] = n
            else:
                self._table_inflight.pop(table, None)

    def table_inflight(self, table: str) -> int:
        with self._lock:
            return self._table_inflight.get(table, 0)

    # -- AIMD windows --------------------------------------------------
    def _window_locked(self, server: str) -> _ServerWindow:
        w = self._windows.get(server)
        if w is None:
            w = self._windows[server] = _ServerWindow(self.initial_window)
        return w

    def check_cover(self, table: str, servers: List[str]) -> AdmissionDecision:
        """Tier 3: pre-scatter overload check.  Admit while ANY server
        in the cover has window headroom; shed with 429 only when every
        one of them is already at (or past) its congestion window —
        scattering then could only end in 210s/timeouts."""
        if not servers:
            return AdmissionDecision(True)
        with self._lock:
            for server in servers:
                w = self._window_locked(server)
                if w.inflight < w.window:
                    return AdmissionDecision(True)
            self._mark_locked("admission.shedOverload")
        return AdmissionDecision(
            False,
            "overload",
            f"all {len(servers)} server(s) covering table {table} are "
            f"saturated (AIMD windows exhausted); shedding at the broker",
        )

    def on_attempt_start(self, server: str) -> None:
        with self._lock:
            self._window_locked(server).inflight += 1

    def on_attempt_cancelled(self, server: str) -> None:
        """A queued attempt was cancelled before it ran (its batch was
        already answered): no health evidence either way — only the
        in-flight count comes back."""
        with self._lock:
            w = self._window_locked(server)
            w.inflight = max(0, w.inflight - 1)

    def on_attempt_done(
        self,
        server: str,
        saturated: bool,
        backpressure: Optional[Dict[str, float]] = None,
    ) -> None:
        """One attempt finished.  ``saturated``: the reply was a 210 /
        transport failure / timeout.  A healthy reply whose backpressure
        snapshot shows the scheduler past the high-water fraction also
        counts as saturation evidence (shed BEFORE the 210s appear)."""
        if not saturated and backpressure:
            try:
                pending = float(backpressure.get("pending", 0))
                cap = float(backpressure.get("maxPending", 0))
                if cap > 0 and pending >= self.pending_high_water * cap:
                    saturated = True
            except (TypeError, ValueError):
                pass
        with self._lock:
            w = self._window_locked(server)
            w.inflight = max(0, w.inflight - 1)
            if saturated:
                w.saturations += 1
                old = w.window
                w.window = max(self.min_window, w.window * self.decrease_factor)
                if w.window < old:
                    self._mark_locked("admission.windowDecreases")
            else:
                w.window = min(self.max_window, w.window + self.increase)

    def window_of(self, server: str) -> float:
        with self._lock:
            return self._window_locked(server).window

    def snapshot(self) -> Dict[str, object]:
        """Ops view (broker /debug/admission)."""
        with self._lock:
            return {
                "maxInflightPerTable": self.max_inflight_per_table,
                "tableInflight": dict(sorted(self._table_inflight.items())),
                "serverWindows": {
                    s: {
                        "window": round(w.window, 2),
                        "inflight": w.inflight,
                        "saturations": w.saturations,
                    }
                    for s, w in sorted(self._windows.items())
                },
            }

    # -- metrics helpers ----------------------------------------------
    def _mark(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.meter(name).mark()

    def _mark_locked(self, name: str) -> None:
        # Meter has its own lock; safe to mark while holding ours
        if self.metrics is not None:
            self.metrics.meter(name).mark()
