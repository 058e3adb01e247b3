"""Time-series history: a bounded ring of metric snapshots (copy of
``pinot_tpu.utils.timeseries``).

One daemon thread per role snapshots the role's metric registries on a
cadence (default 5 s, ``PINOT_TPU_HISTORY_INTERVAL_S``) into a bounded
ring (default 720 samples, ``PINOT_TPU_HISTORY_N``), served at ``GET
/debug/history?series=&windowS=`` on every role's admin surface.

Each sample is a flat ``{series: value}`` dict:

- meters   -> ``<name>.count`` (cumulative) and ``<name>.rate1m``
- timers   -> ``<name>.count``, ``<name>.p50Ms``, ``<name>.p99Ms``
- gauges   -> ``<name>`` (numeric values only)
- extra providers (``register_provider``) merge more series into the
  same sample (the broker's per-table SLO counters).

Cumulative series and the ring give windowed deltas (``window_delta``),
which the SLO burn rates (``utils/slo.py``) and the flight-recorder
triggers (``utils/flightrec.py``) read; both run as ``add_tick_hook``
callbacks on the recorder's own cadence, so the plane costs one thread a
role.  ``tick(now=...)`` takes a sample explicitly with an injectable
clock, so tests drive the timeline without sleeping.

Every recorder that started a thread is listed: a STOPPED recorder whose
thread survives ``stop()`` is a leak (``leaked_recorder_threads``)."""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, Tuple

from pinot_tpu_torch.common.conf import env_float, env_int

logger = logging.getLogger(__name__)

# (recorder, thread) for every recorder that ever started a thread —
# consulted by the tests' thread-leak guard.  Bounded in practice by
# process lifetime; entries of exited threads are pruned on scan.
_RECORDERS: List[Tuple["HistoryRecorder", threading.Thread]] = []
_RECORDERS_LOCK = threading.Lock()


def leaked_recorder_threads(grace_s: float = 2.0) -> List[threading.Thread]:
    """Threads of STOPPED recorders still alive after ``grace_s`` —
    recorders still running (module fixtures, live roles) are exempt."""
    deadline = time.monotonic() + grace_s
    leaked: List[threading.Thread] = []
    with _RECORDERS_LOCK:
        entries = list(_RECORDERS)
    for rec, thread in entries:
        if not rec.stopped or not thread.is_alive():
            continue
        thread.join(timeout=max(0.0, deadline - time.monotonic()))
        if thread.is_alive():
            leaked.append(thread)
    with _RECORDERS_LOCK:
        _RECORDERS[:] = [(r, t) for r, t in _RECORDERS if t.is_alive()]
    return leaked


def _flatten_registry(reg) -> Dict[str, float]:
    """One registry -> flat numeric series (see module docstring)."""
    out: Dict[str, float] = {}
    with reg._lock:
        meters = dict(reg._meters)
        timers = dict(reg._timers)
        gauges = dict(reg._gauges)
    for name, m in meters.items():
        out[f"{name}.count"] = m.count
        out[f"{name}.rate1m"] = round(m.rate_1m, 4)
    for name, t in timers.items():
        p50, p99 = t.percentiles((50, 99))
        out[f"{name}.count"] = t.count
        out[f"{name}.p50Ms"] = round(p50, 3)
        out[f"{name}.p99Ms"] = round(p99, 3)
    for name, g in gauges.items():
        v = g.value
        if isinstance(v, bool):
            out[name] = 1.0 if v else 0.0
        elif isinstance(v, (int, float)):
            out[name] = v
    return out


class HistoryRecorder:
    """Bounded ring of flat metric samples, fed by one daemon thread
    (or explicit ``tick()`` calls — both are safe concurrently)."""

    def __init__(
        self,
        registries,
        interval_s: Optional[float] = None,
        capacity: Optional[int] = None,
        metrics=None,
        clock: Callable[[], float] = time.time,
        start: bool = True,
    ) -> None:
        if not isinstance(registries, (list, tuple)):
            registries = [registries]
        self.registries = list(registries)
        if interval_s is None:
            interval_s = env_float("PINOT_TPU_HISTORY_INTERVAL_S", 5.0)
        if capacity is None:
            capacity = env_int("PINOT_TPU_HISTORY_N", 720)
        self.interval_s = max(0.05, interval_s)
        self.capacity = max(2, capacity)
        self._ring: Deque[Tuple[float, Dict[str, float]]] = deque(
            maxlen=self.capacity
        )
        self._providers: List[Callable[[], Dict[str, float]]] = []
        self._hooks: List[Callable[[float], None]] = []
        self._lock = threading.Lock()
        self._clock = clock
        self._metrics = metrics
        if metrics is not None:
            # metric hygiene: the history.* series exist from construction
            metrics.meter("history.ticks")
            metrics.gauge("history.series").set_fn(self.series_count)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------
    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="history-recorder", daemon=True
        )
        self._thread.start()
        with _RECORDERS_LOCK:
            _RECORDERS.append((self, self._thread))

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # a sick gauge must not kill the recorder
                logger.warning("history tick failed", exc_info=True)

    # -- write side ----------------------------------------------------
    def register_provider(self, fn: Callable[[], Dict[str, float]]) -> None:
        """Merge ``fn()``'s flat series into every sample (e.g. the
        broker's per-table SLO counters)."""
        self._providers.append(fn)

    def add_tick_hook(self, fn: Callable[[float], None]) -> None:
        """Run ``fn(sample_ts)`` after every sample lands (outside the
        ring lock) — SLO evaluation and flight-recorder triggers ride
        the recorder's cadence instead of owning threads."""
        self._hooks.append(fn)

    def tick(self, now: Optional[float] = None) -> Dict[str, float]:
        """Take one sample now; returns the sample dict."""
        if now is None:
            now = self._clock()
        sample: Dict[str, float] = {}
        for reg in self.registries:
            sample.update(_flatten_registry(reg))
        for fn in self._providers:
            try:
                sample.update(fn())
            except Exception:
                logger.warning("history provider failed", exc_info=True)
        with self._lock:
            self._ring.append((now, sample))
        if self._metrics is not None:
            self._metrics.meter("history.ticks").mark()
        for fn in self._hooks:
            try:
                fn(now)
            except Exception:
                logger.warning("history tick hook failed", exc_info=True)
        return sample

    # -- read side -----------------------------------------------------
    def series_count(self) -> int:
        with self._lock:
            return len(self._ring[-1][1]) if self._ring else 0

    def sample_count(self) -> int:
        with self._lock:
            return len(self._ring)

    def latest(self, name: str) -> Optional[float]:
        with self._lock:
            if not self._ring:
                return None
            return self._ring[-1][1].get(name)

    def window_delta(
        self, name: str, window_s: float, now: Optional[float] = None
    ) -> Optional[Tuple[float, float]]:
        """``(value_now - value_then, actual_window_s)`` for a CUMULATIVE
        series over the trailing window — ``then`` is the newest sample
        at least ``window_s`` old (the oldest held sample when the ring
        is younger than the window, so short-lived processes still
        report a meaningful partial-window figure).  None when the
        series needs two samples it doesn't have."""
        if now is None:
            now = self._clock()
        horizon = now - window_s
        with self._lock:
            samples = [(ts, s.get(name)) for ts, s in self._ring]
        points = [(ts, v) for ts, v in samples if v is not None]
        if len(points) < 2:
            return None
        newest_ts, newest_v = points[-1]
        base_ts, base_v = points[0]
        for ts, v in points:
            if ts <= horizon:
                base_ts, base_v = ts, v
            else:
                break
        if newest_ts <= base_ts:
            return None
        return newest_v - base_v, newest_ts - base_ts

    def query_from_qs(self, query_string: str) -> Dict[str, Any]:
        """``GET /debug/history`` adapter shared by every role's HTTP
        handler: parses ``series=`` (comma-separated name prefixes) and
        ``windowS=`` (trailing window seconds; invalid values degrade to
        the full ring) out of the raw URL query string."""
        from urllib.parse import parse_qs

        qs = parse_qs(query_string or "")
        series = [s for s in (qs.get("series") or [""])[0].split(",") if s]
        window = (qs.get("windowS") or [None])[0]
        try:
            window_s = float(window) if window else None
        except ValueError:
            window_s = None
        return self.query(series=series or None, window_s=window_s)

    def query(
        self,
        series: Optional[Iterable[str]] = None,
        window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """``/debug/history`` payload: columnar ``{name: [[ts, v],..]}``.
        ``series`` filters by exact name OR prefix (comma form on the
        endpoint); ``window_s`` keeps only the trailing window."""
        if now is None:
            now = self._clock()
        prefixes = [p for p in (series or ()) if p]
        horizon = None if window_s is None else now - float(window_s)
        with self._lock:
            samples = list(self._ring)
        out: Dict[str, List[List[float]]] = {}
        for ts, sample in samples:
            if horizon is not None and ts < horizon:
                continue
            for name, v in sample.items():
                if prefixes and not any(name.startswith(p) for p in prefixes):
                    continue
                out.setdefault(name, []).append([round(ts, 3), v])
        return {
            "intervalS": self.interval_s,
            "capacity": self.capacity,
            "samples": len(samples),
            **({"windowS": float(window_s)} if window_s is not None else {}),
            "series": out,
        }
