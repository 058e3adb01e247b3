"""On-demand deep profiling: bracketed ``torch.profiler`` capture (port
of ``pinot_tpu.server.profiler``, on ``torch.profiler`` instead of
``jax.profiler``).

The utilization plane's gauges (``device.util.*``) answer "HOW utilized
is the device"; when a lane saturates in production the next question
is "on WHAT", and that needs a trace of the card's kernels.  This module
makes capture an admin-endpoint action instead of a restart:

  POST /debug/profile/start   begin (or join) a capture
  POST /debug/profile/stop    release one start; capture ends at zero
  GET  /debug/profile         live state + capture directory listing

Semantics:

- **Ref-counted**: concurrent starts share ONE capture (one profiler
  session per process); each ``start`` must be paired with a ``stop``,
  and the trace stops when the count reaches zero.
- **What a capture holds**: ``torch.profiler`` with the CPU and (on the
  card) CUDA activities, started from the admin handler's thread.  The
  CUDA activity records every kernel of the process whatever thread
  launched it (the lane thread launches K1 and K2), so a capture
  directory holds ``trace.json`` (the Chrome trace) and
  ``kernels.json`` (per device kernel: its name, launches and device
  microseconds), and the snapshot's ``lastCapture`` carries that kernel
  summary.
- **Auto-stop timeout**: every start (re-)arms a deadline
  (``PINOT_TPU_PROFILE_AUTO_STOP_S``, default 120s); a client that
  dies mid-capture cannot leave the profiler running forever — the
  timer force-stops regardless of the count and marks
  ``profile.autoStops``.
- **Bounded on disk**: captures land under one base directory
  (``PINOT_TPU_PROFILE_DIR`` or a per-process tempdir), one
  subdirectory per capture, oldest pruned beyond ``max_captures``.
- **Typed unavailability**: a build without a working profiler raises
  ``ProfilerUnavailableError``; the admin endpoint maps it to a 404 with
  ``errorType`` so callers can distinguish "no profiler" from "bad
  request".

The hot path cost while idle is literally zero — nothing is consulted
per query; the profiler only acts inside start/stop.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class ProfilerUnavailableError(RuntimeError):
    """torch.profiler missing or its session refused to start."""


class _TorchTraceApi:
    """``(start(dir), stop())`` over one ``torch.profiler.profile``
    session at a time.  The session lives on a capture thread of its own:
    the profiler must be started and stopped on one thread, while the
    admin server answers each request on a new one.  ``stop`` exports the
    Chrome trace and the device kernels' summary into the capture's
    directory and keeps the summary as ``last_kernels``."""

    def __init__(self) -> None:
        try:
            import torch
            from torch import profiler as tprof
        except ImportError as e:  # pragma: no cover - import environment
            raise ProfilerUnavailableError(f"torch.profiler unavailable: {e}")
        self._torch = torch
        self._tprof = tprof
        self._session = None  # (thread, stop event, outcome box)
        self.last_kernels: Optional[Dict[str, Any]] = None

    def __iter__(self):
        return iter((self.start, self.stop))

    def start(self, capture_dir: str) -> None:
        started, stop_event, box = threading.Event(), threading.Event(), {}
        t = threading.Thread(target=self._capture, args=(capture_dir, started, stop_event, box),
                             name="profiler-capture", daemon=True)
        t.start()
        started.wait()
        if "error" in box:
            t.join()
            raise box["error"]
        self._session = (t, stop_event, box)

    def stop(self) -> None:
        session, self._session = self._session, None
        if session is None:
            return
        t, stop_event, box = session
        stop_event.set()
        t.join()
        if "error" in box:
            raise box["error"]
        self.last_kernels = box["kernels"]

    def _capture(self, capture_dir: str, started, stop_event, box) -> None:
        activities = [self._tprof.ProfilerActivity.CPU]
        if self._torch.cuda.is_available():
            activities.append(self._tprof.ProfilerActivity.CUDA)
        try:
            prof = self._tprof.profile(activities=activities)
            prof.start()
        except Exception as e:
            box["error"] = e
            started.set()
            return
        started.set()
        stop_event.wait()
        try:
            prof.stop()
            from torch.autograd import DeviceType

            kernels: Dict[str, Any] = {}
            for ev in prof.key_averages():
                if ev.device_type != DeviceType.CUDA:
                    continue
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = ev.self_cuda_time_total
                kernels[ev.key] = {"launches": int(ev.count), "deviceUs": round(float(us), 3)}
            with open(os.path.join(capture_dir, "kernels.json"), "w") as f:
                json.dump(kernels, f)
            prof.export_chrome_trace(os.path.join(capture_dir, "trace.json"))
            box["kernels"] = {"dir": capture_dir, "kernels": kernels}
        except Exception as e:
            box["error"] = e


class DeviceProfiler:
    """Ref-counted, auto-stopping ``torch.profiler`` capture manager.

    ``trace_api`` ((start_fn(dir), stop_fn()) tuple) and ``clock`` are
    injectable for unit tests; production uses ``torch.profiler`` and
    ``time.monotonic``."""

    def __init__(
        self,
        name: str = "server",
        base_dir: Optional[str] = None,
        metrics=None,
        auto_stop_s: Optional[float] = None,
        max_captures: int = 4,
        trace_api=None,
        clock=time.monotonic,
    ) -> None:
        if base_dir is None:
            base_dir = os.environ.get("PINOT_TPU_PROFILE_DIR")
        if base_dir is None:
            import tempfile

            base_dir = os.path.join(
                tempfile.gettempdir(), "pinot_tpu_profiles", f"{name}-{os.getpid()}"
            )
        self.base_dir = base_dir
        self.max_captures = max(1, max_captures)
        if auto_stop_s is None:
            auto_stop_s = float(
                os.environ.get("PINOT_TPU_PROFILE_AUTO_STOP_S", "120")
            )
        self.auto_stop_s = auto_stop_s
        self.metrics = metrics
        self._trace_api = trace_api
        self._clock = clock
        self._lock = threading.Lock()
        self._refcount = 0
        self._capture_dir: Optional[str] = None
        self._started_at: Optional[float] = None
        self._deadline: Optional[float] = None
        self._timer: Optional[threading.Timer] = None
        self._seq = 0
        # capture dirs are immutable once their trace stops, so their
        # sizes are computed once and cached — snapshot() sits on polled
        # paths (/debug/device, status()) and must not re-walk hundreds
        # of MB of trace files per scrape, let alone under self._lock
        self._size_cache: Dict[str, int] = {}
        self.auto_stops = 0
        # optional hook fired whenever a capture ends (stop or
        # auto-stop): the server uses it to park its occupancy sampler
        self.on_capture_end = None
        if metrics is not None:
            # pre-registered so /metrics shows zeros before first use
            for m in ("profile.starts", "profile.stops", "profile.autoStops",
                      "profile.failedStarts"):
                metrics.meter(m)
            metrics.gauge("profile.active").set(0)

    # -- public API ----------------------------------------------------
    def start(self, timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Begin a capture, or join the active one (refcount++).  Every
        start re-arms the auto-stop deadline to now + timeout (capped
        callers extend; a second client cannot SHORTEN a running
        capture's remaining window below its own request)."""
        timeout = float(timeout_s) if timeout_s else self.auto_stop_s
        with self._lock:
            if self._refcount == 0:
                self._begin_capture_locked()
            self._refcount += 1
            now = self._clock()
            deadline = now + max(0.1, timeout)
            if self._deadline is None or deadline > self._deadline:
                self._deadline = deadline
                self._arm_timer_locked(self._deadline - now)
            if self.metrics is not None:
                self.metrics.meter("profile.starts").mark()
                self.metrics.gauge("profile.active").set(1)
            return self._snapshot_locked()

    def stop(self) -> Dict[str, Any]:
        """Release one start; the trace stops when the count hits zero.
        Stopping an inactive profiler is a no-op snapshot (idempotent
        — a retried stop after a timeout must not error)."""
        ended = False
        with self._lock:
            if self._refcount > 0:
                self._refcount -= 1
                if self.metrics is not None:
                    self.metrics.meter("profile.stops").mark()
                if self._refcount == 0:
                    ended = self._end_capture_locked()
            snap = self._snapshot_locked()
        if ended:
            self._fire_capture_end()
        return snap

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return self._snapshot_locked()

    def shutdown(self) -> None:
        """Force-stop any active capture (server shutdown path)."""
        ended = False
        with self._lock:
            if self._refcount > 0:
                self._refcount = 0
                ended = self._end_capture_locked()
        if ended:
            self._fire_capture_end()

    # -- internals -----------------------------------------------------
    def _begin_capture_locked(self) -> None:
        start_fn, _ = self._api()
        self._seq += 1
        capture_dir = os.path.join(
            self.base_dir, f"capture-{self._seq:04d}-{int(time.time())}"
        )
        try:
            # prune BEFORE creating the new dir: pruning after would
            # count the new capture among the victims-by-age candidates
            # (with max_captures=1 it would rmtree the dir the trace is
            # about to write into)
            self._prune_captures_locked(keep=self.max_captures - 1)
            os.makedirs(capture_dir, exist_ok=True)
            start_fn(capture_dir)
        except ProfilerUnavailableError:
            raise
        except Exception as e:
            if self.metrics is not None:
                self.metrics.meter("profile.failedStarts").mark()
            raise ProfilerUnavailableError(
                f"profiler trace failed to start: {type(e).__name__}: {e}"
            )
        self._capture_dir = capture_dir
        self._started_at = time.time()

    def _end_capture_locked(self) -> bool:
        """Returns True when an active capture actually ended — the
        caller fires ``on_capture_end`` AFTER releasing the lock (the
        hook may join the occupancy sampler thread for seconds, and a
        concurrent snapshot/start must not stall behind that)."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._deadline = None
        if self._capture_dir is None:
            return False
        _, stop_fn = self._api()
        try:
            stop_fn()
        except Exception as e:
            # a capture that failed mid-flight must still reset state:
            # the NEXT start has to be able to begin a fresh trace
            logger.warning("profiler stop_trace failed: %s", e)
        self._capture_dir = None
        self._started_at = None
        if self.metrics is not None:
            self.metrics.gauge("profile.active").set(0)
        return True

    def _fire_capture_end(self) -> None:
        if self.on_capture_end is not None:
            try:
                self.on_capture_end()
            except Exception:
                logger.exception("profiler on_capture_end hook failed")

    def _api(self):
        if self._trace_api is None:
            # one session object for the profiler's life: stop() must end
            # the session start() began
            self._trace_api = _TorchTraceApi()
        return tuple(self._trace_api)

    def _arm_timer_locked(self, delay_s: float) -> None:
        if self._timer is not None:
            self._timer.cancel()
        t = threading.Timer(max(0.05, delay_s), self._auto_stop)
        t.daemon = True
        self._timer = t
        t.start()

    def _auto_stop(self) -> None:
        """Deadline fired: force-stop REGARDLESS of refcount — a dead
        client's unmatched start must not pin the profiler open."""
        ended = False
        with self._lock:
            if self._capture_dir is None:
                return
            if self._deadline is not None and self._clock() < self._deadline - 1e-3:
                # a later start extended the deadline after this timer
                # was armed; re-arm for the remainder instead
                self._arm_timer_locked(self._deadline - self._clock())
                return
            self._refcount = 0
            self.auto_stops += 1
            if self.metrics is not None:
                self.metrics.meter("profile.autoStops").mark()
            ended = self._end_capture_locked()
        if ended:
            self._fire_capture_end()

    def _prune_captures_locked(self, keep: int) -> None:
        try:
            entries = sorted(
                d
                for d in os.listdir(self.base_dir)
                if d.startswith("capture-")
                and os.path.isdir(os.path.join(self.base_dir, d))
            )
        except OSError:
            return
        for victim in entries[: max(0, len(entries) - max(0, keep))]:
            shutil.rmtree(os.path.join(self.base_dir, victim), ignore_errors=True)

    def _dir_bytes(self, path: str) -> int:
        nbytes = 0
        for root, _, files in os.walk(path):
            for f in files:
                try:
                    nbytes += os.path.getsize(os.path.join(root, f))
                except OSError:
                    pass
        return nbytes

    def _captures_locked(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        try:
            entries = sorted(
                d
                for d in os.listdir(self.base_dir)
                if d.startswith("capture-")
            )
        except OSError:
            return out
        live = set(entries)
        for stale in [k for k in self._size_cache if k not in live]:
            del self._size_cache[stale]
        for d in entries:
            path = os.path.join(self.base_dir, d)
            if path == self._capture_dir:
                # still being written: size unknown until the trace stops
                out.append({"name": d, "bytes": None})
                continue
            nbytes = self._size_cache.get(d)
            if nbytes is None:
                nbytes = self._dir_bytes(path)
                self._size_cache[d] = nbytes
            out.append({"name": d, "bytes": nbytes})
        return out

    def _snapshot_locked(self) -> Dict[str, Any]:
        now = self._clock()
        return {
            "active": self._capture_dir is not None,
            "refCount": self._refcount,
            "dir": self._capture_dir,
            "baseDir": self.base_dir,
            "startedAt": self._started_at,
            "autoStopS": self.auto_stop_s,
            "remainingS": (
                round(max(0.0, self._deadline - now), 3)
                if self._deadline is not None and self._capture_dir is not None
                else None
            ),
            "autoStops": self.auto_stops,
            "maxCaptures": self.max_captures,
            "captures": self._captures_locked(),
            # the device kernels of the last finished capture (None before
            # one, or under an injected trace API)
            "lastCapture": getattr(self._trace_api, "last_kernels", None),
        }
