"""Ingest backpressure: watermark-governed pause and resume of realtime
consumers (port of ``pinot_tpu.realtime.backpressure``).

One governor a server, shared by its consumers (the in-process
``realtime/llc.py RealtimeSegmentDataManager`` and the networked
``server/network_starter.py RemoteConsumer``).  It watches two pools:

- **staged bytes on the card**: the server executor's staging cache
  (``QueryExecutor.staged_bytes``), the device memory queries create by
  staging segments;
- **mutable-segment bytes**: ``MutableSegment.approx_bytes`` summed over
  the server's consuming segments, the host memory ingest creates.

A hysteresis latch: consumption pauses when either pool crosses its high
watermark and resumes only once both are back under their low ones.
Consumers poll ``consume_allowed()`` before every fetch (bounded
batches, ``clamp_batch``); while paused the stream offset stops, lag
grows on the ``ingest.lag.*`` gauges and drains after the resume.
Nothing consumed is dropped, nothing unconsumed is skipped.

Watermarks default off (0 = unlimited) and come from the environment:
``PINOT_TPU_INGEST_HBM_HIGH_BYTES`` / ``..._LOW_BYTES`` (low defaults to
80% of high) and ``PINOT_TPU_INGEST_MUTABLE_HIGH_BYTES`` /
``..._LOW_BYTES``; ``PINOT_TPU_INGEST_BATCH_ROWS`` bounds one fetch
(default 4096).

Residency pressure (the third pool): with an HBM cap set on the
server's residency manager (``engine/residency.py``) the governor also
watches its ``pressure()``, hot bytes as a fraction of the cap, pausing
at ``PINOT_TPU_INGEST_RESIDENCY_HIGH_FRAC`` (default 0.95) and resuming
below ``..._LOW_FRAC`` (default 0.8): a working set pushing the hot tier
against its cap throttles new rows before allocation failures do.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from pinot_tpu_torch.common.conf import env_float

logger = logging.getLogger(__name__)


class IngestBackpressure:
    """One governor a server instance, shared by all its consumers."""

    def __init__(
        self,
        metrics=None,
        hbm_high_bytes: Optional[float] = None,
        hbm_low_bytes: Optional[float] = None,
        mutable_high_bytes: Optional[float] = None,
        mutable_low_bytes: Optional[float] = None,
        hbm_bytes_fn: Optional[Callable[[], float]] = None,
        mutable_bytes_fn: Optional[Callable[[], float]] = None,
        poll_interval_s: float = 0.2,
        max_batch_rows: Optional[int] = None,
        event_capacity: int = 64,
        residency=None,
    ) -> None:
        self.hbm_high = float(hbm_high_bytes if hbm_high_bytes is not None
                              else env_float("PINOT_TPU_INGEST_HBM_HIGH_BYTES"))
        self.hbm_low = float(hbm_low_bytes if hbm_low_bytes is not None
                             else env_float("PINOT_TPU_INGEST_HBM_LOW_BYTES", 0.8 * self.hbm_high))
        self.mutable_high = float(mutable_high_bytes if mutable_high_bytes is not None
                                  else env_float("PINOT_TPU_INGEST_MUTABLE_HIGH_BYTES"))
        self.mutable_low = float(mutable_low_bytes if mutable_low_bytes is not None
                                 else env_float("PINOT_TPU_INGEST_MUTABLE_LOW_BYTES", 0.8 * self.mutable_high))
        self._hbm_bytes = hbm_bytes_fn or (lambda: 0.0)
        self._mutable_bytes = mutable_bytes_fn or (lambda: 0.0)
        # the residency pool: fractions of the manager's HBM cap, inert
        # (pressure reads 0.0) while no cap is set
        self._residency = residency
        self.residency_high_frac = env_float("PINOT_TPU_INGEST_RESIDENCY_HIGH_FRAC", 0.95)
        self.residency_low_frac = env_float("PINOT_TPU_INGEST_RESIDENCY_LOW_FRAC",
                                             0.8 if self.residency_high_frac > 0 else 0.0)
        # one decision a poll interval: the watermark reads (the staging
        # lock, the data-manager walk) stay off the per-batch path
        self.poll_interval_s = poll_interval_s
        self.max_batch_rows = int(max_batch_rows if max_batch_rows is not None
                                  else env_float("PINOT_TPU_INGEST_BATCH_ROWS", 4096))
        self.metrics = metrics
        self._lock = threading.Lock()
        self._paused = False
        self._reason = ""
        self._last_poll = 0.0
        self._pauses = 0
        self._resumes = 0
        self._events: deque = deque(maxlen=event_capacity)
        if metrics is not None:
            metrics.meter("ingest.pauses")
            metrics.meter("ingest.resumes")
            metrics.gauge("ingest.paused").set_fn(lambda: 1 if self._paused else 0)

    @property
    def enabled(self) -> bool:
        return self.hbm_high > 0 or self.mutable_high > 0 or self._residency_enabled()

    def _residency_enabled(self) -> bool:
        """The residency pool is live only while the manager has an HBM
        cap (read at each poll: an operator may set it at run time)."""
        return (self._residency is not None and self.residency_high_frac > 0
                and self._residency.hbm_cap_bytes > 0)

    @property
    def paused(self) -> bool:
        return self._paused

    @property
    def reason(self) -> str:
        return self._reason

    # -- the consumer-facing check ------------------------------------
    def consume_allowed(self, force_poll: bool = False) -> bool:
        """True when consumers may fetch the next batch.  Re-evaluates the
        watermarks at most every ``poll_interval_s`` unless ``force_poll``."""
        if not self.enabled:
            return True
        with self._lock:
            now = time.monotonic()
            if not force_poll and now - self._last_poll < self.poll_interval_s:
                return not self._paused
            self._last_poll = now
            hbm = self._read(self._hbm_bytes)
            mutable = self._read(self._mutable_bytes)
            res_on = self._residency_enabled()
            pressure = self._read(self._residency.pressure) if res_on else 0.0
            if not self._paused:
                reason = None
                if self.hbm_high > 0 and hbm >= self.hbm_high:
                    reason = f"hbm {int(hbm)}B >= high watermark {int(self.hbm_high)}B"
                elif self.mutable_high > 0 and mutable >= self.mutable_high:
                    reason = f"mutable {int(mutable)}B >= high watermark {int(self.mutable_high)}B"
                elif res_on and pressure >= self.residency_high_frac:
                    reason = f"residency pressure {pressure:.2f} >= {self.residency_high_frac:.2f} of HBM cap"
                if reason is not None:
                    self._paused = True
                    self._reason = reason
                    self._pauses += 1
                    self._event("pause", reason, hbm, mutable)
                    if self.metrics is not None:
                        self.metrics.meter("ingest.pauses").mark()
                    logger.warning("ingest paused: %s", reason)
            else:
                hbm_ok = self.hbm_high <= 0 or hbm <= self.hbm_low
                mutable_ok = self.mutable_high <= 0 or mutable <= self.mutable_low
                residency_ok = not res_on or pressure <= self.residency_low_frac
                if hbm_ok and mutable_ok and residency_ok:
                    self._paused = False
                    self._reason = ""
                    self._resumes += 1
                    self._event("resume", "below low watermarks", hbm, mutable)
                    if self.metrics is not None:
                        self.metrics.meter("ingest.resumes").mark()
                    logger.info("ingest resumed (below low watermarks)")
            return not self._paused

    @staticmethod
    def _read(fn: Callable[[], float]) -> float:
        try:
            return float(fn() or 0)
        except Exception:
            # a broken probe fails open: a server stuck paused would fall
            # behind its stream unseen
            return 0.0

    def _event(self, kind: str, reason: str, hbm: float, mutable: float) -> None:
        self._events.append({"event": kind, "reason": reason, "hbmBytes": int(hbm),
                             "mutableBytes": int(mutable), "tMs": time.time() * 1000.0})

    def clamp_batch(self, rows: int) -> int:
        """Bound one fetch's rows."""
        return min(rows, self.max_batch_rows) if self.max_batch_rows > 0 else rows

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "paused": self._paused,
                "reason": self._reason,
                "pauses": self._pauses,
                "resumes": self._resumes,
                "watermarks": {
                    "hbmHighBytes": self.hbm_high,
                    "hbmLowBytes": self.hbm_low,
                    "mutableHighBytes": self.mutable_high,
                    "mutableLowBytes": self.mutable_low,
                    "residencyHighFrac": self.residency_high_frac,
                    "residencyLowFrac": self.residency_low_frac,
                },
                "residencyPressure": round(
                    self._read(self._residency.pressure) if self._residency is not None else 0.0, 4),
                "maxBatchRows": self.max_batch_rows,
                "events": list(self._events),
            }


def instance_mutable_bytes(server) -> float:
    """``approx_bytes`` summed over the consuming (mutable) segments the
    instance hosts: the governor's host-memory input."""
    from pinot_tpu_torch.realtime.mutable import MutableSegment

    total = 0.0
    dm = getattr(server, "data_manager", None)
    if dm is None:
        return total
    for table in dm.table_names():
        tdm = dm.table(table)
        if tdm is None:
            continue
        acquired = tdm.acquire_segments()
        try:
            for sdm in acquired:
                if isinstance(sdm.segment, MutableSegment):
                    total += sdm.segment.approx_bytes()
        finally:
            tdm.release_segments(acquired)
    return total
