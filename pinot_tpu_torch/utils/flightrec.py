"""Flight recorder: bounded on-disk postmortem bundles on notable events
(copy of ``pinot_tpu.utils.flightrec``).

At a notable event (an SLO burn crossing, a shed burst, a heal event, an
audit divergence) the role's in-memory observability state (the history
window, the slow-query log, the retained tails, plan statistics, device
snapshots) is dumped to disk:

- one JSON file a bundle (``frec-<millis>-<role>-<name>-<reason>-<seq>.json``,
  written through a temporary file and a rename), each a ``{"reason",
  "ts", "detail", "sources": {...}}`` document;
- bounded: the oldest bundles are pruned BEFORE a new one is written
  (``PINOT_TPU_FLIGHTREC_MAX``, default 8);
- rate-limited (``PINOT_TPU_FLIGHTREC_MIN_INTERVAL_S``, default 30 s);
- **disabled unless ``PINOT_TPU_FLIGHTREC_DIR`` is set** (or a directory
  is passed).

The triggers are each role's ``_history_tick`` hooks (broker: SLO burn
crossing, shed burst, failed query; server: heal events) and the
auditors' divergences."""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from pinot_tpu_torch.common.conf import env_float

logger = logging.getLogger(__name__)


class FlightRecorder:
    def __init__(
        self,
        role: str,
        name: str,
        sources: Optional[Dict[str, Callable[[], Any]]] = None,
        directory: Optional[str] = None,
        max_bundles: Optional[int] = None,
        min_interval_s: Optional[float] = None,
        metrics=None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.role = role
        self.name = name
        self.dir = directory if directory is not None else (
            os.environ.get("PINOT_TPU_FLIGHTREC_DIR") or None
        )
        self.max_bundles = int(
            env_float("PINOT_TPU_FLIGHTREC_MAX", 8)
            if max_bundles is None
            else max_bundles
        )
        self.min_interval_s = (
            env_float("PINOT_TPU_FLIGHTREC_MIN_INTERVAL_S", 30.0)
            if min_interval_s is None
            else min_interval_s
        )
        self._sources: Dict[str, Callable[[], Any]] = dict(sources or {})
        self._clock = clock
        self._last_dump = 0.0
        self._seq = 0
        self._lock = threading.Lock()
        self.metrics = metrics
        if metrics is not None:
            metrics.meter("flightrec.dumps")
            metrics.gauge("flightrec.bundles").set_fn(
                lambda: len(self.bundle_files())
            )

    @property
    def enabled(self) -> bool:
        return bool(self.dir)

    # -- disk side -----------------------------------------------------
    def bundle_files(self) -> List[str]:
        """Absolute paths of THIS recorder's bundles, oldest first (the
        filename's millisecond stamp + sequence orders them)."""
        if not self.dir or not os.path.isdir(self.dir):
            return []
        prefix = f"frec-"
        mine = f"-{self.role}-{self.name}-"
        out = [
            os.path.join(self.dir, f)
            for f in os.listdir(self.dir)
            if f.startswith(prefix) and mine in f and f.endswith(".json")
        ]
        return sorted(out)

    def _prune(self) -> None:
        files = self.bundle_files()
        # prune BEFORE writing (the profiler lesson: pruning after with
        # max_bundles=1 deletes the bundle just written)
        while len(files) >= max(1, self.max_bundles):
            victim = files.pop(0)
            try:
                os.remove(victim)
            except OSError:
                pass

    def maybe_dump(
        self, reason: str, detail: Optional[Dict[str, Any]] = None
    ) -> Optional[str]:
        """Collect every source and write one bundle, unless disabled or
        inside the rate-limit window.  Source failures degrade to an
        ``{"error": ...}`` entry — a sick snapshot never loses the rest
        of the bundle.  Returns the written path (or None)."""
        if not self.enabled:
            return None
        now = self._clock()
        with self._lock:
            if now - self._last_dump < self.min_interval_s:
                return None
            prev_last = self._last_dump
            self._last_dump = now
            self._seq += 1
            seq = self._seq
        bundle: Dict[str, Any] = {
            "role": self.role,
            "instance": self.name,
            "reason": reason,
            "ts": round(now, 3),
            "detail": detail or {},
            "sources": {},
        }
        for sname, fn in self._sources.items():
            try:
                bundle["sources"][sname] = fn()
            except Exception as e:
                bundle["sources"][sname] = {"error": f"{type(e).__name__}: {e}"}
        try:
            os.makedirs(self.dir, exist_ok=True)
            self._prune()
            fname = (
                f"frec-{int(now * 1000)}-{self.role}-{self.name}-{reason}-{seq}.json"
            )
            path = os.path.join(self.dir, fname)
            tmp = path + ".part"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(bundle, f)
            os.replace(tmp, path)
        except OSError:
            logger.warning("flight-recorder dump failed", exc_info=True)
            with self._lock:
                # no bundle exists: give the window back so the NEXT
                # notable event isn't silently dropped for min_interval_s
                if self._last_dump == now:
                    self._last_dump = prev_last
            return None
        if self.metrics is not None:
            self.metrics.meter("flightrec.dumps").mark()
        logger.warning(
            "flight-recorder bundle written: %s (%s)", path, reason
        )
        return path

    # -- read side -----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """``/debug/flightrec`` payload: config + bundle inventory."""
        bundles = []
        for path in self.bundle_files():
            try:
                st = os.stat(path)
                bundles.append(
                    {
                        "file": os.path.basename(path),
                        "bytes": st.st_size,
                        "mtime": round(st.st_mtime, 3),
                    }
                )
            except OSError:
                continue
        return {
            "enabled": self.enabled,
            "dir": self.dir,
            "maxBundles": self.max_bundles,
            "minIntervalS": self.min_interval_s,
            "dumps": 0
            if self.metrics is None
            else self.metrics.meter("flightrec.dumps").count,
            "bundles": bundles,
        }
