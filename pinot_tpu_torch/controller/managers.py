"""Controller background managers (a copy of
``pinot_tpu.controller.managers``).

Reference counterparts:
- RetentionManager (``helix/core/retention/RetentionManager.java:50``):
  periodically deletes segments whose end time is past the table's
  retention window.
- ValidationManager (``validation/ValidationManager.java:64``): compares
  ideal vs external view, retries ERROR partitions, emits
  missing-segment metrics (and, for realtime tables, re-creates missing
  consuming segments — see ``pinot_tpu_torch.realtime``).
- SegmentStatusChecker (``helix/SegmentStatusChecker.java``): gauges of
  segments in ERROR / missing replicas.

Managers are explicit ``run_once()`` steps driven by a thread loop (or
tests calling run_once directly — deterministic, no sleeps).
"""
from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from typing import Dict, List, Optional

from pinot_tpu_torch.common.schema import time_unit_to_millis
from pinot_tpu_torch.controller.resource_manager import (
    CONSUMING,
    ClusterResourceManager,
    ERROR,
    ONLINE,
)
from pinot_tpu_torch.utils.metrics import ControllerMetrics

logger = logging.getLogger(__name__)


# every started manager registers here so the conftest thread-leak
# guard can assert that a stopped manager's worker actually exited
# (mirrors engine.dispatch._all_lanes / leaked_lane_threads)
_all_managers: "weakref.WeakSet[_PeriodicManager]" = weakref.WeakSet()


class _PeriodicManager:
    def __init__(self, interval_s: float, metrics_scope: Optional[str] = None) -> None:
        self.interval_s = interval_s
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.metrics = ControllerMetrics(metrics_scope or type(self).__name__)
        _all_managers.add(self)

    def run_once(self) -> None:
        raise NotImplementedError

    def start(self) -> None:
        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.run_once()
                except Exception:
                    # counted, not only logged: a manager silently
                    # failing every round (retention never deleting,
                    # stabilizer never healing) must show on a meter
                    self.metrics.meter(
                        f"manager.{type(self).__name__}.failures"
                    ).mark()
                    logger.exception("%s run failed", type(self).__name__)

        self._thread = threading.Thread(
            target=loop, name=f"manager-{type(self).__name__}", daemon=True
        )
        self._thread.start()

    def stop(self, join_timeout_s: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            # bounded join: the worker is at most one run_once away from
            # seeing the stop event; a wedged run must not hang shutdown
            t.join(timeout=join_timeout_s)


def leaked_manager_threads(grace_s: float = 2.0) -> List[threading.Thread]:
    """Worker threads still alive on STOPPED managers — the post-test
    leak check (running managers, e.g. module-scoped fixtures, are
    exempt: they are still on duty)."""
    suspects: List[threading.Thread] = []
    for mgr in list(_all_managers):
        t = mgr._thread
        if mgr._stop.is_set() and t is not None and t.is_alive():
            suspects.append(t)
    deadline = time.monotonic() + grace_s
    leaked = []
    for t in suspects:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            leaked.append(t)
    return leaked


class RetentionManager(_PeriodicManager):
    def __init__(
        self,
        resources: ClusterResourceManager,
        store,
        interval_s: float = 3600.0,
        now_ms=None,
    ) -> None:
        super().__init__(interval_s, metrics_scope="retention")
        self.resources = resources
        self.store = store
        self._now_ms = now_ms or (lambda: int(time.time() * 1000))

    def run_once(self) -> None:
        now = self._now_ms()
        for table in self.resources.tables():
            config = self.resources.table_configs.get(table)
            if config is None or config.retention.retention_time_value <= 0:
                continue
            window_ms = config.retention.retention_time_value * time_unit_to_millis(
                config.retention.retention_time_unit
            )
            for seg in self.resources.segments_of(table):
                info = self.resources.get_segment_metadata(table, seg)
                if not info:
                    continue
                meta = info.get("metadata")
                if meta is None or meta.end_time is None or meta.time_column is None:
                    continue
                end_ms = meta.end_time * time_unit_to_millis(meta.time_unit)
                if end_ms < now - window_ms:
                    logger.info("retention: deleting %s/%s", table, seg)
                    self.resources.delete_segment(table, seg)
                    if self.store is not None:
                        self.store.delete(table, seg)


class ValidationManager(_PeriodicManager):
    def __init__(
        self,
        resources: ClusterResourceManager,
        interval_s: float = 300.0,
        realtime_manager=None,
    ) -> None:
        super().__init__(interval_s, metrics_scope="validation")
        self.resources = resources
        # RealtimeSegmentManager: every run also re-creates missing
        # CONSUMING segments (the LLC repair half of the reference's
        # ValidationManager); the Controller wires it at construction
        self.realtime_manager = realtime_manager

    def run_once(self) -> None:
        for table in self.resources.tables():
            ideal = self.resources.get_ideal_state(table)
            view = self.resources.get_external_view(table)
            missing = 0
            errors = 0
            for seg, replicas in ideal.items():
                actual = view.get(seg, {})
                for server, target in replicas.items():
                    got = actual.get(server)
                    if got == ERROR:
                        errors += 1
                        self.resources.reset_segment(table, seg, server)
                    elif got != target:
                        missing += 1
                        self.resources.reset_segment(table, seg, server)
            self.metrics.gauge(f"{table}.missingReplicas").set(missing)
            self.metrics.gauge(f"{table}.errorReplicas").set(errors)
        if self.realtime_manager is not None:
            self.realtime_manager.ensure_consuming_segments()


class CrcAuditManager(_PeriodicManager):
    """Cross-replica checksum sweep (the control-plane half of
    the audit plane): every round pulls each alive server's claimed
    segment CRCs (``/debug/segments``) and compares the replica sets —
    against each other AND against the property-store metadata CRC the
    segment was registered with.  A disagreement means replicas of the
    same immutable segment serve different bytes (torn download, bit
    rot, a stale copy a failed refresh left behind) — the divergence
    class the per-query shadow auditor cannot see because a broker
    normally scatters each segment to exactly one replica.

    Consuming mutable segments carry no CRC claim and are skipped; a
    server with no admin URL (in-process deployments) is skipped and
    counted, never treated as divergent.  The fetch is pluggable
    (``crc_fn(name, url) -> {table: {segment: crc}}``) so tests drive
    the sweep deterministically without HTTP."""

    def __init__(
        self,
        resources: ClusterResourceManager,
        interval_s: float = 300.0,
        crc_fn=None,
        timeout_s: float = 3.0,
    ) -> None:
        super().__init__(interval_s, metrics_scope="crcAudit")
        self.resources = resources
        self.crc_fn = crc_fn or self._http_crcs
        self.timeout_s = timeout_s
        self._rollup_lock = threading.Lock()
        self._last: Dict = {"runs": 0, "segmentsChecked": 0, "mismatches": []}
        # pre-registered so the sweep plane shows zeros before round one
        for m in (
            "audit.sweep.runs",
            "audit.sweep.segmentsChecked",
            "audit.sweep.skippedInstances",
        ):
            self.metrics.meter(m)
        self.metrics.gauge("audit.crcMismatches").set(0)

    def _http_crcs(self, name: str, url: str) -> Dict:
        import json
        import urllib.request

        with urllib.request.urlopen(
            url.rstrip("/") + "/debug/segments", timeout=self.timeout_s
        ) as resp:
            return json.loads(resp.read().decode()).get("segments", {})

    def run_once(self) -> None:
        per_server: Dict[str, Dict] = {}
        skipped = 0
        for inst in self.resources.instances_snapshot():
            if inst.role != "server" or not inst.alive:
                continue
            if not inst.url:
                skipped += 1
                continue
            try:
                per_server[inst.name] = self.crc_fn(inst.name, inst.url) or {}
            except Exception:
                skipped += 1
        checked = 0
        mismatches: List[Dict] = []
        for table in self.resources.tables():
            ideal = self.resources.get_ideal_state(table)
            for seg, replicas in ideal.items():
                crcs = {
                    server: per_server[server][table][seg]
                    for server in replicas
                    if per_server.get(server, {}).get(table, {}).get(seg)
                    is not None
                }
                if not crcs:
                    continue
                checked += 1
                info = self.resources.get_segment_metadata(table, seg) or {}
                expected = getattr(info.get("metadata"), "crc", None)
                vals = set(crcs.values())
                if len(vals) > 1 or (
                    expected is not None and vals != {expected}
                ):
                    mismatches.append(
                        {
                            "table": table,
                            "segment": seg,
                            "expectedCrc": expected,
                            "replicaCrcs": dict(crcs),
                        }
                    )
        self.metrics.meter("audit.sweep.runs").mark()
        self.metrics.meter("audit.sweep.segmentsChecked").mark(checked)
        if skipped:
            self.metrics.meter("audit.sweep.skippedInstances").mark(skipped)
        self.metrics.gauge("audit.crcMismatches").set(len(mismatches))
        with self._rollup_lock:
            self._last = {
                "runs": self._last["runs"] + 1,
                "segmentsChecked": checked,
                "skippedInstances": skipped,
                "serversPolled": sorted(per_server),
                "mismatches": mismatches,
            }

    def snapshot(self) -> Dict:
        """Latest sweep rollup (the controller's ``/debug/audit``)."""
        with self._rollup_lock:
            out = dict(self._last)
        out["intervalS"] = self.interval_s
        return out


class DeepStoreScrubber(_PeriodicManager):
    """Background re-verification of the controller's durable segment
    copies, with reverse replication for lost/corrupt ones.

    The reference's deep store (NFS/HDFS) has storage-level redundancy
    and ``RetentionManager``-adjacent validators; our controller-local
    ``SegmentStore`` is a single copy that nobody reads between upload
    and the next server fetch — bit rot there is invisible until a
    replica tries to load it.  This manager (a ``CrcAuditManager``
    sibling) walks the store on a cadence, re-verifies each copy's CRC
    under the shared ``SamplerBudget`` (scrubbing must never starve
    serving), and repairs a bad copy *from a live server's verified
    local copy* — the reverse of the normal fetch direction, possible
    because servers CRC-verify every segment they load.

    Servers also push suspects: a fetch that fails CRC against the
    store copy reports it here (``report_suspect``), so a rotten copy
    is repaired on the next round instead of poisoning every future
    replica placement.  The copy fetch is pluggable
    (``copy_fn(name, url, table, segment) -> bytes``) so in-process
    tests drive repairs without HTTP."""

    def __init__(
        self,
        resources: ClusterResourceManager,
        store,
        interval_s: float = 300.0,
        budget=None,
        copy_fn=None,
        timeout_s: float = 10.0,
    ) -> None:
        super().__init__(interval_s, metrics_scope="deepstore")
        from pinot_tpu_torch.utils.audit import BUDGET

        self.resources = resources
        self.store = store
        self.budget = budget if budget is not None else BUDGET
        self.copy_fn = copy_fn or self._http_copy
        self.timeout_s = timeout_s
        self._suspect_lock = threading.Lock()
        self._suspects: List[Dict] = []
        self._rollup_lock = threading.Lock()
        self._last: Dict = {
            "runs": 0,
            "copiesChecked": 0,
            "corruptCopies": 0,
            "repairs": 0,
            "repairFailures": 0,
            "budgetDenied": 0,
            "evidence": [],
        }
        for m in (
            "deepstore.scrub.runs",
            "deepstore.scrub.copiesChecked",
            "deepstore.scrub.budgetDenied",
            "deepstore.corruptCopies",
            "deepstore.repairs",
            "deepstore.repairFailures",
            "deepstore.suspectsReported",
        ):
            self.metrics.meter(m)
        self.metrics.gauge("deepstore.suspectsPending").set(0)

    # -- suspect intake (fetch-path feedback) -------------------------

    def report_suspect(self, table: str, segment: str, source: str = "") -> None:
        """A fetch failed CRC against the store copy: queue that copy
        for priority verification on the next scrub round."""
        with self._suspect_lock:
            if any(
                s["table"] == table and s["segment"] == segment
                for s in self._suspects
            ):
                return
            self._suspects.append(
                {"table": table, "segment": segment, "source": source}
            )
            pending = len(self._suspects)
        self.metrics.meter("deepstore.suspectsReported").mark()
        self.metrics.gauge("deepstore.suspectsPending").set(pending)

    def _http_copy(self, name: str, url: str, table: str, segment: str) -> bytes:
        import urllib.request

        if not url:
            raise RuntimeError(f"server {name} has no admin URL")
        with urllib.request.urlopen(
            url.rstrip("/") + f"/segments/{table}/{segment}/copy",
            timeout=self.timeout_s,
        ) as resp:
            return resp.read()

    # -- scrub round --------------------------------------------------

    def _targets(self) -> List[Dict]:
        """Suspects first (priority), then the cadence walk over every
        segment the metadata expects a durable copy for (CONSUMING
        realtime segments have none yet)."""
        with self._suspect_lock:
            targets = list(self._suspects)
            self._suspects = []
        seen = {(t["table"], t["segment"]) for t in targets}
        for table in self.resources.tables():
            ideal = self.resources.get_ideal_state(table)
            for seg, replicas in ideal.items():
                if (table, seg) in seen:
                    continue
                if replicas and all(s == CONSUMING for s in replicas.values()):
                    continue
                targets.append({"table": table, "segment": seg, "source": ""})
        return targets

    def run_once(self) -> None:
        checked = 0
        denied = 0
        corrupt: List[Dict] = []
        repaired = 0
        repair_failures = 0
        evidence: List[Dict] = []
        for target in self._targets():
            table, seg = target["table"], target["segment"]
            if not self.budget.take():
                denied += 1
                if target["source"]:
                    # keep a server-reported suspect for the next round
                    # rather than dropping the report on the floor
                    self.report_suspect(table, seg, target["source"])
                continue
            info = self.resources.get_segment_metadata(table, seg) or {}
            expected = getattr(info.get("metadata"), "crc", None)
            try:
                self.store.verify_copy(table, seg, expected_crc=expected)
                checked += 1
                continue
            except FileNotFoundError:
                reason = "missing"
            except Exception as e:
                reason = f"corrupt: {e}"
            checked += 1
            row = {
                "table": table,
                "segment": seg,
                "reason": reason,
                "reportedBy": target["source"] or None,
                "repairedFrom": None,
            }
            corrupt.append(row)
            src = self._repair(table, seg, expected)
            if src:
                row["repairedFrom"] = src
                repaired += 1
            else:
                repair_failures += 1
            evidence.append(row)

        self.metrics.meter("deepstore.scrub.runs").mark()
        self.metrics.meter("deepstore.scrub.copiesChecked").mark(checked)
        if denied:
            self.metrics.meter("deepstore.scrub.budgetDenied").mark(denied)
        if corrupt:
            self.metrics.meter("deepstore.corruptCopies").mark(len(corrupt))
        if repaired:
            self.metrics.meter("deepstore.repairs").mark(repaired)
        if repair_failures:
            self.metrics.meter("deepstore.repairFailures").mark(repair_failures)
        with self._suspect_lock:
            pending = len(self._suspects)
        self.metrics.gauge("deepstore.suspectsPending").set(pending)
        with self._rollup_lock:
            self._last = {
                "runs": self._last["runs"] + 1,
                "copiesChecked": checked,
                "corruptCopies": len(corrupt),
                "repairs": self._last["repairs"] + repaired,
                "repairFailures": repair_failures,
                "budgetDenied": denied,
                "evidence": (self._last["evidence"] + evidence)[-32:],
            }

    def _repair(self, table: str, seg: str, expected_crc) -> Optional[str]:
        """Reverse replication: pull verified bytes from a live ONLINE
        replica, re-verify them independently, and install as the new
        durable copy.  Returns the donor server name or None."""
        import tempfile

        from pinot_tpu_torch.segment.format import read_segment, verify_segment_crc

        view = self.resources.get_external_view(table).get(seg, {})
        urls = {
            inst.name: inst.url
            for inst in self.resources.instances_snapshot()
            if inst.role == "server" and inst.alive
        }
        for server, state in sorted(view.items()):
            if state != ONLINE or server not in urls:
                continue
            try:
                data = self.copy_fn(server, urls[server], table, seg)
                if not data:
                    continue
                # verify the donated bytes before trusting them: parse,
                # recompute the data CRC, and match the registered crc
                with tempfile.TemporaryDirectory() as td:
                    fpath = os.path.join(td, "columns.pnt")
                    with open(fpath, "wb") as f:
                        f.write(data)
                    donated = read_segment(fpath)
                    verify_segment_crc(donated, source=f"repair:{server}")
                    if (
                        expected_crc
                        and donated.metadata.crc
                        and donated.metadata.custom.get("dataCrc")
                        and int(donated.metadata.crc) != int(expected_crc)
                    ):
                        continue
                self.store.save_bytes(table, seg, data)
                self.store.verify_copy(table, seg, expected_crc=expected_crc)
                return server
            except Exception:
                logger.exception(
                    "deep-store repair of %s/%s from %s failed", table, seg, server
                )
        return None

    def snapshot(self) -> Dict:
        """Latest scrub rollup (the controller's ``/debug/deepstore``)."""
        with self._rollup_lock:
            out = dict(self._last)
        with self._suspect_lock:
            out["suspectsPending"] = len(self._suspects)
        out["intervalS"] = self.interval_s
        return out


class SegmentStatusChecker(_PeriodicManager):
    def __init__(self, resources: ClusterResourceManager, interval_s: float = 300.0) -> None:
        super().__init__(interval_s, metrics_scope="segmentStatus")
        self.resources = resources

    def run_once(self) -> None:
        for table in self.resources.tables():
            ideal = self.resources.get_ideal_state(table)
            view = self.resources.get_external_view(table)
            total = len(ideal)
            online = sum(
                1
                for seg, replicas in ideal.items()
                if any(view.get(seg, {}).get(s) == replicas[s] for s in replicas)
            )
            pct = 100.0 if total == 0 else 100.0 * online / total
            self.metrics.gauge(f"{table}.percentSegmentsAvailable").set(round(pct, 1))
            self.metrics.gauge(f"{table}.segmentCount").set(total)
