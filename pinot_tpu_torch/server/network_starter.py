"""Networked server starter: a server process joining a remote controller
(port of ``pinot_tpu.server.network_starter``, trimmed).

- ``start`` initializes the device on the main thread and builds and
  loads both kernels (``ServerInstance`` does, on the card) BEFORE the
  server registers, so it never reports ONLINE before it can launch;
- it registers over HTTP (the participant join) and heartbeats for
  liveness, renewing its serving lease on each reply;
- it polls transition messages, runs them (download the segment file
  from the controller with a CRC check and load it, start a consuming
  segment's ``RemoteConsumer``, or drop it) and acks the resulting state;
- its ``IngestConsumerPool`` drives every realtime consumer it hosts:
  each pulls its stream partition from the stream broker, indexes into a
  mutable segment that queries read at its watermark, and at the flush
  threshold runs the completion protocol against the controller over
  HTTP (the committer uploads its segment file);
- it serves broker queries on a length-framed TCP socket, and
  ``/health``, ``/metrics``, ``/debug/metrics``, ``/debug/residency``,
  ``/debug/device``, ``/debug/plans[?top=&by=]``, ``/debug/profile``,
  ``POST /debug/profile/start|stop``, ``/debug/prewarm``,
  ``/debug/history``, ``/debug/audit``, ``/debug/flightrec``,
  ``/debug/segments`` and ``/segments/<table>/<segment>/copy`` on its
  admin HTTP port (``ServerAdminHttpServer``);
- its prewarm worker (``server/prewarm.py``) pulls the controller's
  fleet workload (``/debug/workload``) for the tables it hosts when its
  segments load, and every heartbeat reports whether it is warming;
- its residency caps come from the environment
  (``starter.residency_options``).

A CONSUMING message of a highlevel table starts an ``HLRemoteConsumer``
instead: one consumer-group member a table on its own thread, which seals
its segment at the row threshold, uploads it pinned to this server, then
commits the group's offsets and rolls to the next sequence.

The heartbeat and message loops back off with full jitter while the
controller is unreachable and keep serving from local state.  With a
``fault_injector`` (``common/faults.NetworkFaultInjector``) every
controller-bound call (register, heartbeat, message poll and ack, the
completion protocol and its upload, the workload feed) rides the link
``name -> controller`` (``_link``).
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Union
from urllib.parse import parse_qs, urlparse

import torch

from pinot_tpu_torch.common.faults import call_on_controller_link
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.controller.resource_manager import CONSUMING, DROPPED, OFFLINE, ONLINE
from pinot_tpu_torch.realtime.kafka_group import KafkaGroupConsumer
from pinot_tpu_torch.realtime.llc import (
    attach_freshness,
    detach_freshness,
    fetch_and_index,
    make_segment_name,
    parse_segment_name,
)
from pinot_tpu_torch.realtime.mutable import MutableSegment
from pinot_tpu_torch.realtime.netstream import HLConsumer
from pinot_tpu_torch.realtime.pool import IngestConsumerPool
from pinot_tpu_torch.realtime.stream import LagProbe, stream_from_descriptor
from pinot_tpu_torch.segment.fetcher import DEFAULT_FACTORY
from pinot_tpu_torch.segment.invindex import warm_inverted_indexes
from pinot_tpu_torch.segment.format import (
    SEGMENT_FILE_NAME,
    SegmentIntegrityError,
    SegmentStaleError,
    read_segment,
    verify_segment_crc,
    write_segment,
)
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.server.profiler import ProfilerUnavailableError
from pinot_tpu_torch.server.starter import quarantine_local_copy, residency_options
from pinot_tpu_torch.transport.tcp import TcpServer
from pinot_tpu_torch.utils.retry import FullJitterBackoff, tighten_liveness_budget

logger = logging.getLogger(__name__)

class ServerAdminHttpServer:
    """The server's scrape and ops surface: ``/health``, Prometheus text at
    ``/metrics``, the status and metrics JSON at ``/debug/metrics``,
    ``/debug/samples?timer=<name>&last=<n>``, the last n samples of one
    timer (per-query phase medians for a client that sends one query shape
    at a time), ``/debug/residency``, the residency tiers (bytes and
    tables a tier, the cap pressure, the demotion and promotion
    counters), ``/debug/device`` (``device_utilization()``),
    ``/debug/plans?top=&by=count|cost`` (the plan statistics),
    ``/debug/profile`` and ``POST /debug/profile/start`` (body
    ``{"timeoutS": s}``) / ``stop`` (the profiler; a typed 404 without
    one), ``/debug/prewarm`` (the prewarm worker's state),
    ``/debug/history?series=&windowS=`` (the metric history),
    ``/debug/audit`` (the shadow auditor's counters and quarantines) and
    ``/debug/flightrec`` (the flight recorder's bundles).  The query data
    plane stays on the TCP socket."""

    def __init__(self, server: ServerInstance, host: str = "127.0.0.1", port: int = 0):
        inst = server

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, body: bytes, ctype: str, status: int = 200) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, payload, status: int = 200) -> None:
                self._send(json.dumps(payload).encode("utf-8"), "application/json", status)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/health":
                    return self._send_json({"status": "ok"})
                if url.path == "/metrics":
                    return self._send(inst.metrics_text().encode("utf-8"), "text/plain; version=0.0.4")
                if url.path == "/debug/metrics":
                    return self._send_json(inst.status())
                if url.path == "/debug/residency":
                    return self._send_json(inst.executor.residency.snapshot())
                if url.path == "/debug/device":
                    return self._send_json(inst.device_utilization())
                if url.path == "/debug/profile":
                    return self._send_json(inst.profiler.snapshot())
                if url.path == "/debug/prewarm":
                    return self._send_json(inst.prewarm.state())
                if url.path == "/debug/history":
                    return self._send_json(inst.history.query_from_qs(url.query))
                if url.path == "/debug/audit":
                    return self._send_json(inst.audit_snapshot())
                if url.path == "/debug/flightrec":
                    return self._send_json(inst.flightrec.snapshot())
                if url.path == "/debug/segments":
                    # the controller's cross-replica CRC sweep
                    return self._send_json(inst.segment_crcs())
                if url.path.startswith("/segments/") and url.path.endswith("/copy"):
                    # the deep-store scrubber pulls a verified replica to
                    # repair the controller's copy
                    p = url.path.strip("/").split("/")
                    data = inst.segment_copy_bytes(p[1], p[2]) if len(p) == 4 else None
                    if data is not None:
                        return self._send(data, "application/octet-stream")
                    return self._send_json({"error": "segment not donatable"}, 404)
                if url.path == "/debug/plans":
                    qs = parse_qs(url.query)
                    by = (qs.get("by") or ["count"])[0]
                    try:
                        top = int((qs.get("top") or ["50"])[0])
                    except ValueError:
                        top = 50
                    return self._send_json(inst.plan_stats.snapshot(top=top, by=by))
                if url.path == "/debug/samples":
                    qs = parse_qs(url.query)
                    name = (qs.get("timer") or [""])[0]
                    try:
                        last = int((qs.get("last") or ["0"])[0])
                    except ValueError:
                        return self._send_json({"error": "last must be an integer"}, 400)
                    samples = inst.metrics.timer(name).samples()
                    return self._send_json({"timer": name, "samples": samples[-last:] if last > 0 else samples})
                self._send_json({"error": "not found"}, 404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0") or 0)
                raw = self.rfile.read(n) if n else b""
                try:
                    body = json.loads(raw) if raw else {}
                except ValueError:
                    return self._send_json({"error": "bad JSON body"}, 400)
                path = urlparse(self.path).path
                if path == "/debug/profile/start":
                    try:
                        return self._send_json(inst.profile_start(body.get("timeoutS")))
                    except ProfilerUnavailableError as e:
                        # typed 404: this process has no usable profiler
                        return self._send_json({"error": str(e), "errorType": "ProfilerUnavailableError"}, 404)
                    except Exception as e:
                        return self._send_json({"error": str(e)}, 500)
                if path == "/debug/profile/stop":
                    return self._send_json(inst.profile_stop())
                self._send_json({"error": "not found"}, 404)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class RemoteConsumer:
    """A server process's LLC consumer: pulls its stream partition by
    offset, indexes into a mutable segment that queries read at once (at
    its watermark), and runs the completion protocol against the
    controller over HTTP (the ``LLRealtimeSegmentDataManager.java:68``
    consume loop and the ``SegmentCompletionProtocol`` client).

    Cooperative: ``step()`` is one bounded unit of consume / commit work
    that never blocks, driven by the starter's ``IngestConsumerPool``.  A
    backpressure pause, an empty stream, a HOLD or an unreachable
    controller is the step's return delay.  A columnar topic is read a
    whole block a fetch (``realtime/llc.py fetch_and_index``; the
    reference's networked consumer reads row topics only)."""

    def __init__(self, starter: "NetworkedServerStarter", table: str, segment: str, msg: Dict[str, Any],
                 poll_interval_s: float = 0.2) -> None:
        self.starter = starter
        self.table = table
        self.segment = segment
        self.partition = int(msg.get("partition", 0))
        self.offset = int(msg.get("startOffset", 0))
        self.rows_per_segment = int(msg.get("rowsPerSegment", 100_000))
        self.poll_interval_s = poll_interval_s
        self.stream = stream_from_descriptor(msg["streamDescriptor"])
        self.mutable = MutableSegment(Schema.from_json(msg["schemaJson"]), segment, table)
        self.mutable.start_offset = self.offset
        self._columnar: Optional[bool] = None
        self._stop = threading.Event()
        # an unreachable controller freezes the round (offsets hold, the
        # consumer lives) and parks it for a full-jitter backoff
        self._ctrl_backoff = FullJitterBackoff(initial_s=max(0.1, poll_interval_s), cap_s=5.0)
        # seconds the next pool step waits, set by the protocol paths
        self._park_s = poll_interval_s
        self._metrics = starter.server.metrics
        self._lag_probe = LagProbe(self.stream, self.partition, lambda: self.offset)
        self._lag_gauge_name = f"ingest.lag.{table}.p{self.partition}"
        self._governor = starter.server.ingest_backpressure
        self._paused = False
        self._paused_gauge_name = f"ingest.paused.{table}.p{self.partition}"
        self._paused_fn = lambda: 1 if self._paused else 0
        self._metrics.gauge(self._lag_gauge_name).set_fn(self._lag_probe)
        self._metrics.gauge(self._paused_gauge_name).set_fn(self._paused_fn)
        # the event-time watermark and the result cache's offset fence
        attach_freshness(self, starter.server, self.mutable.schema)

    def _detach_gauges(self) -> None:
        """A finished consumer's frozen offset must not report lag; the
        equality guard of clear_fn keeps a rolled successor's series."""
        self._metrics.gauge(self._lag_gauge_name).clear_fn(self._lag_probe)
        self._metrics.gauge(self._paused_gauge_name).clear_fn(self._paused_fn)
        detach_freshness(self, self._metrics)

    def start(self) -> None:
        self.starter.server.add_segment(self.table, self.mutable)
        self.starter.ingest_pool.add(self, key=self.segment)

    def stop(self) -> None:
        self._stop.set()
        self._detach_gauges()

    def _mark_rows(self, n: int) -> None:
        if n:
            self._metrics.meter("ingest.rowsConsumed").mark(int(n))

    # -- consume loop ---------------------------------------------------
    def _consume_to(self, limit_rows: int) -> int:
        budget = limit_rows - self.mutable.num_docs
        if budget <= 0:
            return 0
        # one governor decision covers at most max_batch_rows
        return fetch_and_index(self, self._governor.clamp_batch(budget))

    def step(self) -> Optional[float]:
        """One pool unit: a bounded consume batch and, at the row threshold,
        one completion round.  Returns the seconds until this consumer is
        eligible again, or None when its segment is finished."""
        if self._stop.is_set():
            self._detach_gauges()
            return None
        allowed = self._governor.consume_allowed()
        self._paused = not allowed
        if not allowed:
            # held above a watermark: the offset freezes, lag grows
            return self.poll_interval_s
        try:
            got = self._consume_to(self.rows_per_segment)
        except Exception as e:
            logger.warning("stream fetch failed for %s: %s", self.segment, e)
            return self.poll_interval_s
        if self.mutable.num_docs >= self.rows_per_segment:
            self._park_s = self.poll_interval_s
            if self._completion_round():
                self._detach_gauges()
                return None
            return self._park_s
        return 0.0 if got else self.poll_interval_s

    def _freeze(self, why: str, err) -> bool:
        """The controller is unreachable (or authority lost) mid-protocol:
        the round freezes and parks for a full-jitter backoff."""
        self._park_s = self._ctrl_backoff.next_delay()
        logger.warning("%s for %s frozen (retry in %.2fs): %s", why, self.segment, self._park_s, err)
        return False

    def _completion_round(self) -> bool:
        """One segmentConsumed exchange; True when this consumer is done.
        Idle verdicts (HOLD, a freeze, a failed commit) set ``_park_s``."""
        lease = self.starter.server.lease
        if not lease.held():
            # no write authority while the lease is expired
            self._metrics.meter("lease.blockedCommits").mark()
            return self._freeze("completion round", "serving lease expired")
        epoch = lease.epoch if lease.granted else None
        try:
            out = self.starter._post("/realtime/consumed", {
                "segment": self.segment, "server": self.starter.name, "offset": self.offset, "epoch": epoch,
            })
        except Exception as e:
            return self._freeze("segmentConsumed", e)
        self._ctrl_backoff.reset()
        resp = out.get("response")
        target = out.get("targetOffset")
        if resp == "COMMIT":
            try:
                return self._commit(epoch)
            except Exception as e:
                # a conversion or serialization failure: the next round retries
                logger.warning("commit of %s failed: %s", self.segment, e)
                self._park_s = self.poll_interval_s
                return False
        if resp == "CATCH_UP" and target is not None:
            while self.offset < int(target) and not self._stop.is_set():
                try:
                    got = self._consume_to(self.rows_per_segment + int(target) - self.offset)
                except Exception as e:
                    logger.warning("catch-up fetch failed for %s: %s", self.segment, e)
                    self._park_s = self.poll_interval_s
                    return False
                if got == 0:
                    self._park_s = self.poll_interval_s
                    return False
            return False
        if resp == "DISCARD":
            # another replica committed another offset range: drop the
            # local rows; the ONLINE transition downloads the committed copy
            self.starter.server.remove_segment(self.table, self.segment)
            return True
        if resp == "KEEP":
            # committed at exactly this offset; the local rows serve until
            # the ONLINE transition replaces them
            return True
        self._park_s = self.poll_interval_s  # HOLD
        return False

    def _commit(self, epoch=None) -> bool:
        """Convert, write the file, upload it (``ingest.commitConvertMs``,
        ``ingest.commitFileMs``, ``ingest.commitUploadMs``; the three in
        ``ingest.commitMs``); the ONLINE transition that follows loads the
        committed copy (``segmentLoad``)."""
        t0 = time.perf_counter()
        committed = self.mutable.to_committed_segment()
        t1 = time.perf_counter()
        path = f"/realtime/commit/{self.segment}/{self.starter.name}"
        if epoch is not None:
            # the lease epoch fences the upload: a controller failover
            # mid-upload rejects it (409) instead of committing twice
            path += f"?epoch={epoch}"
        try:
            data = self.starter.segment_file_bytes(committed)
            t2 = time.perf_counter()
            out = self.starter.upload_file_bytes(path, data)
        except Exception as e:
            # the controller may have stored the copy and lost the reply:
            # the next segmentConsumed answers KEEP or DISCARD
            return self._freeze("segmentCommit", e)
        if out.get("response") != "KEEP":
            return False  # NOT_LEADER / HOLD: the next round retries
        t3 = time.perf_counter()
        for name, a, b in (("Convert", t0, t1), ("File", t1, t2), ("Upload", t2, t3), ("", t0, t3)):
            self._metrics.timer(f"ingest.commit{name}Ms").update((b - a) * 1000)
        logger.info("committed %s at offset %d", self.segment, self.offset)
        return True


class HLRemoteConsumer:
    """A server's high-level consumer of one table
    (``HLRealtimeSegmentDataManager.java:54``): this server is one member
    of the table's consumer group, and the stream broker assigns it
    partitions and rebalances them as members come and go.  Rows index
    into a server-owned mutable segment; at the row threshold the segment
    converts and uploads pinned to this server, then the group's offsets
    commit, and consumption rolls locally to the next sequence (an HLC
    segment has one owner, so no committer is elected).  Delivery is at
    least once across a rebalance, as in the reference.  The group is the
    stream broker's (``netstream.HLConsumer``) or, for a Kafka stream,
    Kafka's group coordinator (``kafka_group.KafkaGroupConsumer``)."""

    rolls_locally = True  # the ONLINE of a sealed HLC segment must not stop it

    def __init__(self, starter: "NetworkedServerStarter", table: str, segment: str, msg: Dict[str, Any]) -> None:
        self.starter = starter
        self.table = table
        self.segment = segment
        _, self.idx, self.seq = parse_segment_name(segment)
        self.rows_per_segment = int(msg.get("rowsPerSegment", 100_000))
        self.poll_interval_s = float(msg.get("pollIntervalS", 0.2))
        desc = msg["streamDescriptor"]
        consumer_cls = KafkaGroupConsumer if desc.get("type") == "kafka" else HLConsumer
        self.consumer = consumer_cls(desc["host"], int(desc["port"]), desc["topic"], group=table,
                                     consumer_id=starter.name,
                                     session_timeout=float(msg.get("sessionTimeoutS", 10.0)))
        self.consumer.on_revoke = self._on_revoke
        self.schema = Schema.from_json(msg["schemaJson"])
        self.mutable = MutableSegment(self.schema, segment, table)
        self._metrics = starter.server.metrics
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.starter.server.add_segment(self.table, self.mutable)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self.consumer.close()
        except Exception:
            pass
        # the loop ends within a poll: joined, so no consumer thread is left
        # inside the server after its shutdown
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=10)

    def _run(self) -> None:
        try:
            joined = False
            while not self._stop.is_set():
                if not joined:
                    try:
                        self.consumer.join()
                        joined = True
                    except Exception as e:
                        # the stream broker is not reachable yet: a one-shot
                        # join would strand the consumer, so it retries
                        logger.warning("HLC join failed for %s: %s", self.segment, e)
                        self._stop.wait(self.poll_interval_s)
                        continue
                try:
                    budget = self.rows_per_segment - self.mutable.num_docs
                    rows = self.consumer.poll() if budget > 0 else []
                except Exception as e:
                    logger.warning("HLC poll failed for %s: %s", self.segment, e)
                    self._stop.wait(self.poll_interval_s)
                    continue
                self.mutable.index_batch([row for _, row in rows])
                if rows:
                    self._metrics.meter("ingest.rowsConsumed").mark(len(rows))
                if self.mutable.num_docs >= self.rows_per_segment:
                    if not self._seal_and_roll():
                        self._stop.wait(self.poll_interval_s)
                elif not rows:
                    self._stop.wait(self.poll_interval_s)
        except Exception:
            logger.exception("HLC consumer for %s died", self.segment)

    def _on_revoke(self) -> None:
        """A rebalance revoked (part of) the assignment: the uncommitted
        rows must be durable before a successor resumes, so the segment
        seals, uploads and commits now (a small segment is fine; a
        rebalance is rare).  If the upload fails the uncommitted rows are
        DISCARDED instead: they stay uncommitted, the successor reads them
        again, and keeping them here would count them twice."""
        if self.mutable.num_docs == 0:
            try:
                self.consumer.commit()
            except Exception as e:
                # every consumed row is durable in a sealed segment already;
                # a failed commit only makes a successor read again from
                # older committed offsets (at least once)
                logger.warning("HLC revoke-time offset commit failed: %s", e)
            return
        try:
            sealed = self._seal_and_roll()
        except Exception:
            # e.g. the conversion failed: the discard path below leaves the
            # member in a known state rather than raising into the consumer
            logger.exception("HLC seal during revoke failed for %s", self.segment)
            sealed = False
        if not sealed:
            old = self.segment
            self.mutable = MutableSegment(self.schema, self.segment, self.table)
            self.starter.server.add_segment(self.table, self.mutable)
            # the discarded rows were neither persisted nor committed: the
            # positions go back to the committed offsets, so whoever owns
            # these partitions next (maybe this member) fetches them again
            try:
                self.consumer.reset_to_committed()
            except Exception as e:
                logger.warning("HLC position rollback failed: %s", e)
            logger.warning("HLC revoke: upload failed; discarded uncommitted rows of %s", old)

    def _seal_and_roll(self) -> bool:
        """Convert, upload pinned to this server, THEN commit the group's
        offsets, then roll to the next sequence (``ingest.commitConvertMs``,
        ``ingest.commitUploadMs``)."""
        t0 = time.perf_counter()
        committed = self.mutable.to_committed_segment()
        t1 = time.perf_counter()
        try:
            self.starter.upload_file_bytes(
                f"/segments/{urllib.parse.quote(self.table)}?server={urllib.parse.quote(self.starter.name)}",
                self.starter.segment_file_bytes(committed))
        except Exception as e:
            logger.warning("HLC upload of %s failed (will retry): %s", self.segment, e)
            return False
        t2 = time.perf_counter()
        self._metrics.timer("ingest.commitConvertMs").update((t1 - t0) * 1000)
        self._metrics.timer("ingest.commitUploadMs").update((t2 - t1) * 1000)
        # the segment is durable on the controller: checkpoint the group's
        # offsets, then go on at the next sequence (a crash between the
        # upload and the commit re-reads rows: the reference's HLC contract)
        try:
            self.consumer.commit()
        except Exception as e:
            logger.warning("HLC offset commit failed for %s: %s", self.segment, e)
        old = self.segment
        self.seq += 1
        self.segment = make_segment_name(self.table, self.idx, self.seq)
        self.mutable = MutableSegment(self.schema, self.segment, self.table)
        # re-keyed BEFORE the controller hears of it, so the CONSUMING
        # transition of the new name dedupes against this consumer
        self.starter._consumers.pop(old, None)
        self.starter._consumers[self.segment] = self
        self.starter.server.add_segment(self.table, self.mutable)
        try:
            self.starter._post("/realtime/hlc/roll", {"table": self.table, "server": self.starter.name,
                                                       "idx": self.idx, "seq": self.seq})
        except Exception as e:
            # routing misses the new consuming segment until the validation
            # repair registers it; the rows are safe
            logger.warning("HLC roll notify failed for %s: %s", self.segment, e)
        logger.info("HLC sealed %s (%d rows), rolled to %s", old, committed.num_docs, self.segment)
        return True


class NetworkedServerStarter:
    """``device``: the card the server stages and launches on (None: the
    current CUDA device; ``"cpu"`` for tests).  ``data_dir`` keeps a local
    copy of each segment file; without it each load downloads to a
    temporary file."""

    def __init__(
        self,
        controller_url: str,
        name: str,
        host: str = "127.0.0.1",
        port: int = 0,
        data_dir: Optional[str] = None,
        heartbeat_interval_s: float = 1.0,
        poll_interval_s: float = 0.3,
        admin_port: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        precision: str = "x64",
        fault_injector=None,
    ) -> None:
        self.controller_url = controller_url.rstrip("/")
        self.name = name
        # the link-level chaos hook: every controller-bound HTTP call rides
        # the link (name -> "controller") through it
        self.fault_injector = fault_injector
        self.server = ServerInstance(name, device=device, precision=precision, **residency_options())
        self.tcp = TcpServer(self.server.handle_request, host=host, port=port)
        self.admin = ServerAdminHttpServer(self.server, host=host, port=admin_port)
        self.data_dir = data_dir
        self.heartbeat_interval_s = heartbeat_interval_s
        self.poll_interval_s = poll_interval_s
        # the heartbeat backoff stays under the controller's liveness
        # window (tightened from the register reply), so an asymmetric
        # partition cannot flap a live server dead
        self._hb_backoff = FullJitterBackoff(initial_s=max(0.1, heartbeat_interval_s), cap_s=2.0)
        self._hb_timeout_s = 10.0
        self._msg_backoff = FullJitterBackoff(initial_s=max(0.1, poll_interval_s), cap_s=10.0)
        self._local_crcs: Dict[str, int] = {}
        # segment -> consumer (a RemoteConsumer, or an HLRemoteConsumer
        # keyed under its current segment)
        self._consumers: Dict[str, Union[RemoteConsumer, HLRemoteConsumer]] = {}
        # one bounded worker pool drives every LLC consumer of this server
        self.ingest_pool = IngestConsumerPool(metrics=self.server.metrics, name=name)
        self._stop = threading.Event()
        # a heartbeat that succeeds while the message poll is deep in
        # backoff wakes the poll (queued transitions land at once)
        self._msg_wake = threading.Event()
        self._threads: list = []
        # fleet plan prewarming: segment loads trigger passes over the
        # controller's merged workload for the tables hosted here
        self.server.prewarm.workload_source = self._fetch_workload

    # -- HTTP helpers --------------------------------------------------
    def _link(self, fn):
        """Run one controller-bound RPC through the link injector."""
        return call_on_controller_link(self.fault_injector, self.name, fn, metrics=self.server.metrics)

    def _post(self, path: str, payload: Dict[str, Any], timeout_s: float = 10.0) -> Dict[str, Any]:
        def send():
            req = urllib.request.Request(
                self.controller_url + path, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                return json.loads(r.read())

        return self._link(send)

    def _get(self, path: str) -> Dict[str, Any]:
        def send():
            with urllib.request.urlopen(self.controller_url + path, timeout=10) as r:
                return json.loads(r.read())

        return self._link(send)

    def _fetch_workload(self, tables, n) -> list:
        """The prewarm feed: the controller's fleet-merged top-K plan
        shapes, narrowed to ``tables``."""
        qs = f"?n={int(n)}"
        if tables:
            qs += "&tables=" + urllib.parse.quote(",".join(tables))
        out = self._get("/debug/workload" + qs)
        return out.get("topByCount") or out.get("top") or []

    def _register_payload(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "role": "server",
            "addr": [self.tcp.address[0], self.tcp.address[1]],
            "url": self.admin.url,
        }

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        dev = self.server.device
        if dev.type == "cuda":
            # the CUDA context on the main thread, before any worker or
            # lane thread; the kernels were built and loaded when the
            # ServerInstance was made, so a failed build never registers
            torch.cuda.set_device(dev)
            torch.cuda.init()
            torch.cuda.synchronize(dev)
        self.tcp.start()
        self.admin.start()
        out = self._post("/instances", self._register_payload())
        self.server.lease.renew(out.get("lease"))
        timeout = out.get("heartbeatTimeoutSeconds")
        if timeout:
            self._hb_timeout_s = tighten_liveness_budget(self._hb_backoff, float(timeout), self._hb_timeout_s)
        for fn in (self._heartbeat_loop, self._message_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def segment_file_bytes(segment) -> bytes:
        """A segment's file (``segment/format.py``) as bytes."""
        with tempfile.TemporaryDirectory() as td:
            write_segment(segment, td)
            with open(os.path.join(td, SEGMENT_FILE_NAME), "rb") as f:
                return f.read()

    def upload_file_bytes(self, path: str, data: bytes) -> Dict[str, Any]:
        """POST segment-file bytes to the controller."""
        def send():
            req = urllib.request.Request(self.controller_url + path, data=data,
                                         headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=600) as r:
                return json.loads(r.read())

        return self._link(send)

    def stop(self) -> None:
        self._stop.set()
        self._msg_wake.set()
        for consumer in list(self._consumers.values()):
            consumer.stop()
        self.ingest_pool.stop()
        for t in self._threads:
            t.join(timeout=5)
        self.tcp.stop()
        self.admin.stop()
        self.server.shutdown()

    def _heartbeat_loop(self) -> None:
        wait_s = self.heartbeat_interval_s
        unreachable = self.server.metrics.gauge("controller.unreachable")
        while not self._stop.wait(wait_s):
            try:
                out = self._post(f"/instances/{self.name}/heartbeat",
                                 {"warming": bool(self.server.prewarm.warming)}, timeout_s=self._hb_timeout_s)
                # the drain flag rides the reply; a "held" reply (flap
                # hysteresis) carries no lease
                self.server.draining = bool(out.get("draining"))
                self.server.lease.renew(out.get("lease"))
                if out.get("reregister"):
                    reg = self._post("/instances", self._register_payload(), timeout_s=self._hb_timeout_s)
                    self.server.lease.renew(reg.get("lease"))
                if self._hb_backoff.failures:
                    # the controller is back: queued transitions land at
                    # once, and frozen consumers leave their backoff
                    self._msg_backoff.reset()
                    self._msg_wake.set()
                    self.ingest_pool.kick()
                self._hb_backoff.reset()
                unreachable.set(0)
                wait_s = self.heartbeat_interval_s
            except Exception as e:
                self.server.metrics.meter("controller.heartbeatFailures").mark()
                unreachable.set(1)
                wait_s = self._hb_backoff.next_delay()
                logger.warning("heartbeat to controller failed (%d consecutive, retry in %.2fs): %s",
                               self._hb_backoff.failures, wait_s, e)

    def _message_loop(self) -> None:
        wait_s = self.poll_interval_s
        while True:
            if self._msg_wake.wait(timeout=wait_s):
                self._msg_wake.clear()
                wait_s = self.poll_interval_s
            if self._stop.is_set():
                return
            try:
                msgs = self._get(f"/instances/{self.name}/messages")["messages"]
                self._msg_backoff.reset()
                wait_s = self.poll_interval_s
            except Exception as e:
                wait_s = self._msg_backoff.next_delay()
                logger.warning("message poll failed (retry in %.2fs): %s", wait_s, e)
                continue
            for msg in msgs:
                if self._stop.is_set():
                    return
                self._handle(msg)

    # -- transitions ---------------------------------------------------
    def _retire_consumer(self, segment: str) -> None:
        consumer = self._consumers.pop(segment, None)
        if consumer is not None:
            consumer.stop()
            self.ingest_pool.remove(segment)

    def _handle(self, msg: Dict[str, Any]) -> None:
        table, segment, target = msg["table"], msg["segment"], msg["target"]
        if target == CONSUMING and not self.server.lease.held():
            # no new consuming role without write authority: not acked, the
            # message comes again once the lease renews
            self.server.metrics.meter("lease.blockedTransitions").mark()
            logger.warning("deferring CONSUMING %s/%s: serving lease expired", table, segment)
            return
        try:
            if target == ONLINE:
                # CONSUMING -> ONLINE: the consumer retires before the
                # committed copy replaces its mutable segment.  An HLC
                # consumer rolls itself to the next sequence (it may still
                # be keyed under the sealed name for an instant): never here
                consumer = self._consumers.get(segment)
                if consumer is not None and not getattr(consumer, "rolls_locally", False):
                    self._retire_consumer(segment)
                ok = self._load(table, segment, msg.get("crc"), msg.get("downloadUri"),
                                msg.get("invertedIndexColumns"), msg.get("schemaJson"))
            elif target == CONSUMING:
                ok = self._start_consumer(table, segment, msg)
            elif target in (OFFLINE, DROPPED):
                self._retire_consumer(segment)
                self.server.remove_segment(table, segment)
                self._local_crcs.pop(segment, None)
                ok = True
            else:
                logger.error("unsupported transition target %s", target)
                ok = False
        except Exception:
            logger.exception("transition %s/%s -> %s failed", table, segment, target)
            ok = False
        try:
            self._post(f"/instances/{self.name}/ack", {
                "msgId": msg.get("msgId"), "table": table, "segment": segment, "state": target, "ok": ok,
            })
        except Exception as e:
            # the message stays on the board and comes again
            logger.warning("ack failed for %s/%s: %s", table, segment, e)

    def _start_consumer(self, table: str, segment: str, msg: Dict[str, Any]) -> bool:
        if segment in self._consumers:
            return True  # a redelivered message: don't reset the offset
        if not msg.get("streamDescriptor") or not msg.get("schemaJson"):
            logger.error("CONSUMING message for %s lacks a consume spec", segment)
            return False
        if msg.get("consumerType") == "highlevel":
            # one group member a (server, table): a replayed CONSUMING of an
            # older sequence (after a controller recovery) must not start a
            # second consumer under the same member id
            for c in self._consumers.values():
                if getattr(c, "rolls_locally", False) and c.table == table:
                    return True
            consumer = HLRemoteConsumer(self, table, segment, msg)
        else:
            consumer = RemoteConsumer(self, table, segment, msg)
        self._consumers[segment] = consumer
        consumer.start()
        return True

    def _load(self, table: str, segment: str, crc: Optional[int], download_uri: Optional[str] = None,
              inv_columns=None, schema_json=None) -> bool:
        # the schema applies on the CRC-skip path too: a reload after schema
        # evolution patches the loaded segments without reading any bytes
        if schema_json is not None:
            self.server.set_table_schema(table, Schema.from_json(schema_json))
        tdm = self.server.data_manager.table(table)
        if tdm is not None and segment in tdm.segment_names() and crc is not None \
                and self._local_crcs.get(segment) == crc:
            return True  # this CRC is already loaded
        t0 = time.perf_counter()
        local = None if self.data_dir is None else os.path.join(self.data_dir, table, segment)
        seg_obj = None
        if local is not None and os.path.exists(os.path.join(local, SEGMENT_FILE_NAME)):
            try:
                cached = read_segment(local)
                if crc is None or cached.metadata.crc == crc:
                    verify_segment_crc(cached, source=local)  # only bytes that verify serve
                    seg_obj = cached
            except SegmentIntegrityError:
                self.server.record_crc_failure(table, segment)
                quarantine_local_copy(self.server, table, segment, local)
                logger.warning("corrupt local copy of %s/%s quarantined; downloading", table, segment)
        if seg_obj is None:
            uri = download_uri or f"{self.controller_url}/segments/{table}/{segment}/file"
            try:
                if local is not None:
                    os.makedirs(local, exist_ok=True)
                    seg_obj = DEFAULT_FACTORY.fetch(uri, os.path.join(local, SEGMENT_FILE_NAME), expected_crc=crc)
                    if seg_obj is None:
                        seg_obj = read_segment(local)
                        verify_segment_crc(seg_obj, source=uri)
                else:
                    with tempfile.TemporaryDirectory() as td:
                        seg_obj = DEFAULT_FACTORY.fetch(uri, os.path.join(td, SEGMENT_FILE_NAME), expected_crc=crc)
                        if seg_obj is None:
                            seg_obj = read_segment(td)
                            verify_segment_crc(seg_obj, source=uri)
            except SegmentStaleError:
                logger.warning("the controller's copy of %s/%s is another version", table, segment)
                return False
            except SegmentIntegrityError:
                self.server.record_crc_failure(table, segment)
                logger.exception("downloaded copy of %s/%s failed integrity verification", table, segment)
                try:
                    # the controller's copy is suspect: its scrubber repairs it
                    self._post("/deepstore/suspect", {"table": table, "segment": segment, "source": uri})
                except Exception:
                    logger.warning("could not report the suspect copy of %s/%s", table, segment)
                return False
        self.server.add_segment(table, seg_obj)
        # the table config's invertedIndexColumns: postings built at load
        warm_inverted_indexes(seg_obj, inv_columns)
        self.server.metrics.timer("segmentLoad").update((time.perf_counter() - t0) * 1000)
        if crc is not None:
            self._local_crcs[segment] = crc
        return True
