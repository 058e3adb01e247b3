"""Networked server starter: a server process joining a remote controller
(port of ``pinot_tpu.server.network_starter``, trimmed to offline
segments).

- ``start`` initializes the device on the main thread and builds and
  loads both kernels (``ServerInstance`` does, on the card) BEFORE the
  server registers, so it never reports ONLINE before it can launch;
- it registers over HTTP (the participant join) and heartbeats for
  liveness, renewing its serving lease on each reply;
- it polls transition messages, runs them (download the segment file
  from the controller with a CRC check and load it, or drop it) and acks
  the resulting state;
- it serves broker queries on a length-framed TCP socket, and
  ``/health``, ``/metrics`` and ``/debug/metrics`` on its admin HTTP port.

The heartbeat and message loops back off with full jitter while the
controller is unreachable and keep serving from local state.  Left out,
ROADMAP queue 1 item 29: the realtime consumers (``RemoteConsumer``,
``HLRemoteConsumer``), the ingest pool and prewarm; a CONSUMING message
fails its transition.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Union
from urllib.parse import parse_qs, urlparse

import torch

from pinot_tpu_torch.common.fencing import ServingLease
from pinot_tpu_torch.controller.resource_manager import DROPPED, OFFLINE, ONLINE
from pinot_tpu_torch.segment.fetcher import DEFAULT_FACTORY
from pinot_tpu_torch.segment.invindex import warm_inverted_indexes
from pinot_tpu_torch.segment.format import (
    SEGMENT_FILE_NAME,
    SegmentIntegrityError,
    SegmentStaleError,
    read_segment,
    verify_segment_crc,
)
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.server.starter import quarantine_local_copy
from pinot_tpu_torch.transport.tcp import TcpServer
from pinot_tpu_torch.utils.retry import FullJitterBackoff, tighten_liveness_budget

logger = logging.getLogger(__name__)

CONSUMING_ITEM = "CONSUMING segments are item 29 of the port (ROADMAP queue 1)"


class ServerAdminHttpServer:
    """The server's scrape and ops surface: ``/health``, Prometheus text at
    ``/metrics``, the status and metrics JSON at ``/debug/metrics``, and
    ``/debug/samples?timer=<name>&last=<n>``, the last n samples of one
    timer (per-query phase medians for a client that sends one query shape
    at a time).  The query data plane stays on the TCP socket."""

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
    ) -> None:
        self.controller_url = controller_url.rstrip("/")
        self.name = name
        self.server = ServerInstance(name, device=device, precision=precision)
        self.tcp = TcpServer(self.server.handle_request, host=host, port=port)
        self.admin = ServerAdminHttpServer(self.server, host=host, port=admin_port)
        self.data_dir = data_dir
        self.heartbeat_interval_s = heartbeat_interval_s
        self.poll_interval_s = poll_interval_s
        self.lease = ServingLease(metrics=self.server.metrics)
        # the heartbeat backoff stays under the controller's liveness
        # window (tightened from the register reply), so an asymmetric
        # partition cannot flap a live server dead
        self._hb_backoff = FullJitterBackoff(initial_s=max(0.1, heartbeat_interval_s), cap_s=2.0)
        self._hb_timeout_s = 10.0
        self._msg_backoff = FullJitterBackoff(initial_s=max(0.1, poll_interval_s), cap_s=10.0)
        self._local_crcs: Dict[str, int] = {}
        self._stop = threading.Event()
        # a heartbeat that succeeds while the message poll is deep in
        # backoff wakes the poll (queued transitions land at once)
        self._msg_wake = threading.Event()
        self._threads: list = []

    # -- HTTP helpers --------------------------------------------------
    def _post(self, path: str, payload: Dict[str, Any], timeout_s: float = 10.0) -> Dict[str, Any]:
        req = urllib.request.Request(
            self.controller_url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            return json.loads(r.read())

    def _get(self, path: str) -> Dict[str, Any]:
        with urllib.request.urlopen(self.controller_url + path, timeout=10) as r:
            return json.loads(r.read())

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
        self.lease.renew(out.get("lease"))
        timeout = out.get("heartbeatTimeoutSeconds")
        if timeout:
            self._hb_timeout_s = tighten_liveness_budget(self._hb_backoff, float(timeout), self._hb_timeout_s)
        for fn in (self._heartbeat_loop, self._message_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self._msg_wake.set()
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
                out = self._post(f"/instances/{self.name}/heartbeat", {"warming": False},
                                 timeout_s=self._hb_timeout_s)
                self.lease.renew(out.get("lease"))
                if out.get("reregister"):
                    reg = self._post("/instances", self._register_payload(), timeout_s=self._hb_timeout_s)
                    self.lease.renew(reg.get("lease"))
                if self._hb_backoff.failures:
                    self._msg_backoff.reset()
                    self._msg_wake.set()
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
    def _handle(self, msg: Dict[str, Any]) -> None:
        table, segment, target = msg["table"], msg["segment"], msg["target"]
        try:
            if target == ONLINE:
                ok = self._load(table, segment, msg.get("crc"), msg.get("downloadUri"),
                                msg.get("invertedIndexColumns"))
            elif target in (OFFLINE, DROPPED):
                self.server.remove_segment(table, segment)
                self._local_crcs.pop(segment, None)
                ok = True
            else:
                logger.error("transition %s/%s -> %s: %s", table, segment, target, CONSUMING_ITEM)
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

    def _load(self, table: str, segment: str, crc: Optional[int], download_uri: Optional[str] = None,
              inv_columns=None) -> bool:
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
                return False
        self.server.add_segment(table, seg_obj)
        # the table config's invertedIndexColumns: postings built at load
        warm_inverted_indexes(seg_obj, inv_columns)
        self.server.metrics.timer("segmentLoad").update((time.perf_counter() - t0) * 1000)
        if crc is not None:
            self._local_crcs[segment] = crc
        return True
