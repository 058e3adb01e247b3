"""A deployed port cluster on the CPU (a controller over HTTP, two
networked servers and a networked broker in this process) through a
controller restart, a drain and a rebalance, with a query loop running:
no answer may claim to be complete over fewer segments.

- The controller is stopped and a new one started over the same
  ``data_dir`` and port: it claims the next epoch and recovers the table;
  the servers' heartbeats are told to register again, their transitions
  replay from the recovered ideal state (the segments load by CRC skip),
  and the broker's answers are partial, never wrong, until every segment
  is ONLINE again; then they equal the reference executor's.
- server1 is drained (replication 1): the stabilizer moves its segments
  to server0 before their last copy leaves the routing, so every answer
  during the drain is complete and equal to the reference's.
- server1 is undrained and ``POST /tables/<t>/rebalance`` moves segments
  back toward 2 / 2; the old replicas are dropped only once the new ones
  report ONLINE, so every answer during the rebalance is complete too.
Every wait has a deadline.
"""
import json
import os
import threading
import time
import urllib.request

from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.broker.network_starter import NetworkedBrokerStarter
from pinot_tpu_torch.common.tableconfig import TableConfig
from pinot_tpu_torch.controller.controller import Controller, ControllerHttpServer
from pinot_tpu_torch.controller.resource_manager import ONLINE
from pinot_tpu_torch.segment.format import write_segment
from pinot_tpu_torch.server.network_starter import NetworkedServerStarter
from pinot_tpu_torch.tools.datagen import lineitem_schema, synthetic_lineitem_segment

TABLE = "lineitem_OFFLINE"
ROWS, SEGMENTS = 2000, 4
DEADLINE_S = 60.0
Q1 = ("SELECT sum(l_quantity), sum(l_extendedprice), sum(l_discount), count(*) FROM lineitem "
      "WHERE l_shipdate <= '1998-09-02' GROUP BY l_returnflag, l_linestatus TOP 10")
REF_SEGMENTS = [ref_synthetic(ROWS, seed=51 + i, name=f"li{i}") for i in range(SEGMENTS)]
PORT_SEGMENTS = [synthetic_lineitem_segment(ROWS, seed=51 + i, name=f"li{i}") for i in range(SEGMENTS)]


def _post(url, data=b"{}", ctype="application/json"):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _wait(cond, what, deadline_s=DEADLINE_S):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out after {deadline_s} s waiting for {what}")


def _all_online(broker):
    view = broker.handler.routing.view_of(TABLE) or {}
    return len(view) == SEGMENTS and all(r and all(v == ONLINE for v in r.values()) for r in view.values())


class _Loop:
    """q1 sent back to back: each answer complete and equal to the
    reference's, partial, or wrong (complete but different)."""

    def __init__(self, url: str, want) -> None:
        self.url, self.want = url, want
        self.counts = {"complete": 0, "partial": 0, "wrong": 0, "failed": 0}
        self.wrong = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                got = _post(self.url + "/query", json.dumps({"pql": Q1}).encode())
            except Exception as e:  # a broker that does not answer is a failure
                self.counts["failed"] += 1
                self.wrong.append(repr(e))
                continue
            if got.get("partialResponse"):
                self.counts["partial"] += 1
            elif got["exceptions"] or not payloads_equivalent(strip_accounting(got), self.want):
                self.counts["wrong"] += 1
                self.wrong.append(got)
            else:
                self.counts["complete"] += 1

    def __enter__(self) -> "_Loop":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=30)


def test_restart_drain_and_rebalance_keep_every_answer_right(tmp_path):
    tmp = str(tmp_path)
    data_dir = os.path.join(tmp, "controller")
    want = canonical_payload(ref_optimize(ref_parse(Q1)), RefExecutor().execute(REF_SEGMENTS, ref_optimize(ref_parse(Q1))))
    ctrl = Controller(data_dir)
    http = ControllerHttpServer(ctrl)
    http.start()
    port = http.port
    servers, broker, ctrl2, http2 = [], None, None, None
    try:
        servers = [NetworkedServerStarter(http.url, f"server{i}", device="cpu", precision="x64",
                                          data_dir=os.path.join(tmp, f"server{i}")) for i in range(2)]
        for s in servers:
            s.start()
        broker = NetworkedBrokerStarter(http.url, "broker0")
        broker.start()
        _post(http.url + "/schemas", json.dumps(lineitem_schema().to_json()).encode())
        _post(http.url + "/tables", json.dumps(TableConfig("lineitem").to_json()).encode())
        for seg in PORT_SEGMENTS:
            with open(write_segment(seg, os.path.join(tmp, "files", seg.segment_name)), "rb") as f:
                _post(f"{http.url}/segments/{TABLE}", f.read(), "application/octet-stream")
        _wait(lambda: _all_online(broker), "every segment ONLINE")
        ideal = ctrl.resources.get_ideal_state(TABLE)
        epoch = ctrl.epoch

        # (a) the controller restarted over the same data dir and port
        with _Loop(broker.http.url, want) as loop:
            time.sleep(0.3)
            http.stop()
            ctrl.stop()
            ctrl2 = Controller(data_dir)
            http2 = ControllerHttpServer(ctrl2, port=port)
            http2.start()
            assert ctrl2.epoch == epoch + 1
            assert ctrl2.resources.get_ideal_state(TABLE) == ideal
            _wait(lambda: ctrl2.resources.get_external_view(TABLE) == ideal, "the views refilled")
            _wait(lambda: _all_online(broker) and broker._epoch == str(ctrl2.epoch), "the broker on the new epoch")
            time.sleep(0.3)
        assert loop.counts["wrong"] == loop.counts["failed"] == 0, loop.wrong[:2]
        assert loop.counts["complete"] > 0
        assert {s.name: len(s.server.data_manager.table(TABLE).segment_names()) for s in servers} == {
            "server0": 2, "server1": 2}

        # (b) server1 drained: its segments move to server0, the last copy
        # routable until the new one is up
        st = ctrl2.stabilizer
        st.grace_s = 0.0
        with _Loop(broker.http.url, want) as loop:
            time.sleep(0.2)
            out = _post(f"{http2.url}/instances/server1/drain")
            assert out["draining"] and out["remainingSegments"] == 2

            def drained():
                st.run_once()
                return ctrl2.drain_status("server1")["drained"]

            _wait(drained, "server1 drained")
            _wait(lambda: len(servers[1].server.data_manager.table(TABLE).segment_names()) == 0, "server1 unloaded")
            time.sleep(0.3)
        assert loop.counts == {**loop.counts, "partial": 0, "wrong": 0, "failed": 0}, loop.wrong[:2]
        assert all(set(r) == {"server0"} for r in ctrl2.resources.get_ideal_state(TABLE).values())

        # (c) undrained, then rebalanced back toward 2 / 2
        with _Loop(broker.http.url, want) as loop:
            time.sleep(0.2)
            _post(f"{http2.url}/instances/server1/undrain")
            plan = _post(f"{http2.url}/tables/{TABLE}/rebalance")
            assert plan["segmentsMoved"] == 2

            def settled():
                return (ctrl2.resources.get_external_view(TABLE) == ctrl2.resources.get_ideal_state(TABLE)
                        and len(servers[0].server.data_manager.table(TABLE).segment_names()) == 2)

            _wait(settled, "the rebalance settled")
            time.sleep(0.3)
        assert loop.counts == {**loop.counts, "partial": 0, "wrong": 0, "failed": 0}, loop.wrong[:2]
        held = {s.name: len(s.server.data_manager.table(TABLE).segment_names()) for s in servers}
        assert held == {"server0": 2, "server1": 2}
    finally:
        if broker is not None:
            broker.stop()
        for s in servers:
            s.stop()
        for h in (http2, http):
            if h is not None:
                try:
                    h.stop()
                except Exception:
                    pass
        for c in (ctrl2, ctrl):
            if c is not None:
                c.stop()


def _rt_schema():
    from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType, Schema, TimeFieldSpec

    return Schema("netRt", dimensions=[FieldSpec("venue_name", DataType.STRING)],
                  metrics=[FieldSpec("rsvp_count", DataType.INT, FieldType.METRIC)],
                  time_field=TimeFieldSpec("mtime", DataType.LONG, time_unit="MILLISECONDS"))


def test_realtime_commits_through_a_restarted_controller(tmp_path):
    """A REALTIME table on the port's stream broker, two networked servers:
    60 rows a partition consumed, the controller restarted over the same
    data dir and port, then the stream runs on to 250 rows a partition.
    Every commit completes through the restarted controller (two a
    partition, at the checkpointed offsets 100 and 200), and the broker
    counts every produced row exactly once."""
    import numpy as np

    from pinot_tpu_torch.common.tableconfig import StreamConfig
    from pinot_tpu_torch.realtime import llc
    from pinot_tpu_torch.realtime.netstream import NetworkStreamProvider, StreamBrokerServer

    physical, per_segment, first, total = "netRt_REALTIME", 100, 60, 250
    stream = StreamBrokerServer()
    stream.start()
    data_dir = str(tmp_path / "controller")
    ctrl = Controller(data_dir)
    http = ControllerHttpServer(ctrl)
    http.start()
    port = http.port
    servers, broker, ctrl2, http2 = [], None, None, None

    def count(b):
        got = _post(b.http.url + "/query", json.dumps({"pql": "SELECT count(*) FROM netRt"}).encode())
        return -1 if got["exceptions"] or got.get("partialResponse") else got["numDocsScanned"]

    try:
        host, sport = stream.address
        producer = NetworkStreamProvider(host, sport, "netRt")
        producer.create_topic(2)
        servers = [NetworkedServerStarter(http.url, f"server{i}", device="cpu", precision="x64") for i in range(2)]
        for s in servers:
            s.start()
        broker = NetworkedBrokerStarter(http.url, "broker0", port=0)
        broker.start()
        _post(http.url + "/schemas", json.dumps(_rt_schema().to_json()).encode())
        config = TableConfig("netRt", table_type="REALTIME", stream=StreamConfig(
            stream_type="network", topic="netRt", rows_per_segment=per_segment,
            properties={"host": host, "port": sport}))
        _post(http.url + "/tables", json.dumps(config.to_json()).encode())
        rng = np.random.default_rng(9)

        def produce(lo, hi):
            for p in range(2):
                n = hi - lo
                producer.produce_columns({
                    "venue_name": np.array([f"v{int(x)}" for x in rng.integers(0, 5, n)]),
                    "rsvp_count": rng.integers(0, 9, n).astype(np.int64),
                    "mtime": np.arange(lo, hi, dtype=np.int64) + 1_000_000 * (p + 1)}, partition=p)

        produce(0, first)
        _wait(lambda: count(broker) == 2 * first, "the first rows counted")
        epoch = ctrl.epoch
        http.stop()
        ctrl.stop()
        ctrl2 = Controller(data_dir)
        http2 = ControllerHttpServer(ctrl2, port=port)
        http2.start()
        assert ctrl2.epoch == epoch + 1
        produce(first, total)
        _wait(lambda: count(broker) == 2 * total and ctrl2.metrics.meter("segmentCommits").count == 4,
              "every row counted and two commits a partition through the restarted controller")
        for p in range(2):
            for s in range(2):
                meta = ctrl2.resources.get_segment_metadata(physical, llc.make_segment_name(physical, p, s))["metadata"]
                assert (meta.custom["startOffset"], meta.custom["endOffset"]) == (s * per_segment, (s + 1) * per_segment)
        ideal = ctrl2.resources.get_ideal_state(physical)
        assert {seg: set(r.values()) for seg, r in ideal.items()} == {
            **{llc.make_segment_name(physical, p, s): {"ONLINE"} for p in range(2) for s in range(2)},
            **{llc.make_segment_name(physical, p, 2): {"CONSUMING"} for p in range(2)}}
        time.sleep(0.5)
        assert count(broker) == 2 * total
    finally:
        if broker is not None:
            broker.stop()
        for s in servers:
            s.stop()
        for h in (http2, http):
            if h is not None:
                try:
                    h.stop()
                except Exception:
                    pass
        for c in (ctrl2, ctrl):
            if c is not None:
                c.stop()
        stream.stop()
