"""The port's TCP stream broker and its networked realtime path on the CPU,
held against the JAX package.

- Row and columnar produce / fetch against the port's ``StreamBrokerServer``
  (offsets, the durable row log across a restart, the torn-tail recovery,
  the typed mode errors).
- Wire compatibility both ways: a port ``NetworkStreamProvider`` against
  the reference's ``StreamBrokerServer``, and the reference's provider
  against the port's broker, give the same replies.
- A deployed realtime table: a port controller over HTTP, two port
  ``NetworkedServerStarter``s (``device="cpu"``) whose ``RemoteConsumer``s
  ingest a columnar and a row partition with replication 2, run the
  completion protocol over HTTP, commit and roll over, and a port
  ``NetworkedBrokerStarter``: the answers equal the reference executor's
  over the same rows, the committed offsets are exact and the committed
  crcs equal the reference's conversion of the same rows.
- The port's ``NetworkRealtimeQuickstart`` across processes.
Every wait has a deadline, and every thread and socket a test starts is
stopped by it.
"""
import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from pinot_tpu.common.schema import DataType as RefDataType
from pinot_tpu.common.schema import FieldSpec as RefFieldSpec
from pinot_tpu.common.schema import FieldType as RefFieldType
from pinot_tpu.common.schema import Schema as RefSchema
from pinot_tpu.common.schema import TimeFieldSpec as RefTimeFieldSpec
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.realtime.mutable import MutableSegment as RefMutableSegment
from pinot_tpu.realtime.netstream import NetworkStreamProvider as RefProvider
from pinot_tpu.realtime.netstream import StreamBrokerServer as RefStreamBroker
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.broker.network_starter import NetworkedBrokerStarter
from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType, Schema, TimeFieldSpec
from pinot_tpu_torch.common.tableconfig import StreamConfig, TableConfig
from pinot_tpu_torch.controller.controller import Controller, ControllerHttpServer
from pinot_tpu_torch.realtime import llc
from pinot_tpu_torch.realtime.llc import RealtimeSegmentDataManager
from pinot_tpu_torch.realtime.netstream import NetworkStreamProvider, StreamBrokerServer, _Topic
from pinot_tpu_torch.realtime.pool import leaked_pool_threads
from pinot_tpu_torch.realtime.stream import describe_stream, stream_from_descriptor
from pinot_tpu_torch.server.network_starter import NetworkedServerStarter
from pinot_tpu_torch.server.scheduler import leaked_scheduler_threads

REPO = Path(__file__).resolve().parents[1]
REL, ABS = 5e-4, 1e-3
DEADLINE_S = 60.0
TABLE = "netRt"
PHYSICAL = "netRt_REALTIME"


@pytest.fixture(autouse=True)
def _nothing_leaks():
    yield
    assert not leaked_pool_threads(grace_s=2.0)
    assert not leaked_scheduler_threads(grace_s=4.0)


def _wait(cond, what, deadline_s=DEADLINE_S):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out after {deadline_s} s waiting for {what}")


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------- the broker
def test_stream_broker_roundtrip(tmp_path):
    broker = StreamBrokerServer(log_dir=str(tmp_path / "log"))
    broker.start()
    try:
        p = NetworkStreamProvider(*broker.address, "events")
        p.create_topic(2)
        assert p.partition_count() == 2
        for i in range(10):
            p.produce({"i": i}, partition=i % 2)
        assert p.latest_offset(0) == 5
        rows, nxt = p.fetch(0, 2, 100)
        assert nxt == 5 and [r["i"] for r in rows] == [4, 6, 8]
        assert p.produce_batch([{"i": 10}, {"i": 12}], partition=0) == 5
        p2 = stream_from_descriptor(describe_stream(p))
        assert p2.latest_offset(0) == 7 and p2.latest_offset(1) == 5
    finally:
        broker.stop()
    # a restart over the same log dir keeps the offsets
    broker2 = StreamBrokerServer(log_dir=str(tmp_path / "log"))
    broker2.start()
    try:
        p3 = NetworkStreamProvider(*broker2.address, "events")
        assert p3.latest_offset(0) == 7
        rows, _ = p3.fetch(1, 0, 100)
        assert [r["i"] for r in rows] == [1, 3, 5, 7, 9]
    finally:
        broker2.stop()


def test_partition_log_torn_tail_recovery(tmp_path):
    log = tmp_path / "p0.jsonl"
    log.write_text('{"i": 1}\n{"i": 2}\n{"i": 3, "x"')
    t = _Topic(1, [str(log)])
    assert [json.loads(b)["i"] for b in t.raw[0]] == [1, 2]
    t.append(0, [{"i": 4}])
    t.close()
    t2 = _Topic(1, [str(log)])  # the torn line was cut before the append
    assert [json.loads(b)["i"] for b in t2.raw[0]] == [1, 2, 4]
    t2.close()
    bad = tmp_path / "p1.jsonl"
    bad.write_text('{"i": 1}\nnot-json\n{"i": 2}\n')
    with pytest.raises(json.JSONDecodeError):
        _Topic(1, [str(bad)])


def test_columnar_produce_fetch_roundtrip():
    srv = StreamBrokerServer()
    srv.start()
    try:
        srv.create_topic("colt", 2)
        prov = NetworkStreamProvider(*srv.address, "colt")
        cols = {"a": np.arange(100, dtype=np.int64), "b": np.linspace(0, 1, 100),
                "s": np.array([f"v{i % 7}" for i in range(100)])}
        assert prov.produce_columns(cols, partition=0) == 0
        assert prov.produce_columns(cols, partition=0) == 100
        got, n, nxt = prov.fetch_columns(0, 0)
        assert (n, nxt) == (100, 100) and all(np.array_equal(got[c], cols[c]) for c in cols)
        got, n, nxt = prov.fetch_columns(0, 130)  # a resume mid-block is trimmed
        assert (n, nxt) == (70, 200) and np.array_equal(got["a"], cols["a"][30:])
        _, n, nxt = prov.fetch_columns(0, 200)  # the end of the log
        assert (n, nxt) == (0, 200) and prov.latest_offset(0) == 200
        with pytest.raises(RuntimeError, match="columnar"):
            prov.fetch(0, 0, 10)
        with pytest.raises(RuntimeError, match="columnar-mode"):
            prov.produce({"a": 1, "b": 2.0}, partition=0)
        prov.produce({"a": 1, "b": 2.0}, partition=1)
        with pytest.raises(RuntimeError, match="row-mode"):
            prov.produce_columns(cols, partition=1)
        with pytest.raises(RuntimeError, match="row-mode"):
            prov.fetch_columns(1, 0)
    finally:
        srv.stop()


def _exchange(provider):
    """One client's view of a broker: a row partition, a columnar one."""
    provider.create_topic(2)
    out = [provider.partition_count()]
    out.append(provider.produce_batch([{"i": i, "s": f"r{i}"} for i in range(5)], partition=0))
    out.append(provider.produce({"i": 5, "s": "r5"}, partition=0))
    out.append(provider.fetch(0, 1, 3))
    cols = {"a": np.arange(40, dtype=np.int64), "f": np.linspace(0.0, 3.0, 40, dtype=np.float32),
            "s": np.array([f"c{i % 3}" for i in range(40)])}
    out.append(provider.produce_columns(cols, partition=1))
    out.append(provider.produce_columns({k: v[:10] for k, v in cols.items()}, partition=1))
    got, n, nxt = provider.fetch_columns(1, 45)
    out.append(({k: v.tolist() for k, v in got.items()}, n, nxt))
    out.append([provider.latest_offset(p) for p in range(2)])
    return out


@pytest.mark.parametrize("direction", ["port_client_reference_broker", "reference_client_port_broker"])
def test_wire_compatibility(direction):
    broker = (RefStreamBroker if direction.startswith("port") else StreamBrokerServer)()
    mirror = (StreamBrokerServer if direction.startswith("port") else RefStreamBroker)()
    broker.start()
    mirror.start()
    try:
        client = (NetworkStreamProvider if direction.startswith("port") else RefProvider)(*broker.address, "wire")
        same_pkg = (RefProvider if direction.startswith("port") else NetworkStreamProvider)(*mirror.address, "wire")
        got, want = _exchange(client), _exchange(same_pkg)
        assert got == want
        assert got[-1] == [6, 50]
    finally:
        broker.stop()
        mirror.stop()


def test_llc_consumer_takes_columnar_path_over_tcp():
    schema = Schema("ct", dimensions=[FieldSpec("d", DataType.LONG, FieldType.DIMENSION)],
                    metrics=[FieldSpec("m", DataType.INT, FieldType.METRIC)],
                    time_field=TimeFieldSpec("t", DataType.LONG, time_unit="MILLISECONDS"))
    srv = StreamBrokerServer()
    srv.start()
    try:
        srv.create_topic("colllc", 1)
        prov = NetworkStreamProvider(*srv.address, "colllc")
        rng = np.random.default_rng(6)
        n = 900
        cols = {"d": rng.integers(0, 50, n), "m": rng.integers(0, 9, n), "t": 1_700_000_000_000 + np.arange(n)}
        for i in range(0, n, 300):
            prov.produce_columns({c: a[i:i + 300] for c, a in cols.items()})
        dm = RealtimeSegmentDataManager(None, None, "ct", "ct__0__0", schema, prov, 0, 0, 1000)
        assert dm.consume_step(max_rows=250) == 250  # a mid-block cap
        assert dm._columnar is True and dm.offset == 250
        while dm.consume_step(max_rows=400):
            pass
        assert dm.mutable.num_docs == n and dm.offset == n
        snap = dm.mutable.snapshot()
        gd = snap.column("d").dictionary.value_array()[snap.column("d").fwd]
        gm = snap.column("m").dictionary.value_array()[snap.column("m").fwd]
        assert sorted(zip(gd.tolist(), gm.tolist())) == sorted(zip(cols["d"].tolist(), cols["m"].tolist()))
    finally:
        srv.stop()


# ---------------------------------------------------------------- deployed
def _schema(port=True):
    D, F, T, S, TF = (DataType, FieldSpec, FieldType, Schema, TimeFieldSpec) if port else (
        RefDataType, RefFieldSpec, RefFieldType, RefSchema, RefTimeFieldSpec)
    return S(TABLE, dimensions=[F("venue_name", D.STRING), F("event_name", D.STRING)],
             metrics=[F("rsvp_count", D.INT, T.METRIC)], time_field=TF("mtime", D.LONG, time_unit="MILLISECONDS"))


def _rows(n, seed, t0):
    rng = np.random.default_rng(seed)
    return [{"venue_name": f"venue{int(v)}", "event_name": f"event{int(e)}", "rsvp_count": int(c), "mtime": t0 + i}
            for i, (v, e, c) in enumerate(zip(rng.integers(0, 9, n), rng.integers(0, 4, n), rng.integers(0, 9, n)))]


DEPLOYED_QUERIES = (
    "SELECT count(*) FROM netRt",
    "SELECT sum(rsvp_count) FROM netRt GROUP BY venue_name",
    "SELECT distinctcount(event_name) FROM netRt GROUP BY venue_name",
    "SELECT max(mtime), min(rsvp_count) FROM netRt WHERE event_name = 'event2'",
)


def test_deployed_realtime_table_commits_and_rolls_over(tmp_path):
    """Replication 2 over two server processes' worth of starters: each
    partition's two replicas run the completion protocol over HTTP (the
    committer uploads, the other keeps or catches up), each committed
    segment turns ONLINE on both and the next sequence opens at its end
    offset."""
    per_segment, total = 100, 250
    stream = StreamBrokerServer()
    stream.start()
    ctrl = Controller(str(tmp_path / "controller"))
    http = ControllerHttpServer(ctrl)
    http.start()
    servers, broker = [], None
    try:
        host, port = stream.address
        producer = NetworkStreamProvider(host, port, TABLE)
        producer.create_topic(2)
        servers = [NetworkedServerStarter(http.url, f"server{i}", device="cpu", precision="x64") for i in range(2)]
        for s in servers:
            s.start()
        broker = NetworkedBrokerStarter(http.url, "broker0", port=0)
        broker.start()
        _post(http.url + "/schemas", _schema().to_json())
        config = TableConfig(TABLE, table_type="REALTIME", replication=2, stream=StreamConfig(
            stream_type="network", topic=TABLE, rows_per_segment=per_segment, properties={"host": host, "port": port}))
        assert _post(http.url + "/tables", config.to_json()) == {"status": "ok", "table": PHYSICAL}
        # partition 0 columnar blocks, partition 1 JSON rows
        rows = {0: _rows(total, 1, 1_000_000), 1: _rows(total, 2, 2_000_000)}
        for lo in range(0, total, 50):
            block = rows[0][lo:lo + 50]
            producer.produce_columns({
                "venue_name": np.array([r["venue_name"] for r in block]),
                "event_name": np.array([r["event_name"] for r in block]),
                "rsvp_count": np.array([r["rsvp_count"] for r in block], dtype=np.int64),
                "mtime": np.array([r["mtime"] for r in block], dtype=np.int64)}, partition=0)
        producer.produce_batch(rows[1], partition=1)

        def settled():
            view = ctrl.resources.get_external_view(PHYSICAL)
            want = {llc.make_segment_name(PHYSICAL, p, s): "ONLINE" for p in range(2) for s in range(2)}
            want.update({llc.make_segment_name(PHYSICAL, p, 2): "CONSUMING" for p in range(2)})
            if set(view) != set(want) or any(set(view[k].values()) != {v} or len(view[k]) != 2
                                             for k, v in want.items()):
                return None
            resp = _post(f"http://127.0.0.1:{broker.http.port}/query", {"pql": DEPLOYED_QUERIES[0]})
            return resp if resp.get("numDocsScanned") == 2 * total and not resp["exceptions"] else None

        _wait(settled, "two commits a partition and every row visible")
        ref_rows = rows[0] + rows[1]
        ref_seg = ref_build_segment(_schema(False), ref_rows, PHYSICAL, "all")
        for pql in DEPLOYED_QUERIES:
            got = _post(f"http://127.0.0.1:{broker.http.port}/query", {"pql": pql})
            assert not got["exceptions"], got
            req = ref_optimize(ref_parse(pql))
            want = canonical_payload(req, RefExecutor().execute([ref_seg], req))
            assert payloads_equivalent(strip_accounting(got), want, rel_tol=REL, abs_tol=ABS), (pql, got, want)
        # exact offsets, and the committed crcs of the reference's conversion
        for p in range(2):
            for s in range(2):
                seg = llc.make_segment_name(PHYSICAL, p, s)
                meta = ctrl.resources.get_segment_metadata(PHYSICAL, seg)["metadata"]
                assert (meta.custom["startOffset"], meta.custom["endOffset"]) == (s * per_segment,
                                                                                  (s + 1) * per_segment)
                ref = RefMutableSegment(_schema(False), seg, PHYSICAL)
                ref.index_batch(rows[p][s * per_segment:(s + 1) * per_segment])
                assert meta.crc == ref.to_committed_segment().metadata.crc, seg
        committed = ctrl.metrics.meter("segmentCommits").count
        assert committed == 4
        for s in servers:
            st = s.server.status()
            assert st["ingest"]["paused"] is False
            assert st["metrics"]["meters"]["ingest.rowsConsumed"]["count"] >= total
    finally:
        if broker is not None:
            broker.stop()
        for s in servers:
            s.stop()
        http.stop()
        stream.stop()


def test_network_realtime_quickstart_across_processes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "pinot_tpu_torch.tools.admin", "NetworkRealtimeQuickstart", "-device", "cpu",
         "-events", "1200"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    assert "DONE networked realtime quickstart: 1200 events ingested" in out.stdout
