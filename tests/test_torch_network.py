"""The port as a deployed cluster on the CPU: a port controller, networked
servers and a networked broker over HTTP and TCP, held against the JAX
package.

- A port controller, two port ``NetworkedServerStarter``s and a port
  ``NetworkedBrokerStarter`` in this process (``device="cpu"``, x64)
  answer the lineitem queries as the reference executor does over the
  same segments (uploaded as segment files), compared with the audit
  comparison at rel 1e-9 / abs 2e-5.
- One port server runs as a subprocess through ``python -m
  pinot_tpu_torch.tools.admin StartServer -device cpu``, with deadlines
  and a SIGTERM in a ``finally``.
- The port's ideal state for the same registrations and uploads equals
  the reference ``Controller``'s.
- A port server serves behind the reference ``Controller``: the
  control-plane JSON is the reference's.
- A segment whose stored copy fails its CRC is not served.
- A join over the networked cluster, its tables' partitioning given
  through ``AddTable``, colocates and equals the reference executor.
Every wait has a deadline.
"""
import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from pinot_tpu.common.tableconfig import TableConfig as RefTableConfig
from pinot_tpu.controller.controller import Controller as RefController
from pinot_tpu.controller.controller import ControllerHttpServer as RefControllerHttpServer
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import lineitem_schema as ref_lineitem_schema
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.broker.network_starter import NetworkedBrokerStarter
from pinot_tpu_torch.common.tableconfig import TableConfig
from pinot_tpu_torch.controller.controller import Controller, ControllerHttpServer
from pinot_tpu_torch.controller.resource_manager import ERROR, ONLINE
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.segment.format import write_segment
from pinot_tpu_torch.server.network_starter import NetworkedServerStarter
from pinot_tpu_torch.tools.datagen import lineitem_schema, synthetic_lineitem_segment

REPO = Path(__file__).resolve().parents[1]
REL, ABS = 1e-9, 2e-5
TABLE = "lineitem_OFFLINE"
ROWS, SEGMENTS = 3000, 4
DEADLINE_S = 60.0

QUERIES = {
    "q1": "SELECT sum(l_quantity), sum(l_extendedprice), sum(l_discount), count(*) FROM lineitem "
    "WHERE l_shipdate <= '1998-09-02' GROUP BY l_returnflag, l_linestatus TOP 10",
    "q3": "SELECT sum(l_extendedprice), sum(l_quantity) FROM lineitem WHERE l_returnflag = 'R' "
    "GROUP BY l_shipmode TOP 10",
    "hll_groupby": "SELECT distinctcounthll(l_extendedprice) FROM lineitem WHERE l_quantity > 25 "
    "GROUP BY l_returnflag TOP 10",
    "distinct_price": "SELECT distinctcount(l_extendedprice) FROM lineitem WHERE l_shipdate > '1995-01-01'",
    "sel_top": "SELECT l_orderkey, l_extendedprice FROM lineitem WHERE l_quantity > 45 "
    "ORDER BY l_extendedprice DESC LIMIT 10",
    "pairs_distinct": "SELECT distinctcount(l_extendedprice) FROM lineitem WHERE l_quantity < 3 "
    "GROUP BY l_shipdate TOP 10",
    "zone_in": "SELECT sum(l_quantity), count(*) FROM lineitem "
    "WHERE l_shipdate IN ('1993-03-14','1995-06-14','1997-09-14') GROUP BY l_returnflag, l_linestatus TOP 10",
}

REF_SEGMENTS = [ref_synthetic(ROWS, seed=31 + i, name=f"li{i}") for i in range(SEGMENTS)]
PORT_SEGMENTS = [synthetic_lineitem_segment(ROWS, seed=31 + i, name=f"li{i}") for i in range(SEGMENTS)]


def _post(url, data, ctype="application/json"):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _wait(cond, what, deadline_s=DEADLINE_S):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out after {deadline_s} s waiting for {what}")


def _all_online(view, n):
    return len(view) == n and all(r and all(v == ONLINE for v in r.values()) for r in view.values())


def _segment_bytes(seg, tmp):
    with open(write_segment(seg, os.path.join(tmp, seg.segment_name)), "rb") as f:
        return f.read()


def _setup_table(url):
    _post(url + "/schemas", json.dumps(lineitem_schema().to_json()).encode())
    _post(url + "/tables", json.dumps(TableConfig("lineitem").to_json()).encode())


def _upload(url, segments, tmp):
    return [_post(f"{url}/segments/{TABLE}", _segment_bytes(s, tmp), "application/octet-stream")
            for s in segments]


def _reference_answer(pql):
    req = ref_optimize(ref_parse(pql))
    return canonical_payload(req, RefExecutor().execute(REF_SEGMENTS, req))


def _broker_answer(broker, pql):
    got = _post(broker.http.url + "/query", json.dumps({"pql": pql}).encode())
    assert not got["exceptions"], got["exceptions"]
    return strip_accounting(got)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cluster"))
    ctrl = Controller(os.path.join(tmp, "controller"))
    http = ControllerHttpServer(ctrl)
    http.start()
    servers, broker = [], None
    try:
        servers = [NetworkedServerStarter(http.url, f"server{i}", device="cpu", precision="x64",
                                          data_dir=os.path.join(tmp, f"server{i}")) for i in range(2)]
        for s in servers:
            s.start()
        broker = NetworkedBrokerStarter(http.url, "broker0")
        broker.start()
        _setup_table(http.url)
        _upload(http.url, PORT_SEGMENTS, tmp)
        _wait(lambda: _all_online(broker.handler.routing.view_of(TABLE) or {}, SEGMENTS), "all ONLINE")
        yield ctrl, http, servers, broker
    finally:
        if broker is not None:
            broker.stop()
        for s in servers:
            s.stop()
        http.stop()


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_cluster_answers_equal_the_reference(cluster, name):
    _, _, _, broker = cluster
    got = _broker_answer(broker, QUERIES[name])
    want = _reference_answer(QUERIES[name])
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (name, got, want)


def test_segments_spread_over_both_servers_and_report_load_times(cluster):
    ctrl, http, servers, _ = cluster
    ideal = ctrl.resources.get_ideal_state(TABLE)
    assert sorted(ideal) == [s.segment_name for s in PORT_SEGMENTS]
    held = {s.name: len(s.server.data_manager.table(TABLE).segment_names()) for s in servers}
    assert held == {"server0": SEGMENTS // 2, "server1": SEGMENTS // 2}
    for s in servers:
        status = _get(s.admin.url + "/debug/metrics")
        assert status["metrics"]["timers"]["segmentLoad"]["count"] == SEGMENTS // 2
        samples = _get(s.admin.url + "/debug/samples?timer=segmentLoad&last=1")["samples"]
        assert len(samples) == 1 and samples[0] > 0
    state = _get(http.url + "/clusterstate")
    assert sorted(state["servers"]) == ["server0", "server1"] and not state["deadServers"]
    assert _get(http.url + f"/clusterstate?ifNewer={state['version']}&epoch={state['epoch']}")["unchanged"]


def _start_process(args, tmp, name):
    log = open(os.path.join(tmp, f"{name}.log"), "w+")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-m", "pinot_tpu_torch.tools.admin", *args],
                            cwd=str(REPO), env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
    return proc, log


def _ready_line(proc, log, role, deadline_s=120.0):
    def ready():
        if proc.poll() is not None:
            log.seek(0)
            raise AssertionError(f"{role} exited with {proc.returncode}:\n{log.read()[-4000:]}")
        log.seek(0)
        return next((ln for ln in log.read().splitlines() if ln.startswith(f"READY {role}")), None)
    return _wait(ready, f"READY {role}", deadline_s)


def _stop_process(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            return proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    return proc.returncode


def test_a_server_in_its_own_process_serves_the_cluster(tmp_path):
    tmp = str(tmp_path)
    ctrl = Controller(os.path.join(tmp, "controller"))
    http = ControllerHttpServer(ctrl)
    http.start()
    proc = broker = None
    try:
        proc, log = _start_process(["StartServer", "-controller", http.url, "-name", "proc0",
                                    "-device", "cpu", "-precision", "x64"], tmp, "server")
        line = _ready_line(proc, log, "server")
        assert "admin http://" in line
        broker = NetworkedBrokerStarter(http.url, "broker0")
        broker.start()
        _setup_table(http.url)
        replies = _upload(http.url, PORT_SEGMENTS, tmp)
        assert all(r["servers"] == ["proc0"] for r in replies)
        _wait(lambda: _all_online(broker.handler.routing.view_of(TABLE) or {}, SEGMENTS), "all ONLINE")
        got = _broker_answer(broker, QUERIES["q1"])
        assert payloads_equivalent(got, _reference_answer(QUERIES["q1"]), rel_tol=REL, abs_tol=ABS)
    finally:
        if broker is not None:
            broker.stop()
        rc = _stop_process(proc) if proc is not None else 0
        http.stop()
    assert rc == 0  # SIGTERM stops the server's threads and exits cleanly


def _register_all(register):
    for i in (2, 0, 1):
        register({"name": f"server{i}", "role": "server", "addr": ["127.0.0.1", 9000 + i]})
    register({"name": "broker0", "role": "broker", "url": "http://127.0.0.1:8099"})


def test_ideal_state_equals_the_reference_controller(tmp_path):
    ref = RefController(str(tmp_path / "ref"))
    port = Controller(str(tmp_path / "port"))
    try:
        _register_all(ref.gateway.register)
        _register_all(port.gateway.register)
        ref.add_schema(ref_lineitem_schema())
        port.add_schema(lineitem_schema())
        ref.add_table(RefTableConfig("lineitem", replication=2))
        port.add_table(TableConfig("lineitem", replication=2))
        for i in range(7):
            data = _segment_bytes(synthetic_lineitem_segment(500, seed=i, name=f"seg{i}"), str(tmp_path))
            assert ref.upload_segment_bytes(TABLE, data) == port.upload_segment_bytes(TABLE, data)
        assert port.resources.get_ideal_state(TABLE) == ref.resources.get_ideal_state(TABLE)
        # the same transition messages are queued for each server
        for i in range(3):
            strip = lambda ms: [{k: v for k, v in m.items() if k != "schemaJson"} for m in ms]  # noqa: E731
            assert strip(port.gateway.messages(f"server{i}")) == strip(ref.gateway.messages(f"server{i}"))
    finally:
        ref.stop()


def test_a_port_server_serves_behind_the_reference_controller(tmp_path):
    ref = RefController(str(tmp_path / "ref"))
    http = RefControllerHttpServer(ref)
    http.start()
    server = broker = None
    url = f"http://127.0.0.1:{http.port}"
    try:
        server = NetworkedServerStarter(url, "port0", device="cpu", precision="x64")
        server.start()
        broker = NetworkedBrokerStarter(url, "broker0")
        broker.start()
        _post(url + "/schemas", json.dumps(ref_lineitem_schema().to_json()).encode())
        _post(url + "/tables", json.dumps(RefTableConfig("lineitem").to_json()).encode())
        for seg in REF_SEGMENTS:
            ref.upload_segment(TABLE, seg)
        _wait(lambda: _all_online(ref.resources.get_external_view(TABLE), SEGMENTS), "reference view ONLINE")
        _wait(lambda: _all_online(broker.handler.routing.view_of(TABLE) or {}, SEGMENTS), "broker routing")
        for name in ("q1", "distinct_price", "sel_top"):
            got = _broker_answer(broker, QUERIES[name])
            assert payloads_equivalent(got, _reference_answer(QUERIES[name]), rel_tol=REL, abs_tol=ABS), name
        assert server.lease.snapshot()["granted"]  # the reference's lease JSON renews the port's lease
    finally:
        if broker is not None:
            broker.stop()
        if server is not None:
            server.stop()
        http.stop()
        ref.stop()


def test_a_segment_whose_stored_copy_fails_its_crc_is_not_served(tmp_path):
    schema = make_test_schema(with_mv=False)
    ref_seg = ref_build_segment(schema, random_rows(schema, 400, seed=3), "testTable", "bad0")
    seg = segment_from_arrays(**segment_arrays_of(ref_seg))
    assert seg.metadata.custom.get("dataCrc")
    data = bytearray(_segment_bytes(seg, str(tmp_path)))
    hlen = int.from_bytes(data[8:16], "little")
    entry = json.loads(data[16 : 16 + hlen])["indexMap"]["dimInt.fwd"]
    data[16 + hlen + entry["offset"] + entry["length"] // 2] ^= 0x5A  # rot one byte of the column

    ctrl = Controller(str(tmp_path / "controller"))
    http = ControllerHttpServer(ctrl)
    http.start()
    server = None
    try:
        server = NetworkedServerStarter(http.url, "server0", device="cpu", precision="x64",
                                        data_dir=str(tmp_path / "server0"))
        server.start()
        _post(http.url + "/schemas", json.dumps(schema.to_json()).encode())
        _post(http.url + "/tables", json.dumps({"tableName": "testTable"}).encode())
        _post(http.url + "/segments/testTable_OFFLINE", bytes(data), "application/octet-stream")
        view = _wait(lambda: (v := ctrl.resources.get_external_view("testTable_OFFLINE")).get("bad0", {})
                     .get("server0") == ERROR and v, "the ERROR state")
        assert view == {"bad0": {"server0": ERROR}}
        tdm = server.server.data_manager.table("testTable_OFFLINE")
        assert tdm is None or "bad0" not in tdm.segment_names()
        assert server.server.metrics.meter("crcFailures").count == 1
        assert not os.path.exists(tmp_path / "server0" / "testTable_OFFLINE" / "bad0" / "columns.pnt")
    finally:
        if server is not None:
            server.stop()
        http.stop()


def test_in_process_starter_heals_a_corrupt_local_copy_and_drops_on_delete(tmp_path):
    """``ServerStarter`` (the in-process participant): an upload loads the
    segment through the server's local copy; a local copy that rots is
    quarantined (moved aside) and fetched again from the controller's
    store on the next ONLINE transition; a deleted segment is dropped."""
    from pinot_tpu_torch.server.instance import ServerInstance
    from pinot_tpu_torch.server.starter import ServerStarter

    schema = make_test_schema(with_mv=False)
    seg = segment_from_arrays(**segment_arrays_of(
        ref_build_segment(schema, random_rows(schema, 400, seed=4), "testTable", "good0")))
    ctrl = Controller(str(tmp_path / "controller"))
    server = ServerInstance("local0", device="cpu", precision="x64")
    try:
        starter = ServerStarter(server, ctrl.resources, data_dir=str(tmp_path / "local0"))
        starter.start()
        ctrl.add_schema(schema)
        ctrl.add_table(TableConfig("testTable"))
        assert ctrl.upload_segment("testTable_OFFLINE", seg) == ["local0"]
        table = server.data_manager.table("testTable_OFFLINE")
        assert table.segment_names() == ["good0"]
        assert ctrl.resources.get_external_view("testTable_OFFLINE") == {"good0": {"local0": ONLINE}}

        local = tmp_path / "local0" / "testTable_OFFLINE" / "good0"
        data = bytearray((local / "columns.pnt").read_bytes())
        hlen = int.from_bytes(data[8:16], "little")
        entry = json.loads(data[16 : 16 + hlen])["indexMap"]["dimInt.fwd"]
        data[16 + hlen + entry["offset"] + entry["length"] // 2] ^= 0x5A
        (local / "columns.pnt").write_bytes(bytes(data))
        server.remove_segment("testTable_OFFLINE", "good0")
        starter._local_crcs.clear()
        ctrl.resources.reconcile_instance("local0")  # replays ONLINE: load, verify, quarantine, re-fetch
        assert table.segment_names() == ["good0"]
        assert server.metrics.meter("crcFailures").count == 1
        assert server.metrics.meter("quarantinedSegments").count == 1
        assert [p.name.split(".")[1] for p in local.parent.iterdir() if p.name != "good0"] == ["quarantined"]
        assert (local / "columns.pnt").read_bytes() == (
            tmp_path / "controller" / "segments" / "testTable_OFFLINE" / "good0" / "columns.pnt").read_bytes()

        ctrl.delete_segment("testTable_OFFLINE", "good0")
        assert table.segment_names() == []
        assert not ctrl.store.exists("testTable_OFFLINE", "good0")
    finally:
        server.shutdown()


def test_a_join_over_the_networked_cluster_colocates(cluster, tmp_path):
    """factT / dimT of tests/test_join.py, partitioned on ``k`` through the
    ``partitioning`` block of the configs ``AddTable`` posts (dimT on both
    servers): the networked broker learns the partitioning from the
    cluster state, colocates the join over HTTP, and answers as the
    reference executor does over the same segments."""
    from pinot_tpu.engine import join as rjm
    from pinot_tpu_torch.common.tableconfig import PartitionConfig
    from pinot_tpu_torch.tools import admin
    from test_torch_join_cluster import FACT, DIM, NPART, _dim_schema, _fact_schema, _segments

    _, http, _, broker = cluster
    tables = _segments(FACT, DIM, prefix="net")
    for name, replication in (("netfactT", 1), ("netdimT", 2)):
        schema = (_fact_schema if "fact" in name else _dim_schema)(name)
        _post(http.url + "/schemas", json.dumps(schema.to_json()).encode())
        config = TableConfig(name, replication=replication, partitioning=PartitionConfig("k", NPART))
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(config.to_json()))
        admin.main(["AddTable", "-controller", http.url, "-config-file", str(path)])
    for table, segs in tables.items():
        for s in segs:
            _post(f"{http.url}/segments/{table}",
                  _segment_bytes(segment_from_arrays(**segment_arrays_of(s)), str(tmp_path)),
                  "application/octet-stream")
        _wait(lambda: _all_online(broker.handler.routing.view_of(table) or {}, NPART), f"{table} ONLINE")
    _wait(lambda: broker.handler.joinplan.partitions.get("netdimT_OFFLINE") == ("k", NPART),
          "the broker's partitioning")
    pql = ("SELECT sum(f.v), count(*), max(d.w) FROM netfactT f JOIN netdimT d ON f.k = d.k "
           "WHERE d.cat <> 'c4' GROUP BY d.cat TOP 10")
    colocated = broker.handler.metrics.meter("join.strategy.colocated").count
    got = _broker_answer(broker, pql)
    assert broker.handler.metrics.meter("join.strategy.colocated").count == colocated + 1

    req = ref_optimize(ref_parse(pql))
    spec = req.join
    left_f, right_f = rjm.split_join_filter(req)
    left_cols, right_cols = rjm.side_columns(req)
    build, _ = rjm.extract_side(tables["netdimT_OFFLINE"], right_f, spec.right_key,
                                [spec.strip_right(c) for c in right_cols],
                                {spec.strip_right(c): c for c in right_cols})
    probe, _ = rjm.extract_side(tables["netfactT_OFFLINE"], left_f, spec.left_key, left_cols)
    want = canonical_payload(req, RefExecutor().execute_join(req, build, probe))
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (got, want)
