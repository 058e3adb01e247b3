"""The port's serving path: two port servers (``device="cpu"``) behind the
port's broker, over ``LocalTransport`` and over TCP, against the JAX
package's cluster (two reference servers and its broker) on the same
segments split the same way.

The eight ``CLUSTER_QUERIES`` of ``tests/test_cluster.py`` must give the
reference cluster's client payload exactly, with the same accounting keys
popped; the seeded ``QueryGenerator`` mix (``make_test_schema()``, MV
included) must be ``payloads_equivalent`` at rel 1e-9 / abs 2e-5 (as the
port's other differential tests).  Then the failure replies: a server
that is down, bad PQL (150), an unknown table (410), a saturated
scheduler (210).
"""
import threading

import pytest

from pinot_tpu.broker.broker import BrokerRequestHandler as RefBroker
from pinot_tpu.broker.routing import RoutingTableProvider as RefRouting
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.server.instance import ServerInstance as RefServer
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.tools.query_gen import QueryGenerator
from pinot_tpu.transport.local import LocalTransport as RefLocal
from pinot_tpu.utils.audit import payloads_equivalent, strip_accounting

from pinot_tpu_torch.broker.broker import BrokerRequestHandler
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.transport.local import LocalTransport
from pinot_tpu_torch.transport.tcp import TcpServer, TcpTransport

TABLE = "testTable"
REL, ABS = 1e-9, 2e-5
MIX_QUERIES = 24

# tests/test_cluster.py:129-138
CLUSTER_QUERIES = [
    "SELECT count(*) FROM testTable",
    "SELECT sum(metInt), avg(metDouble) FROM testTable WHERE dimInt > 1000",
    "SELECT sum(metInt) FROM testTable GROUP BY dimStr TOP 5",
    "SELECT distinctcount(dimLong) FROM testTable",
    "SELECT percentile90(metInt) FROM testTable",
    "SELECT min(metFloat) FROM testTable GROUP BY dimStr, dimInt TOP 10",
    "SELECT dimStr, metInt FROM testTable ORDER BY metInt DESC LIMIT 8",
    "SELECT distinctcounthll(dimInt) FROM testTable WHERE dimStr <> 'qq'",
]
# the keys tests/test_cluster.py pops before comparing
POPPED = ("timeUsedMs", "requestId", "planDigest", "cost", "freshnessMs",
          "numEntriesScannedInFilter", "numEntriesScannedPostFilter",
          "numSegmentsQueried", "numServersQueried", "numServersResponded")

SCHEMA = make_test_schema()
ROWS = random_rows(SCHEMA, 800, seed=9, cardinality=12)
SPLIT = {"serverA": [("segA1", 0, 200), ("segA2", 200, 400)],
         "serverB": [("segB1", 400, 600), ("segB2", 600, 800)]}
REF_SEGMENTS = {
    server: [ref_build_segment(SCHEMA, ROWS[a:b], TABLE, name) for name, a, b in segs]
    for server, segs in SPLIT.items()
}
MIX = [QueryGenerator(SCHEMA, ROWS, table=TABLE, seed=23).next_query() for _ in range(MIX_QUERIES)]


def _routing(cls):
    routing = cls()
    routing.update(TABLE, {name: {server: "ONLINE"} for server, segs in SPLIT.items()
                           for name, _, _ in segs})
    return routing


@pytest.fixture(scope="module")
def reference():
    servers = {name: RefServer(name) for name in SPLIT}
    transport = RefLocal()
    for name, server in servers.items():
        for seg in REF_SEGMENTS[name]:
            server.add_segment(TABLE, seg)
        transport.register((name, 0), server.handle_request)
    broker = RefBroker(transport, {n: (n, 0) for n in SPLIT}, routing=_routing(RefRouting),
                       timeout_ms=30_000)
    yield broker
    broker.shutdown()
    for server in servers.values():
        server.shutdown()


def _port_servers(**kwargs):
    servers = {name: ServerInstance(name, device="cpu", **kwargs) for name in SPLIT}
    for name, server in servers.items():
        for seg in REF_SEGMENTS[name]:
            server.add_segment(TABLE, segment_from_arrays(**segment_arrays_of(seg)))
    return servers


@pytest.fixture(scope="module", params=["local", "tcp"])
def port(request):
    servers = _port_servers()
    tcp = []
    if request.param == "local":
        transport = LocalTransport()
        addresses = {}
        for name, server in servers.items():
            transport.register((name, 0), server.handle_request)
            addresses[name] = (name, 0)
    else:
        transport = TcpTransport()
        addresses = {}
        for name, server in servers.items():
            t = TcpServer(server.handle_request)
            t.start()
            tcp.append(t)
            addresses[name] = t.address
    broker = BrokerRequestHandler(transport, addresses, routing=_routing(RoutingTableProvider),
                                  timeout_ms=30_000)
    yield broker, transport, servers
    broker.shutdown()
    for t in tcp:
        t.stop()
    for server in servers.values():
        server.shutdown()


_REF_ANSWERS = {}


def _reference_answer(reference, pql):
    if pql not in _REF_ANSWERS:
        _REF_ANSWERS[pql] = reference.handle_pql(pql).to_json()
    return dict(_REF_ANSWERS[pql])


def _no_failover(servers):
    for server in servers.values():
        heal = server.status()["selfHealing"]
        assert heal["deviceFailures"] == heal["hostFailovers"] == 0, (server.name, heal)


@pytest.mark.parametrize("pql", CLUSTER_QUERIES)
def test_cluster_queries_equal_the_reference_cluster(port, reference, pql):
    broker, _, servers = port
    got = broker.handle_pql(pql).to_json()
    _no_failover(servers)
    want = _reference_answer(reference, pql)
    for k in POPPED:
        got.pop(k, None)
        want.pop(k, None)
    assert got == want


def test_seeded_mix_equals_the_reference_cluster(port, reference):
    broker, _, servers = port
    for pql in MIX:
        got = strip_accounting(broker.handle_pql(pql).to_json())
        _no_failover(servers)
        want = strip_accounting(_reference_answer(reference, pql))
        assert not got["exceptions"], (pql, got["exceptions"])
        assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (pql, got, want)


def test_the_replies_went_through_both_lanes(port):
    broker, _, servers = port
    resp = broker.handle_pql("SELECT count(*) FROM testTable")
    assert resp.num_servers_queried == 2 and resp.num_servers_responded == 2
    assert resp.total_docs == 800 and resp.cost["segmentsFullScan"] == 4
    for server in servers.values():
        status = server.status()
        assert status["lane"]["dispatches"] > 0
        assert status["selfHealing"]["hostFailovers"] == 0
        assert status["metrics"]["timers"]["phase.laneWait"]["count"] > 0
    assert "pinot_tpu_server_lane_dispatches_total" in servers["serverA"].metrics_text()


def test_trace_rides_back(port):
    broker, _, _ = port
    resp = broker.handle_pql("SELECT count(*) FROM testTable", trace=True)
    scopes = resp.trace_info["scopes"]
    assert set(scopes) >= {"broker0", "serverA", "serverB"}
    spans = {s["span"] for s in scopes["serverA"]}
    assert {"serverQuery", "queueWait", "planAndExecute", "laneWait", "planExec"} <= spans


def test_a_server_down_gives_one_exception_and_the_other_partial(port):
    broker, transport, servers = port
    if isinstance(transport, LocalTransport):
        transport.set_down(("serverB", 0))
        restore = lambda: transport.set_down(("serverB", 0), down=False)  # noqa: E731
    else:
        address = broker.server_addresses["serverB"]
        broker.set_server_address("serverB", ("127.0.0.1", 1))  # nothing listens there
        restore = lambda: broker.set_server_address("serverB", address)  # noqa: E731
    try:
        resp = broker.handle_pql("SELECT count(*) FROM testTable")
        assert resp.num_servers_responded == 1
        assert len(resp.exceptions) == 1
        assert resp.num_docs_scanned == 400
        assert resp.partial_response and resp.num_segments_unserved == 2
    finally:
        restore()
    broker.health = type(broker.health)()  # forget the failures


def test_bad_pql_and_unknown_table(port):
    broker, _, _ = port
    resp = broker.handle_pql("SELEC nope")
    assert resp.exceptions and resp.exceptions[0].error_code == 150
    resp = broker.handle_pql("SELECT count(*) FROM nosuchtable")
    assert resp.exceptions and resp.exceptions[0].error_code == 410


def test_saturated_scheduler_replies_210():
    servers = _port_servers(num_workers=1, max_pending=1)
    transport = LocalTransport()
    for name, server in servers.items():
        transport.register((name, 0), server.handle_request)
    broker = BrokerRequestHandler(transport, {n: (n, 0) for n in SPLIT},
                                  routing=_routing(RoutingTableProvider), timeout_ms=10_000)
    release = threading.Event()
    try:
        # one held query fills serverB's only slot
        servers["serverB"].scheduler.submit(release.wait, table=TABLE)
        resp = broker.handle_pql("SELECT count(*) FROM testTable")
        assert [e.error_code for e in resp.exceptions] == [210]
        assert resp.num_docs_scanned == 400 and resp.num_servers_responded == 1
        assert servers["serverB"].metrics.meter("queriesShed").count == 1
    finally:
        release.set()
        broker.shutdown()
        for server in servers.values():
            server.shutdown()


def test_server_without_a_device_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ServerInstance("nodevice")
