"""EXPLAIN is refused by the port until its plan introspection lands: the
port's broker in front of two port servers, and the JAX package's broker
in front of a port server (a mixed fleet), both answer every EXPLAIN form
(``EXPLAIN``, ``EXPLAIN PLAN FOR``, ``EXPLAIN ANALYZE``) with
QUERY_VALIDATION naming item 24, with no results and with no scan: the
port broker sends nothing to its servers, and a port server behind the
reference broker never calls its executor.  A plain query through the
same fleets still answers (the refusal keys on the EXPLAIN prefix only).
"""
import pytest

from pinot_tpu.broker.broker import BrokerRequestHandler as RefBroker
from pinot_tpu.broker.routing import RoutingTableProvider as RefRouting
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.transport.local import LocalTransport as RefLocal

from pinot_tpu_torch.broker.broker import BrokerRequestHandler
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.common.response import ErrorCode
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.transport.local import LocalTransport

TABLE = "testTable"
SCHEMA = make_test_schema()
ROWS = random_rows(SCHEMA, 400, seed=9, cardinality=12)
SPLIT = {"serverA": [("segA", 0, 200)], "serverB": [("segB", 200, 400)]}
SEGMENTS = {
    server: [ref_build_segment(SCHEMA, ROWS[a:b], TABLE, name) for name, a, b in segs]
    for server, segs in SPLIT.items()
}
EXPLAINS = [
    "EXPLAIN SELECT count(*) FROM testTable",
    "EXPLAIN PLAN FOR SELECT dimStr, metInt FROM testTable ORDER BY metInt DESC LIMIT 5",
    "EXPLAIN ANALYZE SELECT sum(metInt) FROM testTable GROUP BY dimStr TOP 5",
]


class _Counting:
    """Counts a server's requests and its executor's calls."""

    def __init__(self, server):
        self.requests = 0
        self.executes = 0
        real_handle, real_execute = server.handle_request, server.executor.execute

        def handle(data):
            self.requests += 1
            return real_handle(data)

        def execute(*a, **k):
            self.executes += 1
            return real_execute(*a, **k)

        self.handle = handle
        server.executor.execute = execute


def _routing(cls):
    routing = cls()
    routing.update(TABLE, {name: {server: "ONLINE"} for server, segs in SPLIT.items()
                           for name, _, _ in segs})
    return routing


def _fleet(broker_cls, routing_cls, transport_cls):
    servers = {name: ServerInstance(name, device="cpu") for name in SPLIT}
    transport = transport_cls()
    counts = {}
    for name, server in servers.items():
        for seg in SEGMENTS[name]:
            server.add_segment(TABLE, segment_from_arrays(**segment_arrays_of(seg)))
        counts[name] = _Counting(server)
        transport.register((name, 0), counts[name].handle)
    broker = broker_cls(transport, {n: (n, 0) for n in SPLIT}, routing=_routing(routing_cls),
                        timeout_ms=30_000)
    return broker, servers, counts


@pytest.fixture(scope="module", params=["port_broker", "reference_broker"])
def fleet(request):
    if request.param == "port_broker":
        broker, servers, counts = _fleet(BrokerRequestHandler, RoutingTableProvider, LocalTransport)
    else:
        broker, servers, counts = _fleet(RefBroker, RefRouting, RefLocal)
    yield request.param, broker, counts
    broker.shutdown()
    for server in servers.values():
        server.shutdown()


def _reset(counts):
    for c in counts.values():
        c.requests = c.executes = 0


@pytest.mark.parametrize("pql", EXPLAINS, ids=("explain", "plan_for", "analyze"))
def test_every_explain_form_is_refused_without_a_scan(fleet, pql):
    kind, broker, counts = fleet
    _reset(counts)
    resp = broker.handle_pql(pql)
    codes = [e.error_code for e in resp.exceptions]
    assert codes and set(codes) == {ErrorCode.QUERY_VALIDATION}, resp.exceptions
    assert all("item 24" in e.message for e in resp.exceptions), resp.exceptions
    # no results: the reference broker's reduce of empty replies leaves
    # an empty shell for EXPLAIN ANALYZE (no value, no group)
    assert all(a.value is None and not a.group_by_result for a in resp.aggregation_results or ())
    assert not resp.selection_results
    assert resp.num_docs_scanned == 0
    assert sum(c.executes for c in counts.values()) == 0
    if kind == "port_broker":
        # refused at the broker: no server sees the request
        assert sum(c.requests for c in counts.values()) == 0
    else:
        # the reference broker forwards it; each port server refuses it
        assert all(c.requests == 1 for c in counts.values())
        assert len(codes) == len(SPLIT)


def test_a_plain_query_still_answers(fleet):
    _, broker, counts = fleet
    _reset(counts)
    resp = broker.handle_pql("SELECT count(*) FROM testTable")
    assert not resp.exceptions, resp.exceptions
    assert int(resp.aggregation_results[0].value) == 400
    assert sum(c.executes for c in counts.values()) == 2
