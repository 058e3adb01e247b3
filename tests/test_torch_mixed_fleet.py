"""A mixed fleet: the JAX package's broker in front of one reference
``ServerInstance`` and one port ``ServerInstance`` (``device="cpu"``)
that hold the same replicas, and the reverse, the port's broker in front
of reference servers.

The reference broker's ``ReplicaAuditor`` (``pinot_tpu/utils/audit.py``)
runs at sample rate 1 with an unbounded budget: every query of the
seeded ``QueryGenerator`` mixes over lineitem and ``make_test_schema()``
(MV included) is re-issued to both replicas and their reduced payloads
compared (``payloads_equivalent`` at its own band, rel 5e-4 / abs 1e-3).
It must check every query and find no divergence.  The port's segments
are built from the reference's through ``segment/convert.py``.
"""
import threading
import time

import pytest

from pinot_tpu.broker.broker import BrokerRequestHandler as RefBroker
from pinot_tpu.broker.routing import RoutingTableProvider as RefRouting
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.server.instance import ServerInstance as RefServer
from pinot_tpu.tools.datagen import lineitem_rows, lineitem_schema, make_test_schema, random_rows
from pinot_tpu.tools.query_gen import QueryGenerator
from pinot_tpu.transport.local import LocalTransport as RefLocal
from pinot_tpu.utils.audit import ReplicaAuditor, SamplerBudget, payloads_equivalent, strip_accounting

from pinot_tpu_torch.broker.broker import BrokerRequestHandler
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.transport.local import LocalTransport

REL, ABS = 1e-9, 2e-5
QUERIES = 30


def _table(kind):
    if kind == "lineitem":
        schema, rows, table = lineitem_schema(), lineitem_rows(3000, seed=5), "lineitem"
    else:
        schema, table = make_test_schema(), "testTable"
        rows = random_rows(schema, 1200, seed=19)
    third = len(rows) // 3
    segs = [ref_build_segment(schema, rows[i * third : (i + 1) * third], table, f"{kind}{i}")
            for i in range(3)]
    gen = QueryGenerator(schema, rows, table=table, seed=29)
    return table, segs, [gen.next_query() for _ in range(QUERIES)]


TABLES = {kind: _table(kind) for kind in ("lineitem", "mvtest")}


class _Counted:
    """Counts the auditor's finished jobs, so a test can wait for them."""

    def __init__(self, auditor):
        self.done = 0
        self._cv = threading.Condition()
        real = auditor._audit_one

        def audit_one(job):
            try:
                real(job)
            finally:
                with self._cv:
                    self.done += 1
                    self._cv.notify_all()

        auditor._audit_one = audit_one

    def wait(self, n, timeout=60.0):
        end = time.monotonic() + timeout
        with self._cv:
            while self.done < n:
                assert self._cv.wait(max(0.0, end - time.monotonic())), (self.done, n)


@pytest.mark.parametrize("kind", sorted(TABLES))
def test_reference_broker_audits_a_port_replica(kind):
    table, segs, mix = TABLES[kind]
    ref = RefServer("ref0")
    port = ServerInstance("port0", device="cpu")
    for seg in segs:
        ref.add_segment(table, seg)
        port.add_segment(table, segment_from_arrays(**segment_arrays_of(seg)))
    transport = RefLocal()
    transport.register(("ref0", 0), ref.handle_request)
    transport.register(("port0", 0), port.handle_request)
    routing = RefRouting()
    routing.update(table, {s.segment_name: {"ref0": "ONLINE", "port0": "ONLINE"} for s in segs})
    broker = RefBroker(transport, {"ref0": ("ref0", 0), "port0": ("port0", 0)},
                       routing=routing, timeout_ms=30_000)
    auditor = broker.replica_audit
    auditor.sample_n = 1
    auditor.budget = SamplerBudget(per_s=1e9, burst=1e9)
    counted = _Counted(auditor)
    try:
        for i, pql in enumerate(mix):
            resp = broker.handle_pql(pql)
            assert not resp.exceptions, (pql, resp.exceptions)
            counted.wait(i + 1)  # one job at a time: the auditor's queue holds 8
        snap = auditor.snapshot()
        assert snap["errors"] == 0 and snap["dropped"] == 0
        assert snap["checks"] == len(mix), snap
        assert snap["divergences"] == 0, snap["recentDivergences"]
        assert port.status()["lane"]["dispatches"] > 0
    finally:
        broker.shutdown()
        ref.shutdown()
        port.shutdown()


@pytest.mark.parametrize("kind", sorted(TABLES))
def test_port_broker_in_front_of_reference_servers(kind):
    table, segs, mix = TABLES[kind]
    servers = {"refA": RefServer("refA"), "refB": RefServer("refB")}
    cover = {"refA": segs[:2], "refB": segs[2:]}
    ref_transport, transport = RefLocal(), LocalTransport()
    for name, server in servers.items():
        for seg in cover[name]:
            server.add_segment(table, seg)
        ref_transport.register((name, 0), server.handle_request)
        transport.register((name, 0), server.handle_request)
    view = {s.segment_name: {name: "ONLINE"} for name, ss in cover.items() for s in ss}
    ref_routing, routing = RefRouting(), RoutingTableProvider()
    ref_routing.update(table, view)
    routing.update(table, view)
    addresses = {n: (n, 0) for n in servers}
    ref_broker = RefBroker(ref_transport, addresses, routing=ref_routing, timeout_ms=30_000)
    broker = BrokerRequestHandler(transport, addresses, routing=routing, timeout_ms=30_000)
    try:
        for pql in mix:
            got = strip_accounting(broker.handle_pql(pql).to_json())
            want = strip_accounting(ref_broker.handle_pql(pql).to_json())
            assert not got["exceptions"], (pql, got["exceptions"])
            assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (pql, got, want)
    finally:
        ref_broker.shutdown()
        broker.shutdown()
        for server in servers.values():
            server.shutdown()
