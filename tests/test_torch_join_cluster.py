"""Distributed joins through the port's broker, against the JAX package's
cluster on the same segments.

Two port servers (``device="cpu"``, x64) behind the port broker over
``LocalTransport``, and two reference servers behind the reference
broker, each fleet holding every segment of ``tests/test_join.py``'s
``join_cluster`` tables (``factT`` / ``dimT``, partitioned on ``k`` into 4
partitions, replication 2).  Every join, under each of ``colocated``,
``broadcast`` and ``shuffle`` (debug option ``joinStrategy``), the size
choice, and the host join with the device off, must give the reference
cluster's client payload (``payloads_equivalent`` at rel 1e-9 / abs 2e-5,
accounting stripped); the port's answers are the same under every
strategy.  Then the broker's cost against the servers' costs, a poisoned
join plan, a replica that fails mid-join, the micro-batching tier, a
mixed fleet both ways, typed 4xx errors and empty sides.
"""
import concurrent.futures
import json

import numpy as np
import pytest

from pinot_tpu.broker.broker import BrokerRequestHandler as RefBroker
from pinot_tpu.broker.routing import RoutingTableProvider as RefRouting
from pinot_tpu.common.schema import DataType as RefDataType
from pinot_tpu.common.schema import FieldSpec as RefFieldSpec
from pinot_tpu.common.schema import FieldType as RefFieldType
from pinot_tpu.common.schema import Schema as RefSchema
from pinot_tpu.common.tableconfig import TableConfig as RefTableConfig
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.server.instance import ServerInstance as RefServer
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.transport.local import LocalTransport as RefLocal
from pinot_tpu.utils.audit import payloads_equivalent, strip_accounting

from pinot_tpu_torch.broker.broker import BrokerRequestHandler
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.common.datatable import deserialize_result
from pinot_tpu_torch.common.faults import DeviceFaultInjector
from pinot_tpu_torch.common.response import ErrorCode
from pinot_tpu_torch.common.tableconfig import PartitionConfig, TableConfig
from pinot_tpu_torch.engine import config
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.transport.local import LocalTransport

REL, ABS = 1e-9, 2e-5
NPART = 4
STRATEGIES = ("colocated", "broadcast", "shuffle")


def _fact_schema(name):
    return RefSchema(name, dimensions=[RefFieldSpec("k", RefDataType.INT, RefFieldType.DIMENSION),
                                       RefFieldSpec("grp", RefDataType.STRING, RefFieldType.DIMENSION)],
                     metrics=[RefFieldSpec("v", RefDataType.INT, RefFieldType.METRIC)])


def _dim_schema(name):
    return RefSchema(name, dimensions=[RefFieldSpec("k", RefDataType.INT, RefFieldType.DIMENSION),
                                       RefFieldSpec("cat", RefDataType.STRING, RefFieldType.DIMENSION)],
                     metrics=[RefFieldSpec("w", RefDataType.INT, RefFieldType.METRIC)])


def _make_rows(seed=3, n=1500, keys=60):
    """tests/test_join.py:_make_rows."""
    rng = np.random.default_rng(seed)
    fact = [{"k": int(k), "grp": f"g{int(k) % 3}", "v": int(v)}
            for k, v in zip(rng.integers(0, keys, n), rng.integers(0, 100, n))]
    dim = [{"k": k, "cat": f"c{k % 5}", "w": (k * 3) % 41} for k in range(keys)]
    return fact, dim


def _segments(fact, dim, prefix=""):
    """{physical table: [reference segments]}, one segment a partition."""
    ft, dt = f"{prefix}factT", f"{prefix}dimT"
    out = {f"{ft}_OFFLINE": [], f"{dt}_OFFLINE": []}
    for p in range(NPART):
        out[f"{ft}_OFFLINE"].append(ref_build_segment(
            _fact_schema(ft), [r for r in fact if r["k"] % NPART == p], f"{ft}_OFFLINE", segment_name=f"{ft}_{p}_p{p}"))
        out[f"{dt}_OFFLINE"].append(ref_build_segment(
            _dim_schema(dt), [r for r in dim if r["k"] % NPART == p], f"{dt}_OFFLINE", segment_name=f"{dt}_{p}_p{p}"))
    return out


MV_SCHEMA = make_test_schema()
MV_SEGMENT = ref_build_segment(MV_SCHEMA, random_rows(MV_SCHEMA, 200, seed=5), "mvT_OFFLINE", "mvT_0")


class Fleet:
    """Servers (each holding every segment given it) behind one broker."""

    def __init__(self, kinds, tables, port_broker=True, injector=None, partitioned=True):
        self.servers = {}
        self.transport = LocalTransport() if port_broker else RefLocal()
        for i, kind in enumerate(kinds):
            name = f"{kind}{i}"
            if kind == "port":
                server = ServerInstance(name, device="cpu", device_fault_injector=injector)
            else:
                server = RefServer(name)
            for table, segs in tables.items():
                for seg in segs:
                    server.add_segment(table, segment_from_arrays(**segment_arrays_of(seg))
                                       if kind == "port" else seg)
            self.servers[name] = server
            self.transport.register((name, 0), server.handle_request)
        routing = RoutingTableProvider() if port_broker else RefRouting()
        for table, segs in tables.items():
            routing.update(table, {s.segment_name: {n: "ONLINE" for n in self.servers} for s in segs})
        broker_cls = BrokerRequestHandler if port_broker else RefBroker
        self.broker = broker_cls(self.transport, {n: (n, 0) for n in self.servers}, routing=routing,
                                 timeout_ms=30_000)
        if partitioned:
            for table in tables:
                if not table.startswith("mvT"):
                    self.broker.joinplan.partitions.set_partitioning(table, "k", NPART)

    def query(self, pql, strategy=None):
        return self.broker.handle_pql(pql, debug_options={"joinStrategy": strategy} if strategy else None)

    def stop(self):
        self.broker.shutdown()
        for s in self.servers.values():
            s.shutdown()


FACT, DIM = _make_rows()
TABLES = _segments(FACT, DIM)
TABLES["mvT_OFFLINE"] = [MV_SEGMENT]


@pytest.fixture(scope="module")
def fleets():
    port = Fleet(("port", "port"), TABLES)
    ref = Fleet(("ref", "ref"), TABLES, port_broker=False)
    yield port, ref
    port.stop()
    ref.stop()


QUERIES = {
    "scalar": "SELECT count(*), sum(f.v), sum(d.w) FROM factT f JOIN dimT d ON f.k = d.k",
    "build_group": "SELECT sum(f.v), count(*) FROM factT f JOIN dimT d ON f.k = d.k "
                   "WHERE d.cat IN ('c1','c3') GROUP BY d.cat",
    "having": "SELECT sum(f.v), count(*) FROM factT f JOIN dimT d ON f.k = d.k "
              "WHERE f.v > 20 GROUP BY d.cat HAVING count(*) > 10 TOP 5",
    "key_as_value": "SELECT count(*), sum(f.k) FROM factT f JOIN dimT d ON f.k = d.k",
    "mixed_radix": "SELECT min(d.w), max(f.v), avg(f.v), minmaxrange(d.w) FROM factT f JOIN dimT d "
                   "ON f.k = d.k GROUP BY f.grp, d.cat TOP 20",
    "value_state": "SELECT distinctcount(f.v), percentile90(d.w) FROM factT f JOIN dimT d ON f.k = d.k "
                   "GROUP BY f.grp",
}


def _payload(resp):
    return strip_accounting(resp.to_json())


def _result_payload(resp):
    """The result sections only (tests/test_join.py): totalDocs counts the
    rows each strategy's phases touched, so it is strategy-dependent."""
    keep = ("aggregationResults", "selectionResults", "exceptions", "partialResponse")
    return json.dumps({k: v for k, v in resp.to_json().items() if k in keep}, sort_keys=True)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_every_strategy_equals_the_reference_cluster(fleets, name, monkeypatch):
    port, ref = fleets
    pql = QUERIES[name]
    seen = set()
    for strategy in STRATEGIES + (None,):
        want = _payload(ref.query(pql, strategy))
        assert not want["exceptions"], want["exceptions"]
        resp = port.query(pql, strategy)
        got = _payload(resp)
        assert not got["exceptions"], (strategy, got["exceptions"])
        assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (strategy, got, want)
        assert resp.cost.get("buildRows", 0) > 0 and resp.cost.get("probeRows", 0) > 0
        if name != "value_state":  # value states take the host join, as in the reference
            assert resp.cost.get("deviceBytes", 0) > 0, (strategy, resp.cost)
        if strategy == "shuffle":
            assert resp.cost.get("shuffleBytes", 0) > 0
        if strategy == "broadcast":
            assert resp.cost.get("broadcastBytes", 0) > 0
        seen.add(_result_payload(resp))
    # the host join with the device off answers the same
    monkeypatch.setattr(config, "JOIN_DEVICE", False)
    for strategy in STRATEGIES:
        resp = port.query(pql, strategy)
        assert "deviceBytes" not in resp.cost
        seen.add(_result_payload(resp))
    assert len(seen) == 1, seen
    assert port.broker.metrics.meter("join.strategy.colocated").count > 0


def test_the_size_choice_colocates_partitioned_tables_and_broadcasts_otherwise(fleets):
    port, _ = fleets
    m = port.broker.metrics
    before = {s: m.meter(f"join.strategy.{s}").count for s in STRATEGIES}
    assert not port.query(QUERIES["scalar"]).exceptions
    assert m.meter("join.strategy.colocated").count == before["colocated"] + 1
    # a join off the partition column cannot colocate: the build side is
    # small, so it is broadcast
    assert not port.query("SELECT count(*) FROM factT f JOIN dimT d ON f.v = d.k").exceptions
    assert m.meter("join.strategy.broadcast").count == before["broadcast"] + 1


def test_selection_join_orders_like_the_reference(fleets):
    """A selection takes the host join; ties admit any row order, so the
    ordered sort-column values are the contract (tests/test_join.py)."""
    port, ref = fleets
    pql = ("SELECT f.v, d.w FROM factT f JOIN dimT d ON f.k = d.k "
           "WHERE d.cat = 'c2' ORDER BY f.v DESC LIMIT 5")
    want = ref.query(pql)
    for strategy in STRATEGIES:
        resp = port.query(pql, strategy)
        assert not resp.exceptions, resp.exceptions
        assert resp.selection_results.columns == ["v", "dimT.w"]
        assert [int(r[0]) for r in resp.selection_results.rows] == \
            [int(r[0]) for r in want.selection_results.rows]


class _Spy:
    def __init__(self, inner):
        self.inner = inner
        self.replies = []

    def request(self, address, payload, timeout=15.0):
        reply = self.inner.request(address, payload, timeout)
        self.replies.append(reply)
        return reply

    def __getattr__(self, name):
        return getattr(self.inner, name)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_broker_cost_equals_the_sum_of_the_servers_costs(fleets, strategy):
    port, _ = fleets
    spy = _Spy(port.broker.transport)
    port.broker.transport = spy
    try:
        resp = port.query(QUERIES["build_group"], strategy)
        assert not resp.exceptions, resp.exceptions
        summed, docs = {}, 0
        for raw in spy.replies:
            part = deserialize_result(raw)
            docs += part.num_docs_scanned
            for k, v in part.cost.items():
                summed[k] = summed.get(k, 0) + v
        assert resp.num_docs_scanned == docs
        for k in set(summed) | set(resp.cost):
            assert resp.cost.get(k, 0) == pytest.approx(summed.get(k, 0)), k
    finally:
        port.broker.transport = spy.inner


def test_joins_do_not_enter_the_micro_batching_tier(fleets):
    """Eight same-plan joins at distinct literals at once: no batched
    launch forms and no reply rode one."""
    port, _ = fleets
    before = [s.lanes.stats()["batchLaunches"] for s in port.servers.values()]
    pqls = [f"SELECT sum(f.v) FROM factT f JOIN dimT d ON f.k = d.k WHERE f.v > {t}" for t in range(5, 45, 5)]
    with concurrent.futures.ThreadPoolExecutor(len(pqls)) as pool:
        resps = list(pool.map(port.query, pqls))
    for resp in resps:
        assert not resp.exceptions, resp.exceptions
        assert "batchHits" not in resp.cost and resp.cost.get("deviceBytes", 0) > 0
    assert [s.lanes.stats()["batchLaunches"] for s in port.servers.values()] == before


def test_a_poisoned_join_plan_heals_to_the_host_join():
    """The next lane launch fails deterministically: the join plan is
    quarantined and the host join answers the same; the next query skips
    the device."""
    injector = DeviceFaultInjector()
    fleet = Fleet(("port",), TABLES, injector=injector)
    try:
        pql = QUERIES["scalar"]
        healthy = fleet.query(pql, "broadcast")
        assert not healthy.exceptions and "deviceBytes" in healthy.cost
        injector.fail_next(1, retryable=False)
        resp = fleet.query(pql, "broadcast")
        assert not resp.exceptions, resp.exceptions
        assert _payload(resp) == _payload(healthy) and "deviceBytes" not in resp.cost
        ex = fleet.servers["port0"].executor
        heal = ex.healing_stats()
        assert heal["hostFailovers"] == 1 and heal["poisonedPlans"] == 1
        again = fleet.query(pql, "broadcast")
        assert _payload(again) == _payload(healthy)
        assert ex.healing_stats()["poisonSkips"] == 1
        # a transient fails once and the device retry serves it
        ex.clear_poisoned()
        injector.fail_next(1, retryable=True)
        retried = fleet.query(pql, "broadcast")
        assert _payload(retried) == _payload(healthy) and "deviceBytes" in retried.cost
        assert ex.healing_stats()["deviceRetries"] == 1
    finally:
        fleet.stop()


@pytest.mark.parametrize("strategy", ("broadcast", "shuffle"))
def test_a_replica_that_fails_mid_join_is_covered_by_its_peer(strategy):
    fleet = Fleet(("port", "port"), TABLES)
    try:
        pql = QUERIES["build_group"]
        ok = fleet.query(pql, strategy)
        assert not ok.exceptions, ok.exceptions

        def severed(payload):
            raise ConnectionError("severed")

        fleet.transport.register(("port0", 0), severed)
        resp = fleet.query(pql, strategy)
        assert not resp.exceptions, (strategy, resp.exceptions)
        assert not resp.partial_response
        assert _payload(resp) == _payload(ok)
        assert resp.num_retries >= 1
    finally:
        fleet.stop()


@pytest.mark.parametrize("port_broker", (True, False), ids=("port_broker", "reference_broker"))
def test_a_mixed_fleet_answers_joins(fleets, port_broker):
    """One reference and one port server behind the port broker, and
    behind the reference broker: every strategy gives the reference
    cluster's payload (the exchange payloads cross between packages)."""
    _, ref = fleets
    fleet = Fleet(("ref", "port"), TABLES, port_broker=port_broker)
    try:
        for name in ("scalar", "mixed_radix"):
            for strategy in STRATEGIES:
                want = _payload(ref.query(QUERIES[name], strategy))
                got = _payload(fleet.query(QUERIES[name], strategy))
                assert not got["exceptions"], (strategy, got["exceptions"])
                assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (name, strategy, got, want)
        served = {n: s.metrics.meter("join.execs").count for n, s in fleet.servers.items()}
        assert all(served.values()), served
    finally:
        fleet.stop()


@pytest.mark.parametrize("pql, strategy", [
    ("SELECT count(*) FROM factT f JOIN dimT d ON f.k = d.k WHERE f.v = 1 OR d.cat = 'c1'", None),
    ("SELECT count(*) FROM factT f JOIN nosuch d ON f.k = d.k", None),
    ("SELECT count(*) FROM factT f JOIN dimT d ON f.v = d.k", "colocated"),
    ("SELECT count(*) FROM factT f JOIN dimT d ON f.k = d.k", "bogus"),
    ("SELECT count(*) FROM factT f JOIN mvT m ON f.k = m.dimInt GROUP BY m.dimStrMV", "broadcast"),
    ("SELECT count(*) FROM factT f JOIN dimT d ON f.grp = d.k", "broadcast"),
    ("SELECT count(*) FROM factT f JOIN dimT d ON f.grp = d.k", "shuffle"),
    # an EXPLAIN of a join is answered (tests/test_torch_explain.py); of an
    # invalid one it is the same typed 4xx as the query's
    ("EXPLAIN SELECT count(*) FROM factT f JOIN dimT d ON f.k = d.k WHERE f.v = 1 OR d.cat = 'c1'", None),
], ids=("mixed_or", "unknown_table", "colocated_ineligible", "bogus_strategy", "mv_column",
        "key_types_broadcast", "key_types_shuffle", "explain"))
def test_typed_4xx_errors(fleets, pql, strategy):
    port, ref = fleets
    resp = port.query(pql, strategy)
    assert [e.error_code for e in resp.exceptions][:1] == [ErrorCode.QUERY_VALIDATION], resp.exceptions
    want = ref.query(pql, strategy)
    assert {e.error_code for e in resp.exceptions} == {e.error_code for e in want.exceptions}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_an_empty_filtered_side_is_an_empty_answer(fleets, strategy):
    port, _ = fleets
    for pql in ("SELECT count(*) FROM factT f JOIN dimT d ON f.k = d.k WHERE d.cat = 'nomatch'",
                "SELECT count(*) FROM factT f JOIN dimT d ON f.k = d.k WHERE f.v > 1000"):
        resp = port.query(pql, strategy)
        assert not resp.exceptions, (strategy, resp.exceptions)
        assert int(resp.aggregation_results[0].value) == 0


def test_table_config_partitioning_crosses_between_the_packages():
    port = TableConfig("factT", replication=2, partitioning=PartitionConfig(column="k", num_partitions=4))
    d = port.to_json()
    assert d["partitioning"] == {"column": "k", "numPartitions": 4}
    ref = RefTableConfig.from_json(d)
    assert ref.partitioning.column == "k" and ref.partitioning.num_partitions == 4
    back = TableConfig.from_json(ref.to_json())
    assert back.partitioning == port.partitioning and back.to_json() == d
    assert TableConfig.from_json(TableConfig("plain").to_json()).partitioning is None


def test_the_size_estimator_learns_from_scans_and_joins():
    """Every merged scan reply feeds the build-size estimate (totalDocs),
    and a join's measured build extraction replaces it."""
    fleet = Fleet(("port",), TABLES, partitioned=False)
    try:
        stats = fleet.broker.joinplan.stats
        assert stats.estimate("dimT") is None
        assert not fleet.query("SELECT count(*) FROM dimT").exceptions
        assert stats.estimate("dimT") == {"rows": len(DIM), "bytes": len(DIM) * 8, "source": "totalDocs"}
        resp = fleet.query(QUERIES["build_group"], "broadcast")
        assert not resp.exceptions
        est = stats.estimate("dimT")
        assert est["source"] == "measured" and est["rows"] == sum(1 for d in DIM if d["cat"] in ("c1", "c3"))
    finally:
        fleet.stop()
