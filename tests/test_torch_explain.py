"""EXPLAIN through the port (``engine/explain.py``, the servers' plan and
analyze branches, the broker's tree, the join's shell), held against the
JAX package's EXPLAIN on the same segments.

The port's ``build_explain_node`` must equal the reference's, called with
``plan_stats=None`` and ``result_cache=None`` on each package's server
executor before any execution, for the reference's own EXPLAIN queries
and one query a serving tier (pruned, star-tree, postings, bit-sliced,
host-forced, zone-map, full scan).  Every field compares except the
wall-clock and device-identity ones (``VOLATILE``): ``generatedAtMs``,
the compile timeline's ``firstCallMs`` / ``firstAt`` / ``launchMsTotal``,
``device.planDigest`` (the two packages digest different ``StaticPlan``
types, so each is held against its own package's real execution: the
digest EXPLAIN reports is the one the lane records when the query then
runs) and ``staged.hbmBytes``.  The broker's assembled tree over a
two-server fleet and a join's shell compare the same way.  Then the
reference's tier-1 EXPLAIN guards, on the port: the parser, the shape
digest, the wire, the golden schema with zero device work, the compile
timeline, ANALYZE's actuals, poison honesty and ``explain_dump``.
"""
import copy
import struct

import numpy as np
import pytest

from pinot_tpu.broker.broker import BrokerRequestHandler as RefBroker
from pinot_tpu.broker.routing import RoutingTableProvider as RefRouting
from pinot_tpu.common.datatable import deserialize_result as ref_deserialize_result
from pinot_tpu.common.schema import DataType as RefDataType
from pinot_tpu.common.schema import FieldSpec as RefFieldSpec
from pinot_tpu.common.schema import FieldType as RefFieldType
from pinot_tpu.common.schema import Schema as RefSchema
from pinot_tpu.engine.device import clear_staging_cache as ref_clear_staging_cache
from pinot_tpu.engine.explain import build_explain_node as ref_build_explain_node
from pinot_tpu.engine.plandigest import plan_shape_digest as ref_plan_shape_digest
from pinot_tpu.engine.plandigest import plan_shape_summary as ref_plan_shape_summary
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.server.instance import ServerInstance as RefServer
from pinot_tpu.startree import StarTreeBuilderConfig as RefStarConfig
from pinot_tpu.startree import build_star_tree as ref_build_star_tree
from pinot_tpu.tools.datagen import baseball_rows, baseball_schema, make_test_schema, random_rows
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic
from pinot_tpu.tools.explain_dump import render_explain as ref_render_explain
from pinot_tpu.transport.local import LocalTransport as RefLocal

from pinot_tpu_torch.broker.broker import BrokerRequestHandler
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.common.datatable import MAGIC, deserialize_result, serialize_result
from pinot_tpu_torch.common.faults import DeviceFaultInjector
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine.explain import build_explain_node
from pinot_tpu_torch.engine.plandigest import plan_shape_digest, plan_shape_summary
from pinot_tpu_torch.engine.results import IntermediateResult
from pinot_tpu_torch.pql import PqlParseError, optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.startree import StarTreeBuilderConfig, build_star_tree
from pinot_tpu_torch.tools.datagen import synthetic_lineitem_segment
from pinot_tpu_torch.tools.explain_dump import render_explain
from pinot_tpu_torch.transport.local import LocalTransport

TABLE = "testTable"
# the fields that legitimately differ between the packages (module docstring)
VOLATILE_COMPILE = ("firstCallMs", "firstAt", "launchMsTotal")


def _port(segs):
    return [segment_from_arrays(**segment_arrays_of(s)) for s in segs]


def _comparable(node):
    """A plan node without its wall-clock and device-identity fields."""
    n = copy.deepcopy(node)
    n.pop("generatedAtMs", None)
    n.get("staged", {}).pop("hbmBytes", None)
    dev = n.get("device")
    if dev is not None:
        dev.pop("planDigest", None)
        for k in VOLATILE_COMPILE:
            dev.get("compile", {}).pop(k, None)
    return n


def _comparable_tree(tree):
    t = copy.deepcopy(tree)
    t["servers"] = sorted((_comparable(n) for n in t.get("servers", [])), key=lambda n: n["server"])
    return t


# -- the segments of each case, built by the reference, copied into the port
EXP_SCHEMA = make_test_schema(with_mv=False)
EXP_ROWS = random_rows(EXP_SCHEMA, 1600, seed=5)
EXP_REF = [ref_build_segment(EXP_SCHEMA, EXP_ROWS[:800], "expTable", "xga"),
           ref_build_segment(EXP_SCHEMA, EXP_ROWS[800:], "expTable", "xgb")]

MV_SCHEMA = make_test_schema()
MV_REF = [ref_build_segment(MV_SCHEMA, random_rows(MV_SCHEMA, 600, seed=8, cardinality=20)[i * 300:(i + 1) * 300],
                            TABLE, f"mv{i}") for i in range(2)]

DAY_BASES = (1000, 3000, 5000)


def _pruner_rows(i):
    rows = random_rows(EXP_SCHEMA, 300, seed=61 + i, cardinality=10)
    for r in rows:
        r["daysSinceEpoch"] = DAY_BASES[i] + r["daysSinceEpoch"] % 1000
    return rows


PRUNE_REF = [ref_build_segment(EXP_SCHEMA, _pruner_rows(i), TABLE, f"t{i}") for i in range(3)]

LI_REF = [ref_synthetic(20000, seed=17 + i, name=f"ex{i}") for i in range(3)]
LI_PORT = [synthetic_lineitem_segment(20000, seed=17 + i, name=f"ex{i}") for i in range(3)]

BB_ROWS = baseball_rows(2000, seed=4)
BB_REF = [ref_build_segment(baseball_schema(), BB_ROWS[:1000], "baseballStats", "bb0"),
          ref_build_segment(baseball_schema(), BB_ROWS[1000:], "baseballStats", "bb1")]
BB_PORT = _port(BB_REF)  # copied before the reference's tree is built: bb1 keeps none
ref_build_star_tree(BB_REF[0], baseball_schema(), RefStarConfig(max_leaf_records=50))
build_star_tree(BB_PORT[0], Schema.from_json(baseball_schema().to_json()), StarTreeBuilderConfig(max_leaf_records=50))

ZONE_DATES = "('1993-03-14', '1995-06-14', '1997-09-14')"
ZONE_BLOCK = 1024

# the reference's EXPLAIN query set (tests/test_explain.py) and one query a tier:
# (id, (reference segments, port segments), table, pql, port executor switches, reference env)
CASES = [
    ("sum_where", "exp", "SELECT sum(metInt) FROM expTable WHERE dimInt > 40", {}, {}),
    ("max_where", "exp", "SELECT max(metFloat) FROM expTable WHERE dimInt > 10", {}, {}),
    ("group_by", "exp", "SELECT sum(metInt) FROM expTable GROUP BY dimStr TOP 5", {}, {}),
    ("count_star", "exp", "SELECT count(*) FROM expTable", {}, {}),
    ("two_aggs", "exp", "SELECT sum(metInt), max(metFloat) FROM expTable WHERE dimInt > 80", {}, {}),
    ("selection", "exp", "SELECT dimStr, metInt FROM expTable ORDER BY metInt DESC LIMIT 5", {}, {}),
    ("mv_group_by", "mv", "SELECT count(*), sum(metInt) FROM testTable GROUP BY dimStrMV TOP 5", {}, {}),
    ("distinct_hll", "mv", "SELECT distinctcount(dimLong), distinctcounthll(dimInt) FROM testTable "
     "WHERE dimStr <> 'qq'", {}, {}),
    ("tier_pruned_all", "prune", "SELECT count(*) FROM testTable WHERE daysSinceEpoch > 9000", {}, {}),
    ("tier_pruned_some", "prune", "SELECT sum(metInt) FROM testTable WHERE daysSinceEpoch < 2000", {}, {}),
    ("tier_star_tree", "bb", "SELECT sum(runs) FROM baseballStats GROUP BY teamID TOP 5", {}, {}),
    ("tier_postings", "li", "SELECT count(*) FROM lineitem WHERE l_shipdate = '1995-06-14'", {}, {}),
    ("tier_bitsliced", "li", "SELECT count(*), sum(l_quantity) FROM lineitem "
     "WHERE l_quantity IN (5, 10, 15) AND l_shipmode = 'AIR'", {}, {}),
    ("tier_host_forced", "li", "SELECT sum(l_extendedprice), count(*) FROM lineitem WHERE l_quantity > 40 "
     "GROUP BY l_shipdate, l_receiptdate TOP 10", {}, {}),
    ("tier_zonemap", "li", "SELECT sum(l_quantity), count(*) FROM lineitem "
     f"WHERE l_shipdate IN {ZONE_DATES} GROUP BY l_returnflag, l_linestatus TOP 10",
     {"postings": False, "bitsliced": False}, {"PINOT_TPU_INVINDEX": "0", "PINOT_TPU_BITSLICED": "0"}),
    ("tier_full_scan", "li", "SELECT sum(l_quantity), sum(l_extendedprice), count(*) FROM lineitem "
     "WHERE l_shipdate <= '1998-09-02' GROUP BY l_returnflag, l_linestatus TOP 10", {}, {}),
]
DATA = {
    "exp": ("expTable", EXP_REF, _port(EXP_REF)),
    "mv": (TABLE, MV_REF, _port(MV_REF)),
    "prune": (TABLE, PRUNE_REF, _port(PRUNE_REF)),
    "bb": ("baseballStats", BB_REF, BB_PORT),
    "li": ("lineitem", LI_REF, LI_PORT),
}
WANT_TIERS = {
    "tier_pruned_all": {"segmentsPruned": 3},
    "tier_pruned_some": {"segmentsPruned": 2, "segmentsBitsliced": 1},
    "tier_star_tree": {"segmentsStarTree": 1, "segmentsFullScan": 1},
    "tier_postings": {"segmentsPostings": 3},
    "tier_bitsliced": {"segmentsBitsliced": 3},
    "tier_host_forced": {"segmentsHost": 3},
    "tier_zonemap": {"segmentsZonemap": 3},
    "tier_full_scan": {"segmentsFullScan": 3},
}


@pytest.fixture
def small_zone_block(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_ZONE_BLOCK", str(ZONE_BLOCK))
    monkeypatch.setattr(config, "ZONE_BLOCK", ZONE_BLOCK)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_explain_node_equals_the_reference(case, small_zone_block, monkeypatch):
    """The plan node of each query, before any execution, equals the
    reference's field for field (``VOLATILE`` aside); then the query runs
    in each package, its lane records the device digest EXPLAIN reported,
    and the tiers it served from are the tiers EXPLAIN predicted."""
    name, data, pql, port_kw, ref_env = case
    for k, v in ref_env.items():
        monkeypatch.setenv(k, v)
    table, ref_segs, port_segs = DATA[data]
    # the reference's staging cache, ledger and tiers are the process's:
    # an earlier case's tables must not show in this one's staged record
    ref_clear_staging_cache()
    ref_server = RefServer("s0")
    port_server = ServerInstance("s0", device="cpu", **port_kw)
    try:
        ref_req = ref_optimize(ref_parse(pql))
        port_req = optimize_request(parse_pql(pql))
        want = ref_build_explain_node(ref_server.executor, ref_segs, ref_req, table, "s0",
                                      plan_stats=None, result_cache=None)
        got = build_explain_node(port_server.executor, port_segs, port_req, table, "s0")
        assert _comparable(got) == _comparable(want)
        if name in WANT_TIERS:
            assert got["tierCounts"] == WANT_TIERS[name]
        # each package's digest against its own execution
        for server, segs, req, node in ((port_server, port_segs, port_req, got),
                                        (ref_server, ref_segs, ref_req, want)):
            res = server.executor.execute(segs, req)
            served = {k: v for k, v in res.cost.items() if k.startswith("segments") and v}
            assert served == node["tierCounts"], (served, node["tierCounts"])
            if "device" in node:
                assert server.lane.compile_info(node["device"]["planDigest"]) is not None
    finally:
        ref_server.shutdown()
        port_server.shutdown()
        ref_clear_staging_cache()


# -- the broker's tree and a join's shell, port fleet against reference fleet
SPLIT = {"serverA": [("segA1", 0, 200), ("segA2", 200, 400)], "serverB": [("segB1", 400, 600)]}
FLEET_ROWS = random_rows(MV_SCHEMA, 600, seed=9, cardinality=12)
FLEET_REF = {srv: [ref_build_segment(MV_SCHEMA, FLEET_ROWS[a:b], TABLE, n) for n, a, b in segs]
             for srv, segs in SPLIT.items()}
FLEET_QUERIES = [
    "EXPLAIN SELECT count(*) FROM testTable",
    "EXPLAIN PLAN FOR SELECT sum(metInt), avg(metDouble) FROM testTable WHERE dimInt > 1000",
    "EXPLAIN SELECT sum(metInt) FROM testTable GROUP BY dimStr TOP 5",
    "EXPLAIN SELECT dimStr, metInt FROM testTable ORDER BY metInt DESC LIMIT 8",
    "EXPLAIN SELECT distinctcounthll(dimInt) FROM testTable WHERE dimStr <> 'qq'",
]


def _fleet(kind):
    port = kind == "port"
    servers = {n: (ServerInstance(n, device="cpu") if port else RefServer(n)) for n in SPLIT}
    transport = LocalTransport() if port else RefLocal()
    for n, server in servers.items():
        for seg in FLEET_REF[n]:
            server.add_segment(TABLE, segment_from_arrays(**segment_arrays_of(seg)) if port else seg)
        transport.register((n, 0), server.handle_request)
    routing = RoutingTableProvider() if port else RefRouting()
    routing.update(TABLE, {s: {srv: "ONLINE"} for srv, segs in SPLIT.items() for s, _, _ in segs})
    broker_cls = BrokerRequestHandler if port else RefBroker
    return broker_cls(transport, {n: (n, 0) for n in SPLIT}, routing=routing, timeout_ms=30_000), servers


@pytest.fixture(scope="module")
def fleets():
    ref_clear_staging_cache()
    port, port_servers = _fleet("port")
    ref, ref_servers = _fleet("ref")
    yield port, ref, port_servers
    for b, servers in ((port, port_servers), (ref, ref_servers)):
        b.shutdown()
        for s in servers.values():
            s.shutdown()


@pytest.mark.parametrize("pql", FLEET_QUERIES, ids=[f"q{i}" for i in range(len(FLEET_QUERIES))])
def test_broker_explain_tree_equals_the_reference(fleets, pql):
    port, ref, port_servers = fleets
    got, want = port.handle_pql(pql), ref.handle_pql(pql)
    assert not got.exceptions and not want.exceptions, (got.exceptions, want.exceptions)
    gj, wj = got.to_json(), want.to_json()
    assert _comparable_tree(gj["explain"]) == _comparable_tree(wj["explain"])
    assert gj["planDigest"] == wj["planDigest"] == gj["explain"]["planDigest"]
    # the plan INSTEAD of results, as the reference's
    assert "aggregationResults" not in gj and "selectionResults" not in gj
    assert sum(s.lane.stats()["dispatches"] for s in port_servers.values()) == 0


def test_plain_query_response_carries_the_plan_digest(fleets):
    port, ref, _ = fleets
    pql = "SELECT sum(metInt) FROM testTable WHERE dimInt > 5"
    got, want = port.handle_pql(pql).to_json(), ref.handle_pql(pql).to_json()
    assert got["planDigest"] == want["planDigest"] and "explain" not in got


NPART = 2


def _join_schema(name, cols):
    return RefSchema(name, dimensions=[RefFieldSpec(c, t, RefFieldType.DIMENSION) for c, t in cols[:-1]],
                     metrics=[RefFieldSpec(cols[-1][0], cols[-1][1], RefFieldType.METRIC)])


def _join_tables():
    rng = np.random.default_rng(3)
    fact = [{"k": int(k), "grp": f"g{int(k) % 3}", "v": int(v)}
            for k, v in zip(rng.integers(0, 40, 400), rng.integers(0, 100, 400))]
    dim = [{"k": k, "cat": f"c{k % 5}", "w": (k * 3) % 41} for k in range(40)]
    fs = _join_schema("factT", [("k", RefDataType.INT), ("grp", RefDataType.STRING), ("v", RefDataType.INT)])
    ds = _join_schema("dimT", [("k", RefDataType.INT), ("cat", RefDataType.STRING), ("w", RefDataType.INT)])
    out = {"factT_OFFLINE": [], "dimT_OFFLINE": []}
    for p in range(NPART):
        out["factT_OFFLINE"].append(ref_build_segment(fs, [r for r in fact if r["k"] % NPART == p],
                                                      "factT_OFFLINE", segment_name=f"factT_{p}_p{p}"))
        out["dimT_OFFLINE"].append(ref_build_segment(ds, [r for r in dim if r["k"] % NPART == p],
                                                     "dimT_OFFLINE", segment_name=f"dimT_{p}_p{p}"))
    return out


JOIN_TABLES = _join_tables()
JOIN = "SELECT sum(f.v), count(*) FROM factT f JOIN dimT d ON f.k = d.k WHERE d.cat = 'c1'"


def _join_fleet(kind, partitioned):
    port = kind == "port"
    names = ("s0", "s1")
    servers = {n: (ServerInstance(n, device="cpu") if port else RefServer(n)) for n in names}
    transport = LocalTransport() if port else RefLocal()
    routing = RoutingTableProvider() if port else RefRouting()
    for n, server in servers.items():
        for table, segs in JOIN_TABLES.items():
            for seg in segs:
                server.add_segment(table, segment_from_arrays(**segment_arrays_of(seg)) if port else seg)
        transport.register((n, 0), server.handle_request)
    for table, segs in JOIN_TABLES.items():
        routing.update(table, {s.segment_name: {n: "ONLINE" for n in names} for s in segs})
    broker = (BrokerRequestHandler if port else RefBroker)(transport, {n: (n, 0) for n in names},
                                                           routing=routing, timeout_ms=30_000)
    if partitioned:
        for table in JOIN_TABLES:
            broker.joinplan.partitions.set_partitioning(table, "k", NPART)
    return broker, servers


@pytest.mark.parametrize("partitioned", (True, False), ids=("colocated", "size_probe"))
def test_join_explain_shell_equals_the_reference(partitioned):
    fleets = [_join_fleet(kind, partitioned) for kind in ("port", "ref")]
    try:
        (port, port_servers), (ref, _) = fleets
        got, want = port.handle_pql("EXPLAIN " + JOIN), ref.handle_pql("EXPLAIN " + JOIN)
        assert not got.exceptions and not want.exceptions
        assert got.to_json()["explain"] == want.to_json()["explain"]
        assert got.explain["join"]["strategy"] == ("colocated" if partitioned else
                                                   "broadcast|shuffle (size probe at execution)")
        assert sum(s.metrics.meter("join.execs").count + s.metrics.meter("join.extracts").count
                   for s in port_servers.values()) == 0
        # ANALYZE executes: the answer, the strategy that ran and the actuals
        got, want = port.handle_pql("EXPLAIN ANALYZE " + JOIN), ref.handle_pql("EXPLAIN ANALYZE " + JOIN)
        assert not got.exceptions
        assert got.aggregation_results[1].value == want.aggregation_results[1].value
        assert got.explain["join"]["actual"] == want.explain["join"]["actual"]
        assert got.explain["actualDocsScanned"] == got.num_docs_scanned
        assert set(got.explain["actualCost"]) == set(got.cost)
    finally:
        for broker, servers in fleets:
            broker.shutdown()
            for s in servers.values():
                s.shutdown()


# -- the reference's tier-1 EXPLAIN guards (tests/test_explain.py), on the port
def test_explain_parser_prefix_variants():
    assert parse_pql("EXPLAIN SELECT count(*) FROM t").explain == "plan"
    assert parse_pql("EXPLAIN PLAN FOR SELECT count(*) FROM t").explain == "plan"
    assert parse_pql("EXPLAIN ANALYZE SELECT count(*) FROM t").explain == "analyze"
    assert parse_pql("SELECT count(*) FROM t").explain is None
    req = parse_pql("EXPLAIN SELECT sum(m) FROM t WHERE a > 5 GROUP BY b TOP 3")
    assert req.explain == "plan" and req.is_group_by
    with pytest.raises(PqlParseError):
        parse_pql("EXPLAIN SELECT FROM t")


DIGEST_QUERIES = [
    "SELECT sum(m) FROM t WHERE a > 5",
    "SELECT sum(m) FROM t WHERE a > 999",
    "SELECT count(*) FROM t WHERE a IN (1, 2)",
    "SELECT sum(m) FROM t_OFFLINE WHERE a > 5",
    "SELECT sum(m) FROM t WHERE b > 5",
    "SELECT max(m) FROM t",
    "SELECT sum(m) FROM t GROUP BY a",
    "SELECT sum(m) FROM t GROUP BY b TOP 7",
    "SELECT a, m FROM t WHERE b = 'x' ORDER BY m DESC LIMIT 3",
    "EXPLAIN SELECT sum(m) FROM t WHERE a > 5",
    "SELECT count(*) FROM f JOIN d ON f.k = d.k WHERE d.c = 'x'",
]


def test_plan_shape_digest_erases_literals_not_shape():
    def dig(pql):
        return plan_shape_digest(optimize_request(parse_pql(pql)))

    assert dig("SELECT sum(m) FROM t WHERE a > 5") == dig("SELECT sum(m) FROM t WHERE a > 999")
    assert dig("SELECT count(*) FROM t WHERE a IN (1, 2)") == dig("SELECT count(*) FROM t WHERE a IN (7, 8)")
    assert dig("SELECT sum(m) FROM t WHERE a > 5") == dig("SELECT sum(m) FROM t_OFFLINE WHERE a > 5")
    assert dig("SELECT sum(m) FROM t WHERE a > 5") != dig("SELECT sum(m) FROM t WHERE b > 5")
    assert dig("SELECT sum(m) FROM t") != dig("SELECT max(m) FROM t")
    assert dig("SELECT sum(m) FROM t GROUP BY a") != dig("SELECT sum(m) FROM t GROUP BY b")
    assert dig("EXPLAIN SELECT sum(m) FROM t WHERE a > 5") == dig("SELECT sum(m) FROM t WHERE a > 5")
    s = plan_shape_summary(optimize_request(parse_pql("SELECT sum(m) FROM t WHERE a > 5 GROUP BY b")))
    assert "sum_m" in s and "from t" in s
    # the reference's digest and summary, query for query
    for pql in DIGEST_QUERIES:
        req, ref_req = optimize_request(parse_pql(pql)), ref_optimize(ref_parse(pql))
        assert plan_shape_digest(req) == ref_plan_shape_digest(ref_req), pql
        assert plan_shape_summary(req) == ref_plan_shape_summary(ref_req), pql


def test_plan_info_wire_roundtrip_and_backward_compat():
    res = IntermediateResult(plan_info=[{"server": "s0", "tierCounts": {"segmentsHost": 1}}])
    data = serialize_result(res)
    assert deserialize_result(data).plan_info == res.plan_info
    assert ref_deserialize_result(data).plan_info == res.plan_info  # the reference reads the port's
    # a payload from a peer before the plan list (no trailing plan list,
    # join payload or freshness: b"l" + i64(0), b"N", b"N") still reads
    data = serialize_result(IntermediateResult(num_docs_scanned=3))
    payload = data[16:-11]
    back = deserialize_result(MAGIC + struct.pack("<Q", len(payload)) + payload)
    assert back.num_docs_scanned == 3 and back.plan_info == []


EXPLAIN_TOP_KEYS = {"mode", "planDigest", "summary", "numServers", "tierCounts", "estimatedCost", "servers"}
NODE_REQUIRED_KEYS = {"server", "table", "planDigest", "summary", "numSegments", "totalDocs", "tierCounts",
                      "segments", "staged", "estimatedCost"}


def _single_server_broker(table, segs, **server_kw):
    server = ServerInstance("benchServer", device="cpu", **server_kw)
    for seg in segs:
        server.add_segment(table, seg)
    transport = LocalTransport()
    transport.register(("benchServer", 0), server.handle_request)
    routing = RoutingTableProvider()
    routing.update(table, {s.segment_name: {"benchServer": "ONLINE"} for s in segs})
    broker = BrokerRequestHandler(transport, {"benchServer": ("benchServer", 0)}, routing=routing,
                                  timeout_ms=60_000)
    broker.local_server = server
    return broker


@pytest.fixture()
def explain_broker():
    broker = _single_server_broker("expTable", _port(EXP_REF))
    yield broker
    broker.shutdown()
    broker.local_server.shutdown()


def test_explain_golden_schema_and_zero_device_work(explain_broker):
    broker, server = explain_broker, explain_broker.local_server
    resp = broker.handle_pql("EXPLAIN SELECT sum(metInt) FROM expTable WHERE dimInt > 40")
    assert not resp.exceptions, resp.exceptions
    j = resp.to_json()
    assert set(j["explain"].keys()) == EXPLAIN_TOP_KEYS
    assert j["explain"]["mode"] == "plan" and j["planDigest"] == j["explain"]["planDigest"]
    assert "aggregationResults" not in j and "selectionResults" not in j
    node = j["explain"]["servers"][0]
    assert NODE_REQUIRED_KEYS.issubset(node.keys())
    assert node["tierCounts"] == {"segmentsBitsliced": 2}
    assert all({"segment", "tier", "reason"}.issubset(s.keys()) for s in node["segments"])
    assert node["staged"] == {"hbmBytes": 0, "stagedTables": 0, "columns": [],
                              "residency": {"xga": "unstaged", "xgb": "unstaged"}}
    # zero device work: no lane submission, no cost marked, nothing staged
    lane = server.lane.stats()
    assert lane["dispatches"] == 0 and lane["depth"] == 0 and lane["coalesceHits"] == 0
    assert server.metrics.meter("cost.docsScanned").count == 0
    assert server.metrics.meter("cost.bytesScanned").count == 0
    assert all(server.metrics.meter(f"cost.tier.{k}").count == 0 for k in server._TIER_KEYS)
    assert server.executor.staged_bytes() == 0 and not server.executor._staged
    assert server.metrics.meter("plan.explains").count == 1
    assert broker.metrics.meter("explain.queries").count == 1
    # after an execution the staged record reads the ledger and the tiers
    broker.handle_pql("SELECT sum(metInt) FROM expTable WHERE dimInt > 40")
    staged = broker.handle_pql("EXPLAIN SELECT sum(metInt) FROM expTable WHERE dimInt > 40").explain
    staged = staged["servers"][0]["staged"]
    assert staged["hbmBytes"] == server.executor.staged_bytes() > 0 and staged["stagedTables"] == 1
    assert staged["residency"] == {"xga": "hot", "xgb": "hot"} and "metInt" in staged["columns"]


def test_explain_device_digest_matches_real_execution(explain_broker):
    broker, server = explain_broker, explain_broker.local_server
    pql = "SELECT sum(metInt) FROM expTable WHERE dimInt > 40"
    dev = broker.handle_pql("EXPLAIN " + pql).explain["servers"][0]["device"]
    assert dev["compile"] == {"state": "cold", "costAnalysis": "unavailable"}
    assert dev["mesh"] == {"shape": "1x1", "lanes": 1, "laneIndex": 0, "shardAxis": None, "collective": None}
    assert not broker.handle_pql(pql).exceptions
    assert server.lane.stats()["compiledPlans"] >= 1
    assert server.lane.compile_info(dev["planDigest"]) is not None, "phantom digest diverged"
    comp = broker.handle_pql("EXPLAIN " + pql).explain["servers"][0]["device"]["compile"]
    assert comp["state"] == "warm" and comp["firstCallMs"] > 0 and comp["launches"] == 1


def test_compile_timeline_cold_then_warm(explain_broker):
    broker, server = explain_broker, explain_broker.local_server
    pql = "SELECT max(metFloat) FROM expTable WHERE dimInt > 10"
    broker.handle_pql(pql)
    cold0 = server.metrics.meter("compile.cold").count
    assert cold0 >= 1 and server.metrics.timer("compile.firstCallMs").count == cold0
    broker.handle_pql(pql)
    assert server.metrics.meter("compile.cold").count == cold0
    assert server.metrics.meter("compile.warm").count >= 1


def test_explain_analyze_actuals_match_cost(explain_broker):
    broker = explain_broker
    pql = "SELECT sum(metInt) FROM expTable GROUP BY dimStr TOP 5"
    resp = broker.handle_pql("EXPLAIN ANALYZE " + pql)
    assert not resp.exceptions
    ex = resp.explain
    assert ex["mode"] == "analyze" and resp.aggregation_results is not None
    summed = {}
    for node in ex["servers"]:
        for k, v in node["actualCost"].items():
            summed[k] = summed.get(k, 0) + v
    assert set(summed) == set(resp.cost)
    for k, v in resp.cost.items():
        assert summed[k] == pytest.approx(v, rel=1e-9), k
    assert ex["actualDocsScanned"] == resp.num_docs_scanned
    assert ex["actualCost"] == {k: (round(v, 3) if isinstance(v, float) else v) for k, v in sorted(resp.cost.items())}
    node = ex["servers"][0]
    assert node["device"]["batching"]["actualBatchSize"] == 1 and node["device"]["compile"]["state"] == "warm"
    # the answer equals the plain query's
    plain = broker.handle_pql(pql)
    assert [a.to_json() for a in resp.aggregation_results] == [a.to_json() for a in plain.aggregation_results]


def test_explain_honest_about_poison_quarantine():
    segs = _port(EXP_REF)
    inj = DeviceFaultInjector()
    broker = _single_server_broker("expTable", segs, device_fault_injector=inj)
    server = broker.local_server
    try:
        pql = "SELECT sum(metInt) FROM expTable GROUP BY dimStr TOP 5"
        assert not broker.handle_pql(pql).exceptions
        pre = broker.handle_pql("EXPLAIN " + pql).explain["servers"][0]
        assert "segmentsHost" not in pre["tierCounts"]
        digest = pre["device"]["planDigest"]
        assert digest == inj.launches[-1].digest
        inj.poison_plan(digest)
        failed_over = broker.handle_pql(pql)
        assert not failed_over.exceptions and failed_over.cost.get("segmentsHost") == 2
        post = broker.handle_pql("EXPLAIN " + pql).explain["servers"][0]
        assert post["tierCounts"] == {"segmentsHost": 2} and post["device"]["quarantined"] is True
        assert all(s["tier"] == "host" and "quarantined" in s["reason"] for s in post["segments"])
        inj.heal()
        server.executor.clear_poisoned()
        cleared = broker.handle_pql("EXPLAIN " + pql).explain["servers"][0]
        assert "segmentsHost" not in cleared["tierCounts"] and cleared["device"]["quarantined"] is False
    finally:
        broker.shutdown()
        server.shutdown()


def test_explain_dump_renders_plan_and_analyze(explain_broker):
    broker = explain_broker
    pql = "SELECT sum(metInt) FROM expTable WHERE dimInt > 40"
    plan = broker.handle_pql("EXPLAIN " + pql).to_json()
    out = render_explain(plan)
    assert out.startswith("EXPLAIN ") and "digest=" in out and "server benchServer" in out
    assert "xga" in out and "xgb" in out
    assert out == ref_render_explain(plan)  # the reference's tool renders the port's tree alike
    out2 = render_explain(broker.handle_pql("EXPLAIN ANALYZE " + pql).to_json())
    assert "EXPLAIN ANALYZE" in out2 and "actual:" in out2 and "est=" in out2 and "x)" in out2
    assert render_explain({"numDocsScanned": 5}).startswith("(no explain tree")


# -- a port fleet behind the port broker and behind the reference broker
MIXED_SPLIT = {"serverA": [("segA", 0, 200)], "serverB": [("segB", 200, 400)]}
MIXED_ROWS = random_rows(MV_SCHEMA, 400, seed=9, cardinality=12)
MIXED_SEGMENTS = {server: [ref_build_segment(MV_SCHEMA, MIXED_ROWS[a:b], TABLE, name) for name, a, b in segs]
                  for server, segs in MIXED_SPLIT.items()}
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


def _mixed_fleet(broker_cls, routing_cls, transport_cls):
    servers = {name: ServerInstance(name, device="cpu") for name in MIXED_SPLIT}
    transport = transport_cls()
    counts = {}
    for name, server in servers.items():
        for seg in MIXED_SEGMENTS[name]:
            server.add_segment(TABLE, segment_from_arrays(**segment_arrays_of(seg)))
        counts[name] = _Counting(server)
        transport.register((name, 0), counts[name].handle)
    routing = routing_cls()
    routing.update(TABLE, {name: {server: "ONLINE"} for server, segs in MIXED_SPLIT.items() for name, _, _ in segs})
    broker = broker_cls(transport, {n: (n, 0) for n in MIXED_SPLIT}, routing=routing, timeout_ms=30_000)
    return broker, servers, counts


@pytest.fixture(scope="module", params=["port_broker", "reference_broker"])
def fleet(request):
    if request.param == "port_broker":
        broker, servers, counts = _mixed_fleet(BrokerRequestHandler, RoutingTableProvider, LocalTransport)
    else:
        broker, servers, counts = _mixed_fleet(RefBroker, RefRouting, RefLocal)
    yield request.param, broker, counts
    broker.shutdown()
    for server in servers.values():
        server.shutdown()


def _reset(counts):
    for c in counts.values():
        c.requests = c.executes = 0


@pytest.mark.parametrize("pql", EXPLAINS, ids=("explain", "plan_for", "analyze"))
def test_every_explain_form_answers_through_either_broker(fleet, pql):
    """Plain EXPLAIN: each port server answers its plan node without
    executing; ANALYZE: each executes once, and the results come back with
    the tree.  Behind the reference broker too, which reads the port
    servers' plan nodes off the wire."""
    _, broker, counts = fleet
    _reset(counts)
    resp = broker.handle_pql(pql)
    assert not resp.exceptions, resp.exceptions
    ex = resp.explain
    assert ex["numServers"] == 2 and sorted(n["server"] for n in ex["servers"]) == sorted(MIXED_SPLIT)
    assert sum(ex["tierCounts"].values()) == 2
    assert all(c.requests == 1 for c in counts.values())
    if ex["mode"] == "plan":
        assert sum(c.executes for c in counts.values()) == 0
        assert resp.aggregation_results is None and resp.selection_results is None
    else:
        assert sum(c.executes for c in counts.values()) == 2
        assert ex["actualDocsScanned"] == resp.num_docs_scanned == 400
        assert resp.aggregation_results


def test_a_plain_query_still_answers(fleet):
    _, broker, counts = fleet
    _reset(counts)
    resp = broker.handle_pql("SELECT count(*) FROM testTable")
    assert not resp.exceptions, resp.exceptions
    assert int(resp.aggregation_results[0].value) == 400
    assert sum(c.executes for c in counts.values()) == 2
