"""The postings tier: the port's ``segment/invindex.py`` and
``engine/invindex_path.py`` against the JAX package's, on the same seeded
segments (the port's datagen draws the reference's rows).

Postings compare exactly: offsets, the decoded row stream, each block's
container kind and arrays, widths and bytes.  ``index_path_decision``'s
verdicts compare as the same JSON-safe dicts.  The postings queries run
through both executors with their default switches: payloads compare with
the audit comparison at rel 1e-9 / abs 2e-5 (both sides aggregate the same
rows with numpy in float64), and the accounting the payload comparison
strips (``segmentsPostings``, ``numEntriesScannedInFilter``,
``bytesScanned``) compares exactly.
"""
import json
import threading

import numpy as np
import pytest

from pinot_tpu.engine.context import TableContext as RefContext
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.engine.invindex_path import index_path_decision as ref_index_path_decision
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment import invindex as ref_ii
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema as ref_make_test_schema
from pinot_tpu.tools.datagen import random_rows
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.engine import config, plan
from pinot_tpu_torch.engine.context import TableContext
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.invindex_path import index_path_decision, try_index_path
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment import invindex as ii
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.segment.invindex import InvertedIndex, inverted_index
from pinot_tpu_torch.tools.datagen import synthetic_lineitem_segment

REL, ABS = 1e-9, 2e-5

REF_SEGMENTS = [ref_synthetic(20000, seed=17 + i, name=f"ii{i}") for i in range(3)]
PORT_SEGMENTS = [synthetic_lineitem_segment(20000, seed=17 + i, name=f"ii{i}") for i in range(3)]
_MV_ROWS = random_rows(ref_make_test_schema(), 3000, seed=9, cardinality=400, mv_max=3)
REF_MV = [ref_build_segment(ref_make_test_schema(), _MV_ROWS[i * 1000:(i + 1) * 1000], "testTable", f"mv{i}")
          for i in range(3)]
PORT_MV = [segment_from_arrays(**segment_arrays_of(s)) for s in REF_MV]


def _pvals():
    d = PORT_SEGMENTS[0].column("l_extendedprice").dictionary
    return repr(d.get(100)), repr(d.get(2000))


def _assert_postings_equal(got: InvertedIndex, want) -> None:
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert got.offsets.dtype == want.offsets.dtype
    assert got.width == want.width and got.n_entries == want.n_entries and got.nbytes == want.nbytes
    np.testing.assert_array_equal(got.rows, want.rows)
    assert (got.blocks is None) == (want.blocks is None)
    for a, b in zip(got.blocks or (), want.blocks or ()):
        assert a.kind == b.kind
        np.testing.assert_array_equal(a.a, b.a)
        assert (a.b is None) == (b.b is None)
        if a.b is not None:
            np.testing.assert_array_equal(a.b, b.b)


# -- the index itself ---------------------------------------------------


@pytest.mark.parametrize("layout", ["clustered", "shuffled", "small"])
@pytest.mark.parametrize("compress", [True, False])
def test_sv_postings_equal_the_reference(layout, compress):
    rng = np.random.default_rng(3)
    n, card = {"clustered": (50_000, 100), "shuffled": (40_000, 7000), "small": (3000, 50)}[layout]
    fwd = rng.integers(0, card, n).astype(np.int32)
    if layout == "clustered":
        fwd = np.sort(fwd)
    got = InvertedIndex.build_sv(fwd, card, compress)
    want = ref_ii.InvertedIndex.build_sv(fwd, card, compress)
    _assert_postings_equal(got, want)
    if compress and layout != "small":
        kinds = {b.kind for b in got.blocks}
        assert kinds == ({ii._RUN} if layout == "clustered" else {ii._PACKED})
    for d in rng.integers(0, card, 6):
        t = np.zeros(card, bool)
        t[d] = True
        t[(d * 7) % card: (d * 7) % card + 3] = True
        np.testing.assert_array_equal(got.resolve_table(t), want.resolve_table(t))
        assert got.count_for_table(t) == want.count_for_table(t)
        assert got.slices_for_table(t) == want.slices_for_table(t)


@pytest.mark.parametrize("compress", [True, False])
def test_mv_postings_equal_the_reference(compress):
    mv_offsets = np.arange(0, 3 * 9001, 3, dtype=np.int32)
    mv_values = np.random.default_rng(5).integers(0, 50, mv_offsets[-1]).astype(np.int32)
    got = InvertedIndex.build_mv(mv_values, mv_offsets, 50, compress)
    want = ref_ii.InvertedIndex.build_mv(mv_values, mv_offsets, 50, compress)
    _assert_postings_equal(got, want)
    t = np.zeros(50, bool)
    t[[7, 31]] = True
    np.testing.assert_array_equal(got.resolve_table(t), want.resolve_table(t))
    # a doc matching several predicate values resolves once
    assert got.resolve_table(np.ones(50, bool)).size == 9000


@pytest.mark.parametrize("column", ["l_shipdate", "l_extendedprice", "l_quantity", "l_returnflag", "l_shipmode"])
def test_segment_postings_equal_the_reference(column):
    for ref_seg, port_seg in zip(REF_SEGMENTS, PORT_SEGMENTS):
        got, want = inverted_index(port_seg, column), ref_ii.inverted_index(ref_seg, column)
        _assert_postings_equal(got, want)
        assert inverted_index(port_seg, column) is got  # cached on the segment


@pytest.mark.parametrize("column", ["dimIntMV", "dimStrMV"])
def test_mv_segment_postings_equal_the_reference(column):
    for ref_seg, port_seg in zip(REF_MV, PORT_MV):
        _assert_postings_equal(inverted_index(port_seg, column), ref_ii.inverted_index(ref_seg, column))


def test_an_unknown_column_has_no_index():
    assert inverted_index(PORT_SEGMENTS[0], "noSuchColumn") is None


def test_cached_match_table_equals_match_table_and_caches_regex():
    from pinot_tpu_torch.common.request import FilterOperator

    req = optimize_request(parse_pql("SELECT count(*) FROM lineitem WHERE regexp_like(l_shipdate, '199[34].*5$')"))
    leaf = req.filter
    assert leaf.operator == FilterOperator.REGEX
    d = PORT_SEGMENTS[0].column("l_shipdate").dictionary
    key = (PORT_SEGMENTS[0].segment_name, PORT_SEGMENTS[0].metadata.crc, "l_shipdate")
    first = plan.cached_match_table(leaf, d, d.cardinality, cache_key=key)
    np.testing.assert_array_equal(first, plan.match_table(leaf, d, d.cardinality))
    assert plan.cached_match_table(leaf, d, d.cardinality, cache_key=key) is first
    assert plan.cached_match_table(leaf, d, d.cardinality, cache_key=None) is not first


# -- the budget ------------------------------------------------------------


def test_postings_budget_refusal_and_release(monkeypatch):
    """Over-budget builds are refused (stamped with the release epoch, not
    retried per query); a segment's unload returns its bytes and bumps
    the epoch, so the refusal is re-evaluated (tests/test_invindex.py's
    contract)."""
    from pinot_tpu_torch.server.datamanager import SegmentDataManager

    seg = synthetic_lineitem_segment(3000, seed=31, name="bud0")
    monkeypatch.setattr(ii, "_postings_bytes", 0)
    monkeypatch.setattr(config, "INVINDEX_BUDGET_BYTES", 64)
    assert inverted_index(seg, "l_extendedprice") is None
    refusal = seg._inv_cache["l_extendedprice"]
    assert refusal[0] == "refused"
    assert inverted_index(seg, "l_extendedprice") is None
    assert seg._inv_cache["l_extendedprice"] is refusal  # same epoch: not retried

    seg2 = synthetic_lineitem_segment(3000, seed=32, name="bud1")
    monkeypatch.setattr(config, "INVINDEX_BUDGET_BYTES", 64 << 20)
    idx = inverted_index(seg2, "l_extendedprice")
    assert idx is not None and ii.postings_bytes_in_use() == idx.nbytes
    assert SegmentDataManager(seg2).release() == 0  # the owner's reference: postings freed
    assert ii.postings_bytes_in_use() == 0 and seg2._inv_cache == {}
    assert inverted_index(seg, "l_extendedprice") is not None  # the epoch moved: rebuilt


def test_concurrent_index_builds_account_once(monkeypatch):
    """Concurrent cold builds of one (segment, column) account the bytes
    once and hand every caller the one cached index."""
    seg = synthetic_lineitem_segment(20000, seed=44, name="race0")
    monkeypatch.setattr(ii, "_postings_bytes", 0)
    monkeypatch.setattr(config, "INVINDEX_BUDGET_BYTES", 64 << 20)
    results = []
    barrier = threading.Barrier(8)

    def hit():
        barrier.wait()
        results.append(inverted_index(seg, "l_extendedprice"))

    threads = [threading.Thread(target=hit) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    cached = seg._inv_cache["l_extendedprice"]
    assert len(results) == 8 and all(r is cached for r in results)
    assert ii.postings_bytes_in_use() == cached.nbytes


# -- the decision ----------------------------------------------------------

DECISION_LEAVES = {
    "eq": "SELECT count(*) FROM lineitem WHERE l_extendedprice = {p0}",
    "in": "SELECT count(*) FROM lineitem WHERE l_extendedprice IN ({p0}, {p1})",
    "range": "SELECT count(*) FROM lineitem WHERE l_shipdate BETWEEN '1995-06-01' AND '1995-06-20'",
    "regex": "SELECT count(*) FROM lineitem WHERE regexp_like(l_shipdate, '1993-03-1.')",
    "and_residuals": "SELECT sum(l_quantity) FROM lineitem WHERE l_extendedprice = {p0} AND l_returnflag = 'R' "
    "AND l_shipmode NOT IN ('RAIL')",
    "or_not_drivable": "SELECT count(*) FROM lineitem WHERE l_extendedprice = {p0} OR l_returnflag = 'R'",
    "over_crossover": "SELECT count(*) FROM lineitem WHERE l_returnflag = 'R'",
    "negated_only": "SELECT count(*) FROM lineitem WHERE l_shipmode NOT IN ('RAIL')",
    "no_filter": "SELECT count(*) FROM lineitem",
    "needle_mv": "SELECT count(*) FROM testTable WHERE dimIntMV IN ({m0})",
}


def _fill(pql):
    p0, p1 = _pvals()
    m0 = REF_MV[0].column("dimIntMV").dictionary.get(5)
    return pql.format(p0=p0, p1=p1, m0=m0)


@pytest.mark.parametrize("name", sorted(DECISION_LEAVES))
def test_index_path_decision_equals_the_reference(name):
    pql = _fill(DECISION_LEAVES[name])
    ref_segs, port_segs = (REF_MV, PORT_MV) if "testTable" in pql else (REF_SEGMENTS, PORT_SEGMENTS)
    total = sum(s.num_docs for s in ref_segs)
    want, _ = ref_index_path_decision(ref_optimize(ref_parse(pql)), ref_segs, RefContext(ref_segs), total)
    got, state = index_path_decision(optimize_request(parse_pql(pql)), port_segs, TableContext(port_segs), total)
    assert json.loads(json.dumps(got)) == got  # JSON-safe, for EXPLAIN
    assert got == want
    assert (state is not None) == got["taken"]


def test_the_switch_and_a_fixed_limit_decline(monkeypatch):
    pql = _fill(DECISION_LEAVES["eq"])
    req = optimize_request(parse_pql(pql))
    ctx = TableContext(PORT_SEGMENTS)
    got, state = index_path_decision(req, PORT_SEGMENTS, ctx, 60000, enabled=False)
    assert not got["taken"] and state is None and "postings=False" in got["reason"]
    assert try_index_path(req, PORT_SEGMENTS, ctx, 60000, None) is not None
    monkeypatch.setattr(config, "INDEX_MAX_MATCHES", 1)
    monkeypatch.setenv("PINOT_TPU_INDEX_MAX_MATCHES", "1")
    assert try_index_path(req, PORT_SEGMENTS, ctx, 60000, None) is None
    want, _ = ref_index_path_decision(ref_optimize(ref_parse(pql)), REF_SEGMENTS, RefContext(REF_SEGMENTS), 60000)
    assert index_path_decision(req, PORT_SEGMENTS, ctx, 60000)[0] == want


def test_the_cost_model_constants_move_the_crossover(monkeypatch):
    from pinot_tpu_torch.engine import tiercost

    for n in (0, 63, 64, 6400, 16_777_216):
        assert tiercost.postings_max_matches(n) == n // 64
    monkeypatch.setattr(config, "POSTINGS_MATCH_FRACTION", 0.5)
    assert tiercost.postings_max_matches(100) == 50
    monkeypatch.setattr(config, "BSI_MAX_PLANES", 3)
    assert tiercost.bsi_max_planes() == 3


# -- through both executors ------------------------------------------------

# tests/test_invindex.py's selective queries, the zone-map tests' needle
# queries (the reference answers them from postings by default) and MV needles
POSTINGS_QUERIES = {
    "eq_count": "SELECT count(*) FROM lineitem WHERE l_extendedprice = {p0}",
    "eq_sum_avg": "SELECT sum(l_quantity), avg(l_tax) FROM lineitem WHERE l_extendedprice = {p0}",
    "in_min_max": "SELECT min(l_quantity), max(l_quantity) FROM lineitem WHERE l_extendedprice IN ({p0}, {p1})",
    "residual_eq": "SELECT count(*) FROM lineitem WHERE l_extendedprice = {p0} AND l_returnflag = 'R'",
    "residual_not_in": "SELECT sum(l_discount) FROM lineitem WHERE l_extendedprice = {p0} "
    "AND l_shipmode NOT IN ('RAIL')",
    "groupby": "SELECT sum(l_quantity) FROM lineitem WHERE l_extendedprice = {p0} GROUP BY l_returnflag TOP 10",
    "selection": "SELECT l_returnflag, l_quantity FROM lineitem WHERE l_extendedprice = {p0} "
    "ORDER BY l_quantity DESC LIMIT 5",
    "zone_eq": "SELECT sum(l_extendedprice) FROM lineitem WHERE l_shipdate = '1995-06-14'",
    "zone_in": "SELECT sum(l_quantity), sum(l_extendedprice), sum(l_discount), count(*) FROM lineitem "
    "WHERE l_shipdate IN ('1993-03-14','1995-06-14','1997-09-14') GROUP BY l_returnflag, l_linestatus TOP 10",
    "zone_distinct": "SELECT distinctcount(l_extendedprice) FROM lineitem "
    "WHERE l_shipdate IN ('1993-03-14','1995-06-14','1997-09-14')",
    "regex": "SELECT count(*), max(l_tax) FROM lineitem WHERE regexp_like(l_shipdate, '1993-03-1.')",
    "empty": "SELECT distinctcount(l_tax), percentile90(l_quantity) FROM lineitem WHERE l_shipmode = 'BOAT'",
    "mv_any": "SELECT sum(metInt), count(*) FROM testTable WHERE dimIntMV IN ({m0}) GROUP BY dimStr TOP 5",
    "mv_residual": "SELECT count(*), max(metInt) FROM testTable WHERE dimIntMV = {m0} AND dimStrMV <> 'zz'",
}


@pytest.mark.parametrize("name", sorted(POSTINGS_QUERIES))
def test_postings_queries_equal_the_reference_and_its_accounting(name):
    pql = _fill(POSTINGS_QUERIES[name])
    ref_segs, port_segs = (REF_MV, PORT_MV) if "testTable" in pql else (REF_SEGMENTS, PORT_SEGMENTS)
    ref_req = ref_optimize(ref_parse(pql))
    ref_res = RefExecutor().execute(ref_segs, ref_req)
    req = optimize_request(parse_pql(pql))
    res = QueryExecutor(device="cpu").execute(port_segs, req)
    got = strip_accounting(reduce_to_response(req, [res]).to_json())
    assert payloads_equivalent(got, canonical_payload(ref_req, ref_res), rel_tol=REL, abs_tol=ABS), (pql, got)
    assert res._served_tier == ref_res._served_tier == "postings"
    assert res.cost["segmentsPostings"] == ref_res.cost["segmentsPostings"] == len(port_segs)
    assert "segmentsHost" not in res.cost and "deviceMs" not in res.cost
    assert res.num_entries_scanned_in_filter == ref_res.num_entries_scanned_in_filter
    assert res.cost["bytesScanned"] == ref_res.cost["bytesScanned"]
    assert res.num_docs_scanned == ref_res.num_docs_scanned


def test_the_postings_switch_sends_the_query_to_the_device():
    pql = _fill(POSTINGS_QUERIES["eq_sum_avg"])
    req = optimize_request(parse_pql(pql))
    on = QueryExecutor(device="cpu").execute(PORT_SEGMENTS, req)
    off = QueryExecutor(device="cpu", postings=False).execute(PORT_SEGMENTS, optimize_request(parse_pql(pql)))
    assert on._served_tier == "postings" and off._served_tier == "device"
    assert "segmentsPostings" not in off.cost and off.cost.get("segmentsFullScan") == len(PORT_SEGMENTS)
    a = strip_accounting(reduce_to_response(req, [on]).to_json())
    b = strip_accounting(reduce_to_response(req, [off]).to_json())
    assert payloads_equivalent(a, b, rel_tol=REL, abs_tol=ABS)


# -- the server ------------------------------------------------------------


def test_configured_inverted_index_columns_warm_at_load(tmp_path):
    """``invertedIndexColumns`` in the table config: the in-process
    starter builds those postings when it loads the segment, and a
    dropped segment returns them to the budget."""
    from pinot_tpu_torch.common.tableconfig import IndexingConfig, TableConfig
    from pinot_tpu_torch.controller.controller import Controller
    from pinot_tpu_torch.server.instance import ServerInstance
    from pinot_tpu_torch.server.starter import ServerStarter
    from pinot_tpu_torch.tools.datagen import lineitem_schema

    ctrl = Controller(str(tmp_path / "controller"))
    server = ServerInstance("warm0", device="cpu", precision="x64")
    try:
        ServerStarter(server, ctrl.resources).start()
        ctrl.add_schema(lineitem_schema())
        ctrl.add_table(TableConfig("lineitem", indexing=IndexingConfig(
            inverted_index_columns=["l_extendedprice", "noSuchColumn"])))
        ctrl.upload_segment("lineitem_OFFLINE", synthetic_lineitem_segment(5000, seed=5, name="warm0"))
        tdm = server.data_manager.table("lineitem_OFFLINE")
        (sdm,) = tdm.acquire_segments(tdm.segment_names())
        try:
            seg = sdm.query_view()
            cache = getattr(seg, "_inv_cache", {})
            assert isinstance(cache.get("l_extendedprice"), InvertedIndex), "postings not warmed at load"
            assert "noSuchColumn" not in cache
        finally:
            tdm.release_segments([sdm])
        ctrl.delete_segment("lineitem_OFFLINE", "warm0")
        assert seg._inv_cache == {}
    finally:
        server.shutdown()


def test_a_port_server_behind_a_reference_broker_carries_segments_postings():
    from pinot_tpu.broker.broker import BrokerRequestHandler as RefBroker
    from pinot_tpu.broker.routing import RoutingTableProvider as RefRouting
    from pinot_tpu.transport.local import LocalTransport as RefLocal

    from pinot_tpu_torch.server.instance import ServerInstance

    server = ServerInstance("s0", device="cpu", precision="x64")
    for seg in PORT_SEGMENTS:
        server.add_segment("lineitem", seg)
    transport = RefLocal()
    transport.register(("s0", 0), server.handle_request)
    routing = RefRouting()
    routing.update("lineitem", {s.segment_name: {"s0": "ONLINE"} for s in PORT_SEGMENTS})
    broker = RefBroker(transport, {"s0": ("s0", 0)}, routing=routing, timeout_ms=30_000)
    try:
        resp = broker.handle_pql(_fill(POSTINGS_QUERIES["zone_eq"])).to_json()
        assert not resp["exceptions"], resp["exceptions"]
        assert resp["cost"]["segmentsPostings"] == len(PORT_SEGMENTS)
        assert server.metrics.meter("cost.tier.segmentsPostings").count == len(PORT_SEGMENTS)
    finally:
        broker.shutdown()
        server.shutdown()


def test_a_server_marks_the_postings_tier_meter():
    """The default route of test_torch_cost_keys.py's one-date query: a
    port server answers it from postings, as a reference server does."""
    from pinot_tpu_torch.broker.broker import BrokerRequestHandler
    from pinot_tpu_torch.broker.routing import RoutingTableProvider
    from pinot_tpu_torch.engine.results import SEGMENT_TIER_KEYS
    from pinot_tpu_torch.server.instance import ServerInstance
    from pinot_tpu_torch.transport.local import LocalTransport

    server = ServerInstance("s0", device="cpu")
    transport = LocalTransport()
    transport.register(("s0", 0), server.handle_request)
    routing = RoutingTableProvider()
    routing.update("lineitem", {s.segment_name: {"s0": "ONLINE"} for s in PORT_SEGMENTS})
    broker = BrokerRequestHandler(transport, {"s0": ("s0", 0)}, routing=routing, timeout_ms=30_000)
    try:
        for seg in PORT_SEGMENTS:
            server.add_segment("lineitem", seg)
        resp = broker.handle_pql(_fill(POSTINGS_QUERIES["zone_eq"]))
        assert not resp.exceptions, resp.exceptions
        assert resp.cost["segmentsPostings"] == len(PORT_SEGMENTS)
        counts = {k: server.metrics.meter(f"cost.tier.{k}").count for k in SEGMENT_TIER_KEYS}
        assert counts == {k: (len(PORT_SEGMENTS) if k == "segmentsPostings" else 0) for k in SEGMENT_TIER_KEYS}
        assert server.status()["lane"]["dispatches"] == 0  # nothing launched
    finally:
        broker.shutdown()
        server.shutdown()
