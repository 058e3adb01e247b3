"""The port's result cache (``engine/rescache.py`` and its wiring in
``ServerInstance``), the twin of ``tests/test_batching.py:354-449`` (the
four cache cases) and ``tests/test_join.py:843`` (the colocated join's
key over both tables), on port servers on the CPU.

A hit answers byte-for-byte what the miss that stored it answered, with
the cost ``{"rescacheHits": 1}``, and launches nothing: neither the lane
nor the K1 / K2 wrappers count a call.  Every miss equals the JAX
package's answer on the same rows (``payloads_equivalent``: rel 5e-4, abs
1e-3 for sums; counts exact).  A segment set change and an LLC offset
advance drop the table's entries; a new data generation gets a new
staging token, so:

- after ``AddSchema`` patches default columns into a loaded segment, the
  next answer is the re-execution's (the reference's cache keeps serving
  the pre-schema answer there: a fault of the reference, recorded in
  ``ROADMAP.md`` queue 3, kept divergence 19);
- a table demoted off the card and promoted back is the same generation
  and still hits.

Stored entries hold host data only: a result holding a tensor is refused.
"""
import json
import time

import pytest
import torch

from pinot_tpu.common.schema import DataType as RefDataType
from pinot_tpu.common.schema import FieldSpec as RefFieldSpec
from pinot_tpu.common.schema import FieldType as RefFieldType
from pinot_tpu.common.schema import Schema as RefSchema
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.cluster_harness import InProcessCluster as RefCluster
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.utils.audit import canonical_payload as ref_canonical_payload
from pinot_tpu.utils.audit import payloads_equivalent, strip_accounting

from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.tableconfig import PartitionConfig
from pinot_tpu_torch.engine.kernels import fused_groupby, value_state_counts
from pinot_tpu_torch.engine.rescache import ResultCache
from pinot_tpu_torch.engine.results import IntermediateResult
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.realtime.llc import make_segment_name
from pinot_tpu_torch.realtime.stream import MemoryStreamProvider
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.tools.cluster_harness import InProcessCluster, single_server_broker

REL, ABS = 5e-4, 1e-3
REF_SCHEMA = make_test_schema(with_mv=False)
SCHEMA = Schema.from_json(REF_SCHEMA.to_json())
ROWS = random_rows(REF_SCHEMA, 2000, seed=9)
TABLE = "testTable"
QUERIES = [
    "SELECT sum(metInt), count(*) FROM testTable WHERE dimInt > 4800",
    "SELECT sum(metFloat), count(*) FROM testTable GROUP BY dimStr TOP 5",
    "SELECT distinctcount(dimLong) FROM testTable WHERE dimInt > 1000 GROUP BY dimStr TOP 5",
    "SELECT distinctcounthll(dimInt), percentile50(metInt) FROM testTable",
    "SELECT dimStr, metInt FROM testTable WHERE dimInt > 4000 ORDER BY metInt DESC LIMIT 7",
]


def _payload(resp) -> str:
    """The client payload but wall clock, request id and the cost vector."""
    return json.dumps({k: v for k, v in resp.to_json().items()
                       if k not in ("timeUsedMs", "requestId", "cost")}, sort_keys=True)


def _result_sections(resp):
    """The result sections only (tests/test_join.py): a join's totalDocs
    counts the rows its phases touched."""
    return {k: v for k, v in strip_accounting(resp.to_json()).items()
            if k in ("aggregationResults", "selectionResults", "exceptions")}


def _reference(pql, rows=ROWS):
    segs = [ref_build_segment(REF_SCHEMA, rows[:1000], TABLE, "bt0"),
            ref_build_segment(REF_SCHEMA, rows[1000:], TABLE, "bt1")]
    req = ref_optimize(ref_parse(pql))
    return ref_canonical_payload(req, RefExecutor().execute(segs, req))


@pytest.fixture
def stack(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "1")
    monkeypatch.setenv("PINOT_TPU_AUDIT_SAMPLE_N", "0")  # no background oracle in the launch counts
    broker = single_server_broker(TABLE, [build_segment(SCHEMA, ROWS[:1000], TABLE, "bt0"),
                                          build_segment(SCHEMA, ROWS[1000:], TABLE, "bt1")], device="cpu")
    yield broker, broker.local_servers[0]
    broker.shutdown()
    broker.local_servers[0].shutdown()


def _launches():
    return (fused_groupby.launches, value_state_counts.launches,
            fused_groupby.batched_launches, value_state_counts.batched_launches)


@pytest.mark.parametrize("pql", QUERIES, ids=["scalar", "groupby", "distinct", "hll_pct", "selection"])
def test_cache_hit_identical_payload_and_zero_device_work(stack, pql):
    """The miss equals the reference; the hit is its byte-identical
    payload with the cost ``{"rescacheHits": 1}``, and neither the lane
    nor a kernel wrapper counts a call for it."""
    broker, server = stack
    r1 = broker.handle_pql(pql)
    assert not r1.exceptions and "rescacheHits" not in r1.cost
    assert payloads_equivalent(strip_accounting(r1.to_json()), _reference(pql), rel_tol=REL, abs_tol=ABS)
    d1, k1 = server.lane.dispatch_count, _launches()
    r2 = broker.handle_pql(pql)
    assert not r2.exceptions and r2.cost == {"rescacheHits": 1}, r2.cost
    assert _payload(r1) == _payload(r2)
    assert server.lane.dispatch_count == d1 and _launches() == k1
    snap = server.result_cache.snapshot()
    assert snap["hits"] == 1 and snap["puts"] == 1 and snap["misses"] == 1
    if "4800" in pql:
        # distinct literals are distinct entries, never cross-served
        assert "rescacheHits" not in broker.handle_pql(pql.replace("4800", "1200")).cost


def test_cache_disabled_by_default(monkeypatch):
    monkeypatch.delenv("PINOT_TPU_RESULT_CACHE", raising=False)
    broker = single_server_broker(TABLE, [build_segment(SCHEMA, ROWS, TABLE, "bt0")], device="cpu")
    server = broker.local_servers[0]
    try:
        for _ in range(2):
            assert "rescacheHits" not in broker.handle_pql("SELECT count(*) FROM testTable").cost
        snap = server.result_cache.snapshot()
        assert snap["enabled"] is False and snap["puts"] == 0
        assert (snap["maxEntries"], snap["maxBytes"]) == (512, 64 << 20)
    finally:
        broker.shutdown()
        server.shutdown()


def test_segment_set_change_invalidates_cache(stack):
    broker, server = stack
    q = "SELECT count(*) FROM testTable"
    r1 = broker.handle_pql(q)
    assert server.result_cache.entry_count() == 1
    server.add_segment("testTable", build_segment(SCHEMA, random_rows(REF_SCHEMA, 50, seed=4), TABLE, "btX"))
    assert server.result_cache.entry_count() == 0
    r2 = broker.handle_pql(q)  # the broker still routes the old cover
    assert "rescacheHits" not in r2.cost and r2.num_docs_scanned == r1.num_docs_scanned
    server.remove_segment("testTable", "btX")
    assert server.result_cache.entry_count() == 0


def test_cache_invalidated_by_llc_offset_advance(tmp_path, monkeypatch):
    """A cached realtime answer is dropped the moment the covering LLC
    consume offset advances; the next answer sees the new rows."""
    from tests.test_torch_realtime import make_row, rsvp_schema

    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "1")
    cluster = InProcessCluster(num_servers=1, data_dir=str(tmp_path), device="cpu")
    try:
        stream = MemoryStreamProvider(num_partitions=1)
        physical = cluster.add_realtime_table(rsvp_schema(), stream, rows_per_segment=500)
        for i in range(120):
            stream.produce(make_row(i))
        (dm,) = cluster.controller.realtime_manager.consumers_of(make_segment_name(physical, 0, 0))
        dm.consume_step(max_rows=30)
        q = "SELECT count(*) FROM meetupRsvp"
        server = cluster.servers[0]
        assert cluster.query(q).num_docs_scanned == 30
        r2 = cluster.query(q)
        assert r2.num_docs_scanned == 30 and r2.cost.get("rescacheHits") == 1, r2.cost
        evicted = server.result_cache.snapshot()["staleEvictions"]
        dm.consume_step(max_rows=20)
        snap = server.result_cache.snapshot()
        assert snap["entries"] == 0 and snap["staleEvictions"] > evicted
        r3 = cluster.query(q)
        assert "rescacheHits" not in r3.cost and r3.num_docs_scanned == 50
    finally:
        cluster.stop()


def _fact_schema(name):
    return RefSchema(name, dimensions=[RefFieldSpec("k", RefDataType.INT, RefFieldType.DIMENSION),
                                       RefFieldSpec("grp", RefDataType.STRING, RefFieldType.DIMENSION)],
                     metrics=[RefFieldSpec("v", RefDataType.INT, RefFieldType.METRIC)])


def _dim_schema(name):
    return RefSchema(name, dimensions=[RefFieldSpec("k", RefDataType.INT, RefFieldType.DIMENSION),
                                       RefFieldSpec("cat", RefDataType.STRING, RefFieldType.DIMENSION)],
                     metrics=[RefFieldSpec("w", RefDataType.INT, RefFieldType.METRIC)])


def test_colocated_join_result_cache_keys_both_tables(tmp_path, monkeypatch):
    """The colocated join's entry keys on both sides' data generations: the
    hit is byte-identical, and a segment change on the BUILD side drops it;
    every answer equals the reference cluster's."""
    import numpy as np

    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "1")
    rng = np.random.default_rng(4)
    fact = [{"k": int(k), "grp": f"g{int(k) % 3}", "v": int(v)}
            for k, v in zip(rng.integers(0, 20, 400), rng.integers(0, 100, 400))]
    dim = [{"k": k, "cat": f"c{k % 5}", "w": (k * 3) % 41} for k in range(20)]
    q = "SELECT count(*), sum(f.v) FROM fC f JOIN dC d ON f.k = d.k"
    from pinot_tpu.common.tableconfig import PartitionConfig as RefPartitionConfig

    port = InProcessCluster(num_servers=1, data_dir=str(tmp_path / "p"), device="cpu")
    ref = RefCluster(num_servers=1, data_dir=str(tmp_path / "r"))
    try:
        for cl, conv, build, part in ((port, lambda s: Schema.from_json(s.to_json()), build_segment, PartitionConfig),
                                      (ref, lambda s: s, ref_build_segment, RefPartitionConfig)):
            p = part(column="k", num_partitions=1)
            cl.add_offline_table(conv(_fact_schema("fC")), table_name="fC", replication=1, partitioning=p)
            cl.add_offline_table(conv(_dim_schema("dC")), table_name="dC", replication=1, partitioning=p)
            cl.upload("fC_OFFLINE", build(conv(_fact_schema("fC")), fact, "fC_OFFLINE", segment_name="fC_0_p0"))
            cl.upload("dC_OFFLINE", build(conv(_dim_schema("dC")), dim, "dC_OFFLINE", segment_name="dC_0_p0"))
        r1 = port.broker.handle_pql(q)
        assert not r1.exceptions and "rescacheHits" not in r1.cost
        want = _result_sections(ref.broker.handle_pql(q))
        assert payloads_equivalent(_result_sections(r1), want, rel_tol=REL, abs_tol=ABS)
        r2 = port.broker.handle_pql(q)
        assert r2.cost == {"rescacheHits": 1}, r2.cost
        assert _payload(r2) == _payload(r1)
        evictions = port.servers[0].metrics.meter("rescache.staleEvictions").count
        extra = [{"k": 5, "cat": "c0", "w": 40}]
        port.upload("dC_OFFLINE", build_segment(Schema.from_json(_dim_schema("dC").to_json()), extra, "dC_OFFLINE",
                                                segment_name="dC_1_p0"))
        ref.upload("dC_OFFLINE", ref_build_segment(_dim_schema("dC"), extra, "dC_OFFLINE", segment_name="dC_1_p0"))
        assert port.servers[0].metrics.meter("rescache.staleEvictions").count > evictions
        r3 = port.broker.handle_pql(q)
        assert not r3.exceptions and "rescacheHits" not in r3.cost
        assert payloads_equivalent(_result_sections(r3), _result_sections(ref.broker.handle_pql(q)),
                                   rel_tol=REL, abs_tol=ABS)
        assert r3.aggregation_results[0].value != r1.aggregation_results[0].value
    finally:
        port.stop()
        ref.stop()


def test_key_for_join_equals_the_references_key_shape():
    """Both keys name (probe raw table, build raw table), the shape and
    literal digests and each side's (segment, token) fence, sorted."""
    from pinot_tpu.engine.rescache import ResultCache as RefResultCache

    class _View:
        def __init__(self, name, token):
            self.segment_name, self.staging_token = name, token

    q = "SELECT count(*) FROM fC f JOIN dC d ON f.k = d.k"
    probe, build = [_View("p1", 7), _View("p0", 3)], [_View("b0", 9)]
    got = ResultCache.key_for_join(optimize_request(parse_pql(q)), probe, build, "fC_OFFLINE", "dC_OFFLINE")
    want = RefResultCache.key_for_join(ref_optimize(ref_parse(q)), probe, build, "fC_OFFLINE", "dC_OFFLINE")
    assert got == want
    assert got[0] == ("fC", "dC") and got[3] == (("p0", 3), ("p1", 7)) and got[4] == (("b0", 9),)


def _grown(base):
    return RefSchema(base.schema_name,
                     dimensions=list(base.dimensions) + [RefFieldSpec("newDim", RefDataType.STRING,
                                                                      RefFieldType.DIMENSION)],
                     metrics=list(base.metrics), time_field=base.time_field)


def test_a_cached_answer_never_outlives_add_schema(tmp_path, monkeypatch):
    """Before ``AddSchema`` the old segment lacks ``newDim`` and is pruned
    (0); the answer is cached.  ``AddSchema`` patches the default column
    in (a new staging token), so the next answer is the re-execution's,
    60, as the reference answers without its cache.  The reference's own
    cache still serves 0 there (its fault, recorded)."""
    monkeypatch.setenv("PINOT_TPU_RESULT_CACHE", "1")
    q = "SELECT count(*) FROM testTable WHERE newDim = 'null'"
    rows = random_rows(REF_SCHEMA, 60, seed=1)
    port = InProcessCluster(num_servers=1, data_dir=str(tmp_path / "p"), device="cpu")
    ref = RefCluster(num_servers=1, data_dir=str(tmp_path / "r"))
    try:
        for cl, schema, build in ((port, SCHEMA, build_segment), (ref, REF_SCHEMA, ref_build_segment)):
            phys = cl.add_offline_table(schema, replication=1)
            cl.upload(phys, build(schema, rows, phys, "old"))
            assert cl.query(q).aggregation_results[0].value in (0, "0")
            assert cl.query(q).cost == {"rescacheHits": 1}
        seg = port.servers[0].data_manager.table("testTable_OFFLINE").acquire_segments()
        token = seg[0].segment.staging_token
        port.servers[0].data_manager.table("testTable_OFFLINE").release_segments(seg)
        port.controller.add_schema(Schema.from_json(_grown(REF_SCHEMA).to_json()))
        ref.controller.add_schema(_grown(REF_SCHEMA))
        got = port.query(q)
        assert "rescacheHits" not in got.cost and int(got.aggregation_results[0].value) == 60
        seg = port.servers[0].data_manager.table("testTable_OFFLINE").acquire_segments()
        assert seg[0].segment.staging_token != token
        port.servers[0].data_manager.table("testTable_OFFLINE").release_segments(seg)
        assert port.query(q).cost == {"rescacheHits": 1}
        # the reference's cache keeps the pre-schema answer; re-executed, it is 60
        stale = ref.query(q)
        assert stale.cost == {"rescacheHits": 1} and int(stale.aggregation_results[0].value) == 0
        ref.servers[0].result_cache.clear()
        assert int(ref.query(q).aggregation_results[0].value) == 60
    finally:
        port.stop()
        ref.stop()


def test_a_promoted_table_is_the_same_generation_and_hits(stack):
    """Demoting the staged table off the card changes no segment's token,
    so the cached answer still hits; with the entry dropped, the next miss
    promotes the table back and stores the same payload again."""
    broker, server = stack
    q = QUERIES[1]
    r1 = broker.handle_pql(q)
    tiers = server.executor.residency
    tiers.hbm_cap_bytes = 1
    assert tiers.enforce() > 0 and tiers.snapshot()["warmTables"] >= 1
    tiers.hbm_cap_bytes = 0
    r2 = broker.handle_pql(q)
    assert r2.cost == {"rescacheHits": 1} and _payload(r2) == _payload(r1)
    assert tiers.counter("promotions") == 0
    server.result_cache.clear()
    r3 = broker.handle_pql(q)
    assert "rescacheHits" not in r3.cost and tiers.counter("promotions") == 1
    assert _payload(r3) == _payload(r1)
    assert broker.handle_pql(q).cost == {"rescacheHits": 1}


def test_a_result_holding_a_tensor_is_never_stored():
    cache = ResultCache(enabled=True)
    res = IntermediateResult(num_docs_scanned=3)
    res.stray = torch.zeros(2)
    cache.put(("t", "d", "l", ()), res)
    assert cache.entry_count() == 0
    del res.stray
    res.trace = {"s": [1]}
    cache.put(("t", "d", "l", ()), res)
    hit = cache.get(("t", "d", "l", ()))
    assert hit.cost == {"rescacheHits": 1} and hit.trace == {} and res.trace == {"s": [1]}
