"""The port's star-tree tier (``startree/``, the segment file's cube
buffers, ``segment/convert.py``'s carry, the executor's star / scan split)
against the JAX package's, on the same seeded inputs.

- The builder: on ``tests/test_startree.py``'s schema, on baseball and
  on ad-events with HLL registers (and with ``skip_star_for_dims``), the
  port's cube arrays, registers, node tree and ``custom["starTree"]``
  equal the reference's exactly (host numpy in both packages).
- The operator: every ``tests/test_startree.py::STAR_QUERIES`` template
  and the ad-events HLL query through both executors as a client payload
  (``canonical_payload`` / ``payloads_equivalent`` in x64: counts, HLL
  and group order exact, float sums within rel 1e-9 / abs 2e-5), with the
  accounting ``strip_accounting`` hides asserted on its own
  (``numDocsScanned`` as cube rows visited, ``numSegmentsQueried``,
  ``cost.segmentsStarTree``).
- The split: a query that is not star-fit scans; a table of a star-tree
  segment and a plain one merges the cube's partial with the scan's;
  only the plain segments are staged.
- Files: a star-tree segment file written by either package is read by
  the other, byte for byte the same file, with an equal tree and CRC.
- Serving: a star-tree table on two port servers behind the port broker,
  and a port server behind the reference broker, answer as the
  reference's cluster does, ``segmentsStarTree`` carried on the wire.
"""
import json
import os

import numpy as np
import pytest

from pinot_tpu.broker.broker import BrokerRequestHandler as RefBroker
from pinot_tpu.broker.routing import RoutingTableProvider as RefRouting
from pinot_tpu.common.schema import DataType as RefDataType
from pinot_tpu.common.schema import FieldSpec as RefFieldSpec
from pinot_tpu.common.schema import FieldType as RefFieldType
from pinot_tpu.common.schema import Schema as RefSchema
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.segment.format import read_segment as ref_read
from pinot_tpu.segment.format import verify_segment_crc as ref_verify
from pinot_tpu.segment.format import write_segment as ref_write
from pinot_tpu.server.instance import ServerInstance as RefServer
from pinot_tpu.startree import StarTreeBuilderConfig as RefConfig
from pinot_tpu.startree import build_star_tree as ref_build_star_tree
from pinot_tpu.startree.index import StarTreeIndex as RefIndex
from pinot_tpu.startree.index import StarTreeNode as RefNode
from pinot_tpu.tools.datagen import adevents_schema as ref_adevents_schema
from pinot_tpu.tools.datagen import baseball_rows, baseball_schema, random_rows
from pinot_tpu.tools.datagen import synthetic_adevents_segment as ref_adevents
from pinot_tpu.transport.local import LocalTransport as RefLocal
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.broker.broker import BrokerRequestHandler
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.segment.fetcher import SegmentFetcherFactory
from pinot_tpu_torch.segment.format import SEGMENT_FILE_NAME, read_segment, verify_segment_crc, write_segment
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.startree import STAR, StarTreeBuilderConfig, build_star_tree, is_fit_for_star_tree
from pinot_tpu_torch.transport.local import LocalTransport

REL, ABS = 1e-9, 2e-5

# tests/test_startree.py's schema, rows and templates
ST_SCHEMA = RefSchema(
    "st",
    dimensions=[
        RefFieldSpec("d1", RefDataType.STRING),
        RefFieldSpec("d2", RefDataType.STRING),
        RefFieldSpec("d3", RefDataType.INT),
    ],
    metrics=[
        RefFieldSpec("m1", RefDataType.INT, RefFieldType.METRIC),
        RefFieldSpec("m2", RefDataType.DOUBLE, RefFieldType.METRIC),
    ],
)
ST_ROWS = random_rows(ST_SCHEMA, 2000, seed=31, cardinality=8)
STAR_QUERIES = [
    "SELECT sum(m1), sum(m2) FROM st",
    "SELECT count(*) FROM st",
    "SELECT sum(m1) FROM st WHERE d1 = '{d1v}'",
    "SELECT sum(m2), count(*) FROM st WHERE d1 = '{d1v}' AND d2 = '{d2v}'",
    "SELECT sum(m1) FROM st WHERE d1 IN ('{d1v}', '{d1w}')",
    "SELECT sum(m1) FROM st GROUP BY d2 TOP 50",
    "SELECT count(*), avg(m2) FROM st WHERE d2 = '{d2v}' GROUP BY d1 TOP 50",
    "SELECT sum(m1) FROM st GROUP BY d1, d2 TOP 1000",
    "SELECT sum(m1), count(*) FROM st WHERE d3 <= '{d3v}'",
    "SELECT sum(m2) FROM st WHERE d1 = '{d1v}' AND d3 > '{d3v}'",
    "SELECT count(*) FROM st WHERE d3 BETWEEN '{d3v}' AND '{d3w}' GROUP BY d1 TOP 50",
]
NOT_FIT = [
    "SELECT min(m1) FROM st",
    "SELECT distinctcount(d1) FROM st",
    "SELECT sum(m1) FROM st WHERE d1 = '{d1v}' OR d2 = '{d2v}'",
]
ADEVENTS_HLL = "SELECT distinctcounthll(user_id), count(*) FROM adevents GROUP BY campaign_id TOP 5"
AD_CONFIG = dict(split_order=["campaign_id", "site_id"], hll_columns=["user_id"], max_leaf_records=16)


def _fill(q, rows=ST_ROWS):
    d3s = sorted(r["d3"] for r in rows)
    return q.format(d1v=rows[0]["d1"], d1w=rows[1]["d1"], d2v=rows[0]["d2"],
                    d3v=d3s[len(d3s) // 3], d3w=d3s[2 * len(d3s) // 3])


def _port_schema(ref_schema):
    return Schema.from_json(ref_schema.to_json())


def _port_copy(ref_seg):
    """The port's segment of the same columns, with no star-tree."""
    spec = segment_arrays_of(ref_seg)
    spec["star_tree"] = None
    return segment_from_arrays(**spec)


def _pair(ref_schema, ref_seg_fn, **cfg):
    """(reference segment, port segment): the same columns, each tree
    built by its own package's builder."""
    ref_seg = ref_seg_fn()
    port_seg = _port_copy(ref_seg)
    ref_build_star_tree(ref_seg, ref_schema, RefConfig(**cfg))
    build_star_tree(port_seg, _port_schema(ref_schema), StarTreeBuilderConfig(**cfg))
    return ref_seg, port_seg


CASES = {
    "st": (ST_SCHEMA, lambda: ref_build_segment(ST_SCHEMA, ST_ROWS, "st", "stseg"),
           dict(max_leaf_records=10)),
    "st_skip_d1": (ST_SCHEMA, lambda: ref_build_segment(ST_SCHEMA, ST_ROWS, "st", "skipseg"),
                   dict(max_leaf_records=10, skip_star_for_dims=["d1"])),
    "baseball": (baseball_schema(),
                 lambda: ref_build_segment(baseball_schema(), baseball_rows(3000, seed=4),
                                           "baseballStats", "bb0"),
                 dict(max_leaf_records=50)),
    "adevents_hll": (ref_adevents_schema(),
                     lambda: ref_adevents(20_000, seed=23, name="ad0", user_card=3000, campaign_card=32),
                     AD_CONFIG),
}
ST_REF, ST_PORT = _pair(*CASES["st"][:2], **CASES["st"][2])
REF = RefExecutor()
# past the postings and bit-sliced tiers: a query that is not star-fit
# scans (the reference may answer it from either tier; the payloads agree)
PORT = QueryExecutor(device="cpu", precision="x64", postings=False, bitsliced=False)


def _assert_trees_equal(got, want):
    for name in ("dims", "sums", "counts"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    assert got.split_order == want.split_order and got.metric_columns == want.metric_columns
    assert got.max_leaf_records == want.max_leaf_records and got.hll_columns == want.hll_columns
    assert sorted(got.hll_registers) == sorted(want.hll_registers)
    for c in want.hll_registers:
        assert got.hll_registers[c].dtype == np.uint8
        np.testing.assert_array_equal(got.hll_registers[c], want.hll_registers[c])
    assert json.dumps(got.root.to_json()) == json.dumps(want.root.to_json())


@pytest.mark.parametrize("case", sorted(CASES))
def test_builder_equals_the_reference(case):
    ref_seg, port_seg = _pair(*CASES[case][:2], **CASES[case][2])
    _assert_trees_equal(port_seg.star_tree, ref_seg.star_tree)
    assert port_seg.metadata.custom["starTree"] == ref_seg.metadata.custom["starTree"]
    if case == "st_skip_d1":
        lvl = port_seg.star_tree.split_order.index("d1")
        assert not np.any(port_seg.star_tree.dims[:, lvl] == STAR)
    if case == "adevents_hll":
        assert port_seg.star_tree.hll_registers["user_id"].shape[1] == 256


def _both(pql, ref_segs, port_segs):
    ref_req = ref_optimize(ref_parse(pql))
    ref_res = REF.execute(ref_segs, ref_req)
    want = canonical_payload(ref_req, ref_res)
    req = optimize_request(parse_pql(pql))
    res = PORT.execute(port_segs, req)
    got = reduce_to_response(req, [res]).to_json()
    assert payloads_equivalent(strip_accounting(got), want, rel_tol=REL, abs_tol=ABS), (pql, got, want)
    return res, ref_res, got


@pytest.mark.parametrize("template", STAR_QUERIES)
def test_star_queries_match_the_reference(template):
    pql = _fill(template)
    assert is_fit_for_star_tree(optimize_request(parse_pql(pql)), ST_PORT), pql
    res, ref_res, got = _both(pql, [ST_REF], [ST_PORT])
    assert res._served_tier == ref_res._served_tier == "starTree"
    assert res.num_docs_scanned == ref_res.num_docs_scanned < 2000
    assert got["numSegmentsQueried"] == res.num_segments_queried == ref_res.num_segments_queried == 1
    assert res.cost == ref_res.cost and res.cost["segmentsStarTree"] == 1
    assert res.total_docs == 2000


def test_docs_scanned_collapses():
    res = PORT.execute([ST_PORT], parse_pql("SELECT sum(m1), sum(m2) FROM st"))
    # the fully starred rows, not 2000 docs
    assert res.num_docs_scanned < 50 and res.total_docs == 2000


@pytest.mark.parametrize("template", NOT_FIT)
def test_a_query_that_is_not_star_fit_scans(template):
    pql = _fill(template)
    assert not is_fit_for_star_tree(optimize_request(parse_pql(pql)), ST_PORT)
    res, ref_res, _ = _both(pql, [ST_REF], [ST_PORT])
    assert res._served_tier == "device" and res.num_docs_scanned == ref_res.num_docs_scanned
    assert "segmentsStarTree" not in res.cost and res.cost["segmentsFullScan"] == 1


def test_adevents_hll_cube_equals_the_reference_and_the_scan():
    ref_segs, port_segs = zip(*(
        _pair(ref_adevents_schema(),
              lambda i=i: ref_adevents(30_000, seed=23 + i, name=f"ad{i}", user_card=5000, campaign_card=32),
              **AD_CONFIG)
        for i in range(2)))
    res, ref_res, got = _both(ADEVENTS_HLL, list(ref_segs), list(port_segs))
    assert res.cost["segmentsStarTree"] == 2 and res.num_docs_scanned == ref_res.num_docs_scanned < 60_000
    trees = [s.star_tree for s in port_segs]
    for s in port_segs:
        s.star_tree = None
    try:
        req = optimize_request(parse_pql(ADEVENTS_HLL))
        scanned = PORT.execute(list(port_segs), req)
        assert scanned.num_docs_scanned == 60_000 and "segmentsStarTree" not in scanned.cost
        # the cube's registers are the max over the same raw rows: equal
        assert strip_accounting(reduce_to_response(req, [scanned]).to_json())["aggregationResults"] == \
            got["aggregationResults"]
    finally:
        for s, t in zip(port_segs, trees):
            s.star_tree = t


def test_a_mixed_table_merges_the_cube_with_the_scan():
    rows2 = random_rows(ST_SCHEMA, 500, seed=77, cardinality=8)
    ref_plain = ref_build_segment(ST_SCHEMA, rows2, "st", "plain")
    port_plain = _port_copy(ref_plain)
    ex = QueryExecutor(device="cpu", precision="x64", postings=False, bitsliced=False)
    for template in ("SELECT sum(m1), count(*) FROM st", STAR_QUERIES[6], NOT_FIT[0]):
        pql = _fill(template)
        ref_req = ref_optimize(ref_parse(pql))
        ref_res = REF.execute([ST_REF, ref_plain], ref_req)
        req = optimize_request(parse_pql(pql))
        res = ex.execute([ST_PORT, port_plain], req)
        got = reduce_to_response(req, [res]).to_json()
        assert payloads_equivalent(strip_accounting(got), canonical_payload(ref_req, ref_res),
                                   rel_tol=REL, abs_tol=ABS), pql
        assert res.total_docs == ref_res.total_docs == 2500
        assert res.num_docs_scanned == ref_res.num_docs_scanned
        assert res.cost.get("segmentsStarTree") == ref_res.cost.get("segmentsStarTree")
        # the rest is the scan's (the port's executor is past the postings
        # and bit-sliced tiers; the reference may serve it from either)
        assert res.cost.get("segmentsStarTree", 0) + res.cost["segmentsFullScan"] == 2
        assert got["numSegmentsQueried"] == 2
    # the star-fit queries staged the plain segment alone; the scan both
    staged_sets = {tuple(name for name, _, _ in key[0]) for key in ex._staged}
    assert staged_sets == {("plain",), ("stseg", "plain")}, staged_sets


def test_conversion_carries_the_tree():
    back = segment_from_arrays(**segment_arrays_of(ST_REF))
    _assert_trees_equal(back.star_tree, ST_REF.star_tree)
    assert back.metadata.custom["starTree"] == ST_REF.metadata.custom["starTree"]


def _ref_tree_of(port_tree):
    """A reference ``StarTreeIndex`` of the port's arrays (the reverse of
    ``segment_arrays_of``'s carry, for the tests)."""
    return RefIndex(
        split_order=list(port_tree.split_order), metric_columns=list(port_tree.metric_columns),
        dims=port_tree.dims, sums=port_tree.sums, counts=port_tree.counts,
        root=RefNode.from_json(port_tree.root.to_json()), max_leaf_records=port_tree.max_leaf_records,
        hll_columns=list(port_tree.hll_columns), hll_registers=dict(port_tree.hll_registers),
    )


@pytest.mark.parametrize("case", ["st", "adevents_hll"])
def test_files_cross_read_in_both_directions(case, tmp_path):
    ref_seg, port_seg = _pair(*CASES[case][:2], **CASES[case][2])
    port_path = write_segment(port_seg, str(tmp_path / "port"))
    ref_path = ref_write(ref_seg, str(tmp_path / "ref"))
    with open(port_path, "rb") as f, open(ref_path, "rb") as g:
        assert f.read() == g.read()  # the reference's bytes
    from_port = ref_read(port_path)
    from_ref = read_segment(ref_path)
    _assert_trees_equal(from_ref.star_tree, ref_seg.star_tree)
    _assert_trees_equal(from_port.star_tree, port_seg.star_tree)
    ref_verify(from_port)
    verify_segment_crc(from_ref)
    assert from_ref.metadata.crc == from_port.metadata.crc == ref_seg.metadata.crc
    # a tree the port built answers in the reference, from the reference's file read
    ref_seg.star_tree = _ref_tree_of(port_seg.star_tree)
    pql = "SELECT sum(m1) FROM st GROUP BY d1 TOP 100" if case == "st" else ADEVENTS_HLL
    res, ref_res, _ = _both(pql, [from_port], [from_ref])
    assert res.cost["segmentsStarTree"] == ref_res.cost["segmentsStarTree"] == 1


# -- serving ---------------------------------------------------------------
BB_SPLIT = {"serverA": ["bb0", "bb1"], "serverB": ["bb2", "bb3"]}
BB_QUERIES = [
    "SELECT sum(runs), count(*) FROM baseballStats GROUP BY teamID TOP 20",
    "SELECT sum(runs), count(*) FROM baseballStats WHERE league = 'AL' AND yearID BETWEEN 1990 AND 2005 "
    "GROUP BY teamID TOP 20",
    "SELECT sum(hits), avg(homeRuns) FROM baseballStats WHERE teamID IN ('BOS', 'NYA')",
    "SELECT max(runs) FROM baseballStats GROUP BY teamID TOP 20",
]


@pytest.fixture(scope="module")
def baseball_files(tmp_path_factory):
    """Four baseball segment files, star-trees on bb0 and bb2 only (each
    server then holds a mixed table), written by the reference."""
    d = tmp_path_factory.mktemp("bb")
    rows = baseball_rows(4000, seed=8)
    paths = {}
    for i in range(4):
        seg = ref_build_segment(baseball_schema(), rows[i * 1000:(i + 1) * 1000], "baseballStats", f"bb{i}")
        if i % 2 == 0:
            ref_build_star_tree(seg, baseball_schema(), RefConfig(max_leaf_records=50))
        paths[f"bb{i}"] = (ref_write(seg, str(d / f"bb{i}")), seg.metadata.crc)
    return paths


def _routing(cls):
    routing = cls()
    routing.update("baseballStats", {n: {s: "ONLINE"} for s, names in BB_SPLIT.items() for n in names})
    return routing


def _fleet(baseball_files, tmp_path, server_cls, broker_cls, routing_cls, transport_cls, **kw):
    """Each server fetches its files through the fetcher (the CRC-checked
    load path of the server starters) and serves them."""
    factory = SegmentFetcherFactory()
    servers = {name: server_cls(name, **kw) for name in BB_SPLIT}
    transport = transport_cls()
    for name, server in servers.items():
        for seg_name in BB_SPLIT[name]:
            path, crc = baseball_files[seg_name]
            dest = os.path.join(str(tmp_path), name, seg_name, SEGMENT_FILE_NAME)
            if server_cls is ServerInstance:
                seg = factory.fetch(path, dest, expected_crc=crc)
                assert hasattr(seg, "star_tree") == (seg_name in ("bb0", "bb2"))
            else:
                seg = ref_read(path)
            server.add_segment("baseballStats", seg)
        transport.register((name, 0), server.handle_request)
    broker = broker_cls(transport, {n: (n, 0) for n in BB_SPLIT}, routing=_routing(routing_cls),
                        timeout_ms=30_000)
    return broker, servers


def _stop(broker, servers):
    broker.shutdown()
    for s in servers.values():
        s.shutdown()


def test_star_tree_files_served_by_port_servers_behind_the_port_broker(baseball_files, tmp_path):
    port = _fleet(baseball_files, tmp_path, ServerInstance, BrokerRequestHandler, RoutingTableProvider,
                  LocalTransport, device="cpu", precision="x64", postings=False, bitsliced=False)
    ref = _fleet(baseball_files, tmp_path, RefServer, RefBroker, RefRouting, RefLocal)
    try:
        for pql in BB_QUERIES:
            got = port[0].handle_pql(pql).to_json()
            want = ref[0].handle_pql(pql).to_json()
            assert not got["exceptions"], got["exceptions"]
            assert payloads_equivalent(strip_accounting(got), strip_accounting(want),
                                       rel_tol=REL, abs_tol=ABS), (pql, got, want)
            assert got["numDocsScanned"] == want["numDocsScanned"]
            assert got["numSegmentsQueried"] == want["numSegmentsQueried"] == 4
            star = got["cost"].get("segmentsStarTree", 0)
            assert star == want["cost"].get("segmentsStarTree", 0) == (0 if "max(" in pql else 2)
            assert star + got["cost"]["segmentsFullScan"] == 4
    finally:
        _stop(*port)
        _stop(*ref)


def test_a_reference_broker_reads_the_port_servers_star_tree_cost(baseball_files, tmp_path):
    servers = {name: ServerInstance(name, device="cpu", precision="x64") for name in BB_SPLIT}
    transport = RefLocal()
    for name, server in servers.items():
        for seg_name in BB_SPLIT[name]:
            server.add_segment("baseballStats", read_segment(baseball_files[seg_name][0]))
        transport.register((name, 0), server.handle_request)
    broker = RefBroker(transport, {n: (n, 0) for n in BB_SPLIT}, routing=_routing(RefRouting),
                       timeout_ms=30_000)
    try:
        resp = broker.handle_pql(BB_QUERIES[0]).to_json()
        assert not resp["exceptions"], resp["exceptions"]
        assert resp["cost"]["segmentsStarTree"] == 2 and resp["cost"]["segmentsFullScan"] == 2
    finally:
        _stop(broker, servers)
