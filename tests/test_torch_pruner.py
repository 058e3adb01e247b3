"""The port's segment pruner (``engine/pruner.py``) against the JAX
package's (``pinot_tpu/engine/pruner.py``): three
``make_test_schema(with_mv=False)`` segments whose ``daysSinceEpoch``
ranges are disjoint ([1000, 1999], [3000, 3999], [5000, 5999]), and ten
queries whose time filter prunes none, some or all of them.

Each query goes through both executors (x64) and is compared as a client
payload (``canonical_payload`` / ``payloads_equivalent``, counts and
order exact, float sums within rel 1e-9 / abs 2e-5).  The accounting
that ``strip_accounting`` hides gets its own assertions:
``numSegmentsQueried``, ``totalDocs`` and ``cost.segmentsPruned`` equal
the reference's, and a fully pruned selection answers no columns, as
the reference's ``_empty_result`` does.
"""
import pytest

from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.engine.pruner import _time_bounds as ref_time_bounds
from pinot_tpu.engine.pruner import prune_explain as ref_prune_explain
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.pruner import _time_bounds, prune_explain, prune_segments
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays

REL, ABS = 1e-9, 2e-5
TABLE = "testTable"
SCHEMA = make_test_schema(with_mv=False)
DAY_BASES = (1000, 3000, 5000)


def _rows(i):
    rows = random_rows(SCHEMA, 400, seed=61 + i, cardinality=10)
    for r in rows:
        r["daysSinceEpoch"] = DAY_BASES[i] + r["daysSinceEpoch"] % 1000
    return rows


REF_SEGMENTS = [ref_build_segment(SCHEMA, _rows(i), TABLE, f"t{i}") for i in range(3)]
PORT_SEGMENTS = [segment_from_arrays(**segment_arrays_of(s)) for s in REF_SEGMENTS]
REF = RefExecutor()
PORT = QueryExecutor(device="cpu", precision="x64")

# (pql, segments the reference prunes)
QUERIES = [
    ("SELECT count(*) FROM testTable WHERE daysSinceEpoch > 9000", 3),
    ("SELECT * FROM testTable WHERE daysSinceEpoch > 9000 LIMIT 5", 3),
    ("SELECT count(*) FROM testTable WHERE daysSinceEpoch > 9000 GROUP BY dimStr TOP 10", 3),
    ("SELECT distinctcount(dimStr), sum(metInt) FROM testTable WHERE daysSinceEpoch < 500", 3),
    ("SELECT sum(metInt) FROM testTable WHERE daysSinceEpoch < 2000", 2),
    ("SELECT sum(metDouble), count(*) FROM testTable WHERE daysSinceEpoch BETWEEN 2500 AND 4500", 2),
    ("SELECT count(*) FROM testTable WHERE daysSinceEpoch = 3500", 2),
    ("SELECT sum(metFloat) FROM testTable WHERE daysSinceEpoch >= 3000 AND dimInt > 100 "
     "GROUP BY dimStr TOP 5", 1),
    ("SELECT dimStr, metInt FROM testTable WHERE daysSinceEpoch <= 1999 ORDER BY metInt DESC LIMIT 8", 2),
    ("SELECT max(metDouble) FROM testTable WHERE daysSinceEpoch IN (1500, 5500) GROUP BY dimStr TOP 10", 0),
]


@pytest.mark.parametrize("pql, pruned", QUERIES, ids=[f"q{i}" for i in range(len(QUERIES))])
def test_pruned_queries_match_the_reference(pql, pruned):
    ref_req = ref_optimize(ref_parse(pql))
    ref_res = REF.execute(REF_SEGMENTS, ref_req)
    want = canonical_payload(ref_req, ref_res)
    req = optimize_request(parse_pql(pql))
    res = PORT.execute(PORT_SEGMENTS, req)
    resp = reduce_to_response(req, [res]).to_json()
    assert payloads_equivalent(strip_accounting(resp), want, rel_tol=REL, abs_tol=ABS), (pql, resp, want)
    # the accounting strip_accounting hides
    assert ref_res.cost.get("segmentsPruned", 0) == pruned
    assert res.cost.get("segmentsPruned", 0) == pruned, res.cost
    assert res.num_segments_queried == ref_res.num_segments_queried
    assert resp["numSegmentsQueried"] == 3 - pruned
    assert res.total_docs == ref_res.total_docs == 1200
    assert res.num_docs_scanned == ref_res.num_docs_scanned


def test_fully_pruned_selection_has_no_columns():
    pql = QUERIES[1][0]
    req = optimize_request(parse_pql(pql))
    resp = reduce_to_response(req, [PORT.execute(PORT_SEGMENTS, req)]).to_json()
    ref_req = ref_optimize(ref_parse(pql))
    want = canonical_payload(ref_req, REF.execute(REF_SEGMENTS, ref_req))
    assert resp["selectionResults"]["columns"] == want["selectionResults"]["columns"] == []
    assert resp["selectionResults"]["results"] == []
    assert resp["numSegmentsQueried"] == 0 and resp["cost"] == {"segmentsPruned": 3}


@pytest.mark.parametrize("pql, pruned", QUERIES, ids=[f"q{i}" for i in range(len(QUERIES))])
def test_prune_verdicts_and_time_bounds_match_the_reference(pql, pruned):
    req = optimize_request(parse_pql(pql))
    ref_req = ref_optimize(ref_parse(pql))
    got = [reason for _, reason in prune_explain(PORT_SEGMENTS, req)]
    want = [reason for _, reason in ref_prune_explain(REF_SEGMENTS, ref_req)]
    assert got == want
    assert sum(r is not None for r in got) == pruned
    assert len(prune_segments(PORT_SEGMENTS, req)) == 3 - pruned
    assert _time_bounds(req.filter, "daysSinceEpoch") == ref_time_bounds(ref_req.filter, "daysSinceEpoch")


def test_empty_and_schema_pruners_still_hold():
    empty = segment_from_arrays(**segment_arrays_of(ref_build_segment(SCHEMA, [], TABLE, "empty")))
    req = optimize_request(parse_pql("SELECT count(*) FROM testTable"))
    reasons = [r for _, r in prune_explain(PORT_SEGMENTS[:1] + [empty], req)]
    assert reasons[0] is None and "ValidSegmentPruner" in reasons[1]
    req = optimize_request(parse_pql("SELECT sum(nosuch) FROM testTable"))
    assert all("DataSchemaSegmentPruner" in r for _, r in prune_explain(PORT_SEGMENTS, req))
