"""The port's host tier (``engine/host_fallback.py``) against the JAX
package's, on the same segments (carried across with
``segment/convert.py``), compared as client payloads.

The executor takes the host tier on the reference's three shape
conditions, each pinned here in x64 and x32:
  * forced before staging (``plan_forced_host``): a group space past
    ``MAX_GROUP_CAPACITY``; nothing is staged;
  * a plan not ``on_device``: an MV group-by expanding a row past 64 keys;
  * a pair overflow after the device run: more unique (group, value)
    pairs than ``DISTINCT_PAIR_CAP``, with ``MAX_VALUE_STATE`` and the
    cap shrunk in both packages (as ``test_torch_distinct_pairs.py``
    shrinks them).
Beside them: the vectorized group-by (scalar, pair and distinct
aggregations, value states over STRING columns), the row-wise
accumulators (percentiles, an MV group column past the capacity, an
ungrouped pair overflow), and a selection through ``execute_host``
itself; ``hostMs``, ``bytesScanned`` and ``segmentsHost`` in the cost.

Tolerances: the host tier sums in float64 numpy in both packages, in the
same order, so payloads compare at rel 1e-9 / abs 2e-5 (x64, as in
``test_torch_engine.py``); with the port in x32 the host tier still sums
in float64, the same band holds.  Counts, distinct counts, percentiles,
HLL estimates, keys and order exactly.
"""
import numpy as np
import pytest

from pinot_tpu.engine import config as ref_config
from pinot_tpu.engine.context import TableContext as RefContext
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.engine.host_fallback import execute_host as ref_execute_host
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema as ref_make_test_schema
from pinot_tpu.tools.datagen import random_rows
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine import host_fallback
from pinot_tpu_torch.engine.context import TableContext
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.engine.results import COST_KEYS, SEGMENT_TIER_KEYS
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays

REL, ABS = 1e-9, 2e-5


def _mv_segments(rows, n_seg):
    per = len(rows) // n_seg
    return [
        ref_build_segment(ref_make_test_schema(), rows[i * per : (i + 1) * per], "testTable", f"t{i}")
        for i in range(n_seg)
    ]


SEGMENTS = {
    "lineitem": [ref_synthetic(2500, seed=61 + i, name=f"li{i}") for i in range(3)],
    # 200-value pools: dimStrMV x dimStr x dimInt spans 8,000,000 keys
    "mvtest": _mv_segments(random_rows(ref_make_test_schema(), 900, seed=4, cardinality=200, mv_max=3), 3),
    # mv_max 9: mv_pad 16, two MV group columns expand a row to 256 keys
    "mvwide": _mv_segments(random_rows(ref_make_test_schema(), 400, seed=2, cardinality=6, mv_max=9), 2),
}
PORT = {k: [segment_from_arrays(**segment_arrays_of(s)) for s in v] for k, v in SEGMENTS.items()}

# (table, exit, query): how each query reaches the host tier
QUERIES = {
    # the vectorized group-by: 2000 x 2000 dates past MAX_GROUP_CAPACITY
    "vector_scalar_aggs": ("lineitem", "forced", "SELECT sum(l_extendedprice), count(*), min(l_tax), "
                           "max(l_discount), avg(l_quantity), minmaxrange(l_quantity) FROM lineitem "
                           "WHERE l_quantity > 40 GROUP BY l_shipdate, l_receiptdate TOP 10"),
    "vector_distinct_string": ("lineitem", "forced", "SELECT distinctcount(l_shipmode), "
                               "distinctcounthll(l_returnflag), fasthll(l_extendedprice), count(*) FROM "
                               "lineitem WHERE l_shipmode <> 'AIR' GROUP BY l_shipdate, l_receiptdate TOP 10"),
    # the row-wise accumulators: percentiles, an MV group column past the capacity
    "rowwise_percentile": ("lineitem", "forced", "SELECT percentile90(l_extendedprice), percentileest50(l_tax) "
                           "FROM lineitem WHERE l_quantity < 5 GROUP BY l_shipdate, l_receiptdate TOP 5"),
    "rowwise_mv_group": ("mvtest", "forced", "SELECT count(*), sum(metDouble), distinctcountmv(dimIntMV), "
                         "percentile50mv(dimIntMV) FROM testTable GROUP BY dimStrMV, dimStr, dimInt TOP 10"),
    # a plan off the device: the MV expansion past 64 keys a row
    "mv_expansion": ("mvwide", "not_on_device", "SELECT count(*), sum(metInt), minmv(dimIntMV) FROM testTable "
                     "WHERE dimStr <> 'x' GROUP BY dimStrMV, dimIntMV TOP 20"),
}
PAIR_QUERIES = {
    "pairs_grouped": "SELECT distinctcount(l_extendedprice), sum(l_tax) FROM lineitem WHERE "
    "l_shipdate > '1993-01-01' GROUP BY l_returnflag TOP 10",
    # ungrouped: the row-wise accumulators
    "pairs_scalar": "SELECT distinctcount(l_extendedprice), percentile90(l_extendedprice), count(*) "
    "FROM lineitem WHERE l_quantity < 20",
}


@pytest.fixture
def shrink(monkeypatch):
    """Sets a config value in both packages for the test."""

    def set_both(name, value):
        monkeypatch.setattr(ref_config, name, value)
        monkeypatch.setattr(config, name, value)

    return set_both


def _run(pql, table, precision):
    """(port payload, reference payload, port result, port executor)."""
    ref_req = ref_optimize(ref_parse(pql))
    want = canonical_payload(ref_req, RefExecutor().execute(SEGMENTS[table], ref_req))
    req = optimize_request(parse_pql(pql))
    ex = QueryExecutor(device="cpu", precision=precision)
    res = ex.execute(PORT[table], req)
    return strip_accounting(reduce_to_response(req, [res]).to_json()), want, res, ex


def _check_host_cost(res, n_segments):
    assert res._served_tier == "host"
    assert res.cost["segmentsHost"] == n_segments
    assert res.cost["hostMs"] > 0 and res.cost["bytesScanned"] > 0
    assert "segmentsFullScan" not in res.cost and "deviceBytes" not in res.cost
    assert set(res.cost) <= set(COST_KEYS)


@pytest.mark.parametrize("precision", ["x64", "x32"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_host_tier_matches_reference(name, precision, monkeypatch):
    table, exit_, pql = QUERIES[name]
    vectorized = []
    real = host_fallback._groupby_vectorized
    monkeypatch.setattr(host_fallback, "_groupby_vectorized", lambda *a, **k: vectorized.append(1) or real(*a, **k))
    got, want, res, ex = _run(pql, table, precision)
    assert bool(vectorized) == name.startswith("vector")
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (got, want)
    _check_host_cost(res, len(PORT[table]))
    # forced: decided before staging, so nothing is staged; off the
    # device: the plan decides it, after staging
    assert (ex.staged_bytes() == 0) == (exit_ == "forced")


@pytest.mark.parametrize("precision", ["x64", "x32"])
@pytest.mark.parametrize("name", sorted(PAIR_QUERIES))
def test_pair_overflow_finishes_on_the_host(name, precision, shrink):
    """The device runs (the pair reduce counts more unique pairs than the
    buffer holds), then the host finishes exactly, as the reference's does."""
    shrink("MAX_VALUE_STATE", 1 << 10)
    shrink("DISTINCT_PAIR_CAP", 64)
    got, want, res, ex = _run(PAIR_QUERIES[name], "lineitem", precision)
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (got, want)
    _check_host_cost(res, 3)
    assert ex.staged_bytes() > 0  # the device ran first


def test_device_results_carry_the_device_tier():
    got, want, res, _ = _run("SELECT sum(l_tax), count(*) FROM lineitem GROUP BY l_returnflag", "lineitem", "x64")
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS)
    assert res._served_tier == "device" and res.cost["segmentsFullScan"] == 3
    assert "segmentsHost" not in res.cost and "hostMs" not in res.cost
    assert SEGMENT_TIER_KEYS == ("segmentsPruned", "segmentsPostings", "segmentsBitsliced", "segmentsZonemap",
                                 "segmentsFullScan", "segmentsHost", "segmentsStarTree")


@pytest.mark.parametrize("pql", [
    "SELECT l_shipmode, l_extendedprice FROM lineitem WHERE l_quantity > 45 LIMIT 7",
    "SELECT * FROM lineitem WHERE l_shipmode <> 'AIR' ORDER BY l_extendedprice DESC, l_shipdate LIMIT 2, 6",
    "SELECT dimStrMV, dimInt FROM testTable WHERE dimIntMV > 5000 ORDER BY dimStrMV, dimInt DESC LIMIT 8",
])
def test_execute_host_selection_matches_reference(pql):
    """A selection through ``execute_host`` itself (no shape condition
    sends one there): the same rows and sort values as the reference's
    host tier, MV values as lists, an MV sort column by its first value."""
    table = "testTable" if "testTable" in pql else "lineitem"
    segs, port = (SEGMENTS["mvtest"], PORT["mvtest"]) if table == "testTable" else \
        (SEGMENTS["lineitem"], PORT["lineitem"])
    ref_req, req = ref_optimize(ref_parse(pql)), optimize_request(parse_pql(pql))
    cols = [c for c in (req.selection.columns or [])]
    if cols == ["*"]:
        cols = list(port[0].columns)
    total = sum(s.num_docs for s in segs)
    want = ref_execute_host(segs, RefContext(segs), ref_req, total, cols)
    got = host_fallback.execute_host(port, TableContext(port), req, total, cols)
    assert got.selection_rows == want.selection_rows
    assert strip_accounting(reduce_to_response(req, [got]).to_json()) == canonical_payload(ref_req, want)
    assert got.cost["segmentsHost"] == len(port)


@pytest.mark.parametrize("pql", [
    "SELECT sum(l_tax), min(l_discount), max(l_quantity), avg(l_extendedprice), minmaxrange(l_tax), count(*) "
    "FROM lineitem WHERE l_shipmode IN ('AIR', 'RAIL')",
    "SELECT count(*), sum(l_quantity) FROM lineitem WHERE l_shipmode = 'NONE'",
])
def test_execute_host_aggregation_matches_reference(pql):
    """Ungrouped scalar and pair aggregations through ``execute_host``:
    the vectorized path, and its empty match."""
    segs, port = SEGMENTS["lineitem"], PORT["lineitem"]
    ref_req, req = ref_optimize(ref_parse(pql)), optimize_request(parse_pql(pql))
    want = ref_execute_host(segs, RefContext(segs), ref_req, 7500, None)
    got = host_fallback.execute_host(port, TableContext(port), req, 7500, None)
    assert got.num_docs_scanned == want.num_docs_scanned
    assert payloads_equivalent(strip_accounting(reduce_to_response(req, [got]).to_json()),
                               canonical_payload(ref_req, want), rel_tol=REL, abs_tol=ABS)


def test_host_segment_mask_matches_reference_on_mv_leaves():
    """``_segment_mask`` over SV and MV leaves (MV_ANY and MV_NONE) and
    AND / OR trees, per segment, equal to the reference's."""
    from pinot_tpu.engine.host_fallback import _segment_mask as ref_mask

    pql = ("SELECT count(*) FROM testTable WHERE (dimStrMV <> 'x' AND dimIntMV > 3000) OR "
           "dimIntMV NOT IN (1, 2) AND dimStr < 'm'")
    ref_req, req = ref_optimize(ref_parse(pql)), optimize_request(parse_pql(pql))
    for rs, ps in zip(SEGMENTS["mvtest"], PORT["mvtest"]):
        want = ref_mask(rs, ref_req.filter)
        got = host_fallback._segment_mask(ps, req.filter)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < got.size
