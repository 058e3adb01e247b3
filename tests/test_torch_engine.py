"""End-to-end differential: the port's QueryExecutor + reduce against the
JAX package's on the same segments (carried across by
``segment/convert.py``), compared as client payloads.

Tolerance: payloads are compared with ``pinot_tpu.utils.audit
.payloads_equivalent`` at rel 1e-9 / abs 2e-5 — both sides sum in
float64 (x64), so the only difference is summation order (~1e-13
relative), which can move the last of the five printed decimals by one
unit (abs 1e-5).  Group keys, group order, counts and structure compare
exactly.
"""
import numpy as np
import pytest
import torch

from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import lineitem_rows as ref_lineitem_rows
from pinot_tpu.tools.datagen import lineitem_schema as ref_lineitem_schema
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.engine import kernel as port_kernel
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.tools.datagen import synthetic_lineitem_segment

REL, ABS = 1e-9, 2e-5

Q1 = (
    "SELECT sum(l_quantity), sum(l_extendedprice), sum(l_discount), count(*) "
    "FROM lineitem WHERE l_shipdate <= '1998-09-02' "
    "GROUP BY l_returnflag, l_linestatus TOP 10"
)
Q3 = (
    "SELECT sum(l_extendedprice), sum(l_quantity) FROM lineitem "
    "WHERE l_returnflag = 'R' GROUP BY l_shipmode TOP 10"
)
RANGE = (
    "SELECT sum(l_extendedprice), count(*) FROM lineitem "
    "WHERE l_quantity > 25 GROUP BY l_returnflag TOP 10"
)
MIX = {
    "in": "SELECT sum(l_quantity) FROM lineitem WHERE l_shipmode IN ('AIR', 'RAIL', 'MAIL') "
    "GROUP BY l_linestatus",
    "not_in": "SELECT count(*), sum(l_tax) FROM lineitem WHERE l_shipmode NOT IN ('AIR', 'RAIL')",
    "and_or": "SELECT avg(l_discount), max(l_quantity) FROM lineitem WHERE "
    "(l_quantity BETWEEN 10 AND 20 AND l_returnflag <> 'N') OR l_shipdate < '1993-01-01' "
    "GROUP BY l_shipmode TOP 5",
    "scalar_aggs": "SELECT min(l_tax), max(l_discount), avg(l_quantity), minmaxrange(l_quantity), "
    "sum(l_extendedprice), count(*) FROM lineitem WHERE l_receiptdate >= '1995-01-01'",
    "no_filter": "SELECT count(*), avg(l_extendedprice) FROM lineitem GROUP BY l_shipmode, l_linestatus",
    "having": "SELECT sum(l_quantity), count(*) FROM lineitem WHERE l_quantity < 40 "
    "GROUP BY l_shipmode HAVING count(*) > 100 TOP 3",
    "regex": "SELECT count(*) FROM lineitem WHERE regexp_like(l_receiptdate, '-0[13579]-') "
    "GROUP BY l_returnflag, l_shipmode",
    "empty_match": "SELECT sum(l_quantity), count(*) FROM lineitem WHERE l_shipmode = 'BOAT' "
    "GROUP BY l_returnflag",
}

REF = RefExecutor()


def _synthetic():
    return [ref_synthetic(3000, seed=11 + i, name=f"li{i}") for i in range(3)]


def _row_built():
    """Row-built segments: l_shipdate is unsorted (its RANGE is an
    ``interval`` leaf) and every dictionary holds only values present,
    so dictionary-fed value columns stay within the fused kernel's 4096
    entries."""
    rows = ref_lineitem_rows(6000, seed=3)
    schema = ref_lineitem_schema()
    return [ref_build_segment(schema, rows[i * 2000 : (i + 1) * 2000], "lineitem", f"li{i}") for i in range(3)]


SYNTHETIC = _synthetic()
ROW_BUILT = _row_built()


def _port(segments):
    return [segment_from_arrays(**segment_arrays_of(s)) for s in segments]


def _compare(pql, ref_segments, executor=None):
    ref_req = ref_optimize(ref_parse(pql))
    want = canonical_payload(ref_req, REF.execute(ref_segments, ref_req))
    req = optimize_request(parse_pql(pql))
    ex = executor or QueryExecutor(device="cpu", precision="x64")
    got = strip_accounting(reduce_to_response(req, [ex.execute(_port(ref_segments), req)]).to_json())
    heal = ex.healing_stats()
    assert heal["deviceFailures"] == heal["hostFailovers"] == 0, heal  # no device run failed over
    return got, want


@pytest.mark.parametrize("name", ["q1", "q3", "range_unsorted", *sorted(MIX)])
def test_payloads_match_reference_on_synthetic_segments(name):
    pql = {"q1": Q1, "q3": Q3, "range_unsorted": RANGE, **MIX}[name]
    got, want = _compare(pql, SYNTHETIC)
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (got, want)


FUSED_QUERIES = {
    "q1_interval": (Q1, "row_built"),
    "q3_point": (Q3, "row_built"),
    "range_unsorted": (RANGE, "row_built"),
    "regex_table": (
        "SELECT sum(l_quantity), count(*) FROM lineitem WHERE "
        "regexp_like(l_shipdate, '-(0[1-9]|1[0-2])-0[13579]') GROUP BY l_returnflag, l_linestatus",
        "row_built",
    ),
    "docrange": (
        "SELECT sum(l_quantity), avg(l_discount), count(*) FROM lineitem WHERE l_shipdate "
        "BETWEEN '1994-01-01' AND '1995-06-30' GROUP BY l_returnflag, l_linestatus",
        "synthetic",
    ),
}


@pytest.mark.parametrize("name", sorted(FUSED_QUERIES))
def test_fused_route_matches_reference(name):
    """Q1 (interval on row-built segments, whose l_shipdate is unsorted),
    Q3 (single point), the unsorted RANGE, a regex match-table leaf and a
    docrange leaf are all fused-kernel plans: the route counter rises and
    the payload matches the reference.  (Over synthetic segments Q1 is a
    docrange plan too, but on the CPU its l_extendedprice input is
    dictionary-fed with 16384 entries, beyond the kernel's 4096.)"""
    pql, which = FUSED_QUERIES[name]
    before = port_kernel.fused_dispatches
    got, want = _compare(pql, ROW_BUILT if which == "row_built" else SYNTHETIC)
    assert port_kernel.fused_dispatches == before + 1
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (got, want)


@pytest.mark.parametrize("name", ["q1_interval", "q3_point", "range_unsorted"])
def test_fused_route_combines_the_key_in_the_kernel(name, monkeypatch):
    """Q1, Q3 and RANGE hand K1 the group-by columns (group_cols, no
    precombined key): ``_group_keys`` never runs on the fused route, and
    the payload still matches the reference (tolerance as above)."""
    from pinot_tpu_torch.engine.kernels import fused_groupby

    def no_key_combine(*a, **k):
        raise AssertionError("the fused route combined the group key with torch ops")

    calls = []
    real = fused_groupby.fused_filtered_groupby_sums

    def recording(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    monkeypatch.setattr(port_kernel, "_group_keys", no_key_combine)
    monkeypatch.setattr(fused_groupby, "fused_filtered_groupby_sums", recording)
    pql, _ = FUSED_QUERIES[name]
    before = port_kernel.fused_dispatches
    got, want = _compare(pql, ROW_BUILT)
    assert port_kernel.fused_dispatches == before + 1
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (got, want)
    ((args, kwargs),) = calls
    assert args[3] is None  # group_keys
    assert len(kwargs["group_cols"]) == len(kwargs["group_cards"]) >= 1


def test_torch_op_path_when_not_fused():
    """min/max aggregations are outside the fused kernel: the torch-op
    path answers, and the route counter stays put."""
    before = port_kernel.fused_dispatches
    got, want = _compare(MIX["and_or"], ROW_BUILT)
    assert port_kernel.fused_dispatches == before
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS)


def test_x32_port_within_audit_band_of_x64_reference():
    """The mode the card serves (float32 sums, int32 keys) against the
    float64 reference, within the audit band (rel 5e-4 / abs 1e-3,
    pinot_tpu/utils/audit.py:189-203)."""
    ex = QueryExecutor(device="cpu", precision="x32")
    for pql in (Q1, Q3, RANGE):
        got, want = _compare(pql, ROW_BUILT, executor=ex)
        assert payloads_equivalent(got, want), (got, want)


def test_staging_is_cached_per_segment_set():
    ex = QueryExecutor(device="cpu")
    segs = _port(SYNTHETIC)
    req = optimize_request(parse_pql(Q1))
    ex.execute(segs, req)
    n = len(ex._staged)
    ex.execute(segs, req)
    assert len(ex._staged) == n == 1
    assert ex.staged_bytes() > 0


def test_empty_segment_is_pruned():
    segs = _port(SYNTHETIC) + [synthetic_lineitem_segment(0, seed=1, name="empty")]
    req = optimize_request(parse_pql(Q1))
    res = QueryExecutor(device="cpu").execute(segs, req)
    assert res.cost.get("segmentsPruned") == 1
    assert res.total_docs == 9000


@pytest.mark.parametrize(
    "pql",
    [
        # group spaces past the dense holder: the host tier (and a one-entry MV)
        "SELECT count(*) FROM lineitem GROUP BY l_extendedprice, l_shipdate",
        "SELECT distinctcountmv(l_shipmode) FROM lineitem",
        "SELECT distinctcount(l_receiptdate) FROM lineitem GROUP BY l_extendedprice, l_shipdate",
        "SELECT distinctcounthll(l_extendedprice) FROM lineitem GROUP BY l_extendedprice, l_receiptdate",
    ],
)
def test_shapes_outside_the_slice_raise(pql):
    """Shapes outside the device's dense path answer as the reference
    does: group spaces past the dense holder from the host tier, before
    anything is staged; an ``…mv``
    function over a single-value column on the device, planned as its SV
    function (each row a one-entry MV), where the reference reaches its
    host tier through its device section."""
    got, want = _compare(pql, SYNTHETIC)
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (got, want)
    ex = QueryExecutor(device="cpu")
    res = ex.execute(_port(SYNTHETIC), optimize_request(parse_pql(pql)))
    host = "GROUP BY" in pql
    assert res._served_tier == ("host" if host else "device")
    assert bool(res.cost.get("segmentsHost")) == host
    assert (ex.staged_bytes() == 0) == host


def test_joins_raise():
    """A join runs through ``execute_join`` from a server's join phase
    (``tests/test_torch_join*.py``); a join request that reaches
    ``execute`` without one no longer raises: it gets the reference
    executor's answer (here a scan of the left table, since no right-side
    column is referenced and none prunes a segment)."""
    pql = "SELECT sum(f.l_quantity) FROM lineitem f JOIN shipmodes d ON f.l_shipmode = d.mode"
    got = QueryExecutor(device="cpu").execute(_port(SYNTHETIC), optimize_request(parse_pql(pql)))
    req = ref_optimize(ref_parse(pql))
    want = canonical_payload(req, RefExecutor().execute(SYNTHETIC, req))
    port = strip_accounting(reduce_to_response(optimize_request(parse_pql(pql)), [got], []).to_json())
    assert payloads_equivalent(port, want, rel_tol=1e-9, abs_tol=2e-5), (port, want)
    assert got.num_docs_scanned == sum(s.num_docs for s in SYNTHETIC)


@pytest.mark.parametrize("seed,rows", [(7, 1000), (11, 4096), (23, 0)])
def test_seeded_datagen_matches_reference(seed, rows):
    ref = ref_synthetic(rows, seed=seed, name="x")
    got = synthetic_lineitem_segment(rows, seed=seed, name="x")
    assert sorted(got.columns) == sorted(ref.columns)
    for name, rc in ref.columns.items():
        gc = got.column(name)
        np.testing.assert_array_equal(gc.fwd, rc.fwd)
        if rc.dictionary.is_string:
            assert list(gc.dictionary.values) == list(rc.dictionary.values)
        else:
            np.testing.assert_array_equal(gc.dictionary.values, rc.dictionary.values)
        assert gc.metadata.is_sorted == rc.metadata.is_sorted
        assert gc.metadata.cardinality == rc.metadata.cardinality


def test_row_values_reach_torch_as_staged_widths():
    """fwd arrays stage in the narrowest width torch can index with (the
    scan's staging: the executor is past the bit-sliced tier, which would
    stage this count as bit-planes)."""
    ex = QueryExecutor(device="cpu", postings=False, bitsliced=False)
    req = optimize_request(parse_pql(
        "SELECT count(*) FROM lineitem WHERE l_returnflag = 'R' AND l_receiptdate > '1995-01-01'"
    ))
    ex.execute(_port(SYNTHETIC), req)
    (st,) = ex._staged.values()
    assert st.column("l_returnflag").fwd.dtype == torch.uint8
    assert st.column("l_receiptdate").fwd.dtype == torch.int16  # 2000 dates: uint16 in the reference
