"""The DataTable wire between the port and the JAX package: byte-compatible
in both directions.

For the seeded ``QueryGenerator`` mix over ``make_test_schema()`` (MV
columns included), each port ``IntermediateResult`` is serialized by the
port and read back by the reference's ``deserialize_result``, and each
reference result the other way round; the client payloads reduced from
what was read must be ``payloads_equivalent`` to the sender's own (rel
1e-9 / abs 2e-5, as the port's other differential tests).  Every wire
field beyond the partials (exceptions, trace, unserved segments, cost,
backpressure, plan info, freshness) must arrive unchanged, and
instance requests must serialize byte-identically.
"""
import numpy as np
import pytest

from pinot_tpu.common import datatable as ref_dt
from pinot_tpu.engine import results as ref_results
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.tools.query_gen import QueryGenerator
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.common import datatable as dt
from pinot_tpu_torch.engine import results
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays

REL, ABS = 1e-9, 2e-5
QUERIES = 30

ROWS = random_rows(make_test_schema(), 1200, seed=31)
SEGMENTS = [
    ref_build_segment(make_test_schema(), ROWS[i * 400 : (i + 1) * 400], "testTable", f"w{i}")
    for i in range(3)
]
PORT = [segment_from_arrays(**segment_arrays_of(s)) for s in SEGMENTS]
REF = RefExecutor()
PORT_EX = QueryExecutor(device="cpu", precision="x64")
_GEN = QueryGenerator(make_test_schema(), ROWS, table="testTable", seed=41)
MIX = [_GEN.next_query() for _ in range(QUERIES)]


def _port_payload(req, res):
    return strip_accounting(reduce_to_response(req, [res]).to_json())


@pytest.mark.parametrize("i", range(QUERIES))
def test_port_result_reads_in_the_reference_and_back(i):
    pql = MIX[i]
    req = optimize_request(parse_pql(pql))
    ref_req = ref_optimize(ref_parse(pql))
    port_res = PORT_EX.execute(PORT, req)
    want = _port_payload(req, port_res)
    read_by_ref = ref_dt.deserialize_result(dt.serialize_result(port_res))
    got = canonical_payload(ref_req, read_by_ref)
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (pql, got, want)
    assert read_by_ref.cost == port_res.cost

    ref_res = REF.execute(SEGMENTS, ref_req)
    ref_want = canonical_payload(ref_req, ref_res)
    read_by_port = dt.deserialize_result(ref_dt.serialize_result(ref_res))
    got = _port_payload(req, read_by_port)
    assert payloads_equivalent(got, ref_want, rel_tol=REL, abs_tol=ABS), (pql, got, ref_want)
    # and the two engines agree, as the query-mix tests hold
    assert payloads_equivalent(want, ref_want, rel_tol=REL, abs_tol=ABS), (pql, want, ref_want)


def _every_wire_field(mod):
    res = mod.IntermediateResult(
        aggregations=[
            mod.CountPartial(5),
            mod.SumPartial(1.5),
            mod.MinPartial(-2.0),
            mod.MaxPartial(7.0),
            mod.AvgPartial(10.0, 4.0),
            mod.MinMaxRangePartial(1.0, 9.0),
            mod.DistinctPartial({"a", "b", 3}),
            mod.HllPartial(np.arange(256, dtype=np.uint8)),
            mod.HistogramPartial({1.0: 3, 2.5: 7}, percentile=90),
        ],
        num_docs_scanned=42,
        total_docs=100,
        num_segments_queried=3,
        num_entries_scanned_in_filter=300,
        num_entries_scanned_post_filter=84,
        trace={"server0": [{"span": "x", "id": "server0:1", "parent": None, "startMs": 1.0, "ms": 1.5}]},
        exceptions=[(200, "boom")],
        unserved_segments=["s9"],
        cost={"bytesScanned": 4096, "deviceMs": 0.25, "segmentsFullScan": 3},
        plan_info=[{"mode": "plan", "server": "server0"}],
    )
    res.backpressure = {"pending": 2, "maxPending": 64, "laneDepth": 1}
    res.freshness = {"minEventMs": 123456}
    res.groups = {("a", "1"): [mod.SumPartial(2.0)], ("b", "2"): [mod.SumPartial(3.0)]}
    res.selection_rows = [([1, "x"], ["x", 1, [1, 2]]), ([2, "y"], ["y", 2, [3]])]
    res.selection_columns = ["d", "m", "mv"]
    return res


FIELDS = ("num_docs_scanned", "total_docs", "num_segments_queried",
          "num_entries_scanned_in_filter", "num_entries_scanned_post_filter", "trace",
          "exceptions", "unserved_segments", "cost", "backpressure", "plan_info", "freshness",
          "selection_rows", "selection_columns")


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_every_wire_field_crosses(direction):
    if direction == "port_to_reference":
        sent, data = _every_wire_field(results), dt.serialize_result(_every_wire_field(results))
        got = ref_dt.deserialize_result(data)
        assert ref_dt.serialize_result(got) == data
    else:
        sent, data = _every_wire_field(ref_results), ref_dt.serialize_result(_every_wire_field(ref_results))
        got = dt.deserialize_result(data)
        assert dt.serialize_result(got) == data
    for f in FIELDS:
        assert getattr(got, f) == getattr(sent, f), f
    assert [type(p).__name__ for p in got.aggregations] == [type(p).__name__ for p in sent.aggregations]
    assert got.aggregations[6].values == {"a", "b", 3}
    np.testing.assert_array_equal(got.aggregations[7].registers, np.arange(256, dtype=np.uint8))
    assert got.aggregations[8].counts == {1.0: 3, 2.5: 7}
    assert {k: v[0].total for k, v in got.groups.items()} == {("a", "1"): 2.0, ("b", "2"): 3.0}


@pytest.mark.parametrize("trace", [False, True])
def test_instance_requests_are_byte_identical(trace):
    args = ("broker0-abc123-7", "SELECT count(*) FROM testTable WHERE dimInt > 3", "testTable",
            ["w0", "w1", "w2"], 14_999.5)
    kw = dict(trace=trace, debug_options={"optimizationFlags": "-multipleOrEqualitiesToInClause"})
    ours = dt.serialize_instance_request(*args, **kw)
    theirs = ref_dt.serialize_instance_request(*args, **kw)
    assert ours == theirs
    assert dt.deserialize_instance_request(theirs) == ref_dt.deserialize_instance_request(ours)
    assert dt.deserialize_instance_request(ours)["trace"] is trace


@pytest.mark.parametrize(
    "values",
    [
        np.array([2.5, -1.0, 1e300, 0.0, 7.25]),
        np.array([3.5, 1.25, 2.0], dtype=np.float32),
        np.array([10, -2, 7, 2**40], dtype=np.int64),
        np.array([5, 1, 3], dtype=np.uint16),
        np.array(["b", "a"], dtype=object),
        {"x", "y", 4.5},
        {1, 2, 30},
    ],
    ids=["f64", "f32", "i64", "u16", "strings", "mixed_set", "int_set"],
)
def test_distinct_values_bulk_coded_as_the_reference_writes_them(values):
    ours = dt.serialize_result(results.IntermediateResult(aggregations=[results.DistinctPartial(values)]))
    theirs = ref_dt.serialize_result(
        ref_results.IntermediateResult(aggregations=[ref_results.DistinctPartial(values)])
    )
    assert ours == theirs
    assert (dt.deserialize_result(theirs).aggregations[0].values
            == ref_dt.deserialize_result(ours).aggregations[0].values)
