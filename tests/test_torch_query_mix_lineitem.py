"""The seeded ``QueryGenerator`` mix over row-built lineitem segments,
through the port's executor and the JAX package's, compared as client
payloads with ``payloads_equivalent`` (x64).

Every query must answer (no ``NotImplementedError``) and equal the
reference: keys, group order, counts, distinct counts, percentiles and
selection rows exactly, float sums within rel 1e-9 / abs 2e-5 (as in
``test_torch_engine.py``).  Group order among equal printed sums is
compared byte for byte, so the port's grouped float sums must add in the
reference's order: each segment's rows in row order, then the segments
in order.  ``test_grouped_float_sums_add_in_the_reference_order`` pins
that on a query whose sums tie at the trim boundary.
"""
import pytest

from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import lineitem_rows as ref_lineitem_rows
from pinot_tpu.tools.datagen import lineitem_schema as ref_lineitem_schema
from pinot_tpu.tools.query_gen import QueryGenerator
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays

REL, ABS = 1e-9, 2e-5
SEEDS = (7, 11, 23)
PER_SEED = 34  # queries per seed: about 100 over the three

ROWS = ref_lineitem_rows(6000, seed=3)
SEGMENTS = [
    ref_build_segment(ref_lineitem_schema(), ROWS[i * 2000 : (i + 1) * 2000], "lineitem", f"li{i}")
    for i in range(3)
]
PORT = [segment_from_arrays(**segment_arrays_of(s)) for s in SEGMENTS]
REF = RefExecutor()
PORT_EX = QueryExecutor(device="cpu", precision="x64")


def _mix(seed):
    gen = QueryGenerator(ref_lineitem_schema(), ROWS, table="lineitem", seed=seed)
    return [gen.next_query() for _ in range(PER_SEED)]


MIX = {seed: _mix(seed) for seed in SEEDS}


def _payloads(pql):
    ref_req = ref_optimize(ref_parse(pql))
    want = canonical_payload(ref_req, REF.execute(SEGMENTS, ref_req))
    req = optimize_request(parse_pql(pql))
    got = strip_accounting(reduce_to_response(req, [PORT_EX.execute(PORT, req)]).to_json())
    heal = PORT_EX.healing_stats()
    assert heal["deviceFailures"] == heal["hostFailovers"] == 0, heal  # no device run failed over
    return got, want


@pytest.mark.parametrize("seed,i", [(s, i) for s in SEEDS for i in range(PER_SEED)])
def test_query_mix_matches_reference(seed, i):
    pql = MIX[seed][i]
    got, want = _payloads(pql)
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (pql, got, want)


def _sums(executor, segments, pql, parse):
    return {k: v[0].total for k, v in executor.execute(segments, parse(pql)).groups.items()}


def test_grouped_float_sums_add_in_the_reference_order():
    """``sum(l_tax) GROUP BY l_receiptdate``: every group sum bit-equal to
    the reference's (TOP 1000 keeps every group past the server trim), and
    at TOP 10 the trim keeps the same groups as the reference's: its
    boundary is a tie at 0.25, so an ulp moves groups across it."""
    port_ex = QueryExecutor(device="cpu", precision="x64")
    ref_parse_req = lambda pql: ref_optimize(ref_parse(pql))  # noqa: E731
    parse = lambda pql: optimize_request(parse_pql(pql))  # noqa: E731
    every = "SELECT sum(l_tax) FROM lineitem GROUP BY l_receiptdate TOP 1000"
    want = _sums(REF, SEGMENTS, every, ref_parse_req)
    assert len(want) > 100  # more groups than the trim's 100 candidates
    assert _sums(port_ex, PORT, every, parse) == want
    top = "SELECT sum(l_tax) FROM lineitem GROUP BY l_receiptdate TOP 10"
    want = _sums(REF, SEGMENTS, top, ref_parse_req)
    assert len(want) < len(_sums(REF, SEGMENTS, every, ref_parse_req))
    assert _sums(port_ex, PORT, top, parse) == want
    got, want = _payloads(top)
    assert got == want
