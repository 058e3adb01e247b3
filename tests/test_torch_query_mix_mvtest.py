"""The seeded ``QueryGenerator`` mix over ``make_test_schema()`` with its
multi-value columns (the reference tests' default schema: MV_ANY and
MV_NONE leaves, MV group columns, ``distinctcountmv``), through the
port's executor and the JAX package's, compared as client payloads with
``payloads_equivalent`` (x64).

Every query must answer (no ``NotImplementedError``) and equal the
reference: keys, group order, counts, distinct counts, percentiles and
selection rows exactly, float sums within rel 1e-9 / abs 2e-5 (as in
``test_torch_engine.py``).
"""
import pytest

from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema as ref_make_test_schema
from pinot_tpu.tools.datagen import random_rows
from pinot_tpu.tools.query_gen import QueryGenerator
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays

REL, ABS = 1e-9, 2e-5
SEED = 17
QUERIES = 100

ROWS = random_rows(ref_make_test_schema(), 1500, seed=5)
SEGMENTS = [
    ref_build_segment(ref_make_test_schema(), ROWS[i * 500 : (i + 1) * 500], "testTable", f"t{i}")
    for i in range(3)
]
PORT = [segment_from_arrays(**segment_arrays_of(s)) for s in SEGMENTS]
REF = RefExecutor()
PORT_EX = QueryExecutor(device="cpu", precision="x64")
_GEN = QueryGenerator(ref_make_test_schema(), ROWS, table="testTable", seed=SEED)
MIX = [_GEN.next_query() for _ in range(QUERIES)]


@pytest.mark.parametrize("i", range(QUERIES))
def test_query_mix_matches_reference(i):
    pql = MIX[i]
    ref_req = ref_optimize(ref_parse(pql))
    want = canonical_payload(ref_req, REF.execute(SEGMENTS, ref_req))
    req = optimize_request(parse_pql(pql))
    got = strip_accounting(reduce_to_response(req, [PORT_EX.execute(PORT, req)]).to_json())
    heal = PORT_EX.healing_stats()
    assert heal["deviceFailures"] == heal["hostFailovers"] == 0, heal  # no device run failed over
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (pql, got, want)


def test_the_mix_reaches_the_mv_shapes():
    """The generated queries hold the MV shapes this file is for."""
    text = " ".join(MIX)
    assert "distinctcountmv(" in text
    assert any("GROUP BY" in q and ("dimStrMV" in q.split("GROUP BY")[1] or "dimIntMV" in q.split("GROUP BY")[1])
               for q in MIX)
    assert any("WHERE" in q and "MV" in q.split("WHERE")[1].split("GROUP BY")[0] for q in MIX)
