"""Segment-axis chunking past the per-dispatch row budget
(``config.CHUNK_ROWS``, ``kernel.make_chunked_table_kernel``), the twin of
``tests/test_engine_edge.py:245-272``: the reference's three queries over
6 x 4096-row lineitem segments with chunking off and at 2-segment chunks
give equal payloads, and both equal the JAX package's chunked run
(``PINOT_TPU_CHUNK_ROWS=8192``) at rel 1e-9 / abs 2e-5.  Past the budget a
block-path query is answered as a chunked full scan, and a chunked
dispatch never batches; ``_pick_chunk`` equals the reference's.
"""
import json
import threading
import time

import pytest

from pinot_tpu.engine import kernel as ref_kernel
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.engine import config, kernel
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.server.instance import ServerInstance

REL, ABS = 1e-9, 2e-5
REF_SEGMENTS = [ref_synthetic(4096, seed=41 + i, name=f"ck{i}") for i in range(6)]
PORT_SEGMENTS = [segment_from_arrays(**segment_arrays_of(s)) for s in REF_SEGMENTS]
CHUNK = 8192  # 2 segments of 4096 rows a dispatch

# tests/test_engine_edge.py:259-264, then the chunked phase's K2 shapes
QUERIES = [
    "SELECT sum(l_quantity), count(*), min(l_discount), max(l_tax) FROM lineitem "
    "WHERE l_shipdate <= '1998-09-02' GROUP BY l_returnflag TOP 10",
    "SELECT avg(l_extendedprice) FROM lineitem",
    "SELECT distinctcounthll(l_shipdate) FROM lineitem GROUP BY l_linestatus TOP 10",
]
MORE = [
    "SELECT percentile90(l_quantity) FROM lineitem GROUP BY l_shipmode TOP 10",
    "SELECT distinctcount(l_extendedprice) FROM lineitem WHERE l_quantity > 25",
    "SELECT sum(l_extendedprice), min(l_quantity), count(*) FROM lineitem "
    "WHERE l_quantity > 45 OR l_shipmode = 'AIR' GROUP BY l_returnflag, l_linestatus TOP 10",
]


def _port(pql, rows, monkeypatch, executor=None):
    monkeypatch.setattr(config, "CHUNK_ROWS", rows)
    req = optimize_request(parse_pql(pql))
    res = (executor or QueryExecutor(device="cpu")).execute(PORT_SEGMENTS, req)
    return reduce_to_response(req, [res]), res


@pytest.mark.parametrize("pql", QUERIES + MORE)
def test_chunked_payloads_equal_unchunked_and_the_reference(pql, monkeypatch):
    outs = {}
    for rows in (0, CHUNK):
        before = kernel.chunked_dispatches
        resp, res = _port(pql, rows, monkeypatch)
        assert kernel.chunked_dispatches - before == (1 if rows else 0)
        assert res.cost["segmentsFullScan"] == len(PORT_SEGMENTS)
        outs[rows] = resp
    assert json.dumps(outs[0].to_json()["aggregationResults"], sort_keys=True) == \
        json.dumps(outs[CHUNK].to_json()["aggregationResults"], sort_keys=True), pql
    monkeypatch.setenv("PINOT_TPU_CHUNK_ROWS", str(CHUNK))
    req = ref_optimize(ref_parse(pql))
    want = canonical_payload(req, RefExecutor().execute(REF_SEGMENTS, req))
    assert payloads_equivalent(strip_accounting(outs[CHUNK].to_json()), want, rel_tol=REL, abs_tol=ABS), pql


def test_pair_and_selection_plans_are_not_chunked(monkeypatch):
    for pql in ("SELECT distinctcount(l_extendedprice) FROM lineitem GROUP BY l_shipdate TOP 10",
                "SELECT l_shipmode, l_extendedprice FROM lineitem WHERE l_quantity > 45 LIMIT 7"):
        before = kernel.chunked_dispatches
        chunked, _ = _port(pql, CHUNK, monkeypatch)
        whole, _ = _port(pql, 0, monkeypatch)
        assert kernel.chunked_dispatches == before
        assert strip_accounting(chunked.to_json()) == strip_accounting(whole.to_json())


def test_a_block_path_query_past_the_budget_is_a_chunked_full_scan(monkeypatch):
    """Past the row budget the block table (which has no chunked form)
    is off: the chunked full scan answers, equal to the block path's
    answer under the budget.  The executor is past the postings tier,
    which would answer this one-date filter ahead of the blocks."""
    monkeypatch.setattr(config, "ZONE_BLOCK", 512)
    pql = ("SELECT sum(l_quantity), count(*) FROM lineitem WHERE l_shipdate = '1995-06-14' "
           "GROUP BY l_returnflag, l_linestatus TOP 10")
    ex = QueryExecutor(device="cpu", postings=False, bitsliced=False)
    b0, c0 = kernel.block_dispatches, kernel.chunked_dispatches
    blocks, res_b = _port(pql, 0, monkeypatch, ex)
    assert kernel.block_dispatches == b0 + 1 and res_b.cost["segmentsZonemap"] == len(PORT_SEGMENTS)
    chunked, res_c = _port(pql, CHUNK, monkeypatch, ex)
    assert kernel.block_dispatches == b0 + 1 and kernel.chunked_dispatches == c0 + 1
    assert res_c.cost["segmentsFullScan"] == len(PORT_SEGMENTS) and "segmentsZonemap" not in res_c.cost
    assert json.dumps(blocks.to_json()["aggregationResults"], sort_keys=True) == \
        json.dumps(chunked.to_json()["aggregationResults"], sort_keys=True)


def test_the_row_budget_caps_and_stops_batching(monkeypatch):
    """max_members is the largest power of two under budget / rows; a
    table past the budget (a chunked dispatch) carries no batch spec."""
    ex = QueryExecutor(device="cpu")
    req = optimize_request(parse_pql(QUERIES[0]))
    seen = []
    real = ex._batch_spec
    monkeypatch.setattr(ex, "_batch_spec", lambda *a: seen.append(real(*a)) or seen[-1])

    class _Lane:  # runs each launch inline; batching needs queued peers
        batch_max = 16

        def submit(self, key, launch, deadline=None, plan_digest=None, cost_provider=None, batch=None):
            class T:
                coalesced, batch_size, device_start = False, 1, None

                def result(self, deadline=None, v=launch()):
                    return v
            return T()

    ex.lane = _Lane()
    rows = len(PORT_SEGMENTS) * 4096
    for limit, want in ((rows * 5, 4), (rows * 2, 2), (0, 0)):
        monkeypatch.setattr(config, "CHUNK_ROWS", limit)
        ex.execute(PORT_SEGMENTS, req)
        assert seen[-1].max_members == want, limit
    seen.clear()
    monkeypatch.setattr(config, "CHUNK_ROWS", CHUNK)
    ex.execute(PORT_SEGMENTS, req)
    assert seen == []  # chunked: no spec asked for


def test_a_chunked_table_does_not_batch_on_a_server(monkeypatch):
    monkeypatch.setattr(config, "CHUNK_ROWS", CHUNK)
    server = ServerInstance("s0", device="cpu")
    try:
        for seg in PORT_SEGMENTS:
            server.add_segment("lineitem", seg)
        ex = server.executor
        # three literals of one plan, queued together: distinct dispatches
        reqs = [optimize_request(parse_pql(QUERIES[0].replace("1998-09-02", d)))
                for d in ("1993-01-01", "1995-01-01", "1997-01-01")]
        gate = threading.Event()
        server.lane.submit(("blocker",), lambda: gate.wait(10))
        time.sleep(0.05)
        c0 = kernel.chunked_dispatches
        out = []
        threads = [threading.Thread(target=lambda r=r: out.append(ex.execute(PORT_SEGMENTS, r))) for r in reqs]
        for t in threads:
            t.start()
        time.sleep(0.3)
        gate.set()
        for t in threads:
            t.join()
        assert len(out) == 3 and kernel.chunked_dispatches == c0 + 3
        assert server.lane.stats()["batchLaunches"] == 0
        assert not any(r.cost.get("batchHits") for r in out)
    finally:
        server.shutdown()


@pytest.mark.parametrize("granularity", [1, 2, 4])
def test_pick_chunk_equals_the_reference(granularity):
    for segments in (1, 2, 3, 5, 6, 7, 8, 12, 16, 17, 31, 64):
        for n_pad in (1024, 4096, 1 << 20, 1 << 23):
            for limit in (0, 1, 4096, 8192, 1 << 20, 1 << 26, 1 << 28, 3 * (1 << 23)):
                assert kernel._pick_chunk(segments, n_pad, limit, granularity) == \
                    ref_kernel._pick_chunk(segments, n_pad, limit, granularity), (segments, n_pad, limit)
