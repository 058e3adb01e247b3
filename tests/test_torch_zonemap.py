"""Zone-map block skipping: the port's ``engine/zonemap.py`` and its block
path (K1 and K2 over a block table, the torch-op route over gathered
blocks) against the JAX package's ``engine/zonemap.py`` and block kernel,
on the reference's eight zone-map queries (``tests/test_zonemap.py``)
over the same 3 x 20,000-row lineitem segments, at a 1024-row block.

The reference reads its block size from ``PINOT_TPU_ZONE_BLOCK`` and
answers selective queries from postings unless ``PINOT_TPU_INVINDEX=0``,
so both are set; the port's executors take ``postings=False,
bitsliced=False``, its switches for the two tiers ahead of the blocks, so
both packages take the block path.  Candidate maps
compare exactly; answers compare with the audit comparison at rel 1e-9 /
abs 2e-5 (both sides sum in float64 over the same rows in the same
order); ``numEntriesScannedInFilter`` compares exactly.
"""
import numpy as np
import pytest
import torch

from pinot_tpu.engine import zonemap as ref_zonemap
from pinot_tpu.engine.context import TableContext as RefContext
from pinot_tpu.engine.device import stage_segments as ref_stage_segments
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.engine.plan import build_query_inputs as ref_build_query_inputs
from pinot_tpu.engine.plan import build_static_plan as ref_build_static_plan
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.engine import config, kernel, zonemap
from pinot_tpu_torch.engine.config import Precision
from pinot_tpu_torch.engine.context import TableContext
from pinot_tpu_torch.engine.device import stage_segments
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.kernels import fused_groupby, value_state_counts
from pinot_tpu_torch.engine.plan import build_query_inputs, build_static_plan
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.tools.datagen import synthetic_lineitem_segment

BLOCK = 1024
REL, ABS = 1e-9, 2e-5

# tests/test_zonemap.py:25-42
QUERIES = [
    "SELECT sum(l_quantity), count(*) FROM lineitem WHERE l_shipdate <= '1992-02-01' GROUP BY l_returnflag TOP 10",
    "SELECT sum(l_extendedprice) FROM lineitem WHERE l_shipdate = '1995-06-14'",
    "SELECT count(*) FROM lineitem WHERE l_shipmode IN ('RAIL','FOB') AND l_shipdate BETWEEN '1993-01-01' AND '1993-03-01'",
    "SELECT max(l_discount) FROM lineitem WHERE l_shipdate > '1998-11-30'",
    "SELECT count(*) FROM lineitem WHERE l_shipdate <= '1992-02-01' OR l_shipdate > '1998-10-01'",
    "SELECT sum(l_tax) FROM lineitem WHERE l_shipdate IN ('1994-01-05','1997-03-22')",
    "SELECT l_shipdate, l_quantity FROM lineitem WHERE l_shipdate = '1995-06-14' ORDER BY l_quantity DESC LIMIT 5",
    "SELECT count(*) FROM lineitem WHERE l_shipdate NOT IN ('1995-06-14') AND l_shipdate BETWEEN '1995-06-01' AND '1995-06-30'",
]
# the block path through K1's fused route and K2's fused value route
# (chip_smoke.py's zone_in and zone_distinct)
ZONE_DATES = "('1993-03-14','1995-06-14','1997-09-14')"
KERNEL_QUERIES = [
    "SELECT sum(l_quantity), sum(l_extendedprice), sum(l_discount), count(*) FROM lineitem "
    f"WHERE l_shipdate IN {ZONE_DATES} GROUP BY l_returnflag, l_linestatus TOP 10",
    f"SELECT distinctcount(l_extendedprice) FROM lineitem WHERE l_shipdate IN {ZONE_DATES}",
]

REF_SEGMENTS = [ref_synthetic(20000, seed=7 + i, name=f"li{i}") for i in range(3)]
PORT_SEGMENTS = [synthetic_lineitem_segment(20000, seed=7 + i, name=f"li{i}") for i in range(3)]


def _executor(**kw):
    """A port executor past the postings and bit-sliced tiers (the
    reference side runs with ``PINOT_TPU_INVINDEX=0``)."""
    return QueryExecutor(device="cpu", precision="x64", postings=False, bitsliced=False, **kw)


@pytest.fixture(autouse=True)
def small_zone_block(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_ZONE_BLOCK", str(BLOCK))
    monkeypatch.setenv("PINOT_TPU_INVINDEX", "0")
    monkeypatch.setattr(config, "ZONE_BLOCK", BLOCK)


def _ref_candidates(pql):
    req = ref_optimize(ref_parse(pql))
    ex = RefExecutor()
    live = REF_SEGMENTS
    needed = set(req.referenced_columns()) - ex._docrange_only_columns(req, live, None)
    ctx = RefContext(live)
    raw, gfwd, hll = ex._role_columns(req, live, ctx)
    st = ref_stage_segments(live, sorted(needed), raw_columns=raw, gfwd_columns=gfwd, hll_columns=hll,
                            ctx=ctx, skip_base_columns=ex._skip_base_columns(req, live, raw, gfwd, hll))
    plan = ref_build_static_plan(req, ctx, st)
    return ref_zonemap.candidate_blocks(plan, ref_build_query_inputs(req, plan, ctx, st), live, st.n_pad)


def _port_candidates(pql):
    req = optimize_request(parse_pql(pql))
    ex = _executor()
    live = PORT_SEGMENTS
    needed = set(req.referenced_columns()) - ex._docrange_only_columns(req, live)
    ctx = TableContext(live)
    raw, gfwd, hll = ex._role_columns(req, live, ctx)
    st = stage_segments(live, sorted(needed), torch.device("cpu"), Precision("x64"), raw_columns=raw,
                        gfwd_columns=gfwd, ctx=ctx, hll_columns=hll,
                        skip_base_columns=ex._skip_base_columns(req, live, raw, gfwd, hll))
    plan = build_static_plan(req, ctx, st)
    return zonemap.candidate_blocks(plan, build_query_inputs(req, plan, ctx, st), live, st.n_pad)


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_candidate_maps_equal_the_reference(i):
    want = _ref_candidates(QUERIES[i])
    got = _port_candidates(QUERIES[i])
    assert want is not None and got is not None
    np.testing.assert_array_equal(got, want)


# the leaf forms the eight queries leave out: a match table and dictId
# runs on the clustered column, an interval, a NOT IN and an OR on an
# unclustered one
LEAF_FORM_QUERIES = [
    "SELECT count(*) FROM lineitem WHERE regexp_like(l_shipdate, '199[34].*5$')",
    "SELECT count(*) FROM lineitem WHERE regexp_like(l_shipdate, '1993-0[1-5].*5$')",
    "SELECT count(*) FROM lineitem WHERE l_receiptdate BETWEEN '1993-01-01' AND '1994-03-01'",
    "SELECT count(*) FROM lineitem WHERE l_receiptdate NOT IN ('1993-03-14','1995-06-14') "
    "AND l_shipdate > '1997-01-01'",
    "SELECT count(*) FROM lineitem WHERE l_receiptdate IN ('1993-03-14','1995-06-14') OR l_shipdate = '1997-01-01'",
]


@pytest.mark.parametrize("pql", LEAF_FORM_QUERIES)
def test_candidate_maps_of_every_leaf_form_equal_the_reference(pql):
    want = _ref_candidates(pql)
    got = _port_candidates(pql)
    assert want is not None and got is not None
    np.testing.assert_array_equal(got, want)


def test_block_ids_list_each_segments_candidates_in_order():
    cand = np.array([[0, 1, 0, 1, 1], [0, 0, 0, 0, 0], [1, 0, 0, 0, 1]], dtype=bool)
    np.testing.assert_array_equal(
        zonemap.block_ids_input(cand, 4), [[1, 3, 4, -1], [-1, -1, -1, -1], [0, 4, -1, -1]])
    # rows of the candidate blocks below num_docs (block 256)
    ids = SOME_IDS.numpy()
    want = sum(int(np.clip(np.minimum(int(NUM_DOCS[s]), (b + 1) * BLK) - b * BLK, 0, None))
               for s in range(S) for b in ids[s] if b >= 0)
    assert zonemap.block_rows_read(ids, NUM_DOCS.tolist(), BLK) == want == 3 * BLK + 4 * BLK - 156


@pytest.mark.parametrize("pql", QUERIES + KERNEL_QUERIES)
def test_block_path_answers_equal_the_reference(pql):
    ref_req = ref_optimize(ref_parse(pql))
    ref_part = RefExecutor().execute(REF_SEGMENTS, ref_req)
    want = canonical_payload(ref_req, ref_part)
    req = optimize_request(parse_pql(pql))
    before = kernel.block_dispatches
    part = _executor().execute(PORT_SEGMENTS, req)
    got = strip_accounting(reduce_to_response(req, [part]).to_json())
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (pql, got, want)
    # the block path engaged: one block dispatch, candidate rows scanned
    assert kernel.block_dispatches == before + 1
    assert part.num_entries_scanned_in_filter == ref_part.num_entries_scanned_in_filter
    assert part.cost.get("segmentsZonemap") == len(PORT_SEGMENTS)
    assert part.num_entries_scanned_in_filter < sum(s.num_docs for s in PORT_SEGMENTS) / 2


@pytest.mark.parametrize("pql", [QUERIES[1], QUERIES[6]] + KERNEL_QUERIES)
def test_zone_maps_off_scans_every_row(pql):
    req = optimize_request(parse_pql(pql))
    on = _executor().execute(PORT_SEGMENTS, req)
    before = kernel.block_dispatches
    off = _executor(zone_maps=False).execute(
        PORT_SEGMENTS, optimize_request(parse_pql(pql)))
    assert kernel.block_dispatches == before
    assert off.cost.get("segmentsFullScan") == len(PORT_SEGMENTS) and not off.cost.get("segmentsZonemap")
    assert off.num_entries_scanned_in_filter > on.num_entries_scanned_in_filter
    assert off.cost["bytesScanned"] > on.cost["bytesScanned"] > 0
    a = strip_accounting(reduce_to_response(req, [on]).to_json())
    b = strip_accounting(reduce_to_response(req, [off]).to_json())
    assert payloads_equivalent(a, b, rel_tol=REL, abs_tol=ABS)


@pytest.mark.parametrize("limit", ["grid", "fraction"])
@pytest.mark.parametrize("pql", [QUERIES[1]] + KERNEL_QUERIES)
def test_a_block_table_past_a_limit_is_a_full_scan(pql, limit, monkeypatch):
    """A block table with more entries than one launch's grid holds, or a
    candidate window over ``config.ZONE_MAX_FRACTION`` of the table,
    falls back to a full scan with the same answer, never an error."""
    if limit == "grid":
        monkeypatch.setattr(fused_groupby, "MAX_GRID_Y", len(PORT_SEGMENTS) - 1)
    else:
        monkeypatch.setattr(config, "ZONE_MAX_FRACTION", 0.0)
    req = optimize_request(parse_pql(pql))
    before = kernel.block_dispatches
    part = _executor().execute(PORT_SEGMENTS, req)
    assert kernel.block_dispatches == before
    assert part.cost.get("segmentsFullScan") == len(PORT_SEGMENTS) and not part.cost.get("segmentsZonemap")
    full = _executor(zone_maps=False).execute(PORT_SEGMENTS, req)
    assert part.num_entries_scanned_in_filter == full.num_entries_scanned_in_filter
    a = strip_accounting(reduce_to_response(req, [part]).to_json())
    b = strip_accounting(reduce_to_response(req, [full]).to_json())
    assert payloads_equivalent(a, b, rel_tol=REL, abs_tol=ABS)


def test_zones_cached_per_segment():
    z1 = zonemap.column_zones(PORT_SEGMENTS[0], "l_shipdate", BLOCK)
    assert z1 is zonemap.column_zones(PORT_SEGMENTS[0], "l_shipdate", BLOCK)
    rz = ref_zonemap.column_zones(REF_SEGMENTS[0], "l_shipdate", BLOCK)
    np.testing.assert_array_equal(z1[0], rz[0])
    np.testing.assert_array_equal(z1[1], rz[1])


# -- the kernels' plain versions over a block table ------------------------

S, NB, BLK = 3, 8, 256
N_PAD = NB * BLK


def _streams(seed):
    rng = np.random.default_rng(seed)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dt)  # noqa: E731
    return dict(
        fwd=t(rng.integers(0, 40, (S, N_PAD)), torch.int16),
        g0=t(rng.integers(0, 3, (S, N_PAD)), torch.uint8),
        g1=t(rng.integers(0, 5, (S, N_PAD)), torch.int32),
        raw=t(rng.random((S, N_PAD)) * 100, torch.float64),
        vfwd=t(rng.integers(0, 30, (S, N_PAD)), torch.int16),
        vdict=t(np.sort(rng.random((S, 30)) * 10, axis=1), torch.float64),
        val=t(rng.integers(0, 500, (S, N_PAD)), torch.int32),
        match=t(rng.random((S, 40)) < 0.5, torch.bool),
    )


# every block of every segment a candidate, ids in order, none padded:
# then the gathered rows are the table's rows in block order
ALL_IDS = torch.arange(NB, dtype=torch.int32).repeat(S, 1).contiguous()
# candidate blocks with -1 padding, a segment with none, rows past num_docs
SOME_IDS = torch.tensor([[1, 4, 7, -1], [-1, -1, -1, -1], [0, 2, 3, 6]], dtype=torch.int32)
NUM_DOCS = torch.tensor([N_PAD, N_PAD - 7, 6 * BLK + 100], dtype=torch.int32)


def _gather(t, ids):
    rowid, _ = fused_groupby.candidate_rows(ids, BLK)
    return torch.gather(t, 1, rowid)


FILTERS = {
    "interval": lambda s: dict(filter_fwd=s["fwd"], filter_bounds=torch.tensor([[5, 30]] * S, dtype=torch.int32)),
    "table": lambda s: dict(filter_fwd=s["fwd"], match=s["match"]),
    "docrange": lambda s: dict(filter_bounds=torch.tensor([[100, 1500], [0, N_PAD], [300, 1800]],
                                                        dtype=torch.int32)),
}


def _k1(s, ids=None, gather=False, num_docs=None, **filt):
    g = (lambda t: _gather(t, ids)) if gather else (lambda t: t)
    nd = num_docs if num_docs is not None else torch.full((S,), N_PAD, dtype=torch.int32)
    filt = {k: (g(v) if k == "filter_fwd" else v) for k, v in filt.items()}
    kw = {} if gather or ids is None else dict(block_ids=ids, block_rows=BLK)
    return fused_groupby.fused_filtered_groupby_sums(
        filt.get("filter_fwd"), filt.get("match"), nd, None, [g(s["vfwd"]), None],
        [s["vdict"], None], 15, dtype=torch.float64, filter_bounds=filt.get("filter_bounds"),
        value_raws=[None, g(s["raw"])], group_cols=[g(s["g0"]), g(s["g1"])], group_cards=[3, 5], **kw)


@pytest.mark.parametrize("form", ["interval", "table"])
def test_k1_plain_over_a_block_table_equals_full_scan_of_gathered_rows(form):
    s = _streams(1)
    ids = torch.tensor([[0, 3, 5, 6]] * S, dtype=torch.int32)
    got = _k1(s, ids, **FILTERS[form](s))
    want = _k1(s, ids, gather=True, **FILTERS[form](s))  # [S, 4 * BLK], every row valid
    assert int(got[0]) == int(want[0])
    assert torch.equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)  # same rows in the same order: bit-equal sums


@pytest.mark.parametrize("form", ["interval", "table", "docrange"])
def test_k1_plain_over_a_block_table_equals_a_row_oracle(form):
    s = _streams(2)
    filt = FILTERS[form](s)
    docs, count, sums = _k1(s, SOME_IDS, num_docs=NUM_DOCS, **filt)
    # the oracle: rows of the candidate blocks below num_docs that pass
    rows = np.arange(N_PAD)
    exp_docs, exp_count, exp_sum = 0, np.zeros(15, np.int64), np.zeros(15)
    for seg in range(S):
        cand = [int(b) for b in SOME_IDS[seg] if b >= 0]
        keep = np.isin(rows // BLK, cand) & (rows < int(NUM_DOCS[seg]))
        if form == "interval":
            f = s["fwd"][seg].numpy()
            keep &= (f >= 5) & (f < 30)
        elif form == "table":
            keep &= s["match"][seg].numpy()[s["fwd"][seg].numpy()]
        else:
            lo, hi = filt["filter_bounds"][seg].tolist()
            keep &= (rows >= lo) & (rows < hi)
        exp_docs += int(keep.sum())
        key = s["g0"][seg].numpy().astype(np.int64) * 5 + s["g1"][seg].numpy()
        np.add.at(exp_count, key[keep], 1)
        np.add.at(exp_sum, key[keep], s["raw"][seg].numpy()[keep])
    assert int(docs) == exp_docs
    np.testing.assert_array_equal(count.numpy(), exp_count)
    np.testing.assert_allclose(sums[1].numpy(), exp_sum, rtol=1e-12)


@pytest.mark.parametrize("mode", ["counts", "presence", "registers"])
def test_k2_plain_over_a_block_table_equals_full_scan_of_gathered_rows(mode):
    s = _streams(3)
    ids = torch.tensor([[1, 2, 4, 7]] * S, dtype=torch.int32)
    nd = torch.full((S,), N_PAD, dtype=torch.int32)

    def run(gather):
        g = (lambda t: _gather(t, ids)) if gather else (lambda t: t)
        kw = {} if gather else dict(block_ids=ids, block_rows=BLK)
        vals = dict(values=g(s["val"]), width=512) if mode != "registers" else dict(
            values=g((s["val"] % 256).to(torch.uint8)), rho=g((s["val"] % 7).to(torch.uint8)))
        return value_state_counts.value_state(
            mode, nd, **vals, capacity=3, filter_fwd=g(s["fwd"]), match=s["match"],
            group_cols=[g(s["g0"])], group_cards=[3], **kw)

    got, want = run(False), run(True)
    assert int(got[0]) == int(want[0]) > 0
    assert torch.equal(got[1], want[1])


def test_k2_plain_over_a_block_table_skips_dead_blocks_and_rows():
    s = _streams(4)
    filt = FILTERS["docrange"](s)
    docs, counts = value_state_counts.value_state(
        "counts", NUM_DOCS, s["val"], width=500, block_ids=SOME_IDS, block_rows=BLK, **filt)
    rows = np.arange(N_PAD)
    exp = np.zeros(500, np.int64)
    n = 0
    for seg in range(S):
        cand = [int(b) for b in SOME_IDS[seg] if b >= 0]
        lo, hi = filt["filter_bounds"][seg].tolist()
        keep = np.isin(rows // BLK, cand) & (rows < int(NUM_DOCS[seg])) & (rows >= lo) & (rows < hi)
        n += int(keep.sum())
        np.add.at(exp, s["val"][seg].numpy()[keep], 1)
    assert int(docs) == n
    np.testing.assert_array_equal(counts.numpy(), exp)


def test_block_table_contract():
    s = _streams(5)
    with pytest.raises(ValueError):  # block does not divide n_pad
        value_state_counts.value_state("counts", NUM_DOCS, s["val"], width=500,
                                       block_ids=SOME_IDS, block_rows=BLK + 1)
    with pytest.raises(ValueError):  # wrong dtype
        _k1(s, SOME_IDS.to(torch.int64), **FILTERS["interval"](s))


@pytest.mark.parametrize("i,route,kernel_name", [(0, "fused_dispatches", "k1"), (1, "fused_value_dispatches", "k2")])
def test_the_fused_routes_hand_the_kernels_the_block_table(i, route, kernel_name, monkeypatch):
    """zone_in (a three-date point list: a match table) takes K1's fused
    route and zone_distinct K2's fused value route, and each kernel gets
    the block table of the candidate blocks, not gathered rows.  The
    card's staging (every aggregated column raw) is what puts zone_in's
    l_extendedprice in K1's reach, as on the card."""
    monkeypatch.setattr(config, "raw_card_min", lambda device: 0)
    calls = []
    module, fn = (fused_groupby, "fused_filtered_groupby_sums") if kernel_name == "k1" else \
        (value_state_counts, "value_state")
    real = getattr(module, fn)

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    monkeypatch.setattr(module, fn, spy)
    before = getattr(kernel, route)
    _executor().execute(PORT_SEGMENTS, optimize_request(parse_pql(KERNEL_QUERIES[i])))
    assert getattr(kernel, route) == before + 1
    ((args, kw),) = calls
    ids = kw["block_ids"]
    assert kw["block_rows"] == BLOCK and ids.shape[0] == len(PORT_SEGMENTS)
    match = args[1] if kernel_name == "k1" else kw["match"]
    assert match is not None and int(match.sum()) == 3 * len(PORT_SEGMENTS)  # the point list as a match table
    live = ids[ids >= 0]
    assert 0 < live.numel() <= 6 * len(PORT_SEGMENTS)  # at most two blocks a date
