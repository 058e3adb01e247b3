"""The bit-sliced tier: the port's encoder (``engine/packing.py``), plane
staging (``engine/device.py``), programs (``engine/kernel.py``) and tier
(``engine/bitsliced.py``) against the JAX package's, on the same seeded
inputs.

The port stages int32 planes where the reference stages uint32 (torch has
no ``>>`` on uint32); viewed as uint32 they compare bit for bit.  Each
program compares exactly with the reference's jnp function on random
planes and on the edge words 0, -1 (all ones), 0x80000000 and a one-bit
tail.  End to end, counts, sums, min and max are exact against the
reference and against the port's own scan tier (the fused SUM is exact
integer arithmetic, so the float64 scan of these integral columns agrees
to the bit), and the tier's accounting (``segmentsBitsliced``,
``numEntriesScannedInFilter``, ``bytesScanned``) equals the reference's.
"""
import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.engine import kernel as ref_kernel
from pinot_tpu.engine import packing as ref_packing
from pinot_tpu.engine.bitsliced import bitsliced_decision as ref_bitsliced_decision
from pinot_tpu.engine.context import TableContext as RefContext
from pinot_tpu.engine.device import stage_segments as ref_stage_segments
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic
from pinot_tpu.utils.audit import canonical_payload

from pinot_tpu_torch.engine import config, kernel, packing
from pinot_tpu_torch.engine.bitsliced import bitsliced_decision
from pinot_tpu_torch.engine.config import Precision
from pinot_tpu_torch.engine.context import TableContext
from pinot_tpu_torch.engine.device import get_staged, stage_segments
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.tools.datagen import synthetic_lineitem_segment

CPU = torch.device("cpu")
REF_SEGMENTS = [ref_synthetic(20000, seed=7, name="bsl0"), ref_synthetic(15000, seed=11, name="bsl1")]
PORT_SEGMENTS = [synthetic_lineitem_segment(20000, seed=7, name="bsl0"),
                 synthetic_lineitem_segment(15000, seed=11, name="bsl1")]
EDGE_WORDS = np.array([0, -1, -0x80000000, 1, 0x7FFFFFFF, 0x55555555, -0x55555556], dtype=np.int32)


# -- the encoder -----------------------------------------------------------


@pytest.mark.parametrize("width", [1, 2, 5, 12, 31, 32])
def test_encode_and_decode_equal_the_reference(width):
    rng = np.random.default_rng(width)
    hi = (1 << width) - 1
    for n in (1, 31, 32, 33, 97):
        vals = rng.integers(0, hi, size=n, endpoint=True, dtype=np.uint64).astype(np.int64)
        n_words = (n + 31) // 32
        got = packing.bitslice_encode(vals, width, n_words)
        want = ref_packing.bitslice_encode(vals, width, n_words)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(packing.bitslice_decode(got, n), vals)
        # int32 planes (the staged dtype) decode the same
        np.testing.assert_array_equal(packing.bitslice_decode(got.view(np.int32), n), vals)
    assert packing.bit_width(hi) == ref_packing.bit_width(hi) == width


def test_encode_out_of_range_raises_and_integral_values_equal_the_reference():
    with pytest.raises(ValueError):
        packing.bitslice_encode(np.array([4]), width=2, n_words=1)
    with pytest.raises(ValueError):
        packing.bitslice_encode(np.array([-1]), width=4, n_words=1)
    for vals in ([1.0, 50.0, 3.0], [1.5, 2.0], [np.nan, 1.0], [2.0**53, 1.0], ["a", "b"],
                 np.array([3, 9], dtype=np.int32), np.zeros(0)):
        got = packing.integral_dictionary_values(np.asarray(vals))
        want = ref_packing.integral_dictionary_values(np.asarray(vals))
        assert (got is None) == (want is None)
        if got is not None:
            assert got.dtype == want.dtype == np.int64
            np.testing.assert_array_equal(got, want)


# -- the staged planes -----------------------------------------------------


@pytest.mark.parametrize("precision", ["x64", "x32"])
def test_staged_planes_equal_the_reference_bit_for_bit(precision):
    bsi, bsiv = ["l_quantity", "l_shipmode", "l_extendedprice", "l_shipdate"], ["l_quantity", "l_extendedprice"]
    want = ref_stage_segments(REF_SEGMENTS, sorted(bsi), skip_base_columns=bsi, bsi_columns=bsi, bsiv_columns=bsiv)
    got = stage_segments(PORT_SEGMENTS, sorted(bsi), CPU, Precision(precision), skip_base_columns=bsi,
                         bsi_columns=bsi, bsiv_columns=bsiv)
    for name in bsi:
        g, w = got.column(name), want.column(name)
        assert g.bsi.dtype == torch.int32 and g.fwd is None
        assert g.bsi_width == w.bsi_width
        np.testing.assert_array_equal(g.bsi.numpy().view(np.uint32), np.asarray(w.bsi))
        assert (g.bsiv is None) == (w.bsiv is None)
        if w.bsiv is not None:
            assert g.bsiv_width == w.bsiv_width and g.bsiv_min == w.bsiv_min
            np.testing.assert_array_equal(g.bsiv.numpy().view(np.uint32), np.asarray(w.bsiv))
    assert got.column("l_extendedprice").bsiv is None  # prices are not integral
    assert got.nbytes() == sum(c.bsi.numel() * 4 + (0 if c.bsiv is None else c.bsiv.numel() * 4)
                               for c in got.columns.values()) + 4 * len(PORT_SEGMENTS)


def test_planes_are_attached_to_a_table_already_staged():
    cache = {}
    cols = ["l_quantity", "l_shipmode"]
    first = get_staged(cache, PORT_SEGMENTS, cols, CPU, Precision("x64"), skip_base_columns=cols)
    before = first.nbytes()
    again = get_staged(cache, PORT_SEGMENTS, cols, CPU, Precision("x64"), skip_base_columns=cols,
                       bsi_columns=cols, bsiv_columns=["l_quantity"])
    assert again is first and len(cache) == 1
    assert first.column("l_shipmode").bsi is not None and first.column("l_quantity").bsiv is not None
    assert first.nbytes() > before


# -- the programs ----------------------------------------------------------


def _planes(seed: int, S: int, width: int, n_words: int, edges: bool = True) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = rng.integers(-2**31, 2**31, size=(S, width, n_words), dtype=np.int64).astype(np.int32)
    if edges:
        k = min(n_words, EDGE_WORDS.size)
        p[0, :, :k] = EDGE_WORDS[:k]
        p[-1, 0, -1] = 1  # a one-bit tail
    return p


def _ref(fn, *args):
    return np.asarray(fn(*args))


@pytest.mark.parametrize("width", [1, 4, 7, 30])
def test_bsi_ge_equals_the_reference(width):
    S, nw = 3, 9
    p = _planes(width, S, width, nw)
    ts = np.array([0, 1, (1 << width) - 1, 1 << width, 5 % (1 << width), 1 << min(width, 29)], dtype=np.int32)
    for t in ts:
        got = kernel._bsi_ge(torch.from_numpy(p), torch.full((S,), int(t), dtype=torch.int32), width)
        for s in range(S):
            want = _ref(ref_kernel._bsi_ge, jnp.asarray(p[s].view(np.uint32)), jnp.int32(t), width)
            np.testing.assert_array_equal(got[s].numpy().view(np.uint32), want)


@pytest.mark.parametrize("width", [1, 3, 6, 30])
def test_bsi_points_equals_the_reference(width):
    S, nw = 2, 8
    p = _planes(10 + width, S, width, nw)
    top = (1 << width) - 1
    pts = np.array([[0, top, -1, -1], [min(3, top), -1, 1 << width, 1]], dtype=np.int32)
    got = kernel._bsi_points(torch.from_numpy(p), torch.from_numpy(pts), width)
    for s in range(S):
        want = _ref(ref_kernel._bsi_points, jnp.asarray(p[s].view(np.uint32)), jnp.asarray(pts[s]), width)
        np.testing.assert_array_equal(got[s].numpy().view(np.uint32), want)


@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("width", [1, 5, 30])
def test_bsi_extreme_equals_the_reference(width, is_max):
    S, nw = 3, 6
    p = _planes(20 + width, S, width, nw)
    bm = _planes(30 + width, S, 1, nw)[:, 0]
    bm[1] = 0  # an empty bitmap: garbage in both, the same garbage
    got = kernel._bsi_extreme(torch.from_numpy(p), torch.from_numpy(bm), width, is_max)
    assert got.dtype == torch.int32
    for s in range(S):
        want = _ref(ref_kernel._bsi_extreme, jnp.asarray(p[s].view(np.uint32)),
                    jnp.asarray(bm[s].view(np.uint32)), width, is_max)
        assert int(got[s]) == int(want)


def test_valid_words_and_popcount_equal_the_reference():
    nd = np.array([0, 1, 31, 32, 33, 64, 200], dtype=np.int32)
    got = kernel._bsi_valid_words(torch.from_numpy(nd), 7)
    for s, n in enumerate(nd):
        want = _ref(ref_kernel._bsi_valid_words, jnp.int32(n), 7)
        np.testing.assert_array_equal(got[s].numpy().view(np.uint32), want)
    words = np.concatenate([EDGE_WORDS, _planes(4, 1, 1, 64, edges=False).reshape(-1)])
    pop = kernel._popcount32(torch.from_numpy(words))
    want = np.unpackbits(words.view(np.uint8)).reshape(-1, 32).sum(axis=1)
    np.testing.assert_array_equal(pop.numpy(), want)
    assert pop.dtype == torch.int32 and int(pop[1]) == 32 and int(pop[2]) == 1


def _encode_ids(ids, n_pad, width):
    return ref_packing.bitslice_encode(ids, width, n_pad // 32)


# tests/test_bitsliced.py's kernel oracle, and the whole program against
# the reference's packed kernel
SPEC = (
    (("interval", "c", 5, 0), ("points", "c", 5, 4), ("points_none", "d", 3, 2)),
    ("or", ("and", ("leaf", 0), ("leaf", 2)), ("leaf", 1)),
    (("c", 6),),
    (("c", 5, True), ("c", 5, False)),
)


def _program_inputs(seed=11):
    rng = np.random.default_rng(seed)
    n_pad = 1024
    docs = [1000, 737, 0]  # uneven: the second ends mid-word; an empty one
    ids = [rng.integers(0, 32, size=n_pad).astype(np.int64) for _ in docs]
    other = [rng.integers(0, 8, size=n_pad).astype(np.int64) for _ in docs]
    vals = [(i * 2) % 61 for i in ids]
    segs = {
        "nd": np.array(docs, dtype=np.int32),
        "p:c": np.stack([_encode_ids(i, n_pad, 5) for i in ids]),
        "p:d": np.stack([_encode_ids(o, n_pad, 3) for o in other]),
        "v:c": np.stack([_encode_ids(v, n_pad, 6) for v in vals]),
    }
    q = {
        "bounds:0": np.array([[3, 10], [0, 32], [5, 6]], dtype=np.int32),
        "pts:1": np.array([[20, 25, -1, -1], [31, -1, -1, -1], [0, 1, 2, 3]], dtype=np.int32),
        "pts:2": np.array([[7, -1], [0, 1], [-1, -1]], dtype=np.int32),
    }
    return segs, q


def _torch_tree(tree):
    return {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v) for k, v in tree.items()}


def test_the_program_equals_the_reference_kernel():
    segs, q = _program_inputs()
    want = ref_kernel.make_packed_bitsliced_kernel(SPEC)(segs, q)
    got = kernel.make_packed_bitsliced_kernel(SPEC)(_torch_tree(segs), _torch_tree(q))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k]
        if k.startswith("ext:"):  # extremes of the empty segment are garbage: masked on count
            w, g = w[:2], g[:2]
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=k)
    assert got["count"].dtype == np.int64 and got["psum:c"].dtype == np.int64


def test_batched_members_equal_their_solo_launches():
    segs, q = _program_inputs()
    rng = np.random.default_rng(2)
    members = []
    for b in range(8):
        m = {k: v.copy() for k, v in q.items()}
        m["bounds:0"][:, 0] = rng.integers(0, 16, 3)
        m["bounds:0"][:, 1] = m["bounds:0"][:, 0] + rng.integers(0, 16, 3)
        m["pts:1"][:, 0] = rng.integers(0, 32, 3)
        members.append(m)
    tsegs = _torch_tree(segs)
    for B in (1, 4, 8):
        stacked = packing.stack_query_inputs(members[:B])
        before = kernel.batched_bitsliced_dispatches
        outs = kernel.make_packed_batched_bitsliced_kernel(SPEC)(tsegs, _torch_tree(stacked))
        assert kernel.batched_bitsliced_dispatches == before + 1
        for b in range(B):
            solo = kernel.make_packed_bitsliced_kernel(SPEC)(tsegs, _torch_tree(members[b]))
            for k in solo:
                assert torch.equal(torch.from_numpy(outs[k][b]), torch.from_numpy(solo[k])), (B, b, k)


# -- the decision ----------------------------------------------------------

DECISIONS = {
    "count_sum_points": ("SELECT count(*), sum(l_quantity) FROM lineitem "
                         "WHERE l_quantity IN (5, 10, 15) AND l_shipmode = 'AIR'", {}),
    "or_minmax": ("SELECT count(*), min(l_quantity), max(l_quantity) FROM lineitem "
                  "WHERE l_quantity NOT IN (1, 2) OR l_shipmode = 'AIR'", {}),
    "interval_all_aggs": ("SELECT sum(l_quantity), count(*), min(l_quantity), max(l_quantity), avg(l_quantity) "
                          "FROM lineitem WHERE l_extendedprice BETWEEN 10000 AND 50000", {}),
    "plane_cap": ("SELECT count(*), min(l_quantity), max(l_quantity), sum(l_quantity) FROM lineitem "
                  "WHERE l_extendedprice BETWEEN 10000 AND 50000", {}),
    "plane_cap_moved": ("SELECT count(*) FROM lineitem WHERE l_quantity > 10", {"BSI_MAX_PLANES": 3}),
    "sorted_deferral": ("SELECT count(*) FROM lineitem WHERE l_shipdate BETWEEN '1993-01-01' AND '1994-01-01'",
                        {}),
    "sorted_deferral_off": ("SELECT count(*) FROM lineitem "
                            "WHERE l_shipdate BETWEEN '1993-01-01' AND '1994-01-01'", {"zone_maps": False}),
    "non_integral_sum": ("SELECT sum(l_extendedprice) FROM lineitem WHERE l_quantity > 10", {}),
    "cost_model": ("SELECT count(*) FROM lineitem WHERE l_quantity > 10", {"BSI_NS_PER_ROW_PER_PLANE": 1000.0}),
    "group_by": ("SELECT sum(l_quantity) FROM lineitem WHERE l_quantity > 5 GROUP BY l_returnflag", {}),
    "selection": ("SELECT l_quantity FROM lineitem WHERE l_quantity > 5 LIMIT 3", {}),
    "no_filter": ("SELECT count(*) FROM lineitem", {}),
    "regex": ("SELECT count(*) FROM lineitem WHERE regexp_like(l_shipmode, 'AI.')", {}),
    "string_agg": ("SELECT min(l_shipmode) FROM lineitem WHERE l_quantity > 5", {}),
    "distinct": ("SELECT distinctcount(l_quantity) FROM lineitem WHERE l_quantity > 5", {}),
    "many_points": ("SELECT count(*) FROM lineitem WHERE l_quantity IN "
                    "(1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17)", {}),
    "force": ("SELECT count(*) FROM lineitem WHERE l_shipdate BETWEEN '1993-01-01' AND '1994-01-01'",
              {"mode": "force"}),
}


@pytest.mark.parametrize("name", sorted(DECISIONS))
def test_bitsliced_decision_equals_the_reference(name, monkeypatch):
    pql, knobs = DECISIONS[name]
    mode, zone_maps = knobs.get("mode", True), knobs.get("zone_maps", True)
    for k in ("BSI_MAX_PLANES", "BSI_NS_PER_ROW_PER_PLANE"):
        if k in knobs:
            monkeypatch.setattr(config, k, knobs[k])
            monkeypatch.setenv(f"PINOT_TPU_TIER_COST_{k}", str(knobs[k]))
    if mode == "force":
        monkeypatch.setenv("PINOT_TPU_BITSLICED", "force")
    if not zone_maps:
        monkeypatch.setenv("PINOT_TPU_ZONEMAP", "0")
    total = sum(s.num_docs for s in REF_SEGMENTS)
    want, ref_state = ref_bitsliced_decision(ref_optimize(ref_parse(pql)), REF_SEGMENTS, RefContext(REF_SEGMENTS),
                                             total)
    got, state = bitsliced_decision(optimize_request(parse_pql(pql)), PORT_SEGMENTS, TableContext(PORT_SEGMENTS),
                                    total, mode, zone_maps)
    assert json.loads(json.dumps(got)) == got
    assert got == want
    assert (state is None) == (ref_state is None)
    if state is not None:
        assert state[0] == ref_state[0]  # the program spec


def test_the_switch_declines():
    pql = DECISIONS["count_sum_points"][0]
    got, state = bitsliced_decision(optimize_request(parse_pql(pql)), PORT_SEGMENTS, TableContext(PORT_SEGMENTS),
                                    35000, False)
    assert not got["taken"] and state is None and "bitsliced=False" in got["reason"]
    with pytest.raises(ValueError):
        QueryExecutor(device="cpu", bitsliced="always")


# -- through both executors ------------------------------------------------

# tests/test_bitsliced.py:187-196, taken in "force" mode on both sides
BIT_EXACT_CASES = [
    "SELECT sum(l_quantity), count(*), min(l_quantity), max(l_quantity), "
    "avg(l_quantity) FROM lineitem WHERE l_extendedprice BETWEEN 10000 AND 50000",
    "SELECT count(*), sum(l_quantity) FROM lineitem "
    "WHERE l_quantity IN (5, 10, 15) AND l_extendedprice > 30000",
    "SELECT count(*) FROM lineitem "
    "WHERE l_quantity NOT IN (1, 2) OR l_extendedprice < 20000",
    "SELECT min(l_extendedprice), max(l_extendedprice) FROM lineitem "
    "WHERE l_quantity = 25",
]
# chip_smoke.py's phase-13 queries, taken at the default switches
PHASE13 = [DECISIONS["count_sum_points"][0], DECISIONS["or_minmax"][0]]


def _values(resp):
    return [a.value for a in resp.aggregation_results]


def _both(pql, mode, precision="x64", monkeypatch=None):
    if mode == "force":
        monkeypatch.setenv("PINOT_TPU_BITSLICED", "force")
    ref_req = ref_optimize(ref_parse(pql))
    ref_res = RefExecutor().execute(REF_SEGMENTS, ref_req)
    req = optimize_request(parse_pql(pql))
    res = QueryExecutor(device="cpu", precision=precision, bitsliced=mode).execute(PORT_SEGMENTS, req)
    scan = QueryExecutor(device="cpu", precision=precision, bitsliced=False).execute(
        PORT_SEGMENTS, optimize_request(parse_pql(pql)))
    return res, ref_res, ref_req, req, scan


@pytest.mark.parametrize("pql,mode", [(q, "force") for q in BIT_EXACT_CASES] + [(q, True) for q in PHASE13])
def test_bit_exact_against_the_reference_and_the_scan(pql, mode, monkeypatch):
    res, ref_res, ref_req, req, scan = _both(pql, mode, monkeypatch=monkeypatch)
    assert res._served_tier == ref_res._served_tier == "bitsliced"
    assert res.cost["segmentsBitsliced"] == ref_res.cost["segmentsBitsliced"] == len(PORT_SEGMENTS)
    assert res.num_entries_scanned_in_filter == ref_res.num_entries_scanned_in_filter
    assert res.num_entries_scanned_post_filter == ref_res.num_entries_scanned_post_filter
    assert res.num_docs_scanned == ref_res.num_docs_scanned == scan.num_docs_scanned
    assert res.cost["bytesScanned"] == ref_res.cost["bytesScanned"] == res.cost["deviceBytes"]
    got = reduce_to_response(req, [res])
    assert got.to_json()["aggregationResults"] == canonical_payload(ref_req, ref_res)["aggregationResults"]
    assert scan._served_tier != "bitsliced" and not scan.cost.get("segmentsBitsliced")
    assert _values(got) == _values(reduce_to_response(req, [scan]))


@pytest.mark.parametrize("pql", PHASE13)
def test_x32_answers_equal_the_x64_scan(pql, monkeypatch):
    """In x32 the fused SUM is still exact integer arithmetic (the x32
    scan sums in float32), and min / max round-trip through float32."""
    res, _, _, req, _ = _both(pql, True, "x32", monkeypatch)
    assert res._served_tier == "bitsliced"
    scan = QueryExecutor(device="cpu", precision="x64", bitsliced=False).execute(PORT_SEGMENTS, req)
    assert _values(reduce_to_response(req, [res])) == _values(reduce_to_response(req, [scan]))


def test_an_empty_match_equals_the_scan(monkeypatch):
    monkeypatch.setenv("PINOT_TPU_BITSLICED", "force")
    monkeypatch.setenv("PINOT_TPU_INVINDEX", "0")
    pql = "SELECT count(*), sum(l_quantity), min(l_quantity) FROM lineitem WHERE l_extendedprice < 0"
    req = optimize_request(parse_pql(pql))
    res = QueryExecutor(device="cpu", postings=False, bitsliced="force").execute(PORT_SEGMENTS, req)
    assert res.cost["segmentsBitsliced"] == len(PORT_SEGMENTS)
    ref_req = ref_optimize(ref_parse(pql))
    want = canonical_payload(ref_req, RefExecutor().execute(REF_SEGMENTS, ref_req))
    assert reduce_to_response(req, [res]).to_json()["aggregationResults"] == want["aggregationResults"]
    scan = QueryExecutor(device="cpu", postings=False, bitsliced=False).execute(PORT_SEGMENTS, req)
    assert _values(reduce_to_response(req, [res])) == _values(reduce_to_response(req, [scan]))


def test_a_reloaded_segment_does_not_reuse_stale_planes():
    ex = QueryExecutor(device="cpu", bitsliced="force")
    pql = "SELECT count(*) FROM lineitem WHERE l_quantity > 10"
    req = optimize_request(parse_pql(pql))
    one = ex.execute(PORT_SEGMENTS[:1], req)
    both = ex.execute(PORT_SEGMENTS, req)
    assert one.cost["segmentsBitsliced"] == 1 and both.cost["segmentsBitsliced"] == 2
    twin = synthetic_lineitem_segment(9000, seed=23, name="bsl0")  # same name, other rows
    got = ex.execute([twin], req)
    want = QueryExecutor(device="cpu", bitsliced=False).execute([twin], req)
    assert got.cost["segmentsBitsliced"] == 1
    assert _values(reduce_to_response(req, [got])) == _values(reduce_to_response(req, [want])) != \
        _values(reduce_to_response(req, [one]))


def test_an_error_in_the_tier_falls_through_to_the_scan(monkeypatch):
    from pinot_tpu_torch.engine import bitsliced as port_bitsliced
    from pinot_tpu_torch.engine.dispatch import LaneClosedError

    pql = PHASE13[0]
    ex = QueryExecutor(device="cpu")
    want = ex.execute(PORT_SEGMENTS, optimize_request(parse_pql(pql)))
    assert want._served_tier == "bitsliced"

    def broken(spec):
        raise RuntimeError("injected bit-sliced failure")

    monkeypatch.setattr(port_bitsliced, "make_packed_bitsliced_kernel", broken)
    res = ex.execute(PORT_SEGMENTS, optimize_request(parse_pql(pql)))
    assert res._served_tier == "device" and res.cost.get("segmentsFullScan") == len(PORT_SEGMENTS)
    assert ex.metrics.meter("heal.bitslicedFallbacks").count == 1
    req = optimize_request(parse_pql(pql))
    assert _values(reduce_to_response(req, [res])) == _values(reduce_to_response(req, [want]))
    for err in (TimeoutError("deadline"), LaneClosedError("closed")):
        def raising(spec, err=err):
            raise err

        monkeypatch.setattr(port_bitsliced, "make_packed_bitsliced_kernel", raising)
        with pytest.raises(type(err)):
            ex.execute(PORT_SEGMENTS, optimize_request(parse_pql(pql)))
    assert ex.metrics.meter("heal.bitslicedFallbacks").count == 1


def test_the_tier_decisions_are_a_phase_of_their_own(monkeypatch):
    """A query both tiers decline books their decisions as
    phase.tierDecision, not as staging; a query a tier serves books none."""
    from pinot_tpu_torch.engine import executor as executor_mod

    ex = QueryExecutor(device="cpu")
    scan = optimize_request(parse_pql("SELECT count(*), sum(l_quantity) FROM lineitem GROUP BY l_returnflag"))
    ex.execute(PORT_SEGMENTS, scan)  # staged once: the run below hits the cache
    real = executor_mod.try_index_path

    def slow(*a, **k):
        time.sleep(0.2)
        return real(*a, **k)

    monkeypatch.setattr(executor_mod, "try_index_path", slow)
    res = ex.execute(PORT_SEGMENTS, scan)
    assert res._served_tier == "device"
    decisions = ex.metrics.timer("phase.tierDecision").samples()
    assert len(decisions) == 2 and decisions[-1] >= 200.0
    assert ex.metrics.timer("phase.staging").samples()[-1] < 200.0
    monkeypatch.setattr(executor_mod, "try_index_path", real)
    assert ex.execute(PORT_SEGMENTS, optimize_request(parse_pql(PHASE13[0])))._served_tier == "bitsliced"
    assert ex.metrics.timer("phase.tierDecision").count == 2


# -- through a server ------------------------------------------------------


def _stack(pipeline: bool, **kw):
    from pinot_tpu_torch.broker.broker import BrokerRequestHandler
    from pinot_tpu_torch.broker.routing import RoutingTableProvider
    from pinot_tpu_torch.server.instance import ServerInstance
    from pinot_tpu_torch.transport.local import LocalTransport

    server = ServerInstance("s0", device="cpu", pipeline=pipeline, **kw)
    for seg in PORT_SEGMENTS:
        server.add_segment("lineitem", seg)
    transport = LocalTransport()
    transport.register(("s0", 0), server.handle_request)
    routing = RoutingTableProvider()
    routing.update("lineitem", {s.segment_name: {"s0": "ONLINE"} for s in PORT_SEGMENTS})
    return server, BrokerRequestHandler(transport, {"s0": ("s0", 0)}, routing=routing, timeout_ms=30_000)


def _payload(resp) -> str:
    return json.dumps({k: v for k, v in resp.to_json().items()
                       if k not in ("timeUsedMs", "requestId", "cost", "freshnessMs")}, sort_keys=True)


def test_batched_bsi_dispatches_match_serial():
    """Same-spec queries at distinct literals queued on a held lane form
    one batched bit-sliced launch (keyed on ("bsi", spec), never on a
    StaticPlan), each member's payload equal to the serial executor's
    (tests/test_bitsliced.py's differential)."""
    serial = _stack(False, bitsliced="force")
    pipelined = _stack(True, bitsliced="force")
    queries = ["SELECT count(*), sum(l_quantity) FROM lineitem "
               f"WHERE l_extendedprice BETWEEN 10000 AND {t}" for t in (30000, 35000, 40000, 45000)]
    try:
        r = pipelined[1].handle_pql(queries[0])
        assert not r.exceptions and r.cost.get("segmentsBitsliced") == len(PORT_SEGMENTS), r.cost
        server = pipelined[0]
        gate = threading.Event()
        server.lane.submit(("blocker", time.monotonic()), lambda: gate.wait(15))
        results, errs = {}, []

        def run(q):
            try:
                results[q] = pipelined[1].handle_pql(q)
            except Exception as e:  # reported below
                errs.append((q, e))

        before = kernel.batched_bitsliced_dispatches
        threads = [threading.Thread(target=run, args=(q,)) for q in queries]
        for t in threads:
            t.start()
        time.sleep(0.8)  # every PREP done and queued on the lane
        gate.set()
        for t in threads:
            t.join()
        assert not errs, errs[:1]
        stats = server.lane.stats()
        assert stats["batchLaunches"] >= 1 and stats["batchedQueries"] >= 2, stats
        assert kernel.batched_bitsliced_dispatches > before
        hits = 0
        for q in queries:
            resp = results[q]
            assert not resp.exceptions, (q, resp.exceptions)
            assert resp.cost.get("segmentsBitsliced") == len(PORT_SEGMENTS), (q, resp.cost)
            assert _payload(serial[1].handle_pql(q)) == _payload(resp), q
            hits += int(resp.cost.get("batchHits", 0))
        assert hits >= 2
    finally:
        for server, broker in (serial, pipelined):
            broker.shutdown()
            server.shutdown()


def test_a_port_server_behind_a_reference_broker_carries_segments_bitsliced():
    from pinot_tpu.broker.broker import BrokerRequestHandler as RefBroker
    from pinot_tpu.broker.routing import RoutingTableProvider as RefRouting
    from pinot_tpu.transport.local import LocalTransport as RefLocal

    from pinot_tpu_torch.server.instance import ServerInstance

    server = ServerInstance("s0", device="cpu", precision="x64")
    for seg in PORT_SEGMENTS:
        server.add_segment("lineitem", seg)
    transport = RefLocal()
    transport.register(("s0", 0), server.handle_request)
    routing = RefRouting()
    routing.update("lineitem", {s.segment_name: {"s0": "ONLINE"} for s in PORT_SEGMENTS})
    broker = RefBroker(transport, {"s0": ("s0", 0)}, routing=routing, timeout_ms=30_000)
    try:
        resp = broker.handle_pql(PHASE13[1]).to_json()
        assert not resp["exceptions"], resp["exceptions"]
        assert resp["cost"]["segmentsBitsliced"] == len(PORT_SEGMENTS)
        assert server.metrics.meter("cost.tier.segmentsBitsliced").count == len(PORT_SEGMENTS)
    finally:
        broker.shutdown()
        server.shutdown()
