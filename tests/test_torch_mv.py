"""The port's multi-value (MV) columns against the JAX package, on the
same row-built ``make_test_schema()`` segments (the reference tests'
default schema), carried across with ``segment/convert.py``.

Covers the staged roles (``mv``, ``mv_counts``, ``mv_raw``), the MV_ANY
and MV_NONE leaves alone and mixed with SV leaves, group-by over one and
two MV columns (each row adds to the group of each of its entries,
duplicates within a row included), every ``…mv`` aggregation grouped and
not, selection of MV columns and by an MV sort column, and K1's and K2's
plain versions at the entry shapes the MV plans give them, against the
reference's Pallas kernels in interpret mode.

Tolerances: payloads with ``payloads_equivalent`` at rel 1e-9 / abs 2e-5
in x64 (two float64 summation orders, as in ``test_torch_engine.py``),
in the audit band (rel 5e-4 / abs 1e-3) with the port in x32; counts,
distinct counts, percentiles, HLL estimates, group keys, group order and
selection rows exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pinot_tpu.engine import kernel as ref_kernel
from pinot_tpu.engine.context import TableContext as RefContext
from pinot_tpu.engine.device import stage_segments as ref_stage_segments
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.engine.pallas_kernels import PALLAS_AVAILABLE
from pinot_tpu.engine.pallas_kernels import fused_filtered_groupby_sums as jax_k1
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema as ref_make_test_schema
from pinot_tpu.tools.datagen import random_rows
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine import kernel as port_kernel
from pinot_tpu_torch.engine import plan as port_plan
from pinot_tpu_torch.engine.context import TableContext
from pinot_tpu_torch.engine.device import stage_segments
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.kernels import fused_groupby as fg
from pinot_tpu_torch.engine.kernels import value_state_counts as vsc
from pinot_tpu_torch.engine.plan import MV_ANY, MV_NONE, SV, build_static_plan, segment_pairs
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.tools.datagen import make_test_schema, synthetic_mv_segment

TOL = {"x64": (1e-9, 2e-5), "x32": (5e-4, 1e-3)}


def _segments(rows, n_seg):
    per = len(rows) // n_seg
    return [
        ref_build_segment(ref_make_test_schema(), rows[i * per : (i + 1) * per], "testTable", f"t{i}")
        for i in range(n_seg)
    ]


# 20-value pools: most rows' entries distinct; 4-value pools: a third of
# the rows repeat an entry, which counts once per occurrence
SEGMENTS = {
    "wide": _segments(random_rows(ref_make_test_schema(), 1500, seed=5, cardinality=20, mv_max=3), 3),
    "dups": _segments(random_rows(ref_make_test_schema(), 900, seed=9, cardinality=4, mv_max=3), 3),
}
PORT = {k: [segment_from_arrays(**segment_arrays_of(s)) for s in v] for k, v in SEGMENTS.items()}

QUERIES = {
    # MV_ANY leaves: points, a range (interval), a regex (runs), a big IN (table)
    "any_eq": "SELECT count(*), sum(metInt) FROM testTable WHERE dimStrMV = 'mvquj'",
    "any_in": "SELECT count(*), avg(metDouble) FROM testTable WHERE dimIntMV IN (4022, 216, 9180)",
    "any_range": "SELECT count(*), max(metFloat) FROM testTable WHERE dimIntMV BETWEEN 2000 AND 4500",
    "any_regex": "SELECT count(*) FROM testTable WHERE regexp_like(dimStrMV, '^(s|x)')",
    "any_in_table": "SELECT count(*) FROM testTable WHERE dimIntMV IN (216, 389, 602, 654, 1996, 2235, "
    "2347, 3989, 4022, 4024, 4485, 4692, 4802, 6428, 7265, 7770, 7814)",
    # MV_NONE leaves: no entry may be in the excluded set
    "none_ne": "SELECT count(*), min(metInt) FROM testTable WHERE dimStrMV <> 'wrozoh'",
    "none_not_in": "SELECT count(*), sum(metDouble) FROM testTable WHERE dimIntMV NOT IN (4022, 2347)",
    "none_not_in_table": "SELECT count(*) FROM testTable WHERE dimStrMV NOT IN ('famjpp', 'gzmkizm', "
    "'hcrkqy', 'ixo', 'iykxewlj', 'jshmu', 'konmej', 'msjwe', 'mvquj', 'nnevy', 'oipyv', 'pqet', "
    "'qbmf', 'qxjlf', 'rkquqsa', 'sjjy', 'syiewmui')",
    # AND / OR mixes with SV leaves
    "and_or": "SELECT count(*), sum(metInt) FROM testTable WHERE (dimStrMV = 'mvquj' OR dimInt > 7000) "
    "AND dimIntMV NOT IN (1996)",
    "or_and": "SELECT count(*) FROM testTable WHERE dimStrMV IN ('xcz', 'ixo') OR (dimStr <> 'qxcm' "
    "AND dimIntMV >= 7000)",
    # group-by over MV columns: one, two, with an SV column, with a filter
    "group_one_mv": "SELECT count(*), sum(metDouble), avg(metFloat), min(metInt), max(metDouble), "
    "minmaxrange(metInt) FROM testTable GROUP BY dimStrMV TOP 50",
    "group_two_mv": "SELECT count(*), sum(metInt) FROM testTable GROUP BY dimStrMV, dimIntMV TOP 50",
    "group_sv_mv": "SELECT sum(metFloat), count(*) FROM testTable WHERE dimInt > 3000 "
    "GROUP BY dimInt, dimStrMV TOP 20",
    "group_mv_filtered": "SELECT count(*), max(metInt) FROM testTable WHERE dimStrMV <> 'xcz' "
    "GROUP BY dimIntMV TOP 10",
    # every MV aggregation, ungrouped and grouped (by SV and by MV columns)
    "aggs_mv": "SELECT countmv(dimIntMV), summv(dimIntMV), minmv(dimIntMV), maxmv(dimIntMV), "
    "avgmv(dimIntMV), minmaxrangemv(dimIntMV) FROM testTable WHERE dimStr <> 'qxcm'",
    "value_mv": "SELECT distinctcountmv(dimStrMV), distinctcounthllmv(dimIntMV), fasthllmv(dimStrMV), "
    "percentile50mv(dimIntMV), percentileest90mv(dimIntMV) FROM testTable",
    "aggs_mv_grouped": "SELECT countmv(dimIntMV), summv(dimIntMV), minmv(dimIntMV), maxmv(dimIntMV), "
    "avgmv(dimIntMV), minmaxrangemv(dimIntMV) FROM testTable GROUP BY dimStr TOP 10",
    "value_mv_grouped": "SELECT distinctcountmv(dimStrMV), distinctcounthllmv(dimIntMV), "
    "percentile90mv(dimIntMV), percentileest50mv(dimIntMV) FROM testTable GROUP BY dimStr TOP 10",
    "value_mv_by_mv": "SELECT distinctcountmv(dimIntMV), fasthllmv(dimIntMV), percentile50mv(dimIntMV), "
    "summv(dimIntMV) FROM testTable WHERE metInt > 2000 GROUP BY dimStrMV TOP 10",
    # selection: MV columns as lists, an MV sort column by its first entry
    "sel_mv_columns": "SELECT dimStrMV, dimIntMV, dimStr FROM testTable WHERE dimIntMV > 7000 LIMIT 10",
    "sel_mv_sort": "SELECT dimStr, dimStrMV FROM testTable ORDER BY dimStrMV, dimInt DESC LIMIT 15",
    "sel_star_mv_sort": "SELECT * FROM testTable WHERE dimStrMV <> 'xcz' ORDER BY dimIntMV DESC LIMIT 3, 5",
}


def _payloads(pql, table, precision):
    ref_req = ref_optimize(ref_parse(pql))
    want = canonical_payload(ref_req, RefExecutor().execute(SEGMENTS[table], ref_req))
    req = optimize_request(parse_pql(pql))
    # the device's MV path: past the postings tier, which answers the
    # selective MV filters from host postings (test_torch_invindex.py)
    ex = QueryExecutor(device="cpu", precision=precision, postings=False, bitsliced=False)
    res = ex.execute(PORT[table], req)
    heal = ex.healing_stats()
    assert heal["deviceFailures"] == heal["hostFailovers"] == 0, heal  # no device run failed over
    return strip_accounting(reduce_to_response(req, [res]).to_json()), want, res


@pytest.mark.parametrize("precision", ["x64", "x32"])
@pytest.mark.parametrize("table", sorted(SEGMENTS))
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_mv_payloads_match_reference(name, table, precision):
    got, want, res = _payloads(QUERIES[name], table, precision)
    rel, abs_ = TOL[precision]
    assert payloads_equivalent(got, want, rel_tol=rel, abs_tol=abs_), (got, want)
    assert res._served_tier == "device"


def test_mv_plans_match_reference():
    """Leaf modes, ``StaticAgg.is_mv`` and the group-by's MV columns as the
    reference plans them."""
    from pinot_tpu.engine.plan import build_static_plan as ref_build_static_plan

    pql = ("SELECT summv(dimIntMV), distinctcountmv(dimStrMV), sum(metInt) FROM testTable WHERE "
           "dimStrMV <> 'xcz' AND dimIntMV IN (216, 389) AND dimStr <> 'qxcm' GROUP BY dimStrMV, dimInt")
    cols = ["dimIntMV", "dimStrMV", "metInt", "dimStr", "dimInt"]
    ref_req, req = ref_optimize(ref_parse(pql)), optimize_request(parse_pql(pql))
    ref_plan = ref_build_static_plan(ref_req, RefContext(SEGMENTS["wide"]),
                                     ref_stage_segments(SEGMENTS["wide"], cols))
    ctx = TableContext(PORT["wide"])
    plan = build_static_plan(req, ctx, stage_segments(PORT["wide"], cols, torch.device("cpu"),
                                                      config.Precision("x64"), ctx=ctx))
    assert [leaf.mode for leaf in plan.leaves] == [MV_NONE, MV_ANY, SV]
    assert [(lf.mode, lf.eval_kind, lf.k_pad) for lf in plan.leaves] == \
        [(lf.mode, lf.eval_kind, lf.k_pad) for lf in ref_plan.leaves]
    assert [a.is_mv for a in plan.aggs] == [a.is_mv for a in ref_plan.aggs] == [True, True, False]
    assert plan.group_by.col_is_mv == ref_plan.group_by.col_is_mv == (True, False)
    assert plan.group_by.use_gfwd == ref_plan.group_by.use_gfwd
    assert plan.group_by.capacity == ref_plan.group_by.capacity


@pytest.mark.parametrize("precision", ["x64", "x32"])
def test_staged_mv_roles_match_reference(precision):
    """``mv``, ``mv_counts``, ``mv_raw`` and the dictionaries as the
    reference stages them (uint16 ids become int16: kept divergence 4)."""
    from pinot_tpu.engine import config as ref_config

    segs, port = SEGMENTS["wide"], PORT["wide"]
    cols = ["dimIntMV", "dimStrMV"]
    ref = ref_stage_segments(segs, cols, raw_columns=["dimIntMV"])
    got = stage_segments(port, cols, torch.device("cpu"), config.Precision(precision),
                         raw_columns=["dimIntMV"])
    for name in cols:
        r, g = ref.column(name), got.column(name)
        assert g.mv_pad == r.mv_pad == 8 and not g.single_value  # pad_card(3): the 8-wide bucket
        np.testing.assert_array_equal(g.mv.numpy(), np.asarray(r.mv).astype(np.int64))
        assert g.mv.dtype == torch.uint8 and np.asarray(r.mv).dtype == np.uint8  # card 20: one byte
        np.testing.assert_array_equal(g.mv_counts.numpy(), np.asarray(r.mv_counts))
        assert g.mv_counts.numpy().dtype == np.asarray(r.mv_counts).dtype == np.dtype(ref_config.count_dtype(8))
    want_raw = np.asarray(ref.column("dimIntMV").mv_raw)
    assert got.column("dimIntMV").mv_raw.dtype == config.Precision(precision).float_dtype
    np.testing.assert_array_equal(got.column("dimIntMV").mv_raw.numpy().astype(np.float64), want_raw)
    assert got.column("dimStrMV").mv_raw is None and got.column("dimStrMV").dict_vals is None
    np.testing.assert_array_equal(got.column("dimIntMV").dict_vals.numpy().astype(np.float64),
                                  np.asarray(ref.column("dimIntMV").dict_vals))


def test_mv_group_expansion_past_64_entries_goes_to_the_host():
    """Two MV group columns of mv_pad 16 expand a row to 256 keys: not on
    the device, in both packages; the port's host tier answers as the
    reference does, after staging (the plan decides it)."""
    rows = random_rows(ref_make_test_schema(), 300, seed=2, cardinality=6, mv_max=9)
    segs = _segments(rows, 2)
    port = [segment_from_arrays(**segment_arrays_of(s)) for s in segs]
    pql = "SELECT count(*), sum(metInt) FROM testTable GROUP BY dimStrMV, dimIntMV TOP 20"
    ref_req = ref_optimize(ref_parse(pql))
    want = canonical_payload(ref_req, RefExecutor().execute(segs, ref_req))
    req = optimize_request(parse_pql(pql))
    ex = QueryExecutor(device="cpu")
    res = ex.execute(port, req)
    got = strip_accounting(reduce_to_response(req, [res]).to_json())
    assert got == want
    assert res._served_tier == "host" and res.cost["segmentsHost"] == 2 and ex.staged_bytes() > 0


@pytest.mark.parametrize("precision", ["x64", "x32"])
def test_segment_pair_space_past_the_int32_row_bound_goes_to_the_host(monkeypatch, precision):
    """K1 and K2 bound a segment's rows by an int32 ``num_docs * E * M``.
    A grouped MV value state over two MV group columns (E = 8 * 8 = 64)
    of an MV column (M = 8) crosses it from 2^22-row segments on: such a
    plan runs on the host.  Here the bound is lowered to the small
    segments' pair space: past it the host tier answers as the reference
    does, at it the device does."""
    assert port_plan.MAX_SEGMENT_PAIRS == torch.iinfo(torch.int32).max < 2**22 * 64 * 8
    pql = ("SELECT distinctcountmv(dimIntMV), percentile50mv(dimIntMV), count(*) FROM testTable "
           "GROUP BY dimStrMV, dimIntMV TOP 20")
    req = optimize_request(parse_pql(pql))
    ctx = TableContext(PORT["wide"])
    staged = stage_segments(PORT["wide"], ["dimIntMV", "dimStrMV"], torch.device("cpu"),
                            config.Precision(precision), ctx=ctx)
    plan = build_static_plan(req, ctx, staged)
    pairs = segment_pairs(plan.aggs, plan.group_by, staged)
    assert pairs == staged.n_pad * 64 * 8 and plan.on_device
    assert not any(a.sort_pairs for a in plan.aggs)  # dense holders, as at the crossing shape
    for bound, tier in ((pairs - 1, "host"), (pairs, "device")):
        monkeypatch.setattr(port_plan, "MAX_SEGMENT_PAIRS", bound)
        assert build_static_plan(req, ctx, staged).on_device == (tier == "device")
        got, want, res = _payloads(pql, "wide", precision)
        assert got == want
        assert res._served_tier == tier


@pytest.mark.parametrize("wrapper", ["k1", "k2"])
def test_kernel_wrappers_refuse_segments_past_the_int32_row_bound(wrapper):
    """A stream wider than the int32 ``num_docs`` can bound raises (a
    zero-stride view: nothing is allocated)."""
    wide = torch.zeros((1, 1), dtype=torch.uint8).expand(1, fg.MAX_ROWS + 1)
    num_docs = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 num_docs"):
        if wrapper == "k1":
            fg.fused_filtered_groupby_sums(None, None, num_docs, None, [], [], 4, dtype=torch.float64,
                                           filter_bounds=torch.zeros((1, 2), dtype=torch.int32),
                                           group_cols=[wide], group_cards=[4], group_remaps=[None])
        else:
            vsc.value_state("counts", num_docs, wide, capacity=1, width=4)


def test_mv_function_over_a_single_value_column_is_its_sv_plan():
    """``distinctcountmv(dimStr)``: each row a one-entry MV, which the SV
    plan computes; the device serves it, with the reference's answer (the
    reference reaches its host tier through its device section)."""
    pql = "SELECT distinctcountmv(dimStr), countmv(dimInt), summv(metInt), percentile50mv(metInt) FROM testTable"
    got, want, res = _payloads(pql, "wide", "x64")
    assert got == want
    assert res._served_tier == "device"


def test_synthetic_mv_segment_follows_random_rows_law():
    """The columnar generator: one pool per column shared across seeds,
    1..mv_max entries a row, dictionaries of the values present, and the
    port queries it as it does a row-built segment."""
    segs = [synthetic_mv_segment(3000, seed=s, name=f"m{s}", cardinality=50, mv_max=3) for s in (1, 2)]
    for name in ("dimStr", "dimStrMV", "dimIntMV", "metFloat"):
        a, b = (set(np.asarray(s.column(name).dictionary.values).tolist()) for s in segs)
        assert len(a | b) <= 50 < len(a) + len(b)  # both draw from one 50-value pool
    c = segs[0].column("dimIntMV")
    counts = np.diff(c.mv_offsets)
    assert counts.min() == 1 and counts.max() == 3 and c.metadata.max_num_multi_values == 3
    assert c.metadata.total_number_of_entries == c.mv_values.size == counts.sum()
    assert sorted(segs[0].columns) == sorted(f.name for f in make_test_schema().all_fields())
    assert np.bincount(c.mv_values, minlength=c.dictionary.cardinality).min() > 0
    f = segs[0].column("metFloat").dictionary.values
    np.testing.assert_array_equal(f, np.asarray(f, dtype=np.float32))


# ---------------------------------------------------------------------------
# K1 and K2 at the MV entry shapes, against the reference's Pallas kernels
# ---------------------------------------------------------------------------


def _capture(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _np(t):
    return None if t is None else t.numpy()


def _np_keys(args):
    """The precombined int64 key [S, N] of a K1 call's group columns, numpy."""
    if args["group_keys"] is not None:
        return args["group_keys"].numpy().astype(np.int64)
    keys = None
    for g, card, r in zip(args["group_cols"], args["group_cards"], args["group_remaps"]):
        g = g.numpy().astype(np.int64)
        if r is not None:
            g = np.take_along_axis(r.numpy().astype(np.int64), g, axis=1)
        keys = g if keys is None else keys * int(card) + g
    return keys


@pytest.mark.skipif(not PALLAS_AVAILABLE, reason="pallas not importable")
@pytest.mark.parametrize("pql", [
    "SELECT sum(metDouble), count(*) FROM testTable WHERE dimIntMV > 3000 GROUP BY dimStrMV, dimInt TOP 10",
    "SELECT summv(dimIntMV), avgmv(dimIntMV), countmv(dimIntMV) FROM testTable GROUP BY dimStrMV TOP 10",
])
def test_plain_k1_at_entry_shapes_matches_pallas(pql, monkeypatch):
    """Each K1 call of an MV group-by (counts and sums over each row's
    expanded key entries [S, n_pad * E], the entry mask as a {0, 1}
    match table, the row bound num_docs * E) equals the reference's
    Pallas K1 (interpret mode) run segment by segment and summed."""
    calls = _capture(monkeypatch, fg, "fused_filtered_groupby_sums")
    QueryExecutor(device="cpu").execute(PORT["dups"], optimize_request(parse_pql(pql)))
    assert calls
    names = ("filter_fwd", "match", "num_docs", "group_keys", "value_fwds", "value_dicts", "capacity")
    for a, k in calls:
        args = {**dict(zip(names, a)), **k}
        S, N = args["filter_fwd"].shape
        assert N == 512 * 8  # n_pad * E (mv_pad 8): the key entries, not the rows
        keys = _np_keys(args)
        docs, count, sums = fg.fused_filtered_groupby_sums_reference(**args)
        want_docs, want_count = 0, 0
        want_sums = [0.0] * len(args["value_raws"])
        for s in range(S):
            d, c, sm = jax_k1(
                jnp.asarray(args["filter_fwd"].numpy()[s].astype(np.int32)), jnp.asarray(args["match"].numpy()[s]),
                jnp.asarray(np.arange(N) < int(args["num_docs"][s])), jnp.asarray(keys[s].astype(np.int32)),
                [None] * len(args["value_raws"]), [None] * len(args["value_raws"]), capacity=args["capacity"],
                interpret=True, value_raws=[jnp.asarray(r.numpy()[s]) for r in args["value_raws"]],
            )
            want_docs += float(d)
            want_count = want_count + np.asarray(c)
            want_sums = [w + np.asarray(x) for w, x in zip(want_sums, sm)]
        assert int(docs) == want_docs
        np.testing.assert_array_equal(count.numpy(), np.asarray(want_count).astype(np.int64))
        for got, want in zip(sums, want_sums):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)


def _np_index(mode, args):
    """The combined index (sentinel K on dropped entries) of a K2 call's
    streams, with numpy."""
    S, N = args["values"].shape
    capacity = args.get("capacity", 1)
    K = vsc.index_space(mode, capacity, args.get("width"))
    mask = np.arange(N)[None, :] < args["num_docs"].numpy()[:, None]
    mask &= np.take_along_axis(args["match"].numpy(), args["filter_fwd"].numpy().astype(np.int64), axis=1)
    slot = np.zeros((S, N), np.int64)
    for g, card, r in zip(args.get("group_cols") or (), args.get("group_cards") or (), args.get("group_remaps") or ()):
        g = g.numpy().astype(np.int64)
        if r is not None:
            g = np.take_along_axis(r.numpy().astype(np.int64), g, axis=1)
        slot = slot * int(card) + g
    v = args["values"].numpy().astype(np.int64)
    if mode == "registers":
        b = np.take_along_axis(args["value_table"].numpy().astype(np.int64), v, axis=1)
        r = np.take_along_axis(args["rho_table"].numpy().astype(np.int64), v, axis=1)
        idx = (slot * vsc.HLL_M + b) * vsc.RHO + r
    else:
        if args.get("value_table") is not None:
            v = np.take_along_axis(args["value_table"].numpy().astype(np.int64), v, axis=1)
        idx = slot * int(args["width"]) + v
    return np.where(mask & (idx < K), idx, K).astype(np.int32), K


@pytest.mark.skipif(not PALLAS_AVAILABLE, reason="pallas not importable")
@pytest.mark.parametrize("pql", [
    "SELECT distinctcountmv(dimIntMV), percentile50mv(dimIntMV), distinctcounthllmv(dimStrMV) FROM testTable "
    "WHERE dimStr <> 'qxcm'",
    "SELECT distinctcountmv(dimIntMV), percentile90mv(dimIntMV) FROM testTable GROUP BY dimStrMV TOP 10",
])
def test_plain_k2_at_entry_shapes_matches_pallas(pql, monkeypatch):
    """Each K2 call of an MV value state (the flattened (key entry, value
    entry) pairs [S, n_pad * E * M], the pair mask as a {0, 1} match
    table, the entries read through the remap or HLL tables) equals the
    reference's Pallas K2 (interpret mode) over the same index."""
    calls = _capture(monkeypatch, vsc, "value_state")
    QueryExecutor(device="cpu").execute(PORT["wide"], optimize_request(parse_pql(pql)))
    assert len(calls) >= 2
    for (mode, num_docs), kw in calls:
        args = dict(kw, num_docs=num_docs)
        assert args["values"].shape[1] in (512 * 8, 512 * 8 * 8)  # n_pad * M, or n_pad * E * M grouped by an MV column
        idx, K = _np_index(mode, args)
        counts = np.asarray(ref_kernel._value_state_counts_pallas(jnp.asarray(idx.reshape(-1)), K)).astype(np.int64)
        docs, holder = vsc.value_state_reference(mode, **args)
        want = torch.from_numpy(counts)
        np.testing.assert_array_equal(holder.numpy(), vsc.holder_from_counts(mode, want).numpy())
