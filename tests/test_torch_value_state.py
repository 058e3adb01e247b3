"""The port's value-state aggregations (distinctcount, percentile, HLL)
and its occupancy-histogram kernel K2 against the JAX package, on the
same seeded segments (carried across with ``segment/convert.py``).

The reference runs with ``PINOT_TPU_GROUPBY_MATMUL=1`` and
``PINOT_TPU_VALUE_STATE_PALLAS=1`` (its kernel and staging caches
cleared around each query), so its own Pallas K2, in interpret mode,
counts inside every compared query, and its grouped-HLL routes are the
port's.

Tolerances: distinct counts, percentiles (dictionary values) and HLL
estimates (integers from identical registers) compare exactly, as client
payloads; the grouped float sums of the repaired torch-op path compare at
rel 1e-9 / abs 2e-5 (two float64 summation orders, as in
``test_torch_engine.py``).  The CUDA kernel itself runs only on the card:
``chip_smoke.py`` holds it against the plain version there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pinot_tpu.engine import device as ref_device
from pinot_tpu.engine import kernel as ref_kernel
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.engine.pallas_kernels import PALLAS_AVAILABLE
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.tools.datagen import synthetic_adevents_segment as ref_adevents
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic
from pinot_tpu.tools.datagen import tile_segments as ref_tile
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.engine import kernel as port_kernel
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.kernels import fused_groupby
from pinot_tpu_torch.engine.kernels import value_state_counts as vsc
from pinot_tpu_torch.engine.packing import fetch_packed
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.tools.datagen import synthetic_adevents_segment, tile_segments

REL, ABS = 1e-9, 2e-5

LINEITEM = [ref_synthetic(4096, seed=11 + i, name=f"li{i}") for i in range(2)]
ADEVENTS = [
    ref_adevents(4096, seed=5 + i, name=f"ad{i}", campaign_card=64, user_card=1 << 14)
    for i in range(2)
]


def _port(segments):
    return [segment_from_arrays(**segment_arrays_of(s)) for s in segments]


PORT_LINEITEM = _port(LINEITEM)
PORT_ADEVENTS = _port(ADEVENTS)


@pytest.fixture
def reference_k2(monkeypatch):
    """The reference's Pallas K2 on every value-state holder it builds."""
    monkeypatch.setenv("PINOT_TPU_GROUPBY_MATMUL", "1")
    monkeypatch.setenv("PINOT_TPU_VALUE_STATE_PALLAS", "1")
    _clear_reference_caches()
    yield monkeypatch
    _clear_reference_caches()


def _clear_reference_caches():
    ref_kernel.make_table_kernel.cache_clear()
    ref_kernel.make_packed_table_kernel.cache_clear()
    ref_device.clear_staging_cache()


class _Spy:
    """Counts calls of a module function while the test runs."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        real = getattr(module, name)

        def spy(*a, **k):
            self.calls += 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, spy)


def _payloads(pql, ref_segments, port_segments, precision="x64"):
    ref_req = ref_optimize(ref_parse(pql))
    want = canonical_payload(ref_req, RefExecutor().execute(ref_segments, ref_req))
    req = optimize_request(parse_pql(pql))
    # K2's path: past the postings tier, which answers the empty match
    # from host postings
    ex = QueryExecutor(device="cpu", precision=precision, postings=False, bitsliced=False)
    got = strip_accounting(reduce_to_response(req, [ex.execute(port_segments, req)]).to_json())
    return got, want


# ---------------------------------------------------------------------------
# K2's plain version against the reference's kernels
# ---------------------------------------------------------------------------


@pytest.mark.skipif(not PALLAS_AVAILABLE, reason="pallas not importable")
@pytest.mark.parametrize("K", [16384, 300])
def test_plain_k2_matches_pallas_and_xla(K):
    """Bit-equal to the Pallas kernel (interpret mode), to the XLA
    factored contraction and to np.bincount, for K a multiple of 128 and
    not, with 5 % sentinel entries (tests/test_pallas.py:74-100)."""
    rng = np.random.default_rng(12)
    n = 6000
    idx = rng.integers(0, K, size=n).astype(np.int32)
    idx[rng.random(n) < 0.05] = K
    got = vsc.value_state_counts(torch.from_numpy(idx), K).numpy()
    pallas = np.asarray(ref_kernel._value_state_counts_pallas(jnp.asarray(idx), K))
    xla = np.asarray(ref_kernel._value_state_counts_xla(jnp.asarray(idx), K))
    assert got.dtype == np.int64 and got.shape == (K,)
    assert np.array_equal(got, pallas.astype(np.int64))
    assert np.array_equal(got, xla.astype(np.int64))
    assert np.array_equal(got, np.bincount(idx[idx < K], minlength=K))


@pytest.mark.skipif(not PALLAS_AVAILABLE, reason="pallas not importable")
def test_plain_k2_batched_segments_sum_the_vmapped_reference():
    """One call over a [S, n] stack is the sum of the reference's
    per-segment (vmapped) counts (tests/test_pallas.py:102-106)."""
    K = 1024
    batch = np.random.default_rng(13).integers(0, K, size=(3, 4096)).astype(np.int32)
    got = vsc.value_state_counts(torch.from_numpy(batch), K).numpy()
    per_seg = np.asarray(jax.vmap(lambda i: ref_kernel._value_state_counts_pallas(i, K))(jnp.asarray(batch)))
    assert np.array_equal(got, per_seg.sum(axis=0).astype(np.int64))


@pytest.mark.parametrize(
    "case", ["empty", "all_sentinel", "negative_dropped", "hot_bin", "K1"]
)
def test_plain_k2_edges(case):
    K = 37
    idx = {
        "empty": np.zeros(0, np.int32),
        "all_sentinel": np.full(1000, K, np.int32),
        "negative_dropped": np.array([-1, 0, 5, -7, 36, 37, 99], np.int32),
        "hot_bin": np.full(4099, 7, np.int32),
        "K1": np.array([0, 0, 1, 0], np.int32),
    }[case]
    k = 1 if case == "K1" else K
    got = vsc.value_state_counts(torch.from_numpy(idx), k).numpy()
    ok = (idx >= 0) & (idx < k)
    assert np.array_equal(got, np.bincount(idx[ok], minlength=k))


def test_k2_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        vsc.value_state_counts(torch.zeros(8, dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        vsc.value_state_counts(torch.zeros((4, 4), dtype=torch.int32).t(), 4)
    with pytest.raises(ValueError):
        vsc.value_state_counts(torch.zeros(8, dtype=torch.int32), 0)


# ---------------------------------------------------------------------------
# Value-state queries against the reference
# ---------------------------------------------------------------------------

QUERIES = {
    "distinct_scalar": "SELECT distinctcount(l_quantity) FROM lineitem",
    "distinct_filtered_wide": "SELECT distinctcount(l_extendedprice) FROM lineitem WHERE l_quantity > 25",
    "distinct_grouped": "SELECT distinctcount(l_shipdate) FROM lineitem WHERE l_returnflag = 'R' "
    "GROUP BY l_shipmode TOP 10",
    "percentile_grouped": "SELECT percentile90(l_quantity) FROM lineitem GROUP BY l_shipmode TOP 10",
    "percentile_scalar": "SELECT percentileest50(l_extendedprice), percentile99(l_tax) FROM lineitem "
    "WHERE l_shipmode IN ('AIR', 'MAIL')",
    "hll_presence_grouped": "SELECT distinctcounthll(l_shipdate) FROM lineitem GROUP BY l_returnflag TOP 10",
    "hll_presence_scalar": "SELECT fasthll(l_receiptdate) FROM lineitem WHERE l_quantity < 10",
    "hll_streams_scalar": "SELECT distinctcounthll(l_extendedprice) FROM lineitem WHERE l_shipmode = 'AIR'",
    "hll_streams_grouped_counts": "SELECT distinctcounthll(l_extendedprice), count(*) FROM lineitem "
    "GROUP BY l_returnflag TOP 10",
    "hll_streams_grouped_sort": "SELECT fasthll(l_extendedprice) FROM lineitem "
    "GROUP BY l_shipmode, l_returnflag TOP 12",
    "mixed_or_filter": "SELECT sum(l_quantity), min(l_discount), distinctcount(l_tax), "
    "percentile50(l_quantity) FROM lineitem WHERE l_shipdate > '1995-01-01' OR l_returnflag = 'A' "
    "GROUP BY l_linestatus",
    "empty_match": "SELECT distinctcount(l_tax), percentile90(l_quantity), distinctcounthll(l_extendedprice) "
    "FROM lineitem WHERE l_shipmode = 'BOAT'",
    "distinct_grouped_interval": "SELECT distinctcount(l_shipdate) FROM lineitem WHERE l_quantity > 25 "
    "GROUP BY l_returnflag TOP 10",
    "percentile_two_groups": "SELECT percentile90(l_quantity) FROM lineitem "
    "GROUP BY l_shipmode, l_returnflag TOP 30",
}

# the queries whose holders come from value_state (all but the
# grouped HLL whose group space takes the sort lowering)
_K2_FREE = {"hll_streams_grouped_sort"}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_value_state_payloads_match_reference(name, reference_k2):
    spy = _Spy(reference_k2, vsc, "value_state")
    got, want = _payloads(QUERIES[name], LINEITEM, PORT_LINEITEM)
    assert got == want, (got, want)
    assert (spy.calls == 0) == (name in _K2_FREE), spy.calls


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_value_state_payloads_match_reference_x32(name, reference_k2):
    """The same payloads with the port in x32 (float32 sums, int32 keys):
    value-state answers are integers and dictionary values, so they
    compare exactly."""
    got, want = _payloads(QUERIES[name], LINEITEM, PORT_LINEITEM, precision="x32")
    assert got == want, (got, want)


_NO_STREAMS = {
    "scalar": "SELECT distinctcounthll(l_extendedprice) FROM lineitem WHERE l_shipmode = 'AIR'",
    "grouped": "SELECT distinctcounthll(l_extendedprice), count(*) FROM lineitem GROUP BY l_returnflag TOP 10",
}


@pytest.mark.parametrize("precision", ["x64", "x32"])
@pytest.mark.parametrize("shape", sorted(_NO_STREAMS))
def test_hll_without_streams_matches_reference(shape, precision, reference_k2):
    """HLL registers over a column staged without its per-row (bucket,
    rho) streams: K2 reads the fwd stream through the per-dictId bucket
    and rho tables.  The port's registers path is forced by lowering
    nothing to presence; the reference's answer is the same either way
    (registers depend only on the distinct value set)."""
    from pinot_tpu_torch.engine import executor as port_executor
    from pinot_tpu_torch.engine import plan as port_plan

    real_roles = QueryExecutor._role_columns

    def no_hll_streams(self, *a):
        raw, gfwd, _ = real_roles(self, *a)
        return raw, gfwd, ()

    reference_k2.setattr(QueryExecutor, "_role_columns", no_hll_streams)
    for mod in (port_plan, port_executor):
        reference_k2.setattr(mod, "hll_lowers_to_presence", lambda *a: False)
    calls = []
    real = vsc.value_state

    def recording(*a, **k):
        calls.append(k)
        return real(*a, **k)

    reference_k2.setattr(vsc, "value_state", recording)
    got, want = _payloads(_NO_STREAMS[shape], LINEITEM, PORT_LINEITEM, precision=precision)
    assert got == want, (got, want)
    (kw,) = calls
    assert kw["rho_table"] is not None and kw.get("rho") is None


# the value-state queries of chip_smoke.py, at the tests' small size
CHIP_QUERIES = {
    "hll_groupby": "SELECT distinctcounthll(l_shipdate) FROM lineitem GROUP BY l_returnflag TOP 10",
    "distinct_price": "SELECT distinctcount(l_extendedprice) FROM lineitem WHERE l_quantity > 25",
    "pct_quantity": "SELECT percentile90(l_quantity) FROM lineitem GROUP BY l_shipmode TOP 10",
    "hll_price": "SELECT distinctcounthll(l_extendedprice) FROM lineitem WHERE l_shipmode = 'AIR'",
}


def _forbid(monkeypatch, module, names):
    def forbidden(*a, **k):
        raise AssertionError("the route built a torch-op mask, key or index")

    for name in names:
        monkeypatch.setattr(module, name, forbidden)


def _record(monkeypatch, module, name) -> list:
    calls = []
    real = getattr(module, name)

    def recording(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    monkeypatch.setattr(module, name, recording)
    return calls


@pytest.mark.parametrize("name", sorted(CHIP_QUERIES))
def test_chip_queries_take_the_fused_value_route(name, reference_k2):
    """Each value-state query of chip_smoke.py takes the fused value
    route: K2 gets the leaf and the group-by columns, K1 (grouped) the
    group-by columns, and no [S, n_pad] mask, key or index is built."""
    _forbid(reference_k2, port_kernel, ("_group_keys", "_valid_mask", "_eval_tree", "_mask_filter"))
    k2 = _record(reference_k2, vsc, "value_state")
    k1 = _record(reference_k2, fused_groupby, "fused_filtered_groupby_sums")
    before = port_kernel.fused_value_dispatches
    got, want = _payloads(CHIP_QUERIES[name], LINEITEM, PORT_LINEITEM)
    assert got == want, (got, want)
    assert port_kernel.fused_value_dispatches == before + 1
    grouped = name in ("hll_groupby", "pct_quantity")
    ((_, kw),) = k2
    assert (kw.get("group_cols") is not None) == grouped
    assert len(k1) == grouped and all(a[3] is None and k["group_cols"] for a, k in k1)


def test_torch_op_route_hands_k2_the_mask_and_the_group_columns(monkeypatch):
    """An OR-filtered value state beside a sum: K1 and K2 take the
    evaluated mask as a {0, 1} match table and combine the group key
    themselves; no precombined key is built without min/max."""
    pql = ("SELECT distinctcount(l_tax), sum(l_quantity) FROM lineitem WHERE l_quantity > 45 "
           "OR l_shipmode = 'AIR' GROUP BY l_returnflag TOP 10")
    _forbid(monkeypatch, port_kernel, ("_group_keys",))
    k2 = _record(monkeypatch, vsc, "value_state")
    before = port_kernel.fused_value_dispatches
    got, want = _payloads(pql, LINEITEM, PORT_LINEITEM)
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (got, want)
    assert port_kernel.fused_value_dispatches == before
    ((_, kw),) = k2
    assert kw["match"].shape[-1] == 2 and kw["group_cols"] is not None


def test_torch_op_route_builds_the_key_once_for_min(monkeypatch):
    """mixed_or_filter's min needs the precombined key: built once, and
    the value states still go through K2 with the group columns."""
    keys = _record(monkeypatch, port_kernel, "_group_keys")
    k2 = _record(monkeypatch, vsc, "value_state")
    got, want = _payloads(QUERIES["mixed_or_filter"], LINEITEM, PORT_LINEITEM)
    assert got == want, (got, want)
    assert len(keys) == 1
    assert len(k2) == 2 and all(k["group_cols"] is not None for _, k in k2)


FIVE_COLUMNS = (
    "SELECT distinctcount(l_quantity), percentile90(l_quantity), sum(l_extendedprice), count(*) "
    "FROM lineitem GROUP BY l_returnflag, l_linestatus, l_shipmode, l_discount, l_tax TOP 20"
)


@pytest.mark.parametrize("precision", ["x64", "x32"])
def test_more_group_columns_than_the_kernels_take(precision, reference_k2):
    """A GROUP BY over more columns than K1 and K2 combine
    (``MAX_GROUP_COLUMNS``) takes the torch-op route: the precombined key
    is built once, K1 sums over its key windows and K2 takes it as its
    one group column.  Value states and counts compare exactly; the sums
    at rel 1e-9 / abs 2e-5 in x64 and, in x32 (float32 sums), within the
    audit band (``payloads_equivalent``'s defaults, rel 5e-4 / abs 1e-3)."""
    gb = optimize_request(parse_pql(FIVE_COLUMNS)).group_by
    assert len(gb.columns) > vsc.MAX_GROUP_COLUMNS
    keys = _record(reference_k2, port_kernel, "_group_keys")
    k1 = _record(reference_k2, fused_groupby, "fused_filtered_groupby_sums")
    k2 = _record(reference_k2, vsc, "value_state")
    got, want = _payloads(FIVE_COLUMNS, LINEITEM, PORT_LINEITEM, precision=precision)
    band = dict(rel_tol=REL, abs_tol=ABS) if precision == "x64" else {}
    assert payloads_equivalent(got, want, **band), (got, want)
    exact = [r for r in got["aggregationResults"] if not r["function"].startswith("sum_")]
    assert exact == [r for r in want["aggregationResults"] if not r["function"].startswith("sum_")]
    assert len(keys) == 1
    assert k1 and all(a[3] is not None and k.get("group_cols") is None for a, k in k1)
    assert len(k2) == 2 and all(len(k["group_cols"]) == 1 for _, k in k2)


def test_north_star_hll_shape_matches_reference(reference_k2):
    """distinctcounthll(user_id) GROUP BY campaign_id over tiled ad-events
    (NORTHSTAR_HLL.json at a small size): per-row HLL streams, the sort
    lowering, no K2."""
    pql = "SELECT distinctcounthll(user_id) FROM adevents GROUP BY campaign_id TOP 10"
    spy = _Spy(reference_k2, vsc, "value_state")
    ref_segs = ref_tile(ADEVENTS, 3)
    got, want = _payloads(pql, ref_segs, tile_segments(PORT_ADEVENTS, 3))
    assert got == want, (got, want)
    assert spy.calls == 0


_HLL_ROUTES = {
    # route -> (_MATMUL_HLL_CAP, _HLL_SORT_CAP), the same caps in both packages
    "matmul": (1 << 25, 1 << 16),
    "sort": (0, 1 << 16),
    "scatter": (0, 0),
}


@pytest.mark.parametrize("route", sorted(_HLL_ROUTES))
def test_grouped_hll_routes_match_reference(route, reference_k2):
    """Each grouped-HLL lowering, forced in both packages by their caps
    (as tests/test_engine.py:392-440 forces the reference's)."""
    hll_cap, sort_cap = _HLL_ROUTES[route]
    for mod in (ref_kernel, port_kernel):
        reference_k2.setattr(mod, "_MATMUL_HLL_CAP", hll_cap)
        reference_k2.setattr(mod, "_HLL_SORT_CAP", sort_cap)
    spy = _Spy(reference_k2, vsc, "value_state")
    pql = "SELECT fasthll(l_extendedprice), count(*) FROM lineitem GROUP BY l_shipmode, l_returnflag TOP 12"
    got, want = _payloads(pql, LINEITEM, PORT_LINEITEM)
    assert got == want, (got, want)
    assert (spy.calls > 0) == (route == "matmul")


@pytest.mark.parametrize(
    "pql",
    [
        # group spaces past the dense holder: the host tier
        "SELECT percentile50(l_quantity) FROM lineitem GROUP BY l_extendedprice, l_shipdate",
        "SELECT distinctcounthll(l_shipdate) FROM lineitem GROUP BY l_extendedprice, l_receiptdate",
        "SELECT distinctcountmv(l_shipmode) FROM lineitem",
    ],
)
def test_shapes_of_later_slices_raise(pql):
    """Value states outside the device's dense path answer exactly as the
    reference does: group
    spaces past the dense holder from the host tier, an ``…mv`` function
    over a single-value column on the device as its SV function."""
    got, want = _payloads(pql, LINEITEM, PORT_LINEITEM)
    assert got == want, (got, want)
    res = QueryExecutor(device="cpu").execute(PORT_LINEITEM, optimize_request(parse_pql(pql)))
    assert res._served_tier == ("host" if "GROUP BY" in pql else "device")


@pytest.mark.parametrize(
    "pql",
    [
        "SELECT distinctcount(l_shipdate) FROM lineitem",
        "SELECT percentile50(l_quantity) FROM lineitem GROUP BY l_returnflag",
        "SELECT distinctcount(l_shipdate) FROM lineitem WHERE l_quantity > 3",
        "SELECT distinctcounthll(l_shipdate) FROM lineitem",
    ],
)
def test_plan_forced_host_matches_reference(pql, monkeypatch):
    """The pre-staging host decision for value states, with the caps
    shrunk in both packages so the small segments cross them: a
    no-filter presence/hist agg past the device pair buffer needs the
    host tier, which the port takes before staging anything, with the
    reference's answer."""
    from pinot_tpu.engine import config as ref_config
    from pinot_tpu.engine.context import TableContext as RefContext
    from pinot_tpu.engine.plan import plan_forced_host as ref_forced
    from pinot_tpu_torch.engine import config
    from pinot_tpu_torch.engine.context import TableContext
    from pinot_tpu_torch.engine.plan import plan_forced_host

    for mod in (ref_config, config):
        monkeypatch.setattr(mod, "DISTINCT_PAIR_CAP", 16)
        monkeypatch.setattr(mod, "MAX_VALUE_STATE", 32)
    want = ref_forced(ref_optimize(ref_parse(pql)), RefContext(LINEITEM))
    req = optimize_request(parse_pql(pql))
    assert plan_forced_host(req, TableContext(PORT_LINEITEM), config.Precision("x64")) == want
    if want:
        ex = QueryExecutor(device="cpu")
        res = ex.execute(PORT_LINEITEM, req)
        assert res._served_tier == "host" and ex.staged_bytes() == 0
        got, want_payload = _payloads(pql, LINEITEM, PORT_LINEITEM)
        assert got == want_payload, (got, want_payload)


# ---------------------------------------------------------------------------
# The repaired torch-op path: deterministic grouped sums through K1
# ---------------------------------------------------------------------------

OR_SUM_MIN = (
    "SELECT sum(l_extendedprice), min(l_quantity), avg(l_discount), count(*) FROM lineitem "
    "WHERE l_quantity > 45 OR l_shipmode = 'AIR' GROUP BY l_returnflag, l_linestatus TOP 10"
)


@pytest.mark.parametrize("windows", ["one", "key_windows", "column_chunks"])
def test_torch_op_group_sums_go_through_k1(windows, monkeypatch):
    """An OR-filtered plan (outside the fused route) sums its groups in
    K1 with the mask as a match table: over one key window, over several
    (a group space wider than the kernel's shared memory) and over column
    chunks (more value columns than the kernel takes)."""
    calls = 1
    if windows == "key_windows":
        monkeypatch.setattr(fused_groupby, "max_capacity", lambda *a: 4)
        calls = 2  # capacity 6 in windows of 4
    elif windows == "column_chunks":
        monkeypatch.setattr(fused_groupby, "MAX_VALUE_COLUMNS", 1)
        calls = 2  # l_extendedprice and l_discount
    spy = _Spy(monkeypatch, fused_groupby, "fused_filtered_groupby_sums")
    before = port_kernel.fused_dispatches
    got, want = _payloads(OR_SUM_MIN, LINEITEM, PORT_LINEITEM)
    assert payloads_equivalent(got, want, rel_tol=REL, abs_tol=ABS), (got, want)
    assert spy.calls == calls
    assert port_kernel.fused_dispatches == before


# ---------------------------------------------------------------------------
# Copied modules against their originals
# ---------------------------------------------------------------------------


def test_hll_tables_and_estimates_match_reference():
    from pinot_tpu.engine import hll as ref_hll
    from pinot_tpu_torch.engine import hll

    for ref_seg, seg in zip(LINEITEM, PORT_LINEITEM):
        for col in ("l_extendedprice", "l_shipdate", "l_quantity"):
            rb, rr = ref_hll.dictionary_tables(ref_seg.column(col).dictionary)
            b, r = hll.dictionary_tables(seg.column(col).dictionary)
            assert np.array_equal(b, rb) and np.array_equal(r, rr), col
    regs = np.random.default_rng(3).integers(0, 20, size=(5, 256)).astype(np.uint8)
    assert np.array_equal(hll.estimate_from_registers(regs), ref_hll.estimate_from_registers(regs))


def test_npgroup_matches_reference():
    from pinot_tpu.utils import npgroup as ref_npgroup
    from pinot_tpu_torch.utils import npgroup

    rng = np.random.default_rng(5)
    inv = rng.integers(0, 7, 500)
    cols = rng.integers(0, 16, 500)
    vals = rng.integers(0, 60, 500).astype(np.uint8)
    assert np.array_equal(
        npgroup.scatter_max_2d(inv, 9, cols, vals, 16), ref_npgroup.scatter_max_2d(inv, 9, cols, vals, 16)
    )
    _, inverse = np.unique(inv, return_inverse=True)
    rows = rng.integers(0, 99, (500, 4))
    assert np.array_equal(
        npgroup.group_max_rows(inverse, 7, rows), ref_npgroup.group_max_rows(inverse, 7, rows)
    )


@pytest.mark.parametrize("seed,rows", [(5, 1000), (9, 0)])
def test_seeded_adevents_match_reference(seed, rows):
    ref = ref_tile([ref_adevents(rows, seed=seed, name="a", user_card=4096)], 2)
    got = tile_segments([synthetic_adevents_segment(rows, seed=seed, name="a", user_card=4096)], 2)
    assert [s.segment_name for s in got] == [s.segment_name for s in ref]
    assert [s.metadata.crc for s in got] == [s.metadata.crc for s in ref]
    assert got[1].columns is got[0].columns
    for name, rc in ref[0].columns.items():
        gc = got[0].column(name)
        np.testing.assert_array_equal(gc.fwd, rc.fwd)
        np.testing.assert_array_equal(gc.dictionary.values, rc.dictionary.values)
        assert gc.metadata.is_sorted == rc.metadata.is_sorted


def test_packed_fetch_carries_value_state_holders():
    tree = {
        "presence": torch.tensor([[0, 1, 1], [1, 0, 0]], dtype=torch.int32),
        "hist": torch.arange(5, dtype=torch.int64),
        "regs": torch.tensor([[3, 0, 255]], dtype=torch.uint8),
        "pair": (torch.zeros(3, dtype=torch.float32), torch.ones(2, dtype=torch.int64)),
    }
    out = fetch_packed(tree)
    for k in ("presence", "hist", "regs"):
        assert out[k].dtype == tree[k].numpy().dtype and np.array_equal(out[k], tree[k].numpy()), k
    assert np.array_equal(out["pair"][1], np.ones(2, np.int64))
