"""The port's join engine against the JAX package's, on the CPU.

- The device join: the four cases of ``tests/test_join.py::
  test_device_join_differential_vs_host`` plus one over float values go
  through the reference's ``QueryExecutor().execute_join`` and the port's
  ``execute_join`` (``device="cpu"``): client payloads
  ``payloads_equivalent`` at rel 1e-9 / abs 2e-5, the device path taken in
  both, and the port's device answer equal to its own ``host_join``
  exactly (the data is integer-valued).
- The program: the reference's ``make_join_kernel`` outputs against
  ``kernel.run_join_kernel`` on the same packed inputs (counts, min / max
  and ``join_ok`` exact; sums at rel 1e-12), a group space past K1's
  one-launch capacity included (key windows), and against the plain
  version ``join_kernel_reference`` (exact on integer values); the hash
  equals the reference's uint32 hash.
- Extraction, shuffle planning and the exchange wire equal the
  reference's exactly, both ways across the wire.
- Typed 4xx errors and empty sides at the executor and server level.
"""
import numpy as np
import pytest
import torch

from pinot_tpu.common.datatable import deserialize_instance_request as ref_deserialize_request
from pinot_tpu.common.datatable import deserialize_result as ref_deserialize_result
from pinot_tpu.common.datatable import serialize_instance_request as ref_serialize_request
from pinot_tpu.common.datatable import serialize_result as ref_serialize_result
from pinot_tpu.common.schema import DataType as RefDataType
from pinot_tpu.engine import join as rjm
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.engine.kernel import _join_hash as ref_join_hash
from pinot_tpu.engine.kernel import make_join_kernel
from pinot_tpu.engine.results import IntermediateResult as RefResult
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.common.datatable import (
    deserialize_instance_request,
    deserialize_result,
    serialize_instance_request,
    serialize_result,
)
from pinot_tpu_torch.common.schema import DataType
from pinot_tpu_torch.engine import config, kernel
from pinot_tpu_torch.engine import join as pjm
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.kernels import fused_groupby
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.engine.results import IntermediateResult
from pinot_tpu_torch.pql import parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays

REL, ABS = 1e-9, 2e-5


# ---------------------------------------------------------------------------
# the sides of tests/test_join.py::test_device_join_differential_vs_host, in
# both packages from the same numpy draws
# ---------------------------------------------------------------------------

def _side(jm, dt, n, key, key_type, **cols):
    return jm.SideRows(
        n=n,
        key=jm._dict_encode(key, getattr(dt, key_type)),
        cols={name: jm._dict_encode(vals, getattr(dt, st)) for name, (vals, st) in cols.items()},
    )


def _sides():
    rng = np.random.default_rng(0)
    N, B = 4000, 400
    pk = rng.integers(0, 300, N)
    pv = rng.integers(0, 100, N)
    pg = np.asarray([f"p{int(x) % 4}" for x in pk], dtype=object)
    bk = np.concatenate([np.arange(250), rng.integers(0, 250, B - 250)])
    bw = rng.integers(0, 50, B)
    ub = np.arange(250)
    uw = rng.integers(0, 50, 250)
    cat = np.asarray([f"c{k % 6}" for k in ub], dtype=object)
    spk = np.asarray([f"k{int(x)}" for x in pk], dtype=object)
    sbk = np.asarray([f"k{int(x)}" for x in ub], dtype=object)
    sw = rng.integers(0, 50, 250)
    fv = np.round(rng.uniform(-50.0, 50.0, N), 3)
    fw = np.round(rng.uniform(0.0, 10.0, B), 2)

    def make(jm, dt):
        probe = _side(jm, dt, N, pk, "LONG", v=(pv, "LONG"), g=(pg, "STRING"))
        return {
            "dup": (_side(jm, dt, B, bk, "LONG", **{"d.w": (bw, "LONG")}), probe),
            "unique": (_side(jm, dt, 250, ub, "LONG", **{"d.w": (uw, "LONG"), "d.cat": (cat, "STRING")}),
                       probe),
            "strings": (_side(jm, dt, 250, sbk, "STRING", **{"d.w": (sw, "LONG")}),
                        _side(jm, dt, N, spk, "STRING", v=(pv, "LONG"))),
            "floats": (_side(jm, dt, B, bk, "LONG", **{"d.x": (fw, "DOUBLE")}),
                       _side(jm, dt, N, pk, "LONG", f=(fv, "DOUBLE"), g=(pg, "STRING"))),
        }

    return make(rjm, RefDataType), make(pjm, DataType)


REF_SIDES, PORT_SIDES = _sides()

ENGINE_CASES = {
    "scalar": ("SELECT count(*), sum(f.v), sum(d.w), avg(f.v), min(d.w), max(f.v), minmaxrange(d.w) "
               "FROM f JOIN d ON f.k = d.k", "dup"),
    "probe_group": ("SELECT sum(f.v), count(*) FROM f JOIN d ON f.k = d.k GROUP BY f.g", "dup"),
    "build_group": ("SELECT sum(f.v), min(d.w) FROM f JOIN d ON f.k = d.k GROUP BY d.cat, f.g", "unique"),
    "string_keys": ("SELECT count(*), sum(f.v) FROM f JOIN d ON f.k = d.k", "strings"),
    "floats": ("SELECT sum(f.f), avg(d.x), min(f.f), max(d.x), count(*) FROM f JOIN d ON f.k = d.k "
               "GROUP BY f.g", "floats"),
}


def _port_payload(pql, res):
    return strip_accounting(reduce_to_response(parse_pql(pql), [res], []).to_json())


def _norm(res):
    if res.groups is not None:
        return {k: [p.finalize() for p in v] for k, v in res.groups.items()}
    return [p.finalize() for p in res.aggregations]


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_device_join_differential_vs_reference(case):
    """Tolerance: rel 1e-9 / abs 2e-5 against the reference; the port's
    device answer equals its own host join exactly where the data is
    integer-valued."""
    pql, sides = ENGINE_CASES[case]
    rb, rp = REF_SIDES[sides]
    pb, pp = PORT_SIDES[sides]
    ref_ex = RefExecutor()
    ex = QueryExecutor(device="cpu")
    want = ref_ex.execute_join(ref_parse(pql), rb, rp)
    got = ex.execute_join(parse_pql(pql), pb, pp)
    assert "deviceBytes" in want.cost and "deviceBytes" in got.cost, (want.cost, got.cost)
    assert got._served_tier == "device"
    assert got.cost["buildRows"] == pb.n and got.cost["probeRows"] == pp.n
    assert got.cost["deviceBytes"] == want.cost["deviceBytes"]
    assert got.num_docs_scanned == want.num_docs_scanned
    assert payloads_equivalent(_port_payload(pql, got), canonical_payload(ref_parse(pql), want),
                               rel_tol=REL, abs_tol=ABS)
    host = pjm.host_join(parse_pql(pql), pb, pp)
    if case == "floats":
        assert payloads_equivalent(_port_payload(pql, got), _port_payload(pql, host), rel_tol=REL, abs_tol=ABS)
    else:
        assert _norm(got) == _norm(host)
        assert got.num_docs_scanned == host.num_docs_scanned
    assert ex.healing_stats()["hostFailovers"] == 0


# ---------------------------------------------------------------------------
# the program itself
# ---------------------------------------------------------------------------

def _program_inputs(pql, sides, precision="x64"):
    rb, rp = sides[0]
    pb, pp = sides[1]
    rplan, rinputs, _ = rjm.build_join_plan(ref_parse(pql), rb, rp)
    plan, inputs, _ = pjm.build_join_plan(parse_pql(pql), pb, pp, precision)
    assert repr(plan) == repr(rplan)
    for k in rinputs:
        assert np.array_equal(inputs[k], rinputs[k]) and inputs[k].dtype == rinputs[k].dtype, k
    return rplan, rinputs, plan, {k: torch.from_numpy(v.copy()) for k, v in inputs.items()}


def _wide_group_sides():
    """A probe group column of 6000 values: past K1's one-launch capacity
    (``max_capacity`` for two float64 streams), so the grouped sums run in
    key windows."""
    rng = np.random.default_rng(4)
    N, U = 30000, 500
    pk = rng.integers(0, 600, N)
    grp = rng.integers(0, 6000, N)
    pv = rng.integers(0, 1000, N)
    bk = np.concatenate([np.arange(U), rng.integers(0, U, 200)])
    bw = rng.integers(0, 90, bk.size)

    def make(jm, dt):
        return (_side(jm, dt, bk.size, bk, "LONG", **{"d.w": (bw, "LONG")}),
                _side(jm, dt, N, pk, "LONG", v=(pv, "LONG"), g=(grp, "LONG")))

    return make(rjm, RefDataType), make(pjm, DataType)


PROGRAM_CASES = {name: (pql, (REF_SIDES[s], PORT_SIDES[s])) for name, (pql, s) in ENGINE_CASES.items()}
PROGRAM_CASES["key_windows"] = (
    "SELECT sum(f.v), sum(d.w), count(*), max(d.w) FROM f JOIN d ON f.k = d.k GROUP BY f.g TOP 50",
    _wide_group_sides(),
)


def _leaves(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_join_program_differential(case):
    """Counts, min / max and join_ok exact; float sums at rel 1e-12 (K1's
    plain version adds in the reference's row order, in float64)."""
    pql, sides = PROGRAM_CASES[case]
    rplan, rinputs, plan, inputs = _program_inputs(pql, sides)
    want = make_join_kernel(rplan)(rinputs)
    before = fused_groupby.launches
    stats = {}
    got = kernel.run_join_kernel(plan, inputs, stats)
    assert fused_groupby.launches == before  # CPU tensors: the plain version, no launch
    assert stats["build_rounds"] >= 1 and stats["probe_rounds"] >= 1
    assert bool(got["join_ok"]) and bool(np.asarray(want["join_ok"]))
    assert int(got["num_docs"]) == int(np.asarray(want["num_docs"]))
    if plan.n_groups:
        assert np.array_equal(got["gb_cnt"].numpy(), np.asarray(want["gb_cnt"]))
    plain = kernel.join_kernel_reference(plan, inputs)
    for i, (kind, _side, _idx) in enumerate(plan.aggs):
        key = f"gb_{i}" if plan.n_groups else f"agg_{i}"
        for g, w, p in zip(_leaves(got[key]), _leaves(want[key]), _leaves(plain[key])):
            g, w = g.numpy().astype(np.float64), np.asarray(w, dtype=np.float64)
            if kind in ("sum", "avg") and case == "floats":
                np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
                np.testing.assert_allclose(g, p.numpy(), rtol=1e-12, atol=0)
            else:
                assert np.array_equal(g, w), (key, kind)
                assert np.array_equal(g, p.numpy().astype(np.float64)), (key, kind)
    if case == "key_windows":
        G = plan.n_groups
        assert G > fused_groupby.max_capacity(8, 2, 0, 2), G


def test_join_program_x32_streams():
    """x32: the packed value streams are float32, as the reference's
    without x64; the program sums them through K1 in float32 (rel 1e-6)."""
    pql, sides = PROGRAM_CASES["probe_group"]
    _, _, plan, inputs = _program_inputs(pql, sides)
    _, inputs32, _ = pjm.build_join_plan(parse_pql(pql), *PORT_SIDES["dup"], precision="x32")
    assert inputs32["pv"].dtype == np.float32 and inputs32["bs"].dtype == np.float32
    got = kernel.run_join_kernel(plan, {k: torch.from_numpy(v.copy()) for k, v in inputs32.items()})
    want = kernel.run_join_kernel(plan, inputs)
    assert got["gb_0"].dtype == torch.float32
    np.testing.assert_allclose(got["gb_0"].numpy(), want["gb_0"].numpy(), rtol=1e-6)
    assert torch.equal(got["gb_cnt"], want["gb_cnt"])


def test_join_hash_is_the_reference_hash():
    rng = np.random.default_rng(1)
    keys = np.concatenate([rng.integers(0, 2**31 - 1, 5000), [0, 1, 2**31 - 1, -1]]).astype(np.int32)
    for cap in (8, 1024, 1 << 17):
        want = np.asarray(ref_join_hash(keys, cap))
        got = kernel._join_hash(torch.from_numpy(keys), cap).numpy()
        assert np.array_equal(got, want), cap


def test_build_that_runs_out_of_rounds_heals_to_the_host_join(monkeypatch):
    """join_ok false poisons the join plan and the host join answers."""
    pql, sides = ENGINE_CASES["scalar"]
    pb, pp = PORT_SIDES[sides]
    real = kernel._join_build

    def starved(bk, cap):
        table_key, table_row, _ok, rounds = real(bk, cap)
        return table_key, table_row, False, rounds

    monkeypatch.setattr(kernel, "_join_build", starved)
    ex = QueryExecutor(device="cpu")
    res = ex.execute_join(parse_pql(pql), pb, pp)
    assert res._served_tier == "host" and "deviceBytes" not in res.cost
    assert _norm(res) == _norm(pjm.host_join(parse_pql(pql), pb, pp))
    heal = ex.healing_stats()
    assert heal["hostFailovers"] == 1 and heal["poisonedPlans"] == 1
    ex.execute_join(parse_pql(pql), pb, pp)
    assert ex.healing_stats()["poisonSkips"] == 1


def test_a_k1_launch_error_on_the_join_path_raises(monkeypatch):
    """A wrapper's own error is the program's fault: it propagates, and
    the host join does not answer it."""
    pql, sides = ENGINE_CASES["probe_group"]
    pb, pp = PORT_SIDES[sides]

    def broken(*a, **k):
        raise RuntimeError("fused_groupby launch failed with code 1")

    monkeypatch.setattr(fused_groupby, "fused_filtered_groupby_sums", broken)
    ex = QueryExecutor(device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        ex.execute_join(parse_pql(pql), pb, pp)
    assert ex.healing_stats()["hostFailovers"] == 0


def test_device_off_takes_the_host_join(monkeypatch):
    pql, sides = ENGINE_CASES["build_group"]
    pb, pp = PORT_SIDES[sides]
    monkeypatch.setattr(config, "JOIN_DEVICE", False)
    res = QueryExecutor(device="cpu").execute_join(parse_pql(pql), pb, pp)
    assert res._served_tier == "host" and "hostMs" in res.cost
    assert _norm(res) == _norm(pjm.host_join(parse_pql(pql), pb, pp))


# ---------------------------------------------------------------------------
# extraction, shuffle planning, the wire
# ---------------------------------------------------------------------------

SCHEMA = make_test_schema()
ROWS = random_rows(SCHEMA, 900, seed=13, cardinality=40)
REF_SEGS = [ref_build_segment(SCHEMA, ROWS[i * 300:(i + 1) * 300], "testTable", f"t{i}") for i in range(3)]
PORT_SEGS = [segment_from_arrays(**segment_arrays_of(s)) for s in REF_SEGS]


def _cols_equal(a, b):
    assert a.stored == b.stored
    assert np.array_equal(a.ids, b.ids) and a.ids.dtype == b.ids.dtype
    if isinstance(b.values, np.ndarray):
        assert isinstance(a.values, np.ndarray) and a.values.dtype == b.values.dtype
        assert np.array_equal(a.values, b.values)
    else:
        assert list(a.values) == list(b.values)


def _sides_equal(a, b):
    assert a.n == b.n
    _cols_equal(a.key, b.key)
    assert sorted(a.cols) == sorted(b.cols)
    for name in b.cols:
        _cols_equal(a.cols[name], b.cols[name])


@pytest.mark.parametrize("key, cols, where", [
    ("dimInt", ["metInt", "dimStr", "metDouble"], None),
    ("dimStr", ["dimLong", "metFloat"], "dimInt > 3000 AND metDouble < 20"),
    ("dimLong", ["dimLong", "daysSinceEpoch"], "dimStr <> 'zz'"),
    ("dimInt", ["metInt"], "dimInt < -5"),
])
def test_extract_side_equals_the_reference(key, cols, where):
    """Exact: ids, vocabularies and their dtypes."""
    pql = f"SELECT count(*) FROM testTable{' WHERE ' + where if where else ''}"
    rtree, ptree = ref_parse(pql).filter, parse_pql(pql).filter
    want, wm = rjm.extract_side(REF_SEGS, rtree, key, cols, {"metInt": "x.metInt"})
    got, gm = pjm.extract_side(PORT_SEGS, ptree, key, cols, {"metInt": "x.metInt"})
    assert gm == wm
    _sides_equal(got, want)
    rows = np.arange(0, got.n, 3)
    _sides_equal(pjm.side_take(got, rows), rjm.side_take(want, rows))


def test_extract_side_rejects_multi_value_columns():
    with pytest.raises(pjm.JoinValidationError, match="multi-value"):
        pjm.extract_side(PORT_SEGS, None, "dimInt", ["dimStrMV"])


def test_shuffle_partitions_equal_the_reference():
    """Zipf s = 1.2 keys (tests/test_join.py's acceptance law): the same
    owner assignment, index for index, and the same heavy-key count."""
    rng = np.random.default_rng(7)
    zk = (np.minimum(rng.zipf(1.2, 30000), 400) - 1).astype(np.int64)
    v = rng.integers(0, 10, zk.size)
    sides = {}
    for name, jm, dt in (("ref", rjm, RefDataType), ("port", pjm, DataType)):
        sides[name] = (_side(jm, dt, 400, np.arange(400), "LONG", **{"d.w": (np.arange(400) % 7, "LONG")}),
                       _side(jm, dt, zk.size, zk, "LONG", v=(v, "LONG")))
    for owners in (1, 3, 4):
        for split in (True, False):
            want, wh = rjm.plan_shuffle_partitions(*sides["ref"], owners, split_heavy=split)
            got, gh = pjm.plan_shuffle_partitions(*sides["port"], owners, split_heavy=split)
            assert gh == wh
            assert len(got) == len(want)
            for (gb, gp), (wb, wp) in zip(got, want):
                assert np.array_equal(gb, wb) and np.array_equal(gp, wp)
    assert wh == 0 and rjm.plan_shuffle_partitions(*sides["ref"], 4)[1] > 0


def test_side_rows_cross_the_wire_both_ways():
    """A SideRows made by either package: the request and result wires
    carry the same bytes, and each package decodes the other's."""
    rb, rp = REF_SIDES["unique"]
    pb, pp = PORT_SIDES["unique"]
    for ref_side, port_side in ((rb, pb), (rp, pp)):
        ref_bytes = ref_serialize_request("rid", "pql", "t", [], 100.0, join={"x": rjm.encode_side(ref_side)})
        port_bytes = serialize_instance_request("rid", "pql", "t", [], 100.0, join={"x": pjm.encode_side(port_side)})
        assert port_bytes == ref_bytes
        _sides_equal(pjm.decode_side(deserialize_instance_request(ref_bytes)["join"]["x"]), port_side)
        _sides_equal(rjm.decode_side(ref_deserialize_request(port_bytes)["join"]["x"]), ref_side)
        port_res, ref_res = IntermediateResult(num_docs_scanned=3), RefResult(num_docs_scanned=3)
        port_res.join_payload, ref_res.join_payload = pjm.encode_side(port_side), rjm.encode_side(ref_side)
        assert serialize_result(port_res) == ref_serialize_result(ref_res)
        _sides_equal(rjm.decode_side(ref_deserialize_result(serialize_result(port_res)).join_payload), ref_side)
        _sides_equal(pjm.decode_side(deserialize_result(ref_serialize_result(ref_res)).join_payload), port_side)
    merged = pjm.merge_sides([pjm.side_take(pp, np.arange(0, 2000)), pjm.side_take(pp, np.arange(2000, 4000))])
    _sides_equal(merged, pp)


# ---------------------------------------------------------------------------
# typed errors and empty sides in the engine
# ---------------------------------------------------------------------------

def test_mixed_side_or_filter_is_a_validation_error():
    bad = parse_pql("SELECT count(*) FROM f JOIN d ON f.k = d.k WHERE f.a = 1 OR d.b = 2")
    with pytest.raises(pjm.JoinValidationError):
        pjm.split_join_filter(bad)
    left, right = pjm.split_join_filter(parse_pql(
        "SELECT count(*) FROM f JOIN d ON f.k = d.k WHERE f.a > 1 AND d.b = 2 AND (f.c = 3 OR f.e = 4)"))
    assert {n.column for n in left.walk() if n.is_leaf} == {"a", "c", "e"}
    assert [n.column for n in right.walk() if n.is_leaf] == ["b"]


def test_incompatible_key_types_are_a_validation_error():
    pb, _ = PORT_SIDES["strings"]
    _, pp = PORT_SIDES["dup"]
    with pytest.raises(pjm.JoinValidationError, match="incompatible"):
        QueryExecutor(device="cpu").execute_join(parse_pql("SELECT count(*) FROM f JOIN d ON f.k = d.k"), pb, pp)


def test_an_empty_side_is_an_empty_answer():
    pb, pp = PORT_SIDES["strings"]
    empty = pjm.merge_sides([])
    pql = "SELECT count(*), sum(f.v) FROM f JOIN d ON f.k = d.k"
    for build, probe in ((empty, pp), (pb, empty)):
        res = QueryExecutor(device="cpu").execute_join(parse_pql(pql), build, probe)
        assert res._served_tier == "host" and res.num_docs_scanned == 0
        assert [p.finalize() for p in res.aggregations][0] == 0
    grouped = QueryExecutor(device="cpu").execute_join(
        parse_pql("SELECT sum(f.v) FROM f JOIN d ON f.k = d.k GROUP BY f.v"), empty, pp)
    assert grouped.groups == {}


def test_a_join_request_without_a_join_phase_is_pruned_like_the_reference():
    """The reference's ``execute`` of a join request prunes every segment
    missing its right-side columns: an empty answer, here too."""
    pql = "SELECT sum(f.metInt) FROM testTable f JOIN dim d ON f.dimInt = d.k WHERE d.cat = 'x'"
    got = QueryExecutor(device="cpu").execute(PORT_SEGS, parse_pql(pql))
    want = RefExecutor().execute(REF_SEGS, ref_parse(pql))
    assert payloads_equivalent(_port_payload(pql, got), canonical_payload(ref_parse(pql), want),
                               rel_tol=REL, abs_tol=ABS)
    assert got.num_docs_scanned == 0
