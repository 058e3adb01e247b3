"""The port's selection queries (``SELECT ... [WHERE] [ORDER BY] LIMIT``)
against the JAX package on the same segments (carried across with
``segment/convert.py``), compared as client payloads: the rows and the
column names exactly, in x64 and with the port in x32 against the
reference's x64.  The sort key's packing differs between the two modes
(x32's key space is 2^30), so x32 runs the lexicographic branch where
the reference packs.

The kernel-level case holds the port's ``_selection_outputs`` against the
reference's on seeded arrays with many tied keys: the candidate doc ids
and their match flags compare exactly, ties resolved in doc order.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.engine import config as ref_config
from pinot_tpu.engine import kernel as ref_kernel
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.engine.plan import StaticSelection as RefSelection
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import lineitem_rows as ref_lineitem_rows
from pinot_tpu.tools.datagen import lineitem_schema as ref_lineitem_schema
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic
from pinot_tpu.utils.audit import canonical_payload, strip_accounting

from pinot_tpu_torch.engine import kernel as port_kernel
from pinot_tpu_torch.engine import plan as port_plan
from pinot_tpu_torch.engine.config import Precision
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays

SEGMENTS = {
    "synthetic": [ref_synthetic(3000, seed=31 + i, name=f"li{i}") for i in range(3)],
    # row-built: every dictionary holds only present values, l_shipdate unsorted
    "row_built": [
        ref_build_segment(ref_lineitem_schema(), ref_lineitem_rows(4500, seed=5)[i * 1500 : (i + 1) * 1500],
                          "lineitem", f"lr{i}")
        for i in range(3)
    ],
}
PORT = {k: [segment_from_arrays(**segment_arrays_of(s)) for s in v] for k, v in SEGMENTS.items()}

CASES = {
    "no_sort": "SELECT l_shipmode, l_extendedprice FROM lineitem WHERE l_shipmode = 'AIR' LIMIT 10",
    "asc": "SELECT l_extendedprice, l_tax FROM lineitem WHERE l_quantity > 20 ORDER BY l_extendedprice LIMIT 8",
    "desc": "SELECT l_shipdate, l_extendedprice, l_quantity FROM lineitem WHERE l_quantity > 45 "
    "ORDER BY l_extendedprice DESC LIMIT 10",
    "multi_packed": "SELECT l_returnflag, l_linestatus, l_quantity FROM lineitem "
    "ORDER BY l_returnflag DESC, l_linestatus, l_quantity DESC LIMIT 12",
    # price x shipdate x receiptdate: past x32's 2^30 key space (lexicographic there)
    "wide": "SELECT * FROM lineitem ORDER BY l_extendedprice, l_shipdate, l_receiptdate LIMIT 5, 10",
    # every column: the doc id no longer folds into an int64 packed key (x64)
    "all_columns": "SELECT l_shipdate FROM lineitem ORDER BY l_returnflag, l_linestatus, l_shipmode, "
    "l_quantity, l_discount, l_tax, l_shipdate, l_receiptdate, l_extendedprice DESC LIMIT 6",
    # ~60 rows per quantity: LIMIT 30 cuts through the first run of ties
    "ties": "SELECT l_quantity, l_receiptdate, l_extendedprice FROM lineitem ORDER BY l_quantity LIMIT 30",
    "offset": "SELECT l_receiptdate, l_discount FROM lineitem WHERE l_returnflag = 'R' "
    "ORDER BY l_discount DESC, l_receiptdate LIMIT 20, 15",
    "limit_above_matches": "SELECT l_shipmode, l_quantity FROM lineitem WHERE l_shipmode = 'AIR' "
    "AND l_quantity = 7 AND l_returnflag = 'N' ORDER BY l_quantity LIMIT 500",
    "empty_match": "SELECT l_quantity FROM lineitem WHERE l_shipmode = 'BOAT' ORDER BY l_quantity LIMIT 5",
    "star": "SELECT * FROM lineitem WHERE l_quantity < 3 OR l_shipmode = 'MAIL' ORDER BY l_shipdate DESC LIMIT 12",
}


@functools.lru_cache(maxsize=None)
def _reference(pql: str, segs: str):
    req = ref_optimize(ref_parse(pql))
    return canonical_payload(req, RefExecutor().execute(SEGMENTS[segs], req))


def _port(pql: str, segs: str, precision: str):
    req = optimize_request(parse_pql(pql))
    ex = QueryExecutor(device="cpu", precision=precision)
    got = strip_accounting(reduce_to_response(req, [ex.execute(PORT[segs], req)]).to_json())
    heal = ex.healing_stats()
    assert heal["deviceFailures"] == heal["hostFailovers"] == 0, heal  # no device run failed over
    return got


@pytest.mark.parametrize(
    "segs,precision", [("synthetic", "x64"), ("synthetic", "x32"), ("row_built", "x64")]
)
@pytest.mark.parametrize("case", sorted(CASES))
def test_selection_payloads_match_reference(case, segs, precision):
    pql = CASES[case]
    want = _reference(pql, segs)
    got = _port(pql, segs, precision)
    assert got == want, (got, want)
    rows = got["selectionResults"]["results"]
    assert (len(rows) == 0) == (case == "empty_match")


def test_unpacked_branch_in_both_packages(monkeypatch):
    """A key space past ``max_key_space`` in both packages: the reference
    sorts its multi-operand lexicographic ``lax.sort``, the port its
    successive stable sorts; the payloads are equal."""
    pql = CASES["multi_packed"]
    monkeypatch.setattr(ref_config, "max_key_space", lambda: 8)
    monkeypatch.setattr(Precision, "max_key_space", property(lambda self: 8))
    plans = []
    real = port_plan.build_static_plan

    def spy(*a, **k):
        plans.append(real(*a, **k))
        return plans[-1]

    monkeypatch.setattr("pinot_tpu_torch.engine.executor.build_static_plan", spy)
    ref_req = ref_optimize(ref_parse(pql))
    want = canonical_payload(ref_req, RefExecutor().execute(SEGMENTS["synthetic"], ref_req))
    got = _port(pql, "synthetic", "x64")
    assert got == want, (got, want)
    assert plans and not plans[0].selection.packed


def test_selection_takes_the_torch_op_route(monkeypatch):
    """A selection plan never takes a fused route."""
    monkeypatch.setattr(port_kernel, "fused_dispatches", 0)
    monkeypatch.setattr(port_kernel, "fused_value_dispatches", 0)
    _port(CASES["desc"], "synthetic", "x64")
    assert port_kernel.fused_dispatches == 0 and port_kernel.fused_value_dispatches == 0


# ---------------------------------------------------------------------------
# _selection_outputs against the reference's, many ties
# ---------------------------------------------------------------------------

SORTS = {
    "no_sort": ((), ()),
    "one_asc": ((3,), (True,)),
    "two_mixed": ((3, 5), (False, True)),
    "three_desc": ((4, 2, 3), (False, False, False)),
}


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("sorts", sorted(SORTS))
def test_selection_outputs_match_reference(sorts, packed):
    gcards, asc = SORTS[sorts]
    rng = np.random.default_rng(17)
    S, n, k = 3, 256, 40
    cols = tuple(f"c{j}" for j in range(len(gcards)))
    g = {c: rng.integers(0, gc, size=(S, n)).astype(np.int32) for c, gc in zip(cols, gcards)}
    mask = rng.random((S, n)) < 0.6
    mask[2] = False  # a segment with no match
    mask[1, 200:] = False

    def selection(cls):
        return cls(columns=("*",), sort_columns=cols, sort_ascending=asc, sort_gcards=gcards,
                   k=k, packed=packed, use_gfwd=tuple(True for _ in cols))

    ref_plan = SimpleNamespace(selection=selection(RefSelection))
    ref_out = [
        ref_kernel._selection_outputs(
            ref_plan, {f"{c}.gfwd": jnp.asarray(g[c][s]) for c in cols}, {"sel_remap": [None] * len(cols)},
            jnp.asarray(mask[s]),
        )
        for s in range(S)
    ]
    plan = SimpleNamespace(selection=selection(port_plan.StaticSelection))
    out = port_kernel._selection_outputs(
        plan, {f"{c}.gfwd": torch.from_numpy(g[c]) for c in cols}, {"sel_remap": [None] * len(cols)},
        torch.from_numpy(mask),
    )
    want_ids = np.stack([np.asarray(o["sel_docids"]) for o in ref_out])
    want_valid = np.stack([np.asarray(o["sel_valid"]) for o in ref_out])
    assert out["sel_docids"].dtype == torch.int32
    np.testing.assert_array_equal(out["sel_docids"].numpy(), want_ids)
    np.testing.assert_array_equal(out["sel_valid"].numpy(), want_valid)
