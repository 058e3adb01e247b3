"""The port's parse -> optimize -> staging roles -> StaticPlan -> query
inputs against the JAX package's, field by field, on the same segments
(carried across with ``segment/convert.py``).  Everything compared here
is exact: plans, roles, staged values and query-input arrays."""
import dataclasses

import numpy as np
import pytest
import torch

from pinot_tpu.engine.context import TableContext as RefContext
from pinot_tpu.engine.device import stage_segments as ref_stage_segments
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.engine.plan import build_query_inputs as ref_build_query_inputs
from pinot_tpu.engine.plan import build_static_plan as ref_build_static_plan
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic

from pinot_tpu_torch.engine.config import Precision
from pinot_tpu_torch.engine.context import TableContext
from pinot_tpu_torch.engine.device import stage_segments
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.plan import build_query_inputs, build_static_plan
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays

Q1 = (
    "SELECT sum(l_quantity), sum(l_extendedprice), sum(l_discount), count(*) "
    "FROM lineitem WHERE l_shipdate <= '1998-09-02' "
    "GROUP BY l_returnflag, l_linestatus TOP 10"
)
Q3 = (
    "SELECT sum(l_extendedprice), sum(l_quantity) FROM lineitem "
    "WHERE l_returnflag = 'R' GROUP BY l_shipmode TOP 10"
)
RANGE = (
    "SELECT sum(l_extendedprice), count(*) FROM lineitem "
    "WHERE l_quantity > 25 GROUP BY l_returnflag TOP 10"
)
QUERIES = {
    "q1": Q1,
    "q3": Q3,
    "range_unsorted": RANGE,
    "in": "SELECT sum(l_quantity) FROM lineitem WHERE l_shipmode IN ('AIR', 'RAIL', 'MAIL') "
    "GROUP BY l_linestatus",
    "not_in": "SELECT count(*), sum(l_tax) FROM lineitem WHERE l_shipmode NOT IN ('AIR', 'RAIL')",
    "and_or": "SELECT avg(l_discount), max(l_quantity) FROM lineitem WHERE "
    "(l_quantity BETWEEN 10 AND 20 AND l_returnflag <> 'N') OR l_shipdate < '1993-01-01' "
    "GROUP BY l_shipmode TOP 5",
    "big_in_runs": "SELECT min(l_extendedprice) FROM lineitem WHERE l_quantity IN "
    "(1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,30,40) GROUP BY l_returnflag",
    "regex": "SELECT count(*) FROM lineitem WHERE regexp_like(l_receiptdate, '-0[13579]-') "
    "GROUP BY l_returnflag, l_shipmode",
}

REF_SEGMENTS = [ref_synthetic(3000, seed=11 + i, name=f"li{i}") for i in range(3)]
PORT_SEGMENTS = [segment_from_arrays(**segment_arrays_of(s)) for s in REF_SEGMENTS]


def _assert_tree_equal(a, b, path="q"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _ref_side(pql):
    req = ref_optimize(ref_parse(pql))
    ex = RefExecutor()
    live = REF_SEGMENTS
    needed = set(req.referenced_columns()) - ex._docrange_only_columns(req, live, None)
    ctx = RefContext(live)
    raw, gfwd, hll = ex._role_columns(req, live, ctx)
    skip = ex._skip_base_columns(req, live, raw, gfwd, hll)
    st = ref_stage_segments(
        live, sorted(needed), raw_columns=raw, gfwd_columns=gfwd, hll_columns=hll,
        ctx=ctx, skip_base_columns=skip,
    )
    plan = ref_build_static_plan(req, ctx, st)
    return req, needed, (raw, gfwd, hll), skip, st, plan, ref_build_query_inputs(req, plan, ctx, st)


def _port_side(pql):
    req = optimize_request(parse_pql(pql))
    ex = QueryExecutor(device="cpu", precision="x64")
    live = PORT_SEGMENTS
    needed = set(req.referenced_columns()) - ex._docrange_only_columns(req, live)
    ctx = TableContext(live)
    raw, gfwd = ex._role_columns(req, live)
    skip = ex._skip_base_columns(req, live, raw, gfwd)
    st = stage_segments(
        live, sorted(needed), torch.device("cpu"), Precision("x64"),
        raw_columns=raw, gfwd_columns=gfwd, ctx=ctx, skip_base_columns=skip,
    )
    plan = build_static_plan(req, ctx, st)
    return req, needed, (raw, gfwd), skip, st, plan, build_query_inputs(req, plan, ctx, st)


@pytest.mark.parametrize("fn", ["pad_docs", "pad_card", "pad_value_card"])
def test_padding_buckets_match_reference(fn):
    """The padding buckets decide every staged shape: copied exactly."""
    from pinot_tpu.engine import config as ref_config
    from pinot_tpu_torch.engine import config as port_config

    sizes = list(range(0, 5000)) + [2**k + d for k in range(12, 28) for d in (-1, 0, 1)]
    for n in sizes:
        assert getattr(port_config, fn)(n) == getattr(ref_config, fn)(n), (fn, n)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_plan_and_inputs_match_reference(name):
    r_req, r_needed, r_roles, r_skip, r_st, r_plan, r_q = _ref_side(QUERIES[name])
    p_req, p_needed, p_roles, p_skip, p_st, p_plan, p_q = _port_side(QUERIES[name])

    assert dataclasses.asdict(p_req) == dataclasses.asdict(r_req)
    assert p_needed == r_needed
    assert p_roles == r_roles[:2] and r_roles[2] == ()
    assert p_skip == r_skip
    assert dataclasses.asdict(p_plan) == dataclasses.asdict(r_plan)
    _assert_tree_equal(r_q, p_q)

    # staged tables hold the same arrays (uint16 staging becomes int16)
    assert p_st.n_pad == r_st.n_pad and p_st.num_docs == r_st.num_docs
    assert sorted(p_st.columns) == sorted(r_st.columns)
    for c, rc in r_st.columns.items():
        pc = p_st.columns[c]
        assert pc.card_pad == rc.card_pad and pc.cards == rc.cards
        for role in ("fwd", "dict_vals", "raw", "gfwd"):
            ra, pa = getattr(rc, role), getattr(pc, role)
            assert (ra is None) == (pa is None), (c, role)
            if ra is not None:
                ra = np.asarray(ra)
                pa = pa.numpy()
                if ra.dtype == np.uint16:
                    assert pa.dtype == np.int16
                else:
                    assert pa.dtype == ra.dtype, (c, role)
                np.testing.assert_array_equal(pa, ra.astype(pa.dtype))
