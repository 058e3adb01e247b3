"""The port's exact distinct over (group, value) pairs (``sort_pairs``:
distinctcount, exact percentile and HLL states too wide for a dense
holder) against the JAX package on the same segments (carried across
with ``segment/convert.py``).

Both packages run with their dense-holder thresholds shrunk alike
(``MAX_VALUE_STATE``), as ``tests/test_distinct_sort.py`` shrinks the
reference's, so the small segments take the pair path.  Distinct counts,
percentiles and HLL estimates compare exactly, as client payloads; float
sums beside them at rel 1e-9 / abs 2e-5 in x64 (two summation orders, as
in ``test_torch_engine.py``) and in the audit band (rel 5e-4 / abs 1e-3)
with the port in x32.  The reduce itself compares exactly: the first
``n_unique`` slots, gids and run starts, ``n_unique`` and ``total_valid``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.engine import config as ref_config
from pinot_tpu.engine import kernel as ref_kernel
from pinot_tpu.engine.context import TableContext as RefContext
from pinot_tpu.engine.device import stage_segments as ref_stage_segments
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.engine.plan import build_static_plan as ref_build_static_plan
from pinot_tpu.engine.plan import plan_forced_host as ref_forced_host
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.tools.datagen import synthetic_adevents_segment as ref_adevents
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine import kernel as port_kernel
from pinot_tpu_torch.engine.context import TableContext
from pinot_tpu_torch.engine.device import stage_segments
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.kernels import fused_groupby
from pinot_tpu_torch.engine.kernels import value_state_counts as vsc
from pinot_tpu_torch.engine.plan import build_static_plan, plan_forced_host
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays

SENT = int(np.iinfo(np.int32).max)
TOL = {"x64": (1e-9, 2e-5), "x32": (5e-4, 1e-3)}

SEGMENTS = {
    "lineitem": [ref_synthetic(3000, seed=41 + i, name=f"li{i}") for i in range(3)],
    "adevents": [
        ref_adevents(4096, seed=5 + i, name=f"ad{i}", campaign_card=64, user_card=1 << 13)
        for i in range(2)
    ],
}
PORT = {k: [segment_from_arrays(**segment_arrays_of(s)) for s in v] for k, v in SEGMENTS.items()}

# (table, dense-holder threshold in both packages, query)
QUERIES = {
    "distinct_scalar": ("lineitem", 1 << 10, "SELECT distinctcount(l_extendedprice) FROM lineitem WHERE l_quantity < 10"),
    "distinct_scalar_nofilter": ("lineitem", 1 << 10, "SELECT distinctcount(l_extendedprice) FROM lineitem"),
    "percentile_scalar": ("lineitem", 1 << 10, "SELECT percentile50(l_extendedprice), percentile95(l_extendedprice) "
                          "FROM lineitem WHERE l_shipmode <> 'AIR'"),
    "distinct_grouped": ("lineitem", 1 << 10, "SELECT distinctcount(l_extendedprice) FROM lineitem "
                         "GROUP BY l_returnflag TOP 10"),
    "percentile_grouped": ("lineitem", 1 << 10, "SELECT percentile90(l_extendedprice), count(*) FROM lineitem "
                           "WHERE l_quantity > 25 GROUP BY l_shipmode TOP 10"),
    "distinct_sum_two_columns": ("lineitem", 1 << 10, "SELECT distinctcount(l_extendedprice), sum(l_quantity) "
                                 "FROM lineitem GROUP BY l_returnflag, l_linestatus TOP 10"),
    # > 100 groups: the trim orders groups by the pair buffers' per-slot values
    "distinct_trim": ("lineitem", 1 << 10, "SELECT distinctcount(l_extendedprice) FROM lineitem "
                      "WHERE l_quantity = 1 GROUP BY l_shipdate TOP 5"),
    "percentile_trim": ("lineitem", 1 << 10, "SELECT percentile90(l_extendedprice) FROM lineitem "
                        "WHERE l_quantity = 1 GROUP BY l_shipdate TOP 10"),
    "hll_grouped": ("lineitem", 1, "SELECT distinctcounthll(l_extendedprice) FROM lineitem GROUP BY l_returnflag TOP 10"),
    "hll_trim": ("lineitem", 1, "SELECT fasthll(l_shipdate), count(*) FROM lineitem GROUP BY l_shipdate TOP 5"),
    # the exact reach and the per-site HLL of the north-star table
    "reach_exact": ("adevents", 1 << 10, "SELECT distinctcount(user_id) FROM adevents WHERE site_id < 8 "
                    "GROUP BY campaign_id TOP 10"),
    "reach_hll_site": ("adevents", 1 << 10, "SELECT distinctcounthll(user_id) FROM adevents WHERE site_id < 8 "
                       "GROUP BY campaign_id, site_id TOP 10"),
}


@pytest.fixture
def shrink(monkeypatch):
    """Sets a config value in both packages for the test."""

    def set_both(name, value):
        monkeypatch.setattr(ref_config, name, value)
        monkeypatch.setattr(config, name, value)

    return set_both


def _plans(table, pql):
    """(reference plan, port plan) for ``pql`` staged as each executor stages it."""
    out = []
    for side in ("ref", "port"):
        if side == "ref":
            req, ex, live = ref_optimize(ref_parse(pql)), RefExecutor(), SEGMENTS[table]
            ctx = RefContext(live)
        else:
            req, ex, live = optimize_request(parse_pql(pql)), QueryExecutor(device="cpu"), PORT[table]
            ctx = TableContext(live)
        raw, gfwd, hll = ex._role_columns(req, live, ctx)
        kw = dict(raw_columns=raw, gfwd_columns=gfwd, hll_columns=hll, ctx=ctx,
                  skip_base_columns=ex._skip_base_columns(req, live, raw, gfwd, hll))
        needed = sorted(req.referenced_columns())
        if side == "ref":
            out.append(ref_build_static_plan(req, ctx, ref_stage_segments(live, needed, **kw)))
        else:
            st = stage_segments(live, needed, torch.device("cpu"), config.Precision("x64"), **kw)
            out.append(build_static_plan(req, ctx, st))
    return out


# ---------------------------------------------------------------------------
# The reduce against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "seed,shape,slots,gids,dropped",
    [
        (1, (3, 4096), 50, 300, 0.3),  # mixed
        (2, (2, 3000), 4, 8, 0.1),  # heavy duplicates
        (3, (1, 5000), 1 << 20, 1 << 30, 0.0),  # all unique
        (4, (2, 1000), 10, 10, 1.0),  # all dropped
        (5, (1, 1), 10, 10, 0.0),  # one row
    ],
)
def test_reduce_distinct_pairs_matches_reference(seed, shape, slots, gids, dropped):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, slots, size=shape).astype(np.int32)
    g = rng.integers(0, gids, size=shape).astype(np.int32)
    gone = rng.random(shape) < dropped
    s[gone] = SENT
    g[gone] = SENT
    want = [np.asarray(x) for x in ref_kernel._reduce_distinct_pairs((jnp.asarray(s), jnp.asarray(g)))]
    got = [x.numpy() for x in port_kernel._reduce_distinct_pairs((torch.from_numpy(s), torch.from_numpy(g)))]
    n = int(want[3])
    assert int(got[3]) == n and int(got[4]) == int(want[4]) == int((~gone).sum())
    for x, y in zip(got[:3], want[:3]):
        assert x.dtype == np.int32 and x.shape == (min(n, config.DISTINCT_PAIR_CAP),)
        np.testing.assert_array_equal(x[:n], y[:n])
    assert port_kernel.apply_reduce("distinct_pairs", (torch.from_numpy(s), torch.from_numpy(g)))[3] == n


def test_reduce_past_the_pair_buffer(shrink):
    """More unique pairs than the buffer: the first CAP entries, and the
    true n_unique that the executor refuses."""
    shrink("DISTINCT_PAIR_CAP", 64)
    rng = np.random.default_rng(3)
    s = rng.integers(0, 40, size=(2, 500)).astype(np.int32)
    g = rng.integers(0, 40, size=(2, 500)).astype(np.int32)
    want = [np.asarray(x) for x in ref_kernel._reduce_distinct_pairs((jnp.asarray(s), jnp.asarray(g)))]
    got = [x.numpy() for x in port_kernel._reduce_distinct_pairs((torch.from_numpy(s), torch.from_numpy(g)))]
    assert int(got[3]) == int(want[3]) > 64
    for x, y in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# Plans and payloads against the reference executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_pair_plans_match_reference(name, shrink):
    table, threshold, pql = QUERIES[name]
    shrink("MAX_VALUE_STATE", threshold)
    ref_plan, plan = _plans(table, pql)
    assert dataclasses.asdict(plan) == dataclasses.asdict(ref_plan)
    assert any(a.sort_pairs for a in plan.aggs) and plan.on_device


@pytest.mark.parametrize("precision", ["x64", "x32"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_pair_payloads_match_reference(name, precision, shrink):
    table, threshold, pql = QUERIES[name]
    shrink("MAX_VALUE_STATE", threshold)
    ref_req = ref_optimize(ref_parse(pql))
    want = canonical_payload(ref_req, RefExecutor().execute(SEGMENTS[table], ref_req))
    req = optimize_request(parse_pql(pql))
    ex = QueryExecutor(device="cpu", precision=precision)
    got = strip_accounting(reduce_to_response(req, [ex.execute(PORT[table], req)]).to_json())
    heal = ex.healing_stats()
    assert heal["deviceFailures"] == heal["hostFailovers"] == 0, heal  # no device run failed over
    rel, abs_ = TOL[precision]
    assert payloads_equivalent(got, want, rel_tol=rel, abs_tol=abs_), (got, want)


def test_grouped_pairs_take_the_torch_op_route_with_k1(monkeypatch, shrink):
    """A sort-pairs plan takes neither fused route; its group counts and
    presence come from K1 over the evaluated mask, and K2 never runs.
    The same query with a dense holder takes the fused value route."""
    table, _, pql = QUERIES["percentile_grouped"]
    calls = {"k1": 0, "k2": 0}
    for key, module, name in (("k1", fused_groupby, "fused_filtered_groupby_sums"),
                              ("k2", vsc, "value_state")):
        real = getattr(module, name)

        def spy(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(module, name, spy)
    monkeypatch.setattr(port_kernel, "fused_dispatches", 0)
    monkeypatch.setattr(port_kernel, "fused_value_dispatches", 0)
    req = optimize_request(parse_pql(pql))

    ex = QueryExecutor(device="cpu")
    ex.execute(PORT[table], req)  # dense holders
    assert port_kernel.fused_value_dispatches == 1 and calls["k2"] == 1

    shrink("MAX_VALUE_STATE", 1 << 10)
    calls.update(k1=0, k2=0)
    ref_plan, plan = _plans(table, pql)
    (st,) = ex._staged.values()
    assert plan.aggs[0].sort_pairs
    assert not port_kernel.fused_eligible(plan, st) and not port_kernel.fused_value_eligible(plan, st)
    QueryExecutor(device="cpu").execute(PORT[table], req)
    assert calls == {"k1": 1, "k2": 0}
    assert port_kernel.fused_dispatches == 0 and port_kernel.fused_value_dispatches == 1


def _host_payloads(table, pql):
    """(port payload, reference payload, port result) of one query."""
    ref_req = ref_optimize(ref_parse(pql))
    want = canonical_payload(ref_req, RefExecutor().execute(SEGMENTS[table], ref_req))
    req = optimize_request(parse_pql(pql))
    res = QueryExecutor(device="cpu").execute(PORT[table], req)
    return strip_accounting(reduce_to_response(req, [res]).to_json()), want, res


def test_pair_overflow_raises_for_the_host_tier(shrink, monkeypatch):
    """More unique pairs than the device buffer returns: after the device
    run (K1 launched, the pair reduce counted the pairs) the host tier
    finishes exactly, in both packages, with equal answers."""
    shrink("MAX_VALUE_STATE", 1 << 10)
    shrink("DISTINCT_PAIR_CAP", 64)
    pql = ("SELECT distinctcount(l_extendedprice) FROM lineitem WHERE l_shipdate > '1993-01-01' "
           "GROUP BY l_returnflag TOP 10")
    ref_plan, plan = _plans("lineitem", pql)
    assert plan.on_device and ref_plan.on_device
    reduced = []
    real = port_kernel._reduce_distinct_pairs
    monkeypatch.setattr(port_kernel, "_reduce_distinct_pairs", lambda v: reduced.append(real(v)) or reduced[-1])
    got, want, res = _host_payloads("lineitem", pql)
    assert got == want, (got, want)
    (out,) = reduced
    assert int(out[3]) > config.DISTINCT_PAIR_CAP
    assert res._served_tier == "host" and res.cost["segmentsHost"] == 3 and "hostMs" in res.cost


def test_forced_host_raises_before_staging(shrink):
    """No filter and more global values than the pair buffer: every value
    lands in a pair, so the plan leaves the device in both packages, and
    the port's host tier answers before it stages anything, as the
    reference's does."""
    shrink("MAX_VALUE_STATE", 1 << 10)
    shrink("DISTINCT_PAIR_CAP", 64)
    pql = "SELECT distinctcount(l_extendedprice) FROM lineitem GROUP BY l_returnflag TOP 10"
    ref_plan, plan = _plans("lineitem", pql)
    assert not plan.on_device and not ref_plan.on_device
    ref_req = ref_optimize(ref_parse(pql))
    assert ref_forced_host(ref_req, RefContext(SEGMENTS["lineitem"]))
    req = optimize_request(parse_pql(pql))
    assert plan_forced_host(req, TableContext(PORT["lineitem"]), config.Precision("x64"))
    ex = QueryExecutor(device="cpu")
    res = ex.execute(PORT["lineitem"], req)
    assert ex.staged_bytes() == 0 and not ex._staged
    assert res._served_tier == "host"
    got, want, _ = _host_payloads("lineitem", pql)
    assert got == want, (got, want)
