"""The port's cross-query micro-batching tier (``engine/dispatch.py``
``BatchSpec`` / ``_BatchFetch``, ``kernel.run_batched_table_kernel``, the
batched K1 / K2 wrappers), the twin of ``tests/test_batching.py:101-352``
on a port server (``device="cpu"``) behind the port broker.

Same-plan queries at distinct literals, queued while the lane is held,
launch as one batch; each answer is byte-identical to the serial
(unbatched, no lane) port server's and ``payloads_equivalent`` to the
JAX package's executor at rel 1e-9 / abs 2e-5.  The lane-unit cases
follow the reference's (window close and fill, the member cap, keys,
the deadline shed, error fan-out), with the port's error typing: a device
fault reaches every member as a ``DeviceExecutionError``, any other error
as raised.  The packing helpers are held against the reference's on the
same numpy trees, and the batched plain K1 / K2 against B one-member
plain calls.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

from pinot_tpu.engine import packing as ref_packing
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.broker.broker import BrokerRequestHandler
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.common.faults import DeviceFaultInjector
from pinot_tpu_torch.engine import kernel as kernel_mod
from pinot_tpu_torch.engine import packing
from pinot_tpu_torch.engine.dispatch import (
    BatchSpec,
    DeviceExecutionError,
    DeviceLane,
    leaked_lane_threads,
)
from pinot_tpu_torch.engine.kernels import fused_groupby, value_state_counts
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.server.scheduler import QueryAbandonedError, leaked_scheduler_threads
from pinot_tpu_torch.transport.local import LocalTransport
from pinot_tpu_torch.utils.metrics import ServerMetrics

REL, ABS = 1e-9, 2e-5
TABLE = "testTable"
SCHEMA = make_test_schema(with_mv=False)
ROWS = random_rows(SCHEMA, 4000, seed=9)
REF_SEGMENTS = [
    ref_build_segment(SCHEMA, ROWS[:2000], TABLE, "bt0"),
    ref_build_segment(SCHEMA, ROWS[2000:], TABLE, "bt1"),
]

# tests/test_batching.py:68-73: filtered scalar aggs, a filtered group-by
# with max, a distinct-count group-by, a selection; then K1's fused route
BATCH_SHAPES = [
    "SELECT sum(metInt), count(*) FROM testTable WHERE dimInt > {t}",
    "SELECT sum(metFloat), max(metInt) FROM testTable WHERE dimInt > {t} GROUP BY dimStr TOP 5",
    "SELECT distinctcount(dimLong) FROM testTable WHERE dimInt > {t} GROUP BY dimStr TOP 5",
    "SELECT dimStr, metInt FROM testTable WHERE dimInt > {t} ORDER BY metInt DESC LIMIT 7",
    "SELECT sum(metInt), avg(metFloat), count(*) FROM testTable WHERE dimInt > {t} GROUP BY dimStr TOP 5",
]
SHAPE_IDS = ["agg", "groupby", "distinct", "select", "fused"]


@pytest.fixture(autouse=True)
def no_leaked_threads():
    yield
    assert leaked_lane_threads() == []
    assert leaked_scheduler_threads() == []


class _Stack:
    """A port server on the CPU behind the port broker."""

    def __init__(self, pipeline: bool = True, **kwargs) -> None:
        self.server = ServerInstance("s0", device="cpu", pipeline=pipeline, **kwargs)
        for seg in REF_SEGMENTS:
            self.server.add_segment(TABLE, segment_from_arrays(**segment_arrays_of(seg)))
        transport = LocalTransport()
        transport.register(("s0", 0), self.server.handle_request)
        routing = RoutingTableProvider()
        routing.update(TABLE, {s.segment_name: {"s0": "ONLINE"} for s in REF_SEGMENTS})
        self.broker = BrokerRequestHandler(transport, {"s0": ("s0", 0)}, routing=routing, timeout_ms=30_000)

    def handle_pql(self, pql):
        return self.broker.handle_pql(pql)

    def close(self) -> None:
        self.broker.shutdown()
        self.server.shutdown()


@pytest.fixture
def stacks():
    made = []

    def make(**kwargs):
        made.append(_Stack(**kwargs))
        return made[-1]

    yield make
    for s in made:
        s.close()


def _payload(resp) -> str:
    """The client payload but wall clock, request id and the cost vector
    (tests/test_batching.py:33-44)."""
    return json.dumps({k: v for k, v in resp.to_json().items()
                       if k not in ("timeUsedMs", "requestId", "cost", "freshnessMs")}, sort_keys=True)


def _ladder(shape: str):
    return [shape.format(t=t) for t in (1000, 2300, 4800, 6500)]


def _reference(pql):
    req = ref_optimize(ref_parse(pql))
    return canonical_payload(req, RefExecutor().execute(REF_SEGMENTS, req))


def _run_concurrently_batched(stack, queries, settle_s: float = 0.8):
    """Send ``queries`` at once while the lane is held, so they queue as
    distinct same-plan dispatches, then release it: the lane's dequeue
    gathers them into batched launches."""
    gate = threading.Event()
    stack.server.lane.submit(("blocker", time.monotonic()), lambda: gate.wait(15))
    time.sleep(0.05)
    results, errs = {}, []

    def run(q):
        try:
            results[q] = stack.handle_pql(q)
        except Exception as e:  # pragma: no cover - reported below
            errs.append((q, e))

    threads = [threading.Thread(target=run, args=(q,)) for q in queries]
    for t in threads:
        t.start()
    time.sleep(settle_s)  # every PREP done and queued on the lane
    gate.set()
    for t in threads:
        t.join()
    assert not errs, errs[:1]
    return results


# ------------------------------------------------------- through a server
@pytest.mark.parametrize("shape", BATCH_SHAPES, ids=SHAPE_IDS)
def test_batched_matches_unbatched_payloads(shape, stacks):
    # the scalar-agg shape would otherwise take the bit-sliced tier, as in
    # the reference's test (PINOT_TPU_BITSLICED=0 there)
    serial = stacks(pipeline=False, bitsliced=False)
    pipelined = stacks(pipeline=True, bitsliced=False)
    queries = _ladder(shape)
    for s in (serial, pipelined):
        r = s.handle_pql(queries[0])
        assert not r.exceptions, r.exceptions
    k1, k2 = kernel_mod.batched_dispatches, kernel_mod.fused_value_dispatches
    results = _run_concurrently_batched(pipelined, queries)
    stats = pipelined.server.status()["lane"]
    assert stats["batchLaunches"] >= 1, stats
    assert stats["batchedQueries"] >= 2, stats
    assert kernel_mod.batched_dispatches > k1
    hits = 0
    for q in queries:
        resp = results[q]
        assert not resp.exceptions, (q, resp.exceptions)
        assert _payload(serial.handle_pql(q)) == _payload(resp), q
        assert payloads_equivalent(strip_accounting(resp.to_json()), _reference(q), rel_tol=REL, abs_tol=ABS), q
        assert "segmentsHost" not in resp.cost
        hits += int(resp.cost.get("batchHits", 0))
    assert hits >= 2
    if shape == BATCH_SHAPES[2]:
        assert kernel_mod.fused_value_dispatches > k2  # batched K1 + K2 on the fused value route


def test_batched_fused_routes_call_the_batched_kernels(stacks, monkeypatch):
    """The fused route's batch is one batched K1 call with a member axis;
    the fused value route's one batched K1 and one batched K2."""
    calls = []
    for mod, name in ((fused_groupby, "fused_filtered_groupby_sums_batched"),
                      (value_state_counts, "value_state_batched")):
        real = getattr(mod, name)

        def spy(*a, real=real, name=name, **k):
            calls.append((name, k["members"]))
            return real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    pipelined = stacks(pipeline=True)
    for shape in (BATCH_SHAPES[4], BATCH_SHAPES[2]):
        queries = _ladder(shape)
        pipelined.handle_pql(queries[0])
        calls.clear()
        _run_concurrently_batched(pipelined, queries)
        names = sorted({n for n, _ in calls})
        want = ["fused_filtered_groupby_sums_batched"] + (["value_state_batched"] if "distinct" in shape else [])
        assert names == want, calls
        assert all(m >= 2 for _, m in calls)


def test_distinct_literals_produce_distinct_results(stacks):
    pipelined = stacks(pipeline=True)
    queries = _ladder(BATCH_SHAPES[4])
    assert not pipelined.handle_pql(queries[0]).exceptions
    results = _run_concurrently_batched(pipelined, queries)
    answers = {json.dumps(results[q].to_json().get("aggregationResults"), sort_keys=True) for q in queries}
    assert len(answers) == len(queries)


def test_poisoned_batched_plan_host_heals_every_member(stacks):
    inj = DeviceFaultInjector()
    serial = stacks(pipeline=False)
    pipelined = stacks(pipeline=True, device_fault_injector=inj)
    queries = _ladder(BATCH_SHAPES[4])
    assert not pipelined.handle_pql(queries[0]).exceptions
    digest = inj.launches[-1].digest
    pipelined.server.executor.clear_poisoned()
    inj.poison_plan(digest)
    popped = ("timeUsedMs", "requestId", "cost", "numEntriesScannedInFilter", "numEntriesScannedPostFilter")

    def heal_payload(resp):
        return json.dumps({k: v for k, v in resp.to_json().items() if k not in popped}, sort_keys=True)

    results = _run_concurrently_batched(pipelined, queries)
    for q in queries:
        resp = results[q]
        assert not resp.exceptions, (q, resp.exceptions)
        assert resp.cost.get("segmentsHost") == len(REF_SEGMENTS)
        assert heal_payload(serial.handle_pql(q)) == heal_payload(resp), q
    heal = pipelined.server.executor.healing_stats()
    assert heal["hostFailovers"] >= len(queries), heal
    assert heal["poisonedPlans"] >= 1, heal
    assert pipelined.server.lane.stats()["batchLaunches"] >= 1


def test_a_planted_build_error_in_a_batched_launch_raises(stacks, monkeypatch):
    """A failed kernel build inside a batched launch reaches every member
    as raised: each query replies an error, none is answered by the host
    tier, and the lane stays up."""
    pipelined = stacks(pipeline=True)
    queries = _ladder(BATCH_SHAPES[4])
    assert not pipelined.handle_pql(queries[0]).exceptions

    def broken(*a, **k):
        raise RuntimeError("nvcc failed for fused_groupby: planted")

    monkeypatch.setattr(fused_groupby, "fused_filtered_groupby_sums_batched", broken)
    results = _run_concurrently_batched(pipelined, queries)
    stats = pipelined.server.lane.stats()
    assert stats["batchLaunches"] >= 1
    for q in queries:
        resp = results[q]
        if resp.cost.get("batchHits"):
            pytest.fail("a member answered from a failed batched launch")
    errs = [results[q] for q in queries if results[q].exceptions]
    assert len(errs) >= 2
    assert all("planted" in json.dumps([e.to_json() for e in r.exceptions]) for r in errs)
    heal = pipelined.server.executor.healing_stats()
    assert heal["hostFailovers"] == 0 and heal["deviceFailures"] == 0, heal
    assert stats["deviceFailures"] == 0
    monkeypatch.undo()
    assert not pipelined.handle_pql(queries[1]).exceptions  # the lane still serves


# ------------------------------------------------------- the lane, alone
def _spec(key, val, calls=None, max_members=0, fetches=None):
    """A BatchSpec whose batched launch doubles each member's value
    (``fetches`` counts the batch fetches)."""

    def launch_batched(inputs_list):
        if calls is not None:
            calls.append([x["v"] for x in inputs_list])
        arr = np.array([x["v"] for x in inputs_list], dtype=np.int64)

        def fetch(handle, deadline=None):
            if fetches is not None:
                fetches.append(1)
            return {"v": arr * 2}

        return fetch, object()

    return BatchSpec(key, {"v": val}, launch_batched, max_members=max_members)


def _member(ticket):
    fetch, handle = ticket.result(time.monotonic() + 10)
    return int(fetch(handle)["v"])


def _held(lane):
    gate = threading.Event()
    lane.submit(("blocker",), lambda: gate.wait(10))
    time.sleep(0.05)
    return gate


def test_batch_fills_queued_peers_and_respects_the_cap():
    lane = DeviceLane("cpu", metrics=ServerMetrics("t"), stall_timeout_s=0)
    lane.batch_max = 3
    lane.batch_window_s = 0.0
    calls, fetches = [], []
    gate = _held(lane)
    tickets = [lane.submit(("q", i), lambda i=i: ("unbatched", i), batch=_spec("K", i, calls, fetches=fetches))
               for i in range(5)]
    gate.set()
    assert [_member(t) for t in tickets] == [0, 2, 4, 6, 8]
    assert [len(c) for c in calls] == [3, 2]  # the cap, then the rest
    assert len(fetches) == 2  # one packed fetch a batched launch, whatever its members
    stats = lane.stats()
    assert stats["batchLaunches"] == 2 and stats["batchedQueries"] == 5
    assert stats["batchWindowFull"] >= 1
    assert all(t.batch_size in (2, 3) for t in tickets)
    lane.close()


def test_the_specs_max_members_caps_the_batch():
    lane = DeviceLane("cpu", stall_timeout_s=0)
    lane.batch_window_s = 0.0
    calls = []
    gate = _held(lane)
    tickets = [lane.submit(("q", i), lambda i=i: ("un", i), batch=_spec("K", i, calls, max_members=2))
               for i in range(5)]
    gate.set()
    assert [_member(t) for t in tickets[:4]] == [0, 2, 4, 6]
    assert tickets[4].result(time.monotonic() + 10) == ("un", 4)  # alone: its own launch
    assert [len(c) for c in calls] == [2, 2]
    lane.close()


def test_a_lone_batchable_dispatch_launches_alone():
    lane = DeviceLane("cpu", stall_timeout_s=0)
    t = lane.submit(("q", 0), lambda: "direct", batch=_spec("K", 0))
    assert t.result(time.monotonic() + 10) == "direct"
    assert lane.batch_launches == 0 and t.batch_size == 1
    lane.close()


def test_the_window_holds_for_demand_and_closes_on_timeout():
    """Two queued same-key members hold the window open: a third arriving
    inside it joins the batch; the window then closes on its timeout."""
    lane = DeviceLane("cpu", stall_timeout_s=0)
    lane.batch_window_s = 0.3
    calls = []
    gate = _held(lane)
    first = [lane.submit(("q", i), lambda i=i: ("un", i), batch=_spec("K", i, calls)) for i in range(2)]
    gate.set()
    time.sleep(0.1)
    late = lane.submit(("q", 2), lambda: ("un", 2), batch=_spec("K", 2, calls))
    assert [_member(t) for t in first + [late]] == [0, 2, 4]
    assert calls == [[0, 1, 2]]
    assert lane.stats()["batchWindowTimeout"] == 1
    lane.close()


def test_batch_keys_partition_batches():
    lane = DeviceLane("cpu", stall_timeout_s=0)
    lane.batch_window_s = 0.0
    gate = _held(lane)
    ta = [lane.submit(("a", i), lambda i=i: ("un", i), batch=_spec("KA", i)) for i in range(2)]
    tb = [lane.submit(("b", i), lambda i=i: ("un", i), batch=_spec("KB", 10 + i)) for i in range(2)]
    gate.set()
    assert [_member(t) for t in ta] == [0, 2]
    assert [_member(t) for t in tb] == [20, 22]
    assert lane.batch_launches == 2
    lane.close()


def test_batch_max_one_turns_the_tier_off():
    lane = DeviceLane("cpu", stall_timeout_s=0)
    lane.batch_max = 1
    gate = _held(lane)
    tickets = [lane.submit(("q", i), lambda i=i: ("un", i), batch=_spec("K", i)) for i in range(3)]
    gate.set()
    assert [t.result(time.monotonic() + 10) for t in tickets] == [("un", 0), ("un", 1), ("un", 2)]
    assert lane.batch_launches == 0
    lane.close()


def test_deadline_expired_member_sheds_without_poisoning_batchmates():
    lane = DeviceLane("cpu", stall_timeout_s=0)
    lane.batch_window_s = 0.0
    gate = _held(lane)
    doomed = lane.submit(("q", 0), lambda: ("un", 0), deadline=time.monotonic() + 0.05, batch=_spec("K", 0))
    survivors = [lane.submit(("q", i), lambda i=i: ("un", i), deadline=time.monotonic() + 30, batch=_spec("K", i))
                 for i in (1, 2)]
    time.sleep(0.2)  # doomed expires while the blocker holds the lane
    gate.set()
    with pytest.raises(QueryAbandonedError):
        doomed.result(time.monotonic() + 5)
    assert [_member(t) for t in survivors] == [2, 4]
    assert lane.shed_count == 1
    assert lane.batch_launches == 1 and lane.batched_queries == 2
    lane.close()


@pytest.mark.parametrize("raised, typed", [
    (ValueError("a wrapper's own launch error"), False),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (DeviceExecutionError("injected: poisoned plan", retryable=False), True),
], ids=["wrapper_error", "allocation_failure", "typed_fault"])
def test_a_batched_launch_error_fans_out_to_every_member(raised, typed):
    """One failing batched launch delivers the same error to every
    member: a device fault typed (counted once), any other error as
    raised (no device failure)."""
    lane = DeviceLane("cpu", stall_timeout_s=0)
    lane.batch_window_s = 0.0

    def bad(inputs_list):
        raise raised

    gate = _held(lane)
    tickets = [lane.submit(("q", i), lambda i=i: ("un", i), batch=BatchSpec("K", {"v": i}, bad)) for i in range(3)]
    gate.set()
    errs = []
    for t in tickets:
        with pytest.raises(Exception) as ei:
            t.result(time.monotonic() + 10)
        errs.append(ei.value)
    assert len({id(e) for e in errs}) == 1  # the same error object
    if typed:
        assert all(isinstance(e, DeviceExecutionError) for e in errs)
        assert lane.device_failure_count == 1
    else:
        assert errs[0] is raised
        assert lane.device_failure_count == 0
    assert lane.batch_launches == 1
    lane.close()


def test_a_stalled_batched_launch_stalls_every_member():
    """A batched launch is one in-flight unit for the watchdog: when it
    wedges, every member gets the stall verdict."""
    lane = DeviceLane("cpu", stall_timeout_s=0.3)
    lane.batch_window_s = 0.0
    release = threading.Event()

    def wedge(inputs_list):
        release.wait(5)
        raise RuntimeError("returned after the restart")

    gate = _held(lane)
    tickets = [lane.submit(("q", i), lambda i=i: ("un", i), batch=BatchSpec("K", {"v": i}, wedge)) for i in range(3)]
    gate.set()
    for t in tickets:
        with pytest.raises(DeviceExecutionError) as ei:
            t.result(time.monotonic() + 10)
        assert ei.value.stalled
    assert lane.restart_count == 1
    release.set()
    lane.close()
    lane.join()


# ------------------------------------------------------- helpers, kernels
def _trees(seed: int, members: int):
    rng = np.random.default_rng(seed)
    return [{
        "match": [rng.integers(0, 2, (3, 8)).astype(bool)],
        "bounds": [rng.integers(0, 100, (3, 2)).astype(np.int32)],
        "agg_aux": [{"remap": rng.integers(0, 50, (3, 5)).astype(np.int32)}, {}],
        "group_remap": [np.zeros((3, 1), np.int32)],
    } for _ in range(members)]


def test_packing_helpers_equal_the_references():
    trees = _trees(5, 4)
    assert packing.batch_input_signature(trees[0]) == ref_packing.batch_input_signature(trees[0])
    got, want = packing.stack_query_inputs(trees), ref_packing.stack_query_inputs(trees)
    assert packing.batch_input_signature(got) == ref_packing.batch_input_signature(want)
    for a, b in zip(packing._sorted_leaves(got, []), ref_packing.jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    outs = {"num_docs": np.arange(4), "gb_0": (np.arange(12).reshape(4, 3), np.ones((4, 3)))}
    for i in range(4):
        a, b = packing.slice_batched_outputs(outs, i), ref_packing.slice_batched_outputs(outs, i)
        np.testing.assert_array_equal(a["num_docs"], b["num_docs"])
        for x, y in zip(a["gb_0"], b["gb_0"]):
            np.testing.assert_array_equal(x, np.asarray(y))
    # a leaf shape that differs changes the signature (no stacking across it)
    other = _trees(5, 1)[0]
    other["match"] = [np.zeros((3, 16), bool)]
    assert packing.batch_input_signature(other) != packing.batch_input_signature(trees[0])


def _k1_streams(members: int, seed: int = 3, S: int = 3, n: int = 1000, card: int = 12):
    g = torch.Generator().manual_seed(seed)
    f = torch.randint(0, card, (S, n), generator=g, dtype=torch.int32).to(torch.int16)
    return dict(
        filter_fwd=f,
        num_docs=torch.tensor([n, n - 7, n // 2], dtype=torch.int32),
        value_fwds=[None, torch.randint(0, 9, (S, n), generator=g, dtype=torch.int32).to(torch.uint8)],
        value_dicts=[None, torch.rand((S, 9), generator=g, dtype=torch.float64)],
        value_raws=[torch.rand((S, n), generator=g, dtype=torch.float64), None],
        group_cols=[torch.randint(0, 3, (S, n), generator=g, dtype=torch.int32).to(torch.uint8),
                    torch.randint(0, 6, (S, n), generator=g, dtype=torch.int32).to(torch.uint8)],
        group_cards=[3, 5],
        capacity=15,
        dtype=torch.float64,
    ), g


@pytest.mark.parametrize("form", ["bounds", "match"])
def test_batched_plain_k1_equals_one_member_plain_calls(form):
    B = 4
    args, g = _k1_streams(B)
    S, card = 3, 12
    per = torch.randint(0, card, (B, S, 2), generator=g, dtype=torch.int32).sort(dim=-1).values
    match = torch.rand((B, S, card), generator=g) > 0.5
    remap = torch.randint(0, 5, (B, S, 6), generator=g, dtype=torch.int32)
    filt = dict(filter_bounds=per) if form == "bounds" else dict(match=match)
    docs, count, sums = fused_groupby.fused_filtered_groupby_sums_batched(
        args["filter_fwd"], filt.get("match"), args["num_docs"], args["value_fwds"], args["value_dicts"],
        args["capacity"], members=B, dtype=args["dtype"], filter_bounds=filt.get("filter_bounds"),
        value_raws=args["value_raws"], group_cols=args["group_cols"], group_cards=args["group_cards"],
        group_remaps=[None, remap],
    )
    assert docs.shape == (B,) and count.shape == (B, 15) and sums.shape == (B, 2, 15)
    for m in range(B):
        d, c, s = fused_groupby.fused_filtered_groupby_sums(
            args["filter_fwd"], None if form == "bounds" else match[m], args["num_docs"], None,
            args["value_fwds"], args["value_dicts"], args["capacity"], dtype=args["dtype"],
            filter_bounds=per[m] if form == "bounds" else None, value_raws=args["value_raws"],
            group_cols=args["group_cols"], group_cards=args["group_cards"], group_remaps=[None, remap[m]],
        )
        assert int(docs[m]) == int(d)
        assert torch.equal(count[m], c)
        assert torch.equal(sums[m], torch.stack(s))
    # members' answers differ (distinct literals stay distinct)
    assert len({tuple(count[m].tolist()) for m in range(B)}) > 1


def test_batched_k1_contract():
    args, g = _k1_streams(2)
    kw = dict(members=2, dtype=torch.float64, value_raws=args["value_raws"], group_cols=args["group_cols"],
              group_cards=args["group_cards"])
    bad = torch.zeros((3, 3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="members"):
        fused_groupby.fused_filtered_groupby_sums_batched(
            args["filter_fwd"], None, args["num_docs"], args["value_fwds"], args["value_dicts"], 15,
            filter_bounds=bad, **kw)
    # a shared (un-batched) table serves every member alike
    shared = torch.tensor([[0, 6]] * 3, dtype=torch.int32)
    docs, count, _ = fused_groupby.fused_filtered_groupby_sums_batched(
        args["filter_fwd"], None, args["num_docs"], args["value_fwds"], args["value_dicts"], 15,
        filter_bounds=shared, **kw)
    assert torch.equal(count[0], count[1]) and int(docs[0]) == int(docs[1])


@pytest.mark.parametrize("mode", ["counts", "presence", "registers"])
def test_batched_plain_k2_equals_one_member_plain_calls(mode):
    B, S, n, card = 3, 3, 800, 10
    g = torch.Generator().manual_seed(11)
    fwd = torch.randint(0, card, (S, n), generator=g, dtype=torch.int32).to(torch.int16)
    vals = torch.randint(0, 40, (S, n), generator=g, dtype=torch.int32).to(torch.int16)
    gcol = torch.randint(0, 4, (S, n), generator=g, dtype=torch.int32).to(torch.uint8)
    num_docs = torch.tensor([n, n - 3, 100], dtype=torch.int32)
    bounds = torch.randint(0, card, (B, S, 2), generator=g, dtype=torch.int32).sort(dim=-1).values
    kw = dict(filter_fwd=fwd, group_cols=[gcol], group_cards=[4], capacity=4)
    if mode == "registers":
        kw.update(value_table=torch.randint(0, 256, (B, S, 40), generator=g, dtype=torch.int32),
                  rho_table=torch.randint(1, 20, (B, S, 40), generator=g, dtype=torch.int32))
    else:
        kw.update(width=64, value_table=torch.randint(0, 64, (B, S, 40), generator=g, dtype=torch.int32))
    docs, holder = value_state_counts.value_state_batched(mode, num_docs, vals, members=B, filter_bounds=bounds, **kw)
    for m in range(B):
        one = dict(kw, filter_bounds=bounds[m], value_table=kw["value_table"][m])
        if "rho_table" in kw:
            one["rho_table"] = kw["rho_table"][m]
        d, h = value_state_counts.value_state(mode, num_docs, vals, **one)
        assert int(docs[m]) == int(d)
        assert torch.equal(holder[m], h)
    with pytest.raises(ValueError):
        value_state_counts.value_state_batched(mode, num_docs, vals, members=B + 1, filter_bounds=bounds, **kw)
