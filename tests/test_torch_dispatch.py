"""The port's device lane and the executor's self-healing ladder, on
``device="cpu"``: coalescing, the deadline shed, error classification
(synthetic CUDA texts), the watchdog's stall restart, and every fault
injector mode ending in an answer equal to the JAX package's (client
payloads ``payloads_equivalent`` at rel 1e-9 / abs 2e-5).  A fixture
checks after every test that no closed lane and no shut-down scheduler
left a thread alive.
"""
import sys
import threading
import time

import pytest
import torch

from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.common.faults import DeviceFaultInjector
from pinot_tpu_torch.engine import device as device_mod
from pinot_tpu_torch.engine import config as config_mod
from pinot_tpu_torch.engine import executor as executor_mod
from pinot_tpu_torch.engine import kernels
from pinot_tpu_torch.engine.dispatch import (
    DeviceExecutionError,
    DeviceLane,
    LaneClosedError,
    classify_device_error,
    is_device_fault,
    leaked_lane_threads,
)
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.server.scheduler import QueryAbandonedError, QueryScheduler, leaked_scheduler_threads

REL, ABS = 1e-9, 2e-5
ROWS = random_rows(make_test_schema(with_mv=False), 900, seed=13)
SEGMENTS = [
    ref_build_segment(make_test_schema(with_mv=False), ROWS[i * 300 : (i + 1) * 300], "testTable", f"d{i}")
    for i in range(3)
]
PORT = [segment_from_arrays(**segment_arrays_of(s)) for s in SEGMENTS]
QUERY = "SELECT sum(metInt), count(*) FROM testTable WHERE dimInt > 1000 GROUP BY dimStr TOP 10"
REF = RefExecutor()


@pytest.fixture(autouse=True)
def no_leaked_threads():
    yield
    assert leaked_lane_threads() == []
    assert leaked_scheduler_threads() == []


def _reference(pql):
    req = ref_optimize(ref_parse(pql))
    return canonical_payload(req, REF.execute(SEGMENTS, req))


def _payload(pql, res):
    return strip_accounting(reduce_to_response(optimize_request(parse_pql(pql)), [res]).to_json())


def _wait_inflight(lane, timeout=5.0):
    end = time.monotonic() + timeout
    while lane._inflight is None:
        assert time.monotonic() < end, "the launch never started"
        time.sleep(0.001)


# ---------------------------------------------------------------- the lane
def test_identical_submits_while_the_first_is_held_launch_once():
    lane = DeviceLane("cpu", stall_timeout_s=0)
    release = threading.Event()
    launches = []

    def launch():
        launches.append(1)
        release.wait(5)
        return "outs"

    first = lane.submit("k", launch)
    _wait_inflight(lane)
    rest = [lane.submit("k", launch) for _ in range(7)]
    release.set()
    assert [t.result(time.monotonic() + 5) for t in [first] + rest] == ["outs"] * 8
    assert len(launches) == 1
    assert lane.stats()["dispatches"] == 1 and lane.stats()["coalesceHits"] == 7
    assert not first.coalesced and all(t.coalesced for t in rest)
    # finished outputs are never handed out anew (a CPU launch is never pending)
    again = lane.submit("k", launch)
    assert again.result(time.monotonic() + 5) == "outs" and len(launches) == 2
    lane.close()


def test_a_waiter_past_its_deadline_is_shed_at_dequeue():
    lane = DeviceLane("cpu", stall_timeout_s=0)
    release = threading.Event()
    ran = []
    held = lane.submit("held", lambda: release.wait(5))
    _wait_inflight(lane)
    late = lane.submit("late", lambda: ran.append(1), deadline=time.monotonic() + 0.05)
    time.sleep(0.1)
    release.set()
    assert held.result(time.monotonic() + 5) is True
    with pytest.raises(QueryAbandonedError):
        late.result(time.monotonic() + 5)
    assert ran == [] and lane.stats()["shed"] == 1
    lane.close()
    with pytest.raises(LaneClosedError):
        lane.submit("after", lambda: None)


@pytest.mark.parametrize(
    "exc, kind",
    [
        (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), "oom"),
        (RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB (GPU 0; 79.11 GiB total)"), "oom"),
        (RuntimeError("CUDA error: an illegal memory access was encountered"), "sticky"),
        (RuntimeError("CUDA error: unspecified launch failure"), "sticky"),
        (RuntimeError("CUDA error: device-side assert triggered"), "sticky"),
        (RuntimeError("CUDA error: misaligned address"), "sticky"),
        (RuntimeError("CUDA error: an illegal instruction was encountered"), "sticky"),
        (TypeError("unsupported operand type(s)"), "poison"),
        (RuntimeError("fused_groupby launch failed with code 1"), "poison"),
    ],
)
def test_classify_device_error(exc, kind):
    err = classify_device_error(exc)
    assert isinstance(err, DeviceExecutionError) and err.cause is exc
    assert classify_device_error(err) is err
    assert err.sticky == (kind == "sticky")
    assert err.resource_exhausted == (kind == "oom")
    assert err.retryable == (kind == "oom")


@pytest.mark.parametrize(
    "exc, fault",
    [
        (DeviceExecutionError("injected", retryable=True), True),
        (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
        (RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"), True),
        (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
        (RuntimeError("CUDA error: device-side assert triggered"), True),
        (RuntimeError("nvcc failed for fused_groupby:\nerror: expected a ';'"), False),
        (RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is"), False),
        (RuntimeError("fused_groupby launch failed with code 1"), False),
        (ValueError("tier 'smem' does not take this shape"), False),
        (TypeError("unsupported operand type(s)"), False),
    ],
)
def test_only_device_faults_reach_the_heal_ladder(exc, fault):
    assert is_device_fault(exc) == fault


def test_a_program_error_in_a_launch_is_delivered_as_raised():
    lane = DeviceLane("cpu", stall_timeout_s=0)

    def boom():
        raise ValueError("tier 'smem' does not take this shape")

    with pytest.raises(ValueError):
        lane.submit("a", boom).result(time.monotonic() + 5)
    assert lane.dead is None and lane.stats()["deviceFailures"] == 0
    assert lane.submit("b", lambda: "ok").result(time.monotonic() + 5) == "ok"
    lane.close()


def test_a_stalled_launch_restarts_the_lane():
    lane = DeviceLane("cpu", stall_timeout_s=0.2)
    wedged = lane.submit("slow", lambda: time.sleep(0.8) or "late")
    with pytest.raises(DeviceExecutionError) as e:
        wedged.result(time.monotonic() + 5)
    assert e.value.stalled and not e.value.retryable
    assert lane.restart_count == 1
    # the fresh lane thread serves the next launch while the wedged one sleeps
    assert lane.submit("next", lambda: "ok").result(time.monotonic() + 5) == "ok"
    time.sleep(0.9)
    assert lane.stats()["staleCompletions"] == 1
    lane.close()


def test_a_sticky_launch_takes_the_lane_off_the_device():
    lane = DeviceLane("cpu", stall_timeout_s=0)

    def boom():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(DeviceExecutionError) as e:
        lane.submit("a", boom).result(time.monotonic() + 5)
    assert e.value.sticky and lane.dead is e.value
    ran = []
    with pytest.raises(DeviceExecutionError):
        lane.submit("b", lambda: ran.append(1)).result(time.monotonic() + 5)
    assert ran == [] and lane.stats()["dispatches"] == 1
    lane.close()


def test_scheduler_shutdown_drains_its_workers():
    sched = QueryScheduler(num_workers=3, max_pending=4)
    assert sched.run(lambda: 7, timeout_s=5) == 7
    sched.shutdown()


# ---------------------------------------------- the executor's heal ladder
@pytest.fixture
def healing():
    inj = DeviceFaultInjector()
    lane = DeviceLane("cpu", stall_timeout_s=0.3, fault_injector=inj)
    ex = QueryExecutor(device="cpu", lane=lane)
    yield ex, lane, inj
    lane.close()


def _run(ex, pql=QUERY):
    res = ex.execute(PORT, optimize_request(parse_pql(pql)), deadline=time.monotonic() + 30)
    got = _payload(pql, res)
    assert payloads_equivalent(got, _reference(pql), rel_tol=REL, abs_tol=ABS), (got, pql)
    return res


def _heal(ex):
    return ex.healing_stats()


def test_a_transient_is_retried_once_on_the_device(healing):
    ex, lane, inj = healing
    inj.fail_next(1, retryable=True)
    res = _run(ex)
    assert res._served_tier == "device" and not res.cost.get("segmentsHost")
    assert _heal(ex)["deviceRetries"] == 1 and _heal(ex)["hostFailovers"] == 0
    assert [r.outcome for r in inj.launches] == ["fail_next", "ok"]


def test_a_hard_failure_fails_over_and_quarantines_the_plan(healing):
    ex, lane, inj = healing
    inj.fail_next(1, retryable=False)
    res = _run(ex)
    assert res._served_tier == "host" and res.cost["segmentsHost"] == 3
    assert _heal(ex)["deviceRetries"] == 0 and _heal(ex)["hostFailovers"] == 1
    assert _heal(ex)["poisonedPlans"] == 1
    n = len(inj.launches)
    res = _run(ex)  # quarantined: the device is skipped
    assert res._served_tier == "host" and len(inj.launches) == n
    assert _heal(ex)["poisonSkips"] == 1
    ex.clear_poisoned()
    assert _run(ex)._served_tier == "device"


def test_a_poisoned_plan_is_served_by_the_host(healing):
    ex, lane, inj = healing
    _run(ex)
    inj.poison_plan(inj.launches[-1].digest)
    res = _run(ex)
    assert res._served_tier == "host" and res.cost["segmentsHost"] > 0
    assert _heal(ex)["hostFailovers"] == 1 and inj.launches[-1].outcome == "poison"


def test_an_allocation_failure_retries_once_and_never_poisons(healing):
    # each allocation failure is retried once more on the device, after a
    # demotion round: two in a row are healed too (the reference's three
    # attempts), a third fails over
    ex, lane, inj = healing
    inj.alloc_fail_next(1)
    assert _run(ex)._served_tier == "device"
    assert _heal(ex)["resourceExhausted"] == 1 and _heal(ex)["deviceRetries"] == 1
    inj.alloc_fail_next(2)
    assert _run(ex)._served_tier == "device"
    assert _heal(ex)["resourceExhausted"] == 3 and _heal(ex)["deviceRetries"] == 3
    inj.alloc_fail_next(3)
    res = _run(ex)
    assert res._served_tier == "host" and res.cost["segmentsHost"] > 0
    assert _heal(ex)["hostFailovers"] == 1 and _heal(ex)["poisonedPlans"] == 0


def test_a_stall_goes_straight_to_the_host(healing):
    ex, lane, inj = healing
    inj.stall_next(1, 1.0)
    res = _run(ex)
    assert res._served_tier == "host" and res.cost["segmentsHost"] > 0
    assert lane.restart_count == 1 and _heal(ex)["deviceRetries"] == 0
    assert _heal(ex)["hostFailovers"] == 1
    time.sleep(0.8)  # let the wedged thread return before the leak check


def test_a_sticky_fault_is_never_retried_on_the_device(healing):
    ex, lane, inj = healing
    inj.sticky_fail_next(1)
    res = _run(ex)
    assert res._served_tier == "host" and res.cost["segmentsHost"] > 0
    assert _heal(ex)["deviceRetries"] == 0 and _heal(ex)["stickyFaults"] == 1
    assert lane.dead is not None and _heal(ex)["deviceOff"]
    n = len(inj.launches)
    res = _run(ex, "SELECT count(*) FROM testTable WHERE dimStr <> 'x'")
    assert res._served_tier == "host" and len(inj.launches) == n


def test_a_sticky_fault_found_by_the_fetch_stops_the_lane(healing, monkeypatch):
    ex, lane, inj = healing
    real = ex._kernel.fetch

    def fetch(handle, deadline=None):
        monkeypatch.setattr(ex._kernel, "fetch", real)
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(ex._kernel, "fetch", fetch)
    assert _run(ex)._served_tier == "host"
    assert lane.dead is not None and lane.dead.sticky


@pytest.fixture
def coalescing():
    """The heal ladder's executor with the watchdog far above the test's
    0.15 s held launch: on a loaded host the held launch plus the plain
    kernel's own run passed the 0.3 s watchdog of ``healing`` now and
    then, the lane failed every attached waiter as a stall, they failed
    over to the host tier, and their results carried no coalesceHits."""
    inj = DeviceFaultInjector()
    lane = DeviceLane("cpu", stall_timeout_s=30.0, fault_injector=inj)
    ex = QueryExecutor(device="cpu", lane=lane)
    yield ex, lane, inj
    lane.close()


def test_concurrent_identical_queries_coalesce_and_stage_once(coalescing, monkeypatch):
    ex, lane, inj = coalescing
    staged = []
    real_stage = device_mod.stage_segments

    def counting_stage(*a, **k):
        staged.append(1)
        time.sleep(0.05)  # widen the window a second stager would race into
        return real_stage(*a, **k)

    monkeypatch.setattr(device_mod, "stage_segments", counting_stage)
    inj.stall_next(1, 0.15)  # hold the first launch so the others attach to it
    req = optimize_request(parse_pql(QUERY))
    out = [None] * 8

    def worker(i):
        out[i] = ex.execute(PORT, req, deadline=time.monotonic() + 30)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    payloads = [_payload(QUERY, r) for r in out]
    assert all(p == payloads[0] for p in payloads)
    assert lane.stats()["coalesceHits"] > 0
    assert sum(r.cost.get("coalesceHits", 0) for r in out) == lane.stats()["coalesceHits"]
    assert staged == [1]


def test_concurrent_distinct_queries_each_equal_their_reference(healing):
    ex, lane, inj = healing
    pqls = [f"SELECT sum(metInt), count(*) FROM testTable WHERE dimInt <= {v} GROUP BY dimStr TOP 10"
            for v in (100, 500, 1000, 2000, 3000, 5000, 8000, 100000)]
    out = {}

    def worker(pql):
        out[pql] = ex.execute(PORT, optimize_request(parse_pql(pql)), deadline=time.monotonic() + 30)

    threads = [threading.Thread(target=worker, args=(p,)) for p in pqls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    for pql in pqls:
        got = _payload(pql, out[pql])
        assert payloads_equivalent(got, _reference(pql), rel_tol=REL, abs_tol=ABS), pql


# ------------------------------- program errors are never healed by the host
def _failing_build(names):
    raise RuntimeError("nvcc failed for " + ", ".join(f"{n}:\nerror: expected a ';'" for n in names))


def _load_k1(*args, **kwargs):
    kernels.load("fused_groupby")  # the build is planted to fail
    raise AssertionError("the planted build did not fail")


def _launch_error(*args, **kwargs):
    raise RuntimeError("fused_groupby launch failed with code 1")


def _shape_error(*args, **kwargs):
    raise ValueError("tier 'smem' does not take this shape")


@pytest.mark.parametrize("planted", [_load_k1, _launch_error, _shape_error])
@pytest.mark.parametrize("with_lane", [True, False])
def test_a_kernel_error_raises_and_is_never_served_by_the_host(planted, with_lane, monkeypatch):
    monkeypatch.setattr(kernels, "build", _failing_build)
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(executor_mod, "run_table_kernel", planted)
    lane = DeviceLane("cpu", stall_timeout_s=0.3) if with_lane else None
    ex = QueryExecutor(device="cpu", lane=lane)
    try:
        with pytest.raises((RuntimeError, ValueError)) as e:
            ex.execute(PORT, optimize_request(parse_pql(QUERY)), deadline=time.monotonic() + 30)
        assert not isinstance(e.value, DeviceExecutionError)
        heal = ex.healing_stats()
        assert heal["deviceFailures"] == heal["hostFailovers"] == heal["deviceRetries"] == 0, heal
        assert ex.metrics.timer("phase.hostFailover").count == 0
    finally:
        if lane is not None:
            lane.close()


def test_a_failed_kernel_build_raises_where_the_server_is_made(monkeypatch):
    monkeypatch.setattr(kernels, "build", _failing_build)
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(config_mod, "resolve_device", lambda device=None: torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="nvcc failed for fused_groupby"):
        QueryExecutor(device="cuda")
    with pytest.raises(RuntimeError, match="nvcc failed for fused_groupby"):
        ServerInstance("nobuild", device="cuda")
