"""The utilization plane in the port: the static plan cost, the lane's
occupancy and its sampler, the ``torch.profiler`` capture, the card's
declared peaks, the per-plan statistics with their roofline, the
server's ``device`` section and the controller's roll-ups.

The reference's ``tests/test_device_util.py`` cases that this plane
ports, on the port (``device="cpu"``), and beside them differentials
against the JAX package: ``roofline_fractions`` on the same inputs, and
the plan statistics of a seeded query mix through both clusters, whose
digests, counts and tier mixes must be equal on the servers'
``/debug/plans``, the brokers' ``/debug/workload`` and the controllers'
``collect_workload``.  On the CPU no peak is declared, so every roofline
fraction is None unless a test declares peaks through the environment.
"""
import itertools
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pinot_tpu.controller.controller import collect_workload as ref_collect_workload
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.cluster_harness import InProcessCluster as RefCluster
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.tools.query_gen import QueryGenerator
from pinot_tpu.utils.platform import roofline_fractions as ref_roofline_fractions

import pinot_tpu_torch.engine.dispatch as dispatch_mod
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.controller.controller import ControllerHttpServer, collect_utilization, collect_workload
from pinot_tpu_torch.controller.resource_manager import InstanceState
from pinot_tpu_torch.engine.dispatch import OccupancySampler
from pinot_tpu_torch.engine.packing import kernel_cost_analysis
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.server.network_starter import ServerAdminHttpServer
from pinot_tpu_torch.server.profiler import DeviceProfiler, ProfilerUnavailableError
from pinot_tpu_torch.tools.cluster_harness import InProcessCluster, single_server_broker
from pinot_tpu_torch.utils.platform import platform_peaks, roofline_fractions

REF_SCHEMA = make_test_schema(with_mv=False)
SCHEMA = Schema.from_json(REF_SCHEMA.to_json())
_SEQ = itertools.count()


def _mk_broker(pipeline=True, rows_n=1200, table="utilTable"):
    n = next(_SEQ)
    rows = random_rows(REF_SCHEMA, rows_n, seed=23)
    half = rows_n // 2
    segs = [build_segment(SCHEMA, rows[:half], table, f"du{n}a"),
            build_segment(SCHEMA, rows[half:], table, f"du{n}b")]
    return single_server_broker(table, segs, pipeline=pipeline, device="cpu")


@pytest.fixture()
def util_broker():
    broker = _mk_broker()
    yield broker
    broker.shutdown()
    broker.local_servers[0].shutdown()


def _wait_cost_analysis(server, digest, timeout_s=15.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        ci = server.lane.compile_info(digest)
        if ci is not None and "costAnalysis" in ci:
            return ci
        time.sleep(0.02)
    raise AssertionError(f"no cost analysis for {digest}")


# --------------------------------------------------- static plan cost
def test_kernel_cost_analysis_counts_the_launch_and_never_raises(monkeypatch):
    t = torch.zeros((2, 8), dtype=torch.int32)
    q = {"lo": np.zeros(3, dtype=np.int64), "k": 7, "none": None}
    out = kernel_cost_analysis(([t], q), 16, rows=16, ops_per_row=3)
    assert out == {"flops": 48.0, "bytesAccessed": float(2 * 8 * 4 + 3 * 8 + 16), "source": "static"}
    # every gap is None, never an exception
    assert kernel_cost_analysis(([t], q), "junk", rows=16, ops_per_row=3) is None
    assert kernel_cost_analysis([], 0, rows=16, ops_per_row=3) is None
    assert kernel_cost_analysis(([t], q), 0, rows="x", ops_per_row=3) is None
    monkeypatch.setenv("PINOT_TPU_COST_ANALYSIS", "off")
    assert kernel_cost_analysis(([t], q), 16, rows=16, ops_per_row=3) is None


def test_explain_compile_block_carries_cost_analysis(util_broker):
    """EXPLAIN's compile block: "unavailable" before the digest's first
    launch, then the lane's static cost as a dict; its bytes cover at
    least the resident arrays the launch read (the cost vector's
    ``deviceBytes``)."""
    broker, server = util_broker, util_broker.local_servers[0]
    pql = "SELECT sum(metInt) FROM utilTable WHERE dimInt > 40 GROUP BY dimStr TOP 5"
    dev = broker.handle_pql("EXPLAIN " + pql).explain["servers"][0]["device"]
    assert dev["compile"] == {"state": "cold", "costAnalysis": "unavailable"}
    resp = broker.handle_pql(pql)
    assert not resp.exceptions
    _wait_cost_analysis(server, dev["planDigest"])
    ca = broker.handle_pql("EXPLAIN " + pql).explain["servers"][0]["device"]["compile"]["costAnalysis"]
    assert isinstance(ca, dict) and ca["source"] == "static"
    assert ca["bytesAccessed"] > resp.cost["deviceBytes"] > 0 and ca["flops"] > 0
    assert server.metrics.meter("compile.costAnalyses").count >= 1


def test_cost_analysis_off_reads_unavailable(util_broker, monkeypatch):
    monkeypatch.setenv("PINOT_TPU_COST_ANALYSIS", "off")
    broker, server = util_broker, util_broker.local_servers[0]
    pql = "SELECT max(metFloat) FROM utilTable WHERE dimInt > 20 GROUP BY dimStr TOP 3"
    assert not broker.handle_pql(pql).exceptions
    digest = broker.handle_pql("EXPLAIN " + pql).explain["servers"][0]["device"]["planDigest"]
    assert _wait_cost_analysis(server, digest)["costAnalysis"] is None
    comp = broker.handle_pql("EXPLAIN " + pql).explain["servers"][0]["device"]["compile"]
    assert comp["costAnalysis"] == "unavailable" and comp["state"] == "warm"
    assert server.metrics.meter("compile.costAnalysisUnavailable").count >= 1


# ----------------------------------------------------------- occupancy
def test_occupancy_idle_reads_zero_then_busy_positive(util_broker):
    broker, server = util_broker, util_broker.local_servers[0]
    gauges = server.metrics.snapshot()["gauges"]
    assert gauges["device.util.busyFraction"] == 0.0
    assert gauges["device.util.avgQueueDepth"] == 0.0
    for _ in range(3):
        assert not broker.handle_pql("SELECT sum(metInt) FROM utilTable WHERE dimInt > 10").exceptions
    occ = server.lane.occupancy_read("test-busy")
    assert 0.0 < occ["busyFraction"] <= 1.0
    assert occ["depth"] == 0 and occ["inflight"] == 0
    time.sleep(0.05)
    assert server.lane.occupancy_read("test-busy")["busyFraction"] == 0.0


def test_occupancy_zero_allocations_without_sampler(util_broker):
    broker = util_broker
    broker.handle_pql("SELECT count(*) FROM utilTable")
    before = dispatch_mod.OCCUPANCY_ALLOCATIONS
    for _ in range(5):
        assert not broker.handle_pql("SELECT count(*) FROM utilTable").exceptions
    assert dispatch_mod.OCCUPANCY_ALLOCATIONS == before


def test_serial_server_has_no_lane_occupancy():
    broker = _mk_broker(pipeline=False, rows_n=600)
    server = broker.local_servers[0]
    try:
        assert server.lane is None and server.occupancy_sampler is None
        assert server.metrics.snapshot()["gauges"]["device.util.busyFraction"] == 0
        dev = server.device_utilization()
        assert dev["occupancy"] is None and "sampler" not in dev
    finally:
        broker.shutdown()
        server.shutdown()


def test_occupancy_sampler_lifecycle(util_broker):
    server = util_broker.local_servers[0]
    sampler = OccupancySampler(server.lane, interval_s=0.03)
    assert not sampler.running
    sampler.stop()  # before a start: no-op
    sampler.start()
    sampler.start()  # idempotent
    assert sampler.running
    deadline = time.time() + 5
    while sampler.samples_taken < 3 and time.time() < deadline:
        time.sleep(0.02)
    sampler.stop()
    assert not sampler.running
    taken = sampler.samples_taken
    assert taken >= 3
    snap = sampler.snapshot()
    assert snap["samplesTaken"] == taken and not snap["running"]
    for s in snap["samples"]:
        assert {"ts", "busyFraction", "avgQueueDepth", "depth"} == set(s)
        assert s["busyFraction"] == 0.0  # idle throughout
    time.sleep(0.1)
    assert sampler.samples_taken == taken
    sampler.start()
    assert sampler.running
    sampler.stop()


def test_occupancy_sampler_refuses_closed_lane():
    broker = _mk_broker(rows_n=400)
    server = broker.local_servers[0]
    sampler = OccupancySampler(server.lane, interval_s=0.03)
    broker.shutdown()
    server.shutdown()
    sampler.start()
    assert not sampler.running


# ------------------------------------------------------------ profiler
class _FakeTrace:
    def __init__(self, fail_start=False):
        self.starts = []
        self.stops = 0
        self.fail_start = fail_start

    def start(self, d):
        if self.fail_start:
            raise RuntimeError("backend says no")
        self.starts.append(d)

    def stop(self):
        self.stops += 1

    @property
    def api(self):
        return (self.start, self.stop)


def test_profiler_refcount_shares_one_capture(tmp_path):
    fake = _FakeTrace()
    prof = DeviceProfiler(base_dir=str(tmp_path), trace_api=fake.api)
    s1 = prof.start()
    s2 = prof.start()
    assert len(fake.starts) == 1
    assert s1["active"] and s2["refCount"] == 2 and s2["dir"] == s1["dir"]
    mid = prof.stop()
    assert mid["active"] and mid["refCount"] == 1 and fake.stops == 0
    done = prof.stop()
    assert not done["active"] and fake.stops == 1
    again = prof.stop()
    assert not again["active"] and again["refCount"] == 0 and fake.stops == 1
    prof.start()
    assert len(fake.starts) == 2
    prof.shutdown()
    assert fake.stops == 2


def test_profiler_auto_stop_force_stops_despite_refcount(tmp_path):
    fake = _FakeTrace()
    prof = DeviceProfiler(base_dir=str(tmp_path), trace_api=fake.api)
    prof.start(timeout_s=0.15)
    prof.start(timeout_s=0.15)
    deadline = time.time() + 5
    while prof.snapshot()["active"] and time.time() < deadline:
        time.sleep(0.02)
    snap = prof.snapshot()
    assert not snap["active"] and snap["refCount"] == 0
    assert snap["autoStops"] == 1 and fake.stops == 1


def test_profiler_bounded_captures_and_unavailable(tmp_path):
    fake = _FakeTrace()
    prof = DeviceProfiler(base_dir=str(tmp_path), trace_api=fake.api, max_captures=2)
    for _ in range(4):
        prof.start()
        prof.stop()
    assert len(prof.snapshot()["captures"]) <= 2
    broken = DeviceProfiler(base_dir=str(tmp_path / "b"), trace_api=_FakeTrace(fail_start=True).api)
    with pytest.raises(ProfilerUnavailableError):
        broken.start()
    assert not broken.snapshot()["active"]


def test_torch_profiler_capture_around_queries(util_broker, tmp_path):
    """The default capture is ``torch.profiler``, started on this thread
    while the lane thread launches: its directory holds the Chrome trace
    and the device-kernel summary (empty on the CPU, which has no CUDA
    activity), and the snapshot carries the summary."""
    broker, server = util_broker, util_broker.local_servers[0]
    server.profiler = DeviceProfiler(base_dir=str(tmp_path), metrics=server.metrics)
    server.profiler.on_capture_end = server._stop_samplers
    snap = server.profile_start(timeout_s=30)
    assert snap["active"] and server.occupancy_sampler.running
    for _ in range(3):
        assert not broker.handle_pql("SELECT sum(metInt) FROM utilTable GROUP BY dimStr TOP 3").exceptions
    done = server.profile_stop()
    assert not done["active"]
    last = done["lastCapture"]
    assert set(os.listdir(last["dir"])) == {"trace.json", "kernels.json"}
    with open(os.path.join(last["dir"], "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    assert last["kernels"] == {}  # no CUDA activity on the CPU
    deadline = time.time() + 5
    while server.occupancy_sampler.running and time.time() < deadline:
        time.sleep(0.02)
    assert not server.occupancy_sampler.running


def test_profiler_endpoints_and_sampler_bracket(util_broker, tmp_path):
    server = util_broker.local_servers[0]
    fake = _FakeTrace()
    server.profiler = DeviceProfiler(base_dir=str(tmp_path), trace_api=fake.api)
    server.profiler.on_capture_end = server.occupancy_sampler.stop
    admin = ServerAdminHttpServer(server)
    admin.start()

    def post(path, body=b"{}"):
        req = urllib.request.Request(admin.url + path, data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(path):
        with urllib.request.urlopen(admin.url + path, timeout=10) as r:
            return json.loads(r.read())

    try:
        code, snap = post("/debug/profile/start")
        assert code == 200 and snap["active"] and snap["refCount"] == 1
        assert server.occupancy_sampler.running
        assert get("/debug/profile")["active"]
        dev = get("/debug/device")
        assert dev["profiler"]["active"] and dev["sampler"]["running"]
        code, snap = post("/debug/profile/stop")
        assert code == 200 and not snap["active"]
        deadline = time.time() + 5
        while server.occupancy_sampler.running and time.time() < deadline:
            time.sleep(0.02)
        assert not server.occupancy_sampler.running
        assert post("/debug/profile/start", body=b"{nope")[0] == 400
        server.profiler._trace_api = _FakeTrace(fail_start=True).api
        code, err = post("/debug/profile/start")
        assert code == 404 and err["errorType"] == "ProfilerUnavailableError"
        assert get("/debug/prewarm") == server.prewarm.state()
        assert post("/debug/nope")[0] == 404
    finally:
        admin.stop()


# ----------------------------------------------------- platform peaks
def test_platform_peaks_unknown_cpu_and_env_override(monkeypatch):
    out = platform_peaks(refresh=True)
    assert out["peakFlopsPerSec"] is None and out["peakBytesPerSec"] is None
    assert out["platform"] == "cpu" and out["source"] == "unknown"
    monkeypatch.setenv("PINOT_TPU_PEAK_FLOPS", "2e12")
    monkeypatch.setenv("PINOT_TPU_PEAK_HBM_BPS", "8e11")
    env_out = platform_peaks(refresh=True)
    assert env_out["source"] == "env"
    assert env_out["peakFlopsPerSec"] == 2e12 and env_out["peakBytesPerSec"] == 8e11
    monkeypatch.setenv("PINOT_TPU_PEAK_FLOPS", "banana")
    assert platform_peaks(refresh=True)["peakFlopsPerSec"] != "banana"
    monkeypatch.delenv("PINOT_TPU_PEAK_FLOPS")
    monkeypatch.delenv("PINOT_TPU_PEAK_HBM_BPS")
    platform_peaks(refresh=True)  # restore the cached no-env state


@pytest.mark.parametrize("name,peaks", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (756e12, 2.0e12)),
    ("NVIDIA H100 NVL", (835e12, 3.9e12)),
    ("NVIDIA A100-SXM4-80GB", (None, None)),
])
def test_platform_peaks_by_card_name(monkeypatch, name, peaks):
    """The peaks keyed on ``torch.cuda.get_device_name()`` (an injected
    name here), and never a CUDA init: before CUDA is initialized the
    source reads "uninitialized"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: pytest.fail("initialized CUDA"))
    try:
        assert platform_peaks(refresh=True)["source"] == "uninitialized"
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
        out = platform_peaks(refresh=True)
        assert (out["peakFlopsPerSec"], out["peakBytesPerSec"]) == peaks
        assert out["platform"] == "cuda" and out["deviceKind"] == name.lower()
        assert out["source"] == ("unknown" if peaks[0] is None else "declared")
    finally:
        monkeypatch.undo()
        platform_peaks(refresh=True)


@pytest.mark.parametrize("bps,fps,peaks", [
    (1.2e12, None, {"peakBytesPerSec": 3.35e12, "peakFlopsPerSec": 989e12}),
    (1.2e12, 5e14, {"peakBytesPerSec": 3.35e12, "peakFlopsPerSec": 989e12}),
    (0.0, 5e14, {"peakBytesPerSec": 3.35e12, "peakFlopsPerSec": 989e12}),
    (2e9, 1e9, {"peakBytesPerSec": None, "peakFlopsPerSec": None}),
    (2e9, 1e9, {"peakBytesPerSec": 8e11, "peakFlopsPerSec": None}),
])
def test_roofline_fractions_equal_the_reference(bps, fps, peaks):
    assert roofline_fractions(bps, fps, peaks=peaks) == ref_roofline_fractions(bps, fps, peaks=peaks)


# ------------------------------------------------- roofline consistency
def test_plan_roofline_consistent_with_phase_timers(util_broker):
    """``/debug/plans``' roofline reads the SAME wall time the cost
    vector reports: achieved bytes/s == the summed deviceBytes over the
    summed per-response deviceMs."""
    broker, server = util_broker, util_broker.local_servers[0]
    pql = "SELECT sum(metInt) FROM utilTable WHERE dimInt > 20"
    want_ms, want_bytes = 0.0, 0
    for _ in range(4):
        resp = broker.handle_pql(pql)
        assert not resp.exceptions
        want_ms += float(resp.cost["deviceMs"])
        want_bytes += int(resp.cost["deviceBytes"])
    assert want_ms > 0 and want_bytes > 0
    [plan] = [p for p in server.plan_stats.snapshot(top=10)["plans"] if p["count"] == 4]
    roof = plan["roofline"]
    assert roof["deviceMs"] == pytest.approx(want_ms, abs=0.01)
    assert roof["deviceBytes"] == want_bytes
    assert roof["achievedBytesPerSec"] == pytest.approx(want_bytes * 1000.0 / roof["deviceMs"], rel=1e-6)
    assert roof["rooflineFraction"] is None  # no declared peak on the CPU
    assert plan["tierLatencyMs"]["device"]["samples"] == 4
    assert plan["tierLatencyMs"]["host"]["samples"] == 0
    recent = server.device_utilization()["recent"]
    assert recent["queries"] >= 4 and recent["deviceBytes"] >= want_bytes


def test_roofline_fractions_against_declared_peaks(monkeypatch, util_broker):
    monkeypatch.setenv("PINOT_TPU_PEAK_FLOPS", "1e15")
    monkeypatch.setenv("PINOT_TPU_PEAK_HBM_BPS", "1e12")
    broker, server = util_broker, util_broker.local_servers[0]
    pql = "SELECT sum(metFloat) FROM utilTable WHERE dimInt > 30 GROUP BY dimStr TOP 3"
    assert not broker.handle_pql(pql).exceptions
    digest = broker.handle_pql("EXPLAIN " + pql).explain["servers"][0]["device"]["planDigest"]
    _wait_cost_analysis(server, digest)
    assert not broker.handle_pql(pql).exceptions
    [plan] = server.plan_stats.snapshot(top=10)["plans"]
    roof = plan["roofline"]
    assert roof["bandwidthFraction"] == pytest.approx(roof["achievedBytesPerSec"] / 1e12, abs=1e-6)
    assert roof["staticFlopsPerExec"] > 0 and "flopsFraction" in roof
    assert roof["rooflineFraction"] == pytest.approx(max(roof["bandwidthFraction"], roof["flopsFraction"]),
                                                     abs=1e-6)
    assert server.device_utilization()["recent"]["rooflineFraction"] is not None


def test_host_path_latency_attributed_per_digest(util_broker):
    broker, server = util_broker, util_broker.local_servers[0]
    host_pql = "SELECT avg(metFloat) FROM utilTable WHERE dimStr = 'a'"
    dev_pql = "SELECT sum(metInt) FROM utilTable WHERE dimInt > 40"
    for _ in range(2):
        assert not broker.handle_pql(host_pql).exceptions
        assert not broker.handle_pql(dev_pql).exceptions
    by_summary = {p["summary"]: p for p in server.plan_stats.snapshot(top=10)["plans"]}
    host_plan = next(p for s, p in by_summary.items() if "dimStr:EQUALITY" in s)
    dev_plan = next(p for s, p in by_summary.items() if "dimInt:RANGE" in s)
    assert host_plan["tierLatencyMs"]["host"]["samples"] == 2 and host_plan["tierLatencyMs"]["host"]["p95Ms"] > 0
    assert host_plan["tierLatencyMs"]["device"]["samples"] == 0 and host_plan["roofline"] is None
    assert dev_plan["tierLatencyMs"]["device"]["samples"] == 2 and dev_plan["tierLatencyMs"]["host"]["samples"] == 0
    assert dev_plan["roofline"] is not None


def test_status_device_section(util_broker):
    server = util_broker.local_servers[0]
    assert not util_broker.handle_pql("SELECT count(*) FROM utilTable GROUP BY dimStr TOP 2").exceptions
    st = server.status()
    dev = st["device"]
    assert {"device", "platform", "occupancy", "transfers", "recent", "profiler"} <= set(dev)
    assert dev["device"] == "cpu" and dev["occupancy"]["busyFraction"] >= 0.0 and not dev["profiler"]["active"]
    assert dev["transfers"] == server.executor.transfers.snapshot()
    assert st["plans"]["digests"] == 1 and st["ready"] and not st["warming"]
    gauges = server.metrics.snapshot()["gauges"]
    for name in ("device.util.busyFraction", "device.util.avgQueueDepth", "device.util.h2dBytes",
                 "device.util.d2hBytes", "device.util.achievedBytesPerSec", "device.util.achievedFlopsPerSec",
                 "device.util.rooflineFraction", "profile.active", "plan.digests", "server.warming"):
        assert name in gauges, name
    assert gauges["plan.digests"] == 1


def test_plain_explain_is_not_recorded(util_broker):
    broker, server = util_broker, util_broker.local_servers[0]
    broker.handle_pql("EXPLAIN SELECT count(*) FROM utilTable")
    assert server.plan_stats.digest_count() == 0 and broker.planstats.digest_count() == 0
    assert not broker.handle_pql("EXPLAIN ANALYZE SELECT count(*) FROM utilTable").exceptions
    assert server.plan_stats.digest_count() == 1 and broker.planstats.digest_count() == 1


# ------------------------------------------------- controller roll-ups
def test_controller_utilization_rollup(tmp_path):
    """``/debug/utilization``'s totals equal the per-server snapshots it
    includes verbatim; an unreachable server degrades to a named entry."""
    cluster = InProcessCluster(num_servers=1, data_dir=str(tmp_path), http=True, device="cpu")
    admin = http = None
    try:
        physical = cluster.add_offline_table(SCHEMA)
        cluster.upload(physical, build_segment(SCHEMA, random_rows(REF_SCHEMA, 800, seed=31), physical, "util0"))
        for _ in range(3):
            assert not cluster.query("SELECT sum(metInt) FROM testTable WHERE dimInt > 5").exceptions
        admin = ServerAdminHttpServer(cluster.servers[0])
        admin.start()
        cluster.controller.resources.instances["server0"].url = admin.url
        cluster.controller.resources.register_instance(
            InstanceState(name="ghost", role="server", url="http://127.0.0.1:9"))
        util = collect_utilization(cluster.controller, timeout_s=5.0)
        assert "ghost" in util["unreachable"]
        dev = util["servers"]["server0"]["device"]
        assert util["totals"]["h2dBytes"] == dev["transfers"]["h2dBytes"]
        assert util["totals"]["d2hBytes"] == dev["transfers"]["d2hBytes"]
        assert util["totals"]["deviceMs"] == dev["recent"]["deviceMs"]
        assert util["totals"]["deviceBytes"] == dev["recent"]["deviceBytes"]
        assert util["totals"]["queries"] == dev["recent"]["queries"] >= 3
        assert util["totals"]["achievedBytesPerSec"] == pytest.approx(
            dev["recent"]["deviceBytes"] * 1000.0 / dev["recent"]["deviceMs"], rel=1e-6)
        assert util["occupancy"]["servers"] == 1
        assert util["occupancy"]["meanBusyFraction"] == pytest.approx(dev["occupancy"]["busyFraction"], abs=1e-9)
        assert util["profilesActive"] == 0 and util["rooflineFraction"] is None
        plans = util["underutilizedPlans"]
        assert plans and plans[0]["server"] == "server0"
        assert {"digest", "deviceMs", "achievedBytesPerSec", "rooflineFraction"} <= set(plans[0])
        http = ControllerHttpServer(cluster.controller)
        http.start()
        with urllib.request.urlopen(http.url + "/debug/utilization", timeout=10) as r:
            over = json.loads(r.read())
        assert "server0" in over["servers"] and "ghost" in over["unreachable"]
    finally:
        if http is not None:
            http.stop()
        if admin is not None:
            admin.stop()
        cluster.stop()


def _plans_view(plans):
    """digest -> (count, table, summary, tier mix) of a plan list."""
    return {p["digest"]: (p["count"], p["table"], p["summary"], p["tierMix"]) for p in plans}


def test_plan_stats_equal_the_reference_at_server_broker_and_controller(tmp_path):
    """The plan-stats differential: a seeded query mix through both
    clusters gives equal digests, counts and tier mixes on the servers'
    ``/debug/plans``, the brokers' ``/debug/workload`` and the
    controllers' ``collect_workload`` (its ``?tables=`` narrowing
    included)."""
    rows = random_rows(REF_SCHEMA, 1500, seed=41)
    gen = QueryGenerator(REF_SCHEMA, rows, table="testTable", seed=5)
    mix = [gen.next_query() for _ in range(24)]
    mix += ["SELECT sum(metInt) FROM testTable WHERE dimInt > %d" % t for t in (5, 50, 500)]
    ref = RefCluster(num_servers=1, data_dir=str(tmp_path / "ref"), http=True)
    port = InProcessCluster(num_servers=1, data_dir=str(tmp_path / "port"), http=True, device="cpu")
    try:
        for cluster, build, schema in ((ref, ref_build_segment, REF_SCHEMA), (port, build_segment, SCHEMA)):
            phys = cluster.add_offline_table(schema)
            for i in range(3):
                cluster.upload(phys, build(schema, rows[i * 500:(i + 1) * 500], phys, f"ps{i}"))
        for pql in mix:
            got, want = port.query(pql), ref.query(pql)
            assert [e.error_code for e in got.exceptions] == [e.error_code for e in want.exceptions], pql
        server_plans = _plans_view(port.servers[0].plan_stats.snapshot(top=100)["plans"])
        assert server_plans == _plans_view(ref.servers[0].plan_stats.snapshot(top=100)["plans"])
        assert sum(v[0] for v in server_plans.values()) == len(mix)
        assert any(v[0] > 1 for v in server_plans.values())  # literals erased: shapes repeat
        with urllib.request.urlopen(port.http.url + "/debug/workload?top=100", timeout=10) as r:
            workload = json.loads(r.read())
        ref_workload = ref.broker.workload_snapshot(top=100)
        for key in ("topByCount", "topByCost"):
            assert _plans_view(workload[key]) == _plans_view(ref_workload[key])
        assert all(p["exemplarPql"] in mix for p in workload["topByCount"])
        for tables in (None, ["testTable"], ["otherTable"]):
            got = collect_workload(port.controller, n=50, tables=tables)
            want = ref_collect_workload(ref.controller, n=50, tables=tables)
            assert got["digests"] == want["digests"] == (0 if tables == ["otherTable"] else len(server_plans))
            for key in ("topByCount", "topByCost"):
                view = {p["digest"]: (p["count"], p["table"], p["summary"], p["cost"].get("segmentsFullScan"))
                        for p in got[key]}
                want_view = {p["digest"]: (p["count"], p["table"], p["summary"], p["cost"].get("segmentsFullScan"))
                             for p in want[key]}
                assert view == want_view
    finally:
        port.stop()
        ref.stop()
