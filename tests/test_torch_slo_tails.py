"""The SLO, tail-sample, history and flight-recorder planes of the port
against the JAX package's, the twin of ``tests/test_slo_tails.py`` (its
unit cases and its in-process broker cases).

The unit cases run against both packages' modules (``utils/timeseries.py``,
``utils/slo.py``, ``utils/tailsample.py``, ``utils/flightrec.py``,
``common/tableconfig.py``): the port keeps copies, and each copy must
give the reference's numbers exactly on the same inputs.  The broker
cases drive a port server on the CPU behind the port broker, and the same
queries through the reference's ``single_server_broker`` on the same rows;
the two answers are compared with ``payloads_equivalent`` (rel 5e-4, abs
1e-3 for sums; counts exact).  A networked port broker takes a table's
``slo`` block from the controller's cluster-state snapshot, and drops it
with the table.
"""
import importlib
import json
import os
import time
import urllib.error
import urllib.request

import pytest

from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.cluster_harness import single_server_broker as ref_single_server_broker
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.utils.audit import payloads_equivalent, strip_accounting

from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.tools.cluster_harness import single_server_broker

TABLE = "testTable"
PKGS = pytest.mark.parametrize("pkg", ["pinot_tpu", "pinot_tpu_torch"], ids=["reference", "port"])


def M(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# ------------------------------------------------------- history recorder
@PKGS
def test_history_recorder_ring_and_window_delta(pkg):
    reg = M(pkg, "utils.metrics").MetricsRegistry("t")
    clk = [1000.0]
    rec = M(pkg, "utils.timeseries").HistoryRecorder(reg, interval_s=5, capacity=4, clock=lambda: clk[0],
                                                     start=False)
    reg.meter("m").mark(10)
    reg.gauge("g").set(2)
    reg.gauge("flag").set(True)
    reg.gauge("label").set("not-a-number")
    reg.timer("ph").update(5.0)
    rec.tick()
    clk[0] += 5
    reg.meter("m").mark(5)
    rec.tick()
    assert rec.sample_count() == 2
    assert rec.latest("m.count") == 15 and rec.latest("flag") == 1.0
    assert rec.latest("label") is None and rec.latest("ph.p99Ms") == 5.0
    assert rec.window_delta("m.count", 5) == (5, 5.0)
    assert rec.window_delta("m.count", 600) == (5, 5.0)
    assert rec.window_delta("nope", 5) is None
    for _ in range(6):
        clk[0] += 5
        rec.tick()
    assert rec.sample_count() == 4
    q = rec.query(series=["m."], window_s=10)
    assert set(q["series"]) == {"m.count", "m.rate1m"} and q["samples"] == 4
    assert len(q["series"]["m.count"]) == 3


@PKGS
def test_history_recorder_providers_hooks_and_thread_lifecycle(pkg):
    ts = M(pkg, "utils.timeseries")
    reg = M(pkg, "utils.metrics").MetricsRegistry("t")
    rec = ts.HistoryRecorder(reg, interval_s=0.02, capacity=8, metrics=reg)
    try:
        seen = []
        rec.register_provider(lambda: {"extra.series": 7.0})
        rec.register_provider(lambda: 1 / 0)  # a sick provider is tolerated
        rec.add_tick_hook(seen.append)
        rec.add_tick_hook(lambda now: 1 / 0)  # a sick hook too
        deadline = time.monotonic() + 5
        while rec.sample_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert rec.sample_count() >= 2, "recorder thread never ticked"
        assert rec.latest("extra.series") == 7.0 and rec.latest("history.ticks.count") >= 1
        assert seen and all(isinstance(t, float) for t in seen)
    finally:
        rec.stop()
    assert rec.stopped and ts.leaked_recorder_threads(grace_s=2.0) == []
    rec.start()  # restartable after stop
    rec.stop()
    assert ts.leaked_recorder_threads(grace_s=2.0) == []


# ------------------------------------------------------------- SLO burn
def _slo_rig(pkg, fast=10.0, slow=100.0):
    reg = M(pkg, "utils.metrics").MetricsRegistry("t")
    clk = [0.0]
    hist = M(pkg, "utils.timeseries").HistoryRecorder(reg, interval_s=5, capacity=64, clock=lambda: clk[0],
                                                      start=False)
    slo = M(pkg, "utils.slo").SloTracker(history=hist, metrics=reg, fast_window_s=fast, slow_window_s=slow,
                                         burn_threshold=1.0)
    hist.register_provider(slo.series)
    return reg, clk, hist, slo


def _burn_run(pkg):
    reg, clk, hist, slo = _slo_rig(pkg)
    for _ in range(100):
        slo.observe(TABLE, 10.0, failed=False)
    hist.tick()
    clk[0] += 10.0
    for i in range(100):
        slo.observe(TABLE, 10.0, failed=(i < 50))
    hist.tick()
    polled = slo.snapshot()["burningTables"]
    ev = slo.evaluate()
    ev2 = slo.evaluate()
    return reg, polled, ev, ev2, slo


@PKGS
def test_slo_burn_rate_math_and_crossing(pkg):
    reg, polled, ev, ev2, slo = _burn_run(pkg)
    # a read-only poll between ticks never consumes the crossing edge
    assert polled == [TABLE]
    t = ev["tables"][TABLE]
    av = t["windows"]["burnRate5m"]["availability"]
    assert av["queries"] == 100 and av["bad"] == 50
    assert av["badFraction"] == pytest.approx(0.5)
    assert av["burnRate"] == pytest.approx(0.5 / 0.001, rel=1e-3)
    assert t["burning"] and ev["crossed"] == [TABLE] and ev["burningTables"] == [TABLE]
    assert ev["worstBurning"][0] == TABLE
    assert reg.gauge("slo.burning").value == 1 and reg.gauge("slo.worstBurnRate5m").value > 1.0
    assert ev2["crossed"] == [] and "crossed" not in slo.snapshot()


def test_slo_burn_evaluation_equals_the_reference():
    """The whole evaluation (both windows, all three objectives, the
    verdicts) is the reference's, number for number."""
    _, _, ref, _, _ = _burn_run("pinot_tpu")
    _, _, port, _, _ = _burn_run("pinot_tpu_torch")
    assert port == ref


@PKGS
def test_slo_multi_window_guard_fast_spike_does_not_page(pkg):
    reg, clk, hist, slo = _slo_rig(pkg, fast=10.0, slow=100.0)
    slo.set_objective(TABLE, {"latencyMs": 5.0, "latencyTarget": 0.5})
    for ts in (0.0, 5.0, 10.0, 15.0):
        clk[0] = ts
        for _ in range(75):
            slo.observe(TABLE, 1.0, failed=False)
        hist.tick()
    clk[0] = 25.0
    for _ in range(10):
        slo.observe(TABLE, 50.0, failed=False)
    hist.tick()
    ev = slo.evaluate()
    t = ev["tables"][TABLE]
    assert t["burnRate5m"] == pytest.approx(2.0, rel=1e-3)
    assert t["burnRate1h"] < 1.0
    assert not t["burning"] and ev["burningTables"] == []


@PKGS
def test_slo_objectives_override_and_clear(pkg, monkeypatch):
    mod = M(pkg, "utils.slo")
    monkeypatch.setenv("PINOT_TPU_SLO_LATENCY_MS", "400")
    assert mod.default_objective()["latencyMs"] == 400.0
    slo = mod.SloTracker()
    slo.set_objective(TABLE, {"latencyTarget": 0.9})
    obj = slo.objective(TABLE)
    assert obj["latencyTarget"] == 0.9 and obj["latencyMs"] == 400.0
    slo.set_objective(TABLE, None)
    assert slo.objective(TABLE) == mod.default_objective()
    slo.observe(TABLE, 1.0, failed=True)
    s = slo.series()
    assert s[f"slo.{TABLE}.failures"] == 1 and s[f"slo.{TABLE}.latencyBreaches"] == 1


def test_slo_defaults_are_the_references(monkeypatch):
    for k in [k for k in os.environ if k.startswith("PINOT_TPU_SLO_")]:
        monkeypatch.delenv(k)
    assert M("pinot_tpu_torch", "utils.slo").default_objective() == M("pinot_tpu", "utils.slo").default_objective()


# ------------------------------------------------------- tail sampling
@PKGS
def test_tail_sampler_decisions_and_zero_overhead(pkg):
    ts_mod = M(pkg, "utils.tailsample")
    t = ts_mod.TailSampler(enabled=True, slow_ms=100.0, sample_n=4, capacity=3)
    assert t.decide(50.0, failed=True, partial=False) == "failed"
    assert t.decide(50.0, failed=False, partial=True) == "partial"
    assert t.decide(150.0, failed=False, partial=False) == "slow"
    assert t.decide(1.0, failed=False, partial=False) == "sampled"
    assert t.decide(1.0, failed=False, partial=False) is None
    before = ts_mod.TAIL_ALLOCATIONS

    def boom():
        raise AssertionError("scopes built on the not-retained path")

    assert t.observe("r0", 1.0, False, False, boom) is None
    assert ts_mod.TAIL_ALLOCATIONS == before
    scopes = {"brk": [{"id": "1", "parent": None, "span": "query", "ms": 100.0},
                      {"id": "2", "parent": "1", "span": "laneWait", "ms": 70.0}]}
    assert t.observe("r1", 500.0, False, False, lambda: scopes, table=TABLE, plan_digest="d1",
                     summary="SELECT ...") == "slow"
    assert ts_mod.TAIL_ALLOCATIONS == before + 1
    got = t.get("r1")
    assert got["reason"] == "slow" and got["phaseSelfMs"] == {"query": 30.0, "laneWait": 70.0}
    for i in range(4):
        t.retain(f"rr{i}", "slow", 300.0, {})
    assert t.get("r1") is None
    snap = t.snapshot()
    assert snap["retained"] == 3 and len(snap["entries"]) == 3
    assert all("scopes" not in e for e in snap["entries"])
    assert all("scopes" in e for e in t.snapshot(include_traces=True)["entries"])


@PKGS
def test_tail_phase_self_time_never_double_counts(pkg):
    phase_self_ms = M(pkg, "utils.tailsample").phase_self_ms
    scopes = {"s": [{"id": "p", "parent": None, "span": "serverQuery", "ms": 100.0},
                    {"id": "a", "parent": "p", "span": "stageA", "ms": 80.0},
                    {"id": "b", "parent": "p", "span": "stageB", "ms": 60.0}]}
    assert phase_self_ms(scopes) == {"stageA": 80.0, "stageB": 60.0}
    assert phase_self_ms({}) == {}


@PKGS
def test_tail_digest_attribution_fractions(pkg):
    t = M(pkg, "utils.tailsample").TailSampler(enabled=True, slow_ms=100.0, sample_n=0, capacity=8)
    scopes = {"b": [{"id": "1", "parent": None, "span": "query", "ms": 100.0},
                    {"id": "2", "parent": "1", "span": "laneWait", "ms": 75.0}]}
    for i in range(6):
        t.retain(f"r{i}", "slow", 200.0 + i, scopes, plan_digest="dig", table=TABLE, summary="shape")
    agg = t.snapshot()["byDigest"][0]
    assert agg["digest"] == "dig" and agg["tails"] == 6 and agg["topPhase"] == "laneWait"
    assert agg["attribution"]["laneWait"] == pytest.approx(0.75)
    assert sum(agg["attribution"].values()) == pytest.approx(1.0)
    assert agg["latencyMs"]["p50"] <= agg["latencyMs"]["p99"]


@PKGS
def test_tail_env_opt_out(pkg, monkeypatch):
    TailSampler = M(pkg, "utils.tailsample").TailSampler
    monkeypatch.setenv("PINOT_TPU_TAIL_TRACE", "0")
    assert TailSampler().armed is False
    monkeypatch.delenv("PINOT_TPU_TAIL_TRACE")
    t = TailSampler()
    assert t.armed is True and (t.slow_ms, t.sample_n, t.capacity) == (250.0, 128, 64)


# ------------------------------------------------------ flight recorder
@PKGS
def test_flight_recorder_dump_prune_rate_limit(pkg, tmp_path, monkeypatch):
    FlightRecorder = M(pkg, "utils.flightrec").FlightRecorder
    monkeypatch.delenv("PINOT_TPU_FLIGHTREC_DIR", raising=False)
    off = FlightRecorder("broker", "b0")
    assert not off.enabled and off.maybe_dump("x") is None
    assert (off.max_bundles, off.min_interval_s) == (8, 30.0)
    clk = [100.0]
    rec = FlightRecorder("broker", "b0", sources={"ok": lambda: {"v": 1}, "sick": lambda: 1 / 0},
                         directory=str(tmp_path), max_bundles=2, min_interval_s=30.0, clock=lambda: clk[0])
    path = rec.maybe_dump("sloBurn", {"table": TABLE})
    doc = json.loads(open(path).read())
    assert doc["reason"] == "sloBurn" and doc["detail"]["table"] == TABLE
    assert doc["sources"]["ok"] == {"v": 1} and "ZeroDivisionError" in doc["sources"]["sick"]["error"]
    assert rec.maybe_dump("sloBurn") is None  # inside the rate-limit window
    written = [path]
    for i in range(3):
        clk[0] += 31.0
        written.append(rec.maybe_dump(f"r{i}"))
    files = rec.bundle_files()
    assert len(files) == 2 and files[-1] == written[-1]
    snap = rec.snapshot()
    assert snap["enabled"] and len(snap["bundles"]) == 2 and snap["dir"] == str(tmp_path)


@PKGS
def test_tableconfig_slo_roundtrip(pkg):
    tc = M(pkg, "common.tableconfig")
    cfg = tc.TableConfig(table_name=TABLE, table_type="OFFLINE",
                         slo=tc.SloConfig(latency_ms=250.0, latency_target=0.95))
    d = cfg.to_json()
    assert d["slo"] == {"latencyMs": 250.0, "latencyTarget": 0.95, "availabilityTarget": None}
    back = tc.TableConfig.from_json(d)
    assert back.slo is not None and back.slo.latency_ms == 250.0
    plain = tc.TableConfig(table_name=TABLE, table_type="OFFLINE")
    assert "slo" not in plain.to_json() and tc.TableConfig.from_json(plain.to_json()).slo is None


# --------------------------------------------------- broker integration
REF_SCHEMA = make_test_schema(with_mv=False)
ROWS = random_rows(REF_SCHEMA, 300, seed=9)


@pytest.fixture(scope="module")
def served():
    """(reference broker, port broker), one server each over the same
    rows, warmed."""
    ref = ref_single_server_broker(TABLE, [ref_build_segment(REF_SCHEMA, ROWS, TABLE, "tailSeg")])
    schema = Schema.from_json(REF_SCHEMA.to_json())
    port = single_server_broker(TABLE, [build_segment(schema, ROWS, TABLE, "tailSeg")], device="cpu")
    for b in (ref, port):
        for _ in range(2):
            assert not b.handle_pql(f"SELECT count(*) FROM {TABLE}").exceptions
    yield {"reference": ref, "port": port}
    for b in (ref, port):
        b.shutdown()
        for s in getattr(b, "local_servers", ()):
            s.shutdown()


BROKERS = pytest.mark.parametrize("side", ["reference", "port"])


def _comparable(resp):
    return strip_accounting(resp.to_json())


def test_armed_tail_tracing_leaves_the_answer_as_the_references(served):
    """Tail arming traces every query inside both brokers; the answers
    stay equal and carry no traceInfo."""
    pql = f"SELECT sum(metInt), count(*) FROM {TABLE} GROUP BY dimStr TOP 5"
    ref, port = served["reference"].handle_pql(pql), served["port"].handle_pql(pql)
    assert not port.exceptions and port.trace_info == {} and ref.trace_info == {}
    assert payloads_equivalent(_comparable(port), _comparable(ref), rel_tol=5e-4, abs_tol=1e-3)
    assert served["port"].tail.armed and served["reference"].tail.armed


@BROKERS
def test_broker_tail_retention_links_querylog(served, side, monkeypatch):
    broker = served[side]
    monkeypatch.setattr(broker.tail, "slow_ms", 0.001)  # retain everything
    monkeypatch.setattr(broker.querylog, "threshold_ms", 0.0)
    resp = broker.handle_pql(f"SELECT sum(metInt) FROM {TABLE}")
    assert not resp.exceptions and resp.trace_info == {}
    got = broker.tail.get(resp.request_id)
    assert got is not None and got["reason"] == "slow" and got["table"] == TABLE and got["planDigest"]
    assert got["phaseSelfMs"], "no phase attribution on the retained tail"
    entry = next(e for e in broker.querylog.snapshot()["entries"] if e["requestId"] == resp.request_id)
    assert entry["traceRetained"] is True
    assert entry["traceRef"] == f"/debug/tails?requestId={resp.request_id}"
    assert broker.metrics.meter("tails.retained").count > 0


@BROKERS
def test_broker_not_retained_path_is_zero_overhead(served, side, monkeypatch):
    broker = served[side]
    pkg = "pinot_tpu_torch" if side == "port" else "pinot_tpu"
    ts_mod = M(pkg, "utils.tailsample")
    monkeypatch.setattr(broker.tail, "slow_ms", 1e9)
    monkeypatch.setattr(broker.tail, "sample_n", 0)
    broker.handle_pql(f"SELECT count(*) FROM {TABLE}")
    before_alloc = ts_mod.TAIL_ALLOCATIONS
    before_obs = broker.metrics.meter("tails.observed").count
    resp = broker.handle_pql(f"SELECT count(*) FROM {TABLE}")
    assert not resp.exceptions and ts_mod.TAIL_ALLOCATIONS == before_alloc
    assert resp.trace_info == {} and broker.metrics.meter("tails.observed").count == before_obs + 1
    assert broker.handle_pql(f"SELECT count(*) FROM {TABLE}", trace=True).trace_info["scopes"]


@BROKERS
def test_broker_shed_not_retained_as_tail(served, side, monkeypatch):
    broker = served[side]
    pkg = "pinot_tpu_torch" if side == "port" else "pinot_tpu"
    ts_mod = M(pkg, "utils.tailsample")
    ErrorCode = M(pkg, "common.response").ErrorCode
    monkeypatch.setattr(broker.tail, "slow_ms", 1e9)
    monkeypatch.setattr(broker.tail, "sample_n", 0)
    broker.quota.set_quota(TABLE, 0.001)  # one initial token, then shed
    try:
        before = ts_mod.TAIL_ALLOCATIONS
        fail0 = broker.slo.series().get(f"slo.{TABLE}.failures", 0)
        sheds = 0
        for _ in range(3):
            resp = broker.handle_pql(f"SELECT count(*) FROM {TABLE}")
            if resp.exceptions:
                assert resp.exceptions[0].error_code == ErrorCode.TOO_MANY_REQUESTS
                assert broker.tail.get(resp.request_id) is None
                sheds += 1
        assert sheds >= 2 and ts_mod.TAIL_ALLOCATIONS == before
        assert broker.slo.series()[f"slo.{TABLE}.failures"] == fail0 + sheds
    finally:
        broker.quota.set_quota(TABLE, None)


@BROKERS
def test_broker_http_history_slo_tails_flightrec(served, side, monkeypatch):
    broker = served[side]
    pkg = "pinot_tpu_torch" if side == "port" else "pinot_tpu"
    monkeypatch.setattr(broker.tail, "slow_ms", 0.001)
    resp = broker.handle_pql(f"SELECT count(*) FROM {TABLE}")
    broker.history.tick()
    http = M(pkg, "broker.broker").BrokerHttpServer(broker)
    http.start()
    try:
        base = f"http://127.0.0.1:{http.port}"

        def get(path, status=200):
            try:
                with urllib.request.urlopen(base + path, timeout=10) as r:
                    assert r.status == status
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                assert e.code == status, (path, e.code)
                return json.loads(e.read())

        hist = get("/debug/history?series=queries,slo.&windowS=600")
        assert hist["samples"] >= 1 and hist["windowS"] == 600.0
        assert any(k.startswith("queries") for k in hist["series"])
        assert any(k.startswith("slo.") for k in hist["series"])
        slo = get("/debug/slo")
        assert TABLE in slo["tables"] and "burningTables" in slo
        tails = get("/debug/tails?top=5")
        assert tails["retained"] >= 1 and tails["byDigest"]
        assert get(f"/debug/tails?requestId={resp.request_id}")["scopes"]
        assert get("/debug/tails?requestId=nope", status=404)["error"]
        assert get("/debug/flightrec")["enabled"] is False
        assert set(get("/debug/queries")) == {"thresholdMs", "capacity", "totalQueries", "totalRecorded",
                                              "entries"}
        assert set(get("/debug/admission")) == {"maxInflightPerTable", "tableInflight", "serverWindows"}
        assert set(get("/debug/audit")) == {"replica", "freshness"}
    finally:
        http.stop()


def test_the_debug_payloads_have_the_references_keys(served):
    """Every plane's snapshot has the reference's keys (the values differ
    with the traffic each broker saw)."""
    ref, port = served["reference"], served["port"]
    for name, fn in (("slo", lambda b: b.slo.snapshot()), ("tails", lambda b: b.tail.snapshot()),
                     ("queries", lambda b: b.querylog.snapshot()), ("admission", lambda b: b.admission.snapshot()),
                     ("flightrec", lambda b: b.flightrec.snapshot()), ("audit", lambda b: b.replica_audit.snapshot()),
                     ("history", lambda b: b.history.query(window_s=60))):
        assert set(fn(port)) == set(fn(ref)), name


@PKGS
def test_role_series_preregistered_at_construction(pkg):
    broker = M(pkg, "broker.broker").BrokerRequestHandler(M(pkg, "transport.local").LocalTransport(), {},
                                                         name="hygBrk")
    snap = broker.metrics.snapshot()
    for m in ("history.ticks", "tails.observed", "tails.retained", "flightrec.dumps"):
        assert m in snap["meters"], m
    for g in ("history.series", "slo.burning", "slo.worstBurnRate5m", "slo.worstBurnRate1h", "tails.ring",
              "flightrec.bundles"):
        assert g in snap["gauges"], g
    broker.shutdown()
    kwargs = {"device": "cpu"} if pkg == "pinot_tpu_torch" else {}
    server = M(pkg, "server.instance").ServerInstance("hygSrv", **kwargs)
    snap = server.metrics.snapshot()
    for m in ("history.ticks", "flightrec.dumps"):
        assert m in snap["meters"], m
    for g in ("history.series", "flightrec.bundles"):
        assert g in snap["gauges"], g
    server.shutdown()


def test_a_table_configs_slo_reaches_the_networked_broker_and_leaves_with_it(tmp_path):
    """A table config with an ``slo`` block reaches the networked port
    broker's ``SloTracker`` through the controller's snapshot; dropping the
    table clears it back to the env defaults."""
    from pinot_tpu_torch.broker.network_starter import NetworkedBrokerStarter
    from pinot_tpu_torch.common.tableconfig import SloConfig, TableConfig
    from pinot_tpu_torch.controller.controller import Controller, ControllerHttpServer

    ctrl = Controller(str(tmp_path / "ctrl"))
    http = ControllerHttpServer(ctrl)
    http.start()
    broker = NetworkedBrokerStarter(http.url, name="sloBroker", poll_interval_s=0.05)
    broker.start()
    try:
        schema = Schema.from_json(REF_SCHEMA.to_json())
        ctrl.add_schema(schema)
        physical = ctrl.add_table(TableConfig(table_name=TABLE, table_type="OFFLINE",
                                              slo=SloConfig(latency_ms=123.0, latency_target=0.95)))
        deadline = time.monotonic() + 20
        while broker.handler.slo.objective(TABLE)["latencyMs"] != 123.0 and time.monotonic() < deadline:
            time.sleep(0.05)
        obj = broker.handler.slo.objective(TABLE)
        assert obj["latencyMs"] == 123.0 and obj["latencyTarget"] == 0.95
        ctrl.delete_table(physical)
        while TABLE in broker.handler.slo.objective_tables() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert TABLE not in broker.handler.slo.objective_tables()
    finally:
        broker.stop()
        http.stop()
