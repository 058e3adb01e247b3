"""The correctness and freshness planes of the port against the JAX
package's, the twin of ``tests/test_audit.py`` (all but the controller's
CRC audit manager, ROADMAP queue 1 item 30).

The comparator, the sampler budget, the shadow auditor's sampling, the
freshness registry, the SLO's freshness objective and the slow-query
log's annotation run against both packages' modules.  End to end, on
port servers on the CPU:

- a wrong answer injected on the device tier (``corrupt_results``) is
  served, caught by the shadow auditor against the host oracle, the
  (plan digest, tier) is quarantined, a flight-recorder bundle holds both
  payloads, and the next answer comes from the host tier and equals the
  JAX package's on the same rows (``payloads_equivalent``: rel 5e-4, abs
  1e-3 for sums; counts and group order exact);
- an honest device answer audits "equivalent" (no false divergence);
- the shadow oracle runs in a forked child, and ``stop`` kills a child
  in flight;
- ``execute_host_oracle`` gives the reference oracle's payload;
- the replica auditor finds two replicas in agreement;
- ``freshnessMs`` equals now minus the table's minimum watermark, in both
  packages, and shrinks when fresher events land.

The freshness registry is process-global in each package; every test that
feeds it drops its tables afterwards.
"""
import importlib
import json
import os
import time
import urllib.request

import pytest

from pinot_tpu.common.schema import DataType as RefDataType
from pinot_tpu.common.schema import FieldSpec as RefFieldSpec
from pinot_tpu.common.schema import FieldType as RefFieldType
from pinot_tpu.common.schema import Schema as RefSchema
from pinot_tpu.common.schema import TimeFieldSpec as RefTimeFieldSpec
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.realtime.stream import MemoryStreamProvider as RefStream
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.cluster_harness import InProcessCluster as RefCluster
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.utils.audit import canonical_payload as ref_canonical_payload

from pinot_tpu_torch.broker.freshness import WATERMARKS, now_ms
from pinot_tpu_torch.common.faults import DeviceFaultInjector
from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType, Schema, TimeFieldSpec
from pinot_tpu_torch.engine.plandigest import plan_shape_digest
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.realtime.llc import make_segment_name
from pinot_tpu_torch.realtime.stream import MemoryStreamProvider
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.tools.cluster_harness import InProcessCluster
from pinot_tpu_torch.utils import audit
from pinot_tpu_torch.utils.audit import SamplerBudget, ShadowAuditor, canonical_payload, payloads_equivalent

PKGS = pytest.mark.parametrize("pkg", ["pinot_tpu", "pinot_tpu_torch"], ids=["reference", "port"])
REF_SCHEMA = make_test_schema(with_mv=False)
SCHEMA = Schema.from_json(REF_SCHEMA.to_json())
ROWS = random_rows(REF_SCHEMA, 600, seed=5)
Q_GROUPS = "SELECT sum(metInt), count(*) FROM testTable WHERE dimInt > 1000 GROUP BY dimStr TOP 10"
REL, ABS = 5e-4, 1e-3


def M(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def no_leaked_audit_threads():
    yield
    assert audit.leaked_audit_threads() == []


# ------------------------------------------------------- comparator
@PKGS
def test_payloads_equivalent_absorbs_float32_noise(pkg):
    eq = M(pkg, "utils.audit").payloads_equivalent
    a = {"aggregationResults": [{"function": "sum_m", "value": "118.37801"}]}
    b = {"aggregationResults": [{"function": "sum_m", "value": "118.37800"}]}
    assert eq(a, b)
    assert eq({"v": "3578694016.00000"}, {"v": "3578694400.00000"})


@PKGS
def test_payloads_equivalent_catches_real_divergence(pkg):
    eq = M(pkg, "utils.audit").payloads_equivalent
    good = {"aggregationResults": [{"function": "sum_m", "value": "2048.00000"}]}
    bad = {"aggregationResults": [{"function": "sum_m", "value": "2148.00000"}]}
    assert not eq(good, bad)
    assert not eq({"numDocs": 300}, {"numDocs": 301})


@PKGS
def test_payloads_equivalent_structure_is_exact(pkg):
    eq = M(pkg, "utils.audit").payloads_equivalent
    assert not eq({"a": 1}, {"a": 1, "b": 2})
    assert not eq([1, 2], [1, 2, 3])
    assert not eq({"group": ["x"]}, {"group": ["y"]})
    assert eq({"g": [["k1"], "5.00000"]}, {"g": [["k1"], "5.00000"]})


@PKGS
def test_unstripped_field_difference_still_fails(pkg):
    mod = M(pkg, "utils.audit")
    a = {"totalDocs": 300, "numDocsScanned": 300, "freshnessMs": 11.0}
    b = {"totalDocs": 299, "numDocsScanned": 250, "freshnessMs": 99.0}
    sa, sb = mod.strip_accounting(a), mod.strip_accounting(b)
    assert "freshnessMs" in mod.ACCOUNTING_FIELDS
    assert "freshnessMs" not in sa and "numDocsScanned" not in sa
    assert not mod.payloads_equivalent(sa, sb)


def test_the_accounting_fields_are_the_references():
    assert M("pinot_tpu_torch", "utils.audit").ACCOUNTING_FIELDS == M("pinot_tpu", "utils.audit").ACCOUNTING_FIELDS


# -------------------------------------------- shadow-audit sampling
class _StubResult:
    def __init__(self, tier="device"):
        self.exceptions = []
        self._served_tier = tier


class _StubRequest:
    explain = False
    join = None


def _stub_instance(pkg):
    class _Exec:
        @staticmethod
        def audit_quarantined_snapshot():
            return []

    class _Inst:
        name = "stub"
        metrics = M(pkg, "utils.metrics").ServerMetrics("stub-audit-test")
        executor = _Exec()

    return _Inst()


@PKGS
def test_shadow_offer_eligibility_and_budget(pkg):
    mod = M(pkg, "utils.audit")
    inst = _stub_instance(pkg)
    auditor = mod.ShadowAuditor(inst, sample_n=1, budget=mod.SamplerBudget(per_s=0.0))
    try:
        req = {"requestId": "r1", "table": "t"}
        assert not auditor.offer(req, _StubRequest(), [], _StubResult("host"))
        assert not auditor.offer(req, _StubRequest(), [], _StubResult("device"))
        assert inst.metrics.meter("audit.dropped").count >= 1
        auditor.sample_n = 1000
        auditor._count = 0
        assert not auditor.offer(req, _StubRequest(), [], _StubResult("device"))
    finally:
        auditor.stop()


@PKGS
def test_shadow_auditor_disabled_when_sample_n_zero(pkg):
    mod = M(pkg, "utils.audit")
    auditor = mod.ShadowAuditor(_stub_instance(pkg), sample_n=0)
    try:
        assert not auditor.enabled
        assert not auditor.offer({}, _StubRequest(), [], _StubResult("device"))
        snap = auditor.snapshot()
        assert snap["enabled"] is False and snap["samples"] == 0
    finally:
        auditor.stop()


@PKGS
def test_sampler_budget_refills(pkg):
    b = M(pkg, "utils.audit").SamplerBudget(per_s=1000.0, burst=2.0)
    assert b.take() and b.take()
    assert not b.take()
    time.sleep(0.01)
    assert b.take()


def test_audit_defaults_are_the_references(monkeypatch):
    for k in ("PINOT_TPU_AUDIT_SAMPLE_N", "PINOT_TPU_AUDIT_REPLICA_N", "PINOT_TPU_AUDIT_BUDGET_PER_S"):
        monkeypatch.delenv(k, raising=False)
    ref, port = M("pinot_tpu", "utils.audit"), M("pinot_tpu_torch", "utils.audit")
    assert port.SamplerBudget().per_s == ref.SamplerBudget().per_s == 8.0
    s_ref, s_port = ref.ShadowAuditor(_stub_instance("pinot_tpu")), port.ShadowAuditor(_stub_instance("pinot_tpu_torch"))
    assert s_port.sample_n == s_ref.sample_n == 64
    s_ref.stop()
    s_port.stop()


# ------------------------------------------------- the shadow audit, end to end
def _reference_payload(pql):
    segs = [ref_build_segment(REF_SCHEMA, ROWS[:300], "testTable", "a0"),
            ref_build_segment(REF_SCHEMA, ROWS[300:], "testTable", "a1")]
    req = ref_optimize(ref_parse(pql))
    return ref_canonical_payload(req, RefExecutor().execute(segs, req))


def _port_cluster(tmp_path, **server_kwargs):
    cluster = InProcessCluster(num_servers=1, data_dir=str(tmp_path), device="cpu", server_kwargs=server_kwargs)
    physical = cluster.add_offline_table(SCHEMA, replication=1)
    cluster.upload(physical, build_segment(SCHEMA, ROWS[:300], physical, "a0"))
    cluster.upload(physical, build_segment(SCHEMA, ROWS[300:], physical, "a1"))
    return cluster


def _wait(pred, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


def _payload_of(resp):
    return audit.strip_accounting(resp.to_json())


def test_a_corrupted_device_answer_is_caught_quarantined_and_healed(tmp_path):
    """The reference's audit-divergence scenario on a port server: the
    injected wrong answer is served (nothing raises), the shadow auditor
    catches it against the host oracle, quarantines (digest, "device"),
    writes a bundle with both payloads, and the next answer comes from
    the host tier and equals the JAX package's."""
    inj = DeviceFaultInjector()
    cluster = _port_cluster(tmp_path / "c", device_fault_injector=inj)
    try:
        server = cluster.servers[0]
        server.auditor.stop()
        server.auditor = ShadowAuditor(server, sample_n=1, budget=SamplerBudget(per_s=1000.0))
        frec_dir = tmp_path / "frec"
        server.flightrec.dir = str(frec_dir)
        want = _reference_payload(Q_GROUPS)
        honest = cluster.query(Q_GROUPS)
        assert payloads_equivalent(_payload_of(honest), want, rel_tol=REL, abs_tol=ABS)
        assert _wait(lambda: server.metrics.meter("audit.samples").count >= 1)
        assert server.metrics.meter("audit.divergences").count == 0  # no false divergence
        digest = plan_shape_digest(optimize_request(parse_pql(Q_GROUPS)))
        inj.corrupt_results(1, tier="device", digest_substring=digest, delta=1000.0)
        lied = cluster.query(Q_GROUPS)
        assert not lied.exceptions
        assert not payloads_equivalent(_payload_of(lied), want, rel_tol=REL, abs_tol=ABS)
        assert [r.outcome for r in inj.records_for("corrupt")] == ["corrupt"]
        assert _wait(lambda: server.metrics.meter("audit.divergences").count == 1)
        snap = server.audit_snapshot()
        assert snap["quarantined"] and snap["quarantined"][0]["tier"] == "device"
        assert snap["quarantined"][0]["planDigest"] == digest
        assert snap["recentDivergences"][0]["tier"] == "device"
        healed = cluster.query(Q_GROUPS)
        assert healed.cost.get("segmentsHost") == 2, healed.cost
        assert payloads_equivalent(_payload_of(healed), want, rel_tol=REL, abs_tol=ABS)
        assert server.metrics.meter("heal.auditTierSkips").count >= 1
        # the auditor's thread writes the bundle after it meters and
        # quarantines the divergence
        assert _wait(lambda: any("-auditDivergence-" in p for p in server.flightrec.bundle_files()))
        bundles = [json.loads(open(p).read()) for p in server.flightrec.bundle_files()]
        div = [b for b in bundles if b["reason"] == "auditDivergence"]
        assert div and {"producedPayload", "expectedPayload"} <= set(div[0]["detail"])
        assert not payloads_equivalent(div[0]["detail"]["producedPayload"], div[0]["detail"]["expectedPayload"])
    finally:
        cluster.stop()


# a numpy oracle, a distinct count without a group-by and an ordered
# selection (the last two the host tier runs row by row)
ORACLE_QUERIES = (
    Q_GROUPS,
    "SELECT distinctcount(dimLong), max(metInt) FROM testTable",
    "SELECT dimStr, metInt FROM testTable WHERE dimInt > 4000 ORDER BY metInt DESC LIMIT 5",
)


def _audited_server(cluster):
    server = cluster.servers[0]
    server.auditor.stop()
    server.auditor = ShadowAuditor(server, sample_n=1, budget=SamplerBudget(per_s=1000.0))
    return server


@pytest.mark.parametrize("pql", ORACLE_QUERIES)
def test_the_shadow_oracle_runs_in_a_forked_child(tmp_path, pql):
    """The oracle never holds the serving interpreter: it runs in a child
    process, one fork a sample, and its verdict is "equivalent" on an
    answer equal to the JAX package's."""
    cluster = _port_cluster(tmp_path / "c")
    try:
        server = _audited_server(cluster)
        pids = tmp_path / "pids"
        oracle = server.executor.execute_host_oracle

        def recorded(views, request):
            with open(pids, "a") as f:
                f.write(f"{os.getpid()}\n")
            return oracle(views, request)

        server.executor.execute_host_oracle = recorded
        resp = cluster.query(pql)
        assert payloads_equivalent(_payload_of(resp), _reference_payload(pql), rel_tol=REL, abs_tol=ABS)
        assert _wait(lambda: server.metrics.meter("audit.samples").count >= 1)
        assert server.metrics.meter("audit.divergences").count == 0
        assert server.metrics.meter("audit.errors").count == 0
        assert os.getpid() not in {int(x) for x in pids.read_text().split()}
        assert len(server.metrics.timer("audit.forkMs").samples()) == 1
    finally:
        cluster.stop()


def test_stop_kills_a_forked_oracle_in_flight(tmp_path):
    """``stop`` ends a child whose oracle is still running: the worker
    returns, the child is gone, and no sample or error is counted."""
    cluster = _port_cluster(tmp_path / "c")
    try:
        server = _audited_server(cluster)
        pidfile = tmp_path / "pid"

        def stuck(views, request):
            pidfile.write_text(str(os.getpid()))
            time.sleep(120)

        server.executor.execute_host_oracle = stuck
        cluster.query(ORACLE_QUERIES[-1])
        assert _wait(lambda: pidfile.exists() and pidfile.read_text().strip() != "")
        child = int(pidfile.read_text())
        assert child != os.getpid()
        t0 = time.monotonic()
        server.auditor.stop()
        assert time.monotonic() - t0 < 5.0
        assert not server.auditor._thread.is_alive()
        with pytest.raises(ProcessLookupError):
            os.kill(child, 0)
        assert server.metrics.meter("audit.samples").count == 0
        assert server.metrics.meter("audit.errors").count == 0
    finally:
        cluster.stop()


def test_the_host_oracle_is_the_references():
    """``execute_host_oracle`` over the served views gives the reference
    oracle's payload, and is stamped as the host tier."""
    from pinot_tpu_torch.engine.executor import QueryExecutor

    ref_segs = [ref_build_segment(REF_SCHEMA, ROWS[:300], "testTable", "a0"),
                ref_build_segment(REF_SCHEMA, ROWS[300:], "testTable", "a1")]
    segs = [build_segment(SCHEMA, ROWS[:300], "testTable", "a0"),
            build_segment(SCHEMA, ROWS[300:], "testTable", "a1")]
    for pql in (Q_GROUPS, "SELECT distinctcount(dimLong), max(metInt) FROM testTable",
                "SELECT dimStr, metInt FROM testTable WHERE dimInt > 4000 ORDER BY metInt DESC LIMIT 5"):
        req, ref_req = optimize_request(parse_pql(pql)), ref_optimize(ref_parse(pql))
        got = QueryExecutor(device="cpu").execute_host_oracle(segs, req)
        assert got._served_tier == "host"
        want = ref_canonical_payload(ref_req, RefExecutor().execute_host_oracle(ref_segs, ref_req))
        assert payloads_equivalent(canonical_payload(req, got), want, rel_tol=REL, abs_tol=ABS), pql


def test_the_replica_auditor_finds_two_replicas_in_agreement(tmp_path, monkeypatch):
    monkeypatch.setenv("PINOT_TPU_AUDIT_REPLICA_N", "1")
    cluster = InProcessCluster(num_servers=2, data_dir=str(tmp_path), device="cpu")
    try:
        physical = cluster.add_offline_table(SCHEMA, replication=2)
        cluster.upload(physical, build_segment(SCHEMA, ROWS, physical, "r0"))
        cluster.broker.replica_audit.budget = SamplerBudget(per_s=1000.0)
        resp = cluster.query(Q_GROUPS)
        assert not resp.exceptions
        rep = cluster.broker.replica_audit
        assert _wait(lambda: rep.snapshot()["checks"] >= 1)
        assert rep.snapshot()["divergences"] == 0
    finally:
        cluster.stop()


# --------------------------------------------------- freshness plane
def _fresh_schema(pkg, name):
    if pkg == "pinot_tpu":
        D, F, T, S, TF = RefDataType, RefFieldSpec, RefFieldType, RefSchema, RefTimeFieldSpec
    else:
        D, F, T, S, TF = DataType, FieldSpec, FieldType, Schema, TimeFieldSpec
    return S(name, dimensions=[F("d", D.STRING)], metrics=[F("m", D.INT, T.METRIC)],
             time_field=TF("ts", D.LONG, time_unit="MILLISECONDS"))


@PKGS
def test_freshness_ms_monotone_consistent_with_watermarks(pkg, tmp_path):
    """``freshnessMs`` = now at the reduce - the table's minimum partition
    watermark, bounded by wall clocks read around the query; it shrinks
    when fresher events land; offline-only answers carry none."""
    port = pkg == "pinot_tpu_torch"
    fr = M(pkg, "broker.freshness")
    cluster = (InProcessCluster(num_servers=1, data_dir=str(tmp_path), device="cpu") if port
               else RefCluster(num_servers=1, data_dir=str(tmp_path)))
    stream = (MemoryStreamProvider if port else RefStream)(num_partitions=1)
    physical = cluster.add_realtime_table(_fresh_schema(pkg, "freshT"), stream, rows_per_segment=500)
    try:
        t0 = fr.now_ms()
        for i in range(20):
            stream.produce({"d": f"a{i % 3}", "m": i, "ts": int(t0 - 60_000 + i)})
        (dm,) = cluster.controller.realtime_manager.consumers_of(M(pkg, "realtime.llc").make_segment_name(physical, 0, 0))
        dm.consume_step(max_rows=100)
        wm = fr.WATERMARKS.table_min_ms(physical)
        assert wm == int(t0 - 60_000 + 19)
        before = fr.now_ms()
        resp = cluster.query("SELECT count(*) FROM freshT")
        after = fr.now_ms()
        assert not resp.exceptions and resp.num_docs_scanned == 20
        assert before - wm - 1e-6 <= resp.freshness_ms <= after - wm + 1e-6
        assert resp.to_json()["freshnessMs"] == round(resp.freshness_ms, 3)
        stream.produce({"d": "z", "m": 1, "ts": int(fr.now_ms() - 2_000)})
        dm.consume_step(max_rows=100)
        wm2 = fr.WATERMARKS.table_min_ms(physical)
        assert wm2 > wm
        assert cluster.query("SELECT count(*) FROM freshT").freshness_ms < resp.freshness_ms
        fr.WATERMARKS.advance(physical, 0, wm2 - 50_000)
        assert fr.WATERMARKS.get(physical, 0) == wm2
        schema_off = REF_SCHEMA if not port else SCHEMA
        off = cluster.add_offline_table(schema_off, replication=1)
        build = ref_build_segment if not port else build_segment
        cluster.upload(off, build(schema_off, random_rows(REF_SCHEMA, 50, seed=3), off, "s0"))
        resp_off = cluster.query("SELECT count(*) FROM testTable")
        assert resp_off.freshness_ms is None and "freshnessMs" not in resp_off.to_json()
    finally:
        cluster.stop()
        fr.WATERMARKS.drop_table(physical)


def test_freshness_gauge_survives_rollover_and_the_pool(tmp_path):
    """The per-(table, partition) ``freshness.lag`` gauge is one series:
    a rollover hands it to the successor consumer, which keeps it moving
    when an ingest pool drives it (the port's pool has no resize)."""
    from pinot_tpu_torch.realtime.pool import IngestConsumerPool

    cluster = InProcessCluster(num_servers=1, data_dir=str(tmp_path), device="cpu")
    stream = MemoryStreamProvider(num_partitions=1)
    physical = cluster.add_realtime_table(_fresh_schema("pinot_tpu_torch", "freshRoll"), stream, rows_per_segment=50)
    pool = IngestConsumerPool(workers=2, name="auditFreshPool")
    try:
        t0 = now_ms()
        for i in range(60):
            stream.produce({"d": "x", "m": i, "ts": int(t0 - 30_000 + i)})
        (dm,) = cluster.controller.realtime_manager.consumers_of(make_segment_name(physical, 0, 0))
        dm.consume_step(max_rows=1000)
        gauge = cluster.servers[0].metrics.gauge(f"freshness.lag.{physical}.p0")
        assert isinstance(gauge.value, (int, float)) and gauge.value > 0
        assert dm.threshold_reached
        dm.try_commit()
        (dm1,) = cluster.controller.realtime_manager.consumers_of(make_segment_name(physical, 0, 1))
        assert isinstance(gauge.value, (int, float)) and gauge.value > 0
        pool.add(dm1, key=("freshRoll", 0))
        stream.produce({"d": "y", "m": 1, "ts": int(now_ms() - 3_000)})
        pool.kick()
        assert _wait(lambda: (WATERMARKS.get(physical, 0) or 0) >= t0 - 4_000, 10.0)
        stream.produce({"d": "y", "m": 2, "ts": int(now_ms() - 1_000)})
        pool.kick()
        assert _wait(lambda: (WATERMARKS.get(physical, 0) or 0) >= t0 - 2_000, 10.0)
        assert isinstance(gauge.value, (int, float)) and 0 < gauge.value < 60_000
    finally:
        pool.stop()
        cluster.stop()
        WATERMARKS.drop_table(physical)


def test_datatable_freshness_roundtrip_across_the_packages():
    """The stamp rides a trailing optional DataTable field: a port reply
    reads in the reference and back, and None stays None."""
    from pinot_tpu.common.datatable import deserialize_result as ref_deserialize
    from pinot_tpu.common.datatable import serialize_result as ref_serialize
    from pinot_tpu_torch.common.datatable import deserialize_result, serialize_result
    from pinot_tpu_torch.engine.results import IntermediateResult

    res = IntermediateResult()
    res.num_docs_scanned = res.total_docs = 7
    res.freshness = {"minEventMs": 1234.5}
    assert deserialize_result(serialize_result(res)).freshness == {"minEventMs": 1234.5}
    assert ref_deserialize(serialize_result(res)).freshness == {"minEventMs": 1234.5}
    assert deserialize_result(ref_serialize(ref_deserialize(serialize_result(res)))).freshness == {"minEventMs": 1234.5}
    assert deserialize_result(serialize_result(IntermediateResult())).freshness is None


def test_results_merge_min_combines_freshness():
    from pinot_tpu_torch.engine.results import IntermediateResult

    a, b, c = IntermediateResult(), IntermediateResult(), IntermediateResult()
    b.freshness = {"minEventMs": 5_000.0}
    c.freshness = {"minEventMs": 2_000.0}
    a.merge(b)
    assert a.freshness == {"minEventMs": 5_000.0}
    a.merge(c)
    assert a.freshness["minEventMs"] == 2_000.0
    a.merge(IntermediateResult())
    assert a.freshness["minEventMs"] == 2_000.0


@PKGS
def test_worst_freshness_tables_ranking(pkg):
    snap = {"tables": {"a_REALTIME": {"lagMs": 100.0}, "b_REALTIME": {"lagMs": 90_000.0},
                       "c_REALTIME": {"lagMs": 7_000.0}}}
    ranked = M(pkg, "broker.freshness").worst_freshness_tables(snap, top=2)
    assert [r["table"] for r in ranked] == ["b_REALTIME", "c_REALTIME"]


@PKGS
def test_slo_freshness_objective_burn(pkg):
    reg = M(pkg, "utils.metrics").MetricsRegistry("slo-fresh-test")
    clk = [0.0]
    hist = M(pkg, "utils.timeseries").HistoryRecorder(reg, interval_s=5, capacity=64, clock=lambda: clk[0],
                                                      start=False)
    slo = M(pkg, "utils.slo").SloTracker(history=hist, metrics=reg, fast_window_s=10.0, slow_window_s=100.0)
    hist.register_provider(slo.series)
    slo.set_objective("t", {"latencyMs": 1e9, "freshnessMs": 1000.0, "freshnessTarget": 0.9})
    slo.observe("t", 1.0, False, freshness_ms=50.0)
    hist.tick()
    clk[0] += 10.0
    for _ in range(8):
        slo.observe("t", 1.0, False, freshness_ms=50.0)
    for _ in range(2):
        slo.observe("t", 1.0, False, freshness_ms=5_000.0)
    hist.tick()
    assert slo.series()["slo.t.freshnessBreaches"] == 2
    fresh = slo.evaluate(consume_crossings=False)["tables"]["t"]["windows"]["burnRate5m"]["freshness"]
    assert fresh["bad"] == 2 and fresh["queries"] == 10
    assert fresh["burnRate"] == pytest.approx(0.2 / 0.1, rel=1e-3)
    slo.set_objective("u", {"latencyMs": 1e9})
    slo.observe("u", 1.0, False, freshness_ms=1e12)
    hist.tick()
    assert slo.series()["slo.u.freshnessBreaches"] == 0
    assert slo.evaluate(consume_crossings=False)["tables"]["u"]["windows"]["burnRate5m"]["freshness"] is None


@PKGS
def test_querylog_freshness_and_audit_ref_annotation(pkg):
    log = M(pkg, "broker.querylog").SlowQueryLog(threshold_ms=0.0)
    log.observe({"requestId": "rq-1", "table": "t", "timeUsedMs": 5.0, "freshnessMs": 123.4})
    assert log.annotate("rq-1", auditRef="audit-rq-1")
    assert not log.annotate("rq-missing", auditRef="x")
    entry = [e for e in log.entries() if e["requestId"] == "rq-1"][0]
    assert entry["freshnessMs"] == 123.4 and entry["auditRef"] == "audit-rq-1"


def test_server_audit_debug_surfaces(tmp_path):
    """``/debug/{audit,history,flightrec}`` on a port server's admin port,
    zeros before any sample, with the reference's top-level keys."""
    from pinot_tpu.server.instance import ServerInstance as RefServerInstance
    from pinot_tpu_torch.server.network_starter import ServerAdminHttpServer

    cluster = _port_cluster(tmp_path)
    ref = RefServerInstance("refAudit")
    http = ServerAdminHttpServer(cluster.servers[0])
    http.start()
    try:
        s = cluster.servers[0]
        snap = s.auditor.snapshot()
        assert snap["samples"] == 0 and snap["divergences"] == 0 and snap["quarantined"] == []
        assert cluster.broker.replica_audit.snapshot()["divergences"] == 0
        s.history.tick()

        def get(path):
            with urllib.request.urlopen(http.url + path, timeout=10) as r:
                return json.loads(r.read())

        assert set(get("/debug/audit")) == set(ref.audit_snapshot())
        assert set(get("/debug/flightrec")) == set(ref.flightrec.snapshot())
        hist = get("/debug/history?series=queries")
        assert set(hist) == set(ref.history.query_from_qs("series=queries")) and hist["samples"] >= 1
        assert set(s.status()) >= {"rescache", "audit"}
    finally:
        http.stop()
        ref.shutdown()
        cluster.stop()


def test_a_poisoned_plans_host_answer_is_never_corrupted():
    """Kept divergence 20: a host exit inside the device section (here a
    poisoned plan) is stamped "host", so an armed wrong-answer injection
    never perturbs it and the shadow auditor does not sample it."""
    from pinot_tpu_torch.server.instance import ServerInstance

    inj = DeviceFaultInjector()
    server = ServerInstance("poisoned", device="cpu", device_fault_injector=inj)
    try:
        segs = [build_segment(SCHEMA, ROWS[:300], "testTable", "a0"), build_segment(SCHEMA, ROWS[300:], "testTable", "a1")]
        req = optimize_request(parse_pql(Q_GROUPS))
        ex = server.executor
        want = canonical_payload(req, ex.execute_host_oracle(segs, req))
        assert ex.execute(segs, req)._served_tier == "device"
        inj.poison_plan(inj.launches[-1].digest)
        assert ex.execute(segs, req)._served_tier == "host"  # failed over and quarantined
        inj.corrupt_results(1)  # any tier but the host
        res = ex.execute(segs, req)
        assert res._served_tier == "host" and res.cost.get("segmentsHost") == 2
        assert inj.records_for("corrupt") == []
        assert payloads_equivalent(canonical_payload(req, res), want, rel_tol=REL, abs_tol=ABS)
        assert not server.auditor.offer({"requestId": "r"}, req, segs, res)
    finally:
        server.shutdown()
