"""The port's typed configs, broker admission and hedging against the JAX
package's, the twin of ``tests/test_conf_quota.py`` (the conf cases),
``tests/test_overload.py`` (the admission cases) and the reference's
hedging cases (``tests/test_chaos.py``, ``tests/test_cost.py``).

The unit cases run against both packages' modules (``common/conf.py``,
``broker/admission.py``).  The broker cases drive a port server on the CPU
behind the port broker: a flood past the per-table in-flight cap is shed
with the typed 429 while every admitted answer equals the JAX package's;
a stalled replica is hedged to the other, whose answer (and cost) equals
the steady state's, with ``numHedges`` 1; hedging stays off near the
table's quota.  Answers are compared with ``payloads_equivalent`` (rel
5e-4, abs 1e-3 for sums; counts exact).
"""
import importlib
import threading
import time

import pytest

from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.utils.audit import canonical_payload as ref_canonical_payload
from pinot_tpu.utils.audit import payloads_equivalent, strip_accounting

from pinot_tpu_torch.common.conf import BrokerConf
from pinot_tpu_torch.common.faults import DeviceFaultInjector
from pinot_tpu_torch.common.response import ErrorCode
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.tools.cluster_harness import InProcessCluster, single_server_broker

PKGS = pytest.mark.parametrize("pkg", ["pinot_tpu", "pinot_tpu_torch"], ids=["reference", "port"])
REF_SCHEMA = make_test_schema(with_mv=False)
SCHEMA = Schema.from_json(REF_SCHEMA.to_json())
ROWS = random_rows(REF_SCHEMA, 400, seed=2)
REL, ABS = 5e-4, 1e-3
Q = "SELECT sum(metInt), count(*) FROM tt WHERE dimInt > 1000 GROUP BY dimStr TOP 10"
QH = Q.replace("FROM tt", "FROM testTable")


def M(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# ------------------------------------------------------------------ conf
@PKGS
def test_parse_properties(pkg):
    props = M(pkg, "common.conf").parse_properties("""
        # comment
        pinot.server.netty.port = 8098
        pinot.server.instance.id=Server_1

        not a property
    """)
    assert props == {"pinot.server.netty.port": "8098", "pinot.server.instance.id": "Server_1"}


@PKGS
def test_conf_from_dict(pkg):
    conf = M(pkg, "common.conf")
    c = conf.ServerConf.from_dict({"pinot.server.netty.port": "9999", "pinot.server.query.executor.timeout.ms": "5000"})
    assert c.netty_port == 9999 and c.query_executor_timeout_ms == 5000 and c.instance_id == "server0"
    assert conf.BrokerConf.from_dict({"pinot.broker.timeout.ms": "2000"}).timeout_ms == 2000
    assert conf.ControllerConf.from_dict({"controller.port": "9001"}).port == 9001


def test_the_conf_defaults_are_the_references():
    ref, port = M("pinot_tpu", "common.conf"), M("pinot_tpu_torch", "common.conf")
    for cls in ("ServerConf", "BrokerConf", "ControllerConf"):
        assert vars(getattr(port, cls)()) == vars(getattr(ref, cls)()), cls
    assert port.BrokerConf().hedge_delay_ms == 0.0


@PKGS
def test_env_float_degrades_to_the_default(pkg, monkeypatch):
    env_float = M(pkg, "common.conf").env_float
    monkeypatch.setenv("PINOT_TPU_TEST_KNOB", "junk")
    assert env_float("PINOT_TPU_TEST_KNOB", 3.5) == 3.5
    monkeypatch.setenv("PINOT_TPU_TEST_KNOB", "7.25")
    assert env_float("PINOT_TPU_TEST_KNOB", 3.5) == 7.25


@PKGS
def test_broker_resilience_conf_maps_to_handler(pkg):
    conf = M(pkg, "common.conf")
    c = conf.BrokerConf.from_dict(conf.parse_properties("""
        pinot.broker.retry.attempts=5
        pinot.broker.retry.backoff.ms=7
        pinot.broker.hedge.delay.ms=120
        pinot.broker.health.failure.threshold=2
        pinot.broker.health.penalty.ms=900
        pinot.broker.admission.table.inflight=3
    """))
    handler = M(pkg, "broker.broker").BrokerRequestHandler.from_conf(M(pkg, "transport.local").LocalTransport(), {}, c)
    try:
        assert handler.retry_attempts == 5 and handler.retry_backoff_ms == 7.0
        assert handler.hedge_delay_ms == 120.0
        assert handler.health.failure_threshold == 2 and handler.health.penalty_ms == 900.0
        assert handler.admission.max_inflight_per_table == 3
    finally:
        handler.shutdown()


# ------------------------------------------------------------- admission
@PKGS
def test_admission_quota_tier_shed(pkg):
    quota = M(pkg, "broker.quota").QueryQuotaManager()
    quota.set_quota("t", 1.0)
    adm = M(pkg, "broker.admission").AdmissionController(quota=quota)
    assert adm.try_admit("t").admitted
    adm.release("t")
    d2 = adm.try_admit("t")
    assert not d2.admitted and d2.tier == "quota" and "quota" in d2.message


@PKGS
def test_admission_concurrency_tier_shed_and_release(pkg):
    adm = M(pkg, "broker.admission").AdmissionController(max_inflight_per_table=2)
    assert adm.try_admit("t").admitted and adm.try_admit("t").admitted
    d = adm.try_admit("t")
    assert not d.admitted and d.tier == "concurrency"
    assert adm.try_admit("other").admitted
    adm.release("t")
    assert adm.try_admit("t").admitted
    for _ in range(2):
        adm.release("t")
    adm.release("other")
    assert adm.table_inflight("t") == 0


@PKGS
def test_admission_aimd_window_decrease_and_recovery(pkg):
    adm = M(pkg, "broker.admission").AdmissionController(initial_window=8, min_window=1, max_window=16)
    for want in (4.0, 2.0):
        adm.on_attempt_start("s1")
        adm.on_attempt_done("s1", saturated=True)
        assert adm.window_of("s1") == want
    for _ in range(4):
        adm.on_attempt_start("s1")
        adm.on_attempt_done("s1", saturated=False)
    assert adm.window_of("s1") == 4.0
    for _ in range(10):
        adm.on_attempt_start("s1")
        adm.on_attempt_done("s1", saturated=True)
    assert adm.window_of("s1") == 1.0


@PKGS
def test_admission_backpressure_snapshot_counts_as_saturation(pkg):
    adm = M(pkg, "broker.admission").AdmissionController(initial_window=8, pending_high_water=0.8)
    adm.on_attempt_start("s1")
    adm.on_attempt_done("s1", saturated=False, backpressure={"pending": 60, "maxPending": 64})
    assert adm.window_of("s1") == 4.0
    adm.on_attempt_start("s1")
    adm.on_attempt_done("s1", saturated=False, backpressure={"pending": 3, "maxPending": 64})
    assert adm.window_of("s1") == 4.5


@PKGS
def test_admission_check_cover_sheds_only_when_all_windows_full(pkg):
    adm = M(pkg, "broker.admission").AdmissionController(initial_window=1)
    adm.on_attempt_start("s1")
    assert adm.check_cover("t", ["s1", "s2"]).admitted
    adm.on_attempt_start("s2")
    d = adm.check_cover("t", ["s1", "s2"])
    assert not d.admitted and d.tier == "overload"
    adm.on_attempt_cancelled("s1")
    assert adm.check_cover("t", ["s1", "s2"]).admitted


@PKGS
def test_broker_aimd_shed_recovers_after_server_drains(pkg):
    adm = M(pkg, "broker.admission").AdmissionController(initial_window=2, min_window=1)
    for _ in range(3):
        adm.on_attempt_start("s1")
        adm.on_attempt_done("s1", saturated=True)
    assert adm.window_of("s1") == 1.0
    adm.on_attempt_start("s1")
    assert not adm.check_cover("t", ["s1"]).admitted
    adm.on_attempt_done("s1", saturated=False)
    assert adm.check_cover("t", ["s1"]).admitted


def test_the_admission_defaults_are_the_references(monkeypatch):
    for k in ("PINOT_TPU_ADMISSION_TABLE_INFLIGHT", "PINOT_TPU_ADMISSION_WINDOW_INIT",
              "PINOT_TPU_ADMISSION_WINDOW_MAX", "PINOT_TPU_ADMISSION_PENDING_HIGH"):
        monkeypatch.delenv(k, raising=False)
    ref = M("pinot_tpu", "broker.admission").AdmissionController()
    port = M("pinot_tpu_torch", "broker.admission").AdmissionController()
    for attr in ("max_inflight_per_table", "initial_window", "min_window", "max_window", "increase",
                 "decrease_factor", "pending_high_water"):
        assert getattr(port, attr) == getattr(ref, attr), attr


def test_backpressure_rides_the_result_wire_both_ways():
    from pinot_tpu.common.datatable import deserialize_result as ref_deserialize
    from pinot_tpu_torch.common.datatable import deserialize_result, serialize_result
    from pinot_tpu_torch.engine.results import IntermediateResult

    res = IntermediateResult(num_docs_scanned=7)
    res.cost = {"bytesScanned": 42}
    res.backpressure = {"pending": 3, "maxPending": 64, "laneDepth": 1}
    for read in (deserialize_result, ref_deserialize):
        out = read(serialize_result(res))
        assert out.backpressure == {"pending": 3, "maxPending": 64, "laneDepth": 1}
        assert out.cost == {"bytesScanned": 42}
    assert deserialize_result(serialize_result(IntermediateResult(num_docs_scanned=1))).backpressure == {}


def _reference_payload(pql, rows=ROWS):
    segs = [ref_build_segment(REF_SCHEMA, rows, "tt", "s0")]
    req = ref_optimize(ref_parse(pql))
    return ref_canonical_payload(req, RefExecutor().execute(segs, req))


def test_broker_concurrency_cap_sheds_typed_429_and_admitted_answers_equal_the_reference():
    """A burst of 6 past an in-flight cap of 2: the excess is shed with the
    typed 429, every admitted answer equals the JAX package's, and
    ``/debug/admission``'s counters agree with what was sent."""
    broker = single_server_broker("tt", [build_segment(SCHEMA, ROWS, "tt", "s0")], device="cpu")
    server = broker.local_servers[0]
    broker.admission.max_inflight_per_table = 2
    gate = threading.Event()
    real_execute = server.executor.execute

    def slow_execute(segs, req, **kwargs):
        gate.wait(10)
        return real_execute(segs, req, **kwargs)

    server.executor.execute = slow_execute
    results = {}

    def q(i):
        results[i] = broker.handle_pql(Q)

    try:
        threads = [threading.Thread(target=q, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5
        while broker.admission.table_inflight("tt") < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        sheds = [broker.handle_pql(Q) for _ in range(4)]
        assert broker.admission.snapshot()["tableInflight"] == {"tt": 2}
        gate.set()
        for t in threads:
            t.join(timeout=20)
        want = _reference_payload(Q)
        for s in sheds:
            assert [e.error_code for e in s.exceptions] == [ErrorCode.TOO_MANY_REQUESTS]
            assert "in flight" in s.exceptions[0].message
        for r in results.values():
            assert not r.exceptions
            assert payloads_equivalent(strip_accounting(r.to_json()), want, rel_tol=REL, abs_tol=ABS)
        assert broker.metrics.meter("admission.shedConcurrency").count == 4
        assert broker.metrics.meter("queriesDropped").count == 4
        snap = broker.admission.snapshot()
        assert snap["tableInflight"] == {} and snap["maxInflightPerTable"] == 2
        assert snap["serverWindows"]["benchServer"]["inflight"] == 0
    finally:
        gate.set()
        broker.shutdown()
        server.shutdown()


# ---------------------------------------------------------------- hedging
def _replicated(tmp_path, hedge_delay_ms, **conf):
    """Two port servers both covering one segment, each with a fault
    injector, behind a broker built from a ``BrokerConf``."""
    injectors = {}

    class _Cluster(InProcessCluster):
        def add_server(self, name=None):
            name = name or f"server{len(self.servers)}"
            injectors[name] = self.server_kwargs["device_fault_injector"] = DeviceFaultInjector()
            return super().add_server(name)

    cluster = _Cluster(num_servers=2, data_dir=str(tmp_path), device="cpu",
                       broker_conf=BrokerConf(hedge_delay_ms=hedge_delay_ms, **conf),
                       server_kwargs={"device_fault_injector": None})
    physical = cluster.add_offline_table(SCHEMA, replication=2)
    cluster.upload(physical, build_segment(SCHEMA, ROWS, physical, "s0"))
    return cluster, injectors


def test_a_stalled_replica_is_hedged_to_the_other(tmp_path):
    """The primary's launch stalls; after the hedge delay the broker sends
    the same segment set to the other replica, whose lane launches it, and
    its answer wins: equal to the steady state's and the reference's, with
    the same integer cost, ``numHedges`` 1, well before the stall ends."""
    cluster, injectors = _replicated(tmp_path, hedge_delay_ms=100.0)
    try:
        baseline = cluster.query(QH)
        assert not baseline.exceptions and baseline.num_hedges == 0
        want = _reference_payload(Q)
        assert payloads_equivalent(strip_accounting(baseline.to_json()), want, rel_tol=REL, abs_tol=ABS)
        primary = next(iter(cluster.broker.routing.find_servers("testTable_OFFLINE")))
        other = next(n for n in injectors if n != primary)
        injectors[primary].stall_next(1, 2.0)
        launches_before = len(injectors[other].launches)
        t0 = time.monotonic()
        resp = cluster.query(QH)
        elapsed = time.monotonic() - t0
        assert not resp.exceptions and resp.num_hedges == 1, (resp.exceptions, resp.num_hedges)
        assert elapsed < 1.5, elapsed
        assert len(injectors[other].launches) > launches_before  # the hedge launched on the other lane
        assert payloads_equivalent(strip_accounting(resp.to_json()), want, rel_tol=REL, abs_tol=ABS)
        assert resp.num_docs_scanned == baseline.num_docs_scanned
        for k in ("segmentsFullScan", "segmentsHost", "segmentsZonemap", "segmentsPruned"):
            assert resp.cost.get(k, 0) == baseline.cost.get(k, 0), k
        assert cluster.broker.metrics.meter("hedgesSent").count == 1
        entry = resp.to_json()
        assert entry["numHedges"] == 1
    finally:
        cluster.stop()


def test_no_hedge_near_the_tables_quota(tmp_path):
    """A hedge doubles a table's traffic: with the headroom floor above any
    bucket's headroom, a straggler gets no hedge."""
    cluster, injectors = _replicated(tmp_path, hedge_delay_ms=10.0, hedge_min_quota_headroom=2.0)
    try:
        for inj in injectors.values():
            inj.stall_next(1, 0.3)
        resp = cluster.query(QH)
        assert not resp.exceptions and resp.num_hedges == 0 and resp.num_docs_scanned > 0
    finally:
        cluster.stop()


def test_hedging_is_off_by_default_and_a_server_conf_reaches_the_servers(tmp_path):
    from pinot_tpu_torch.common.conf import ServerConf

    cluster = InProcessCluster(num_servers=1, data_dir=str(tmp_path), device="cpu",
                               server_conf=ServerConf(query_worker_threads=2))
    try:
        assert cluster.broker.hedge_delay_ms == 0.0 and cluster.broker._hedge_delay_s() is None
        assert cluster.servers[0].scheduler._num_workers == 2
    finally:
        cluster.stop()
