"""The port's audit-divergence scenario on the CPU: the assertions of the
JAX package's twin (``tests/test_audit.py::test_audit_divergence_scenario_chaos_twin``),
and the scenario's pre-corruption payload held against the JAX package's
answer to the same PQL over the same rows."""
import threading
import time

import pytest

from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema as ref_make_test_schema
from pinot_tpu.tools.datagen import random_rows
from pinot_tpu.utils.audit import canonical_payload as ref_canonical_payload

from pinot_tpu_torch.tools.cluster_harness import run_audit_divergence_scenario
from pinot_tpu_torch.utils import audit

PQL = "SELECT sum(metInt), sum(metFloat), max(dimInt) FROM auditT GROUP BY dimStr"


def _reference_payload(rows: int, num_segments: int, seed: int):
    schema = ref_make_test_schema(with_mv=False)
    schema.schema_name = "auditT"
    all_rows = random_rows(schema, rows, seed=seed)
    per = rows // num_segments
    segs = [ref_build_segment(schema, all_rows[i * per:(i + 1) * per], "auditT_OFFLINE", f"audits{i}")
            for i in range(num_segments)]
    req = ref_optimize(ref_parse(PQL))
    return ref_canonical_payload(req, RefExecutor().execute(segs, req))


@pytest.mark.chaos
def test_audit_divergence_scenario_chaos_twin(tmp_path, monkeypatch):
    """A seeded device fault injector corrupts served aggregates under
    closed-loop load; the shadow auditor detects it within budget and
    quarantines the (shape, device tier), the cluster serves right answers
    after, and no query fails.  The answer before the corruption is the
    JAX package's (sums in the audit band, counts and group order exact)."""
    stripped = []
    real_strip = audit.strip_accounting

    def strip(payload):
        out = real_strip(payload)
        if threading.current_thread() is threading.main_thread():  # the scenario's, not the auditor's
            stripped.append(out)
        return out

    monkeypatch.setattr(audit, "strip_accounting", strip)
    res = run_audit_divergence_scenario(load_s=1.0, detect_budget_s=20.0, data_dir=str(tmp_path), device="cpu")
    assert res["detected"], res
    assert res["quarantined"] and res["quarantined"][0]["tier"] == "device"
    assert res["failedQueries"] == 0
    assert res["postQuarantineMismatches"] == 0
    assert res["divergences"] >= 1

    # the scenario's first stripped payload is its pre-corruption reference
    before = stripped[0]
    assert audit.payloads_equivalent(before, _reference_payload(96, 2, 1907))
    # the scenario's eight answers after the quarantine, each its equivalent
    assert len(stripped) == 9
    assert all(audit.payloads_equivalent(p, before) for p in stripped[1:])


def _blocked_auditor(monkeypatch):
    """One CPU server auditing 1 in 1 behind a broker, its auditor's first
    forked oracle held until ``gate`` is set: (broker, server, gate, the
    sizes of the batches each child checked)."""
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.tools.cluster_harness import _tenant_schema, single_server_broker
    from pinot_tpu_torch.tools.datagen import random_rows as port_random_rows

    monkeypatch.setenv("PINOT_TPU_AUDIT_SAMPLE_N", "1")
    schema = _tenant_schema("auditT")
    rows = port_random_rows(schema, 96, seed=1907)
    segs = [build_segment(schema, rows[:48], "auditT_OFFLINE", "audits0"),
            build_segment(schema, rows[48:], "auditT_OFFLINE", "audits1")]
    broker = single_server_broker("auditT_OFFLINE", segs, device="cpu")
    server = broker.local_servers[0]
    auditor = server.auditor
    auditor.budget = audit.SamplerBudget(per_s=1000.0, burst=64.0)
    real, gate, batches = auditor._shadow_in_child, threading.Event(), []

    def shadow_in_child(jobs):
        batches.append(len(jobs))
        if len(batches) == 1:
            gate.wait(20.0)  # the first oracle runs while more samples arrive
        return real(jobs)

    auditor._shadow_in_child = shadow_in_child
    assert not broker.handle_pql(PQL).exceptions
    deadline = time.monotonic() + 20.0
    while not batches and time.monotonic() < deadline:
        time.sleep(0.01)
    assert batches == [1]
    return broker, server, gate, batches


def _wait_for(cond, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def test_the_auditor_forks_once_for_every_queued_sample(monkeypatch):
    """The samples queued while a shadow oracle runs are checked together in
    the next forked child (one fork a batch, not a sample), and every one
    gets its verdict."""
    broker, server, gate, batches = _blocked_auditor(monkeypatch)
    samples = server.metrics.meter("audit.samples")
    try:
        for k in range(8):  # eight different queries: eight samples to check
            assert not broker.handle_pql(f"{PQL[:-len(' GROUP BY dimStr')]} WHERE dimInt > {k * 1000} "
                                         "GROUP BY dimStr").exceptions
        assert len(server.auditor._queue) == 8
        gate.set()
        assert _wait_for(lambda: samples.count == 9), (samples.count, batches)
        assert batches == [1, 8]
        assert len(server.metrics.timer("audit.forkMs").samples()) == 2
        snap = server.auditor.snapshot()
        assert snap["divergences"] == 0 and snap["errors"] == 0 and snap["dropped"] == 0
    finally:
        gate.set()
        broker.shutdown()
        server.shutdown()


def test_a_repeated_answer_waits_once_and_a_wrong_one_still_finds_room(monkeypatch):
    """While an oracle runs, the same answer to the same query queues once
    (the rest are duplicates: their verdicts would be its own), so a closed
    loop of one query never fills the queue; a corrupted answer to it is a
    different sample, is queued, and is caught."""
    from pinot_tpu_torch.common.faults import DeviceFaultInjector

    broker, server, gate, batches = _blocked_auditor(monkeypatch)
    inj = DeviceFaultInjector(seed=1907)
    try:
        for _ in range(40):
            assert not broker.handle_pql(PQL).exceptions
        assert len(server.auditor._queue) == 1
        assert server.metrics.meter("audit.duplicates").count == 39
        server.lane.fault_injector = inj
        inj.corrupt_results(n=1, delta=100.0)
        assert not broker.handle_pql(PQL).exceptions  # served, wrong, no error
        assert len(server.auditor._queue) == 2
        gate.set()
        assert _wait_for(lambda: server.auditor.snapshot()["divergences"] == 1)
        assert batches == [1, 2]
        assert server.executor.audit_quarantined_snapshot()[0]["tier"] == "device"
    finally:
        gate.set()
        server.lane.fault_injector = None
        broker.shutdown()
        server.shutdown()
