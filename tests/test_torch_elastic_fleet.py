"""The port's elastic-fleet scenario and the ingest pool's live resize on
the CPU, the twin of ``tests/test_elastic_fleet.py``'s scenario and pool
cases and of ``tests/test_audit.py``'s freshness gauge across a rollover
and a resize.

The scenario (16 tables for the smoke, 104 for the acceptance) is held to
the reference test's assertions, and its table count and realtime rows
served to the JAX package's scenario on the same parameters."""
import threading
import time

import pytest

from pinot_tpu.tools.cluster_harness import run_elastic_fleet_scenario as ref_run_elastic_fleet_scenario

from pinot_tpu_torch.broker.freshness import WATERMARKS, now_ms
from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType, Schema, TimeFieldSpec
from pinot_tpu_torch.realtime.llc import make_segment_name
from pinot_tpu_torch.realtime.pool import IngestConsumerPool, leaked_pool_threads
from pinot_tpu_torch.realtime.stream import MemoryStreamProvider
from pinot_tpu_torch.tools.cluster_harness import InProcessCluster, run_elastic_fleet_scenario
from pinot_tpu_torch.tools.datagen import make_test_schema, random_rows


def _wait(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


@pytest.mark.chaos
@pytest.mark.parametrize("num_tables", [16, 104])
def test_elastic_fleet_scenario(tmp_path, num_tables):
    """No failed query, coverage never lost, the restart interrupting a
    rebalance in flight that the new controller finishes, every realtime
    row served once, one committed copy a sequence, the final imbalance
    under the skew threshold; the rows and tables the reference's scenario
    reports on the same parameters."""
    out = run_elastic_fleet_scenario(num_tables=num_tables, data_dir=str(tmp_path / "port"), device="cpu")
    assert out["failedQueries"] == 0, out.get("failures")
    assert out["oneCommittedCopyPerSequence"]
    assert out["coverageNeverLost"]
    assert out["okQueries"] > 0
    assert out["movesStartedBeforeRestart"] > 0
    assert out["pendingMovesAtRestart"] > 0 or out["surplusReplicasAtRestart"] > 0
    assert out["movesCompletedAfterRestart"] > 0
    assert out["rtRowsServed"] == [out["rtRowsExpected"]] * len(out["rtRowsServed"])
    assert out["finalImbalanceRatio"] < out["skewRatioThreshold"]
    assert out["ingestPool"]["a"]["workers"] == out["ingestPool"]["b"]["workers"] == 4

    ref = ref_run_elastic_fleet_scenario(num_tables=num_tables, data_dir=str(tmp_path / "ref"))
    assert ref["failedQueries"] == 0, ref.get("failures")
    for key in ("tables", "servers", "rtRowsExpected", "rtRowsServed", "skewRatioThreshold"):
        assert out[key] == ref[key], key


class _ScriptedConsumer:
    """step() pops scripted return values and records the threads that ran it
    (a shrink's new workers reuse the old names)."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = 0
        self.threads = set()

    def step(self):
        self.calls += 1
        self.threads.add(threading.current_thread())
        return self.script.pop(0) if self.script else None


def test_pool_live_resize():
    """Growing starts workers at once, shrinking retires the surplus at
    their next wake-up while the consumer keeps being driven; a stopped
    pool leaves no worker behind, the retired ones included."""
    pool = IngestConsumerPool(workers=1, name="t5")
    c = _ScriptedConsumer([0.05] * 40 + [None])
    pool.add(c, key="c")
    assert _wait(lambda: c.calls >= 2)
    pool.resize(3)
    assert pool.snapshot()["workers"] == 3
    assert _wait(lambda: sum(t.is_alive() for t in pool._threads) == 3)
    pool.resize(1)
    assert pool.snapshot()["workers"] == 1
    assert _wait(lambda: c.calls >= 5)  # still driven after the shrink
    assert _wait(lambda: not any(t.is_alive() for t in pool._retired))
    assert len(c.threads) >= 2  # a worker of the new generation took over
    pool.resize(1)  # the same count: nothing changes
    assert pool.snapshot()["workers"] == 1
    pool.stop()
    assert leaked_pool_threads(grace_s=2.0) == []


def _fresh_schema(name: str) -> Schema:
    return Schema(name, dimensions=[FieldSpec("d", DataType.STRING)],
                  metrics=[FieldSpec("m", DataType.INT, FieldType.METRIC)],
                  time_field=TimeFieldSpec("ts", DataType.LONG, time_unit="MILLISECONDS"))


def test_freshness_gauge_survives_rollover_and_pool_resize(tmp_path):
    """The per-(table, partition) ``freshness.lag`` gauge is one continuous
    series: a segment's rollover hands it to the successor consumer, and a
    resize of the ingest pool does not detach it."""
    cluster = InProcessCluster(num_servers=1, data_dir=str(tmp_path), device="cpu")
    stream = MemoryStreamProvider(num_partitions=1)
    physical = cluster.add_realtime_table(_fresh_schema("freshRoll"), stream, rows_per_segment=50)
    pool = IngestConsumerPool(workers=2, name="auditFreshPool")
    try:
        t0 = now_ms()
        for i in range(60):
            stream.produce({"d": "x", "m": i, "ts": int(t0 - 30_000 + i)})
        dm = cluster.controller.realtime_manager.consumers_of(make_segment_name(physical, 0, 0))[0]
        dm.consume_step(max_rows=1000)
        gauge = cluster.servers[0].metrics.gauge(f"freshness.lag.{physical}.p0")
        assert isinstance(gauge.value, (int, float)) and gauge.value > 0

        # the rollover: seq 0 commits, seq 1 consumes under the same series
        assert dm.threshold_reached
        dm.try_commit()
        dm1 = cluster.controller.realtime_manager.consumers_of(make_segment_name(physical, 0, 1))[0]
        assert isinstance(gauge.value, (int, float)) and gauge.value > 0

        # the successor driven by the pool, then the pool resized: the
        # watermark keeps advancing and the gauge stays attached
        pool.add(dm1, key=("freshRoll", 0))
        for m, age_ms, bound_ms in ((1, 3_000, 4_000), (2, 1_000, 2_000)):
            if m == 2:
                pool.resize(1)
            stream.produce({"d": "y", "m": m, "ts": int(now_ms() - age_ms)})
            pool.kick()
            assert _wait(lambda: (WATERMARKS.get(physical, 0) or 0) >= t0 - bound_ms, timeout_s=10.0)
        assert isinstance(gauge.value, (int, float)) and 0 < gauge.value < 60_000
    finally:
        pool.stop()
        cluster.stop()
        WATERMARKS.drop_table(physical)


def test_lag_gauges_continuous_across_rollover_and_resize(tmp_path):
    """Two partitions on one server, driven by the pool: partition 0's
    rollover binds the same ``ingest.lag.<table>.p0`` series to the
    successor's probe, partition 1's is untouched, a stale detach is a
    no-op, and a live resize keeps every binding."""
    cluster = InProcessCluster(num_servers=1, data_dir=str(tmp_path), device="cpu")
    rm = cluster.controller.realtime_manager
    pool = IngestConsumerPool(workers=2, name="lagtest")
    rm.ingest_pool = pool
    try:
        schema = make_test_schema(with_mv=False)
        schema.schema_name = "lagT"
        stream = MemoryStreamProvider(num_partitions=2)
        physical = cluster.add_realtime_table(schema, stream, rows_per_segment=50)
        rows = random_rows(schema, 70, seed=5)
        for row in rows:
            stream.produce(row, partition=0)  # 70 rows: one roll and 20
        for row in rows[:30]:
            stream.produce(row, partition=1)  # 30 rows: no roll
        server = cluster.servers[0]
        seg01 = make_segment_name(physical, 0, 1)
        assert _wait(lambda: bool(rm.consumers_of(seg01)) and rm.consumers_of(seg01)[0].offset == 70,
                     timeout_s=15.0), "partition 0 did not roll"
        pool.resize(1)
        pool.resize(3)
        dms1 = rm.consumers_of(make_segment_name(physical, 1, 0))
        assert _wait(lambda: dms1[0].offset == 30, timeout_s=10.0)

        g0 = server.metrics.gauge(f"ingest.lag.{physical}.p0")
        g1 = server.metrics.gauge(f"ingest.lag.{physical}.p1")
        successor = rm.consumers_of(seg01)[0]
        assert g0._fn is successor._lag_probe
        assert g1._fn is dms1[0]._lag_probe
        assert g0.value == 0 and g1.value == 0
        assert rm.consumers_of(make_segment_name(physical, 0, 0)) == []
        bound = g0._fn
        g0.clear_fn(lambda: 999)  # a stale detach with a foreign probe
        assert g0._fn is bound
        resp = cluster.query("SELECT count(*) FROM lagT")
        assert resp.num_docs_scanned == 100 and not resp.exceptions
    finally:
        pool.stop()
        cluster.stop()
