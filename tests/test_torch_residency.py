"""The port's residency tiers (``engine/residency.py``, the staging ledger
of ``engine/device.py``, the executor's OOM ladder, the ingest governor's
residency pool), held against the JAX package's ``tests/test_residency.py``
on the same ``make_test_schema()`` segments (MV included).

The reference's ten tests run on the port: snapshot and restore byte
identity, ledger-exact demotion and promotion, promoted tables equal to a
fresh staging, warm -> cold -> reload, pins, nested pins, the entry cap,
concurrent staging racing the cap, a clear and a segment drop.  Then:

- a differential: one sequence of stagings under the same caps gives the
  same tier a segment and the same tier counters in both packages.  The
  tables differ only in their segment names (the same rows), so within a
  package every table has the same bytes and the victim order is decided
  by heat alone, never by a byte ratio that the port's staged dtypes
  (kept divergences 4 and 13) could move;
- the OOM ladder: an allocation failure (``torch.cuda.OutOfMemoryError``
  from the device fault injector, or from staging itself) demotes the
  coldest table and the query answers from the device, equal to the
  reference's answer;
- the governor's residency pool: pause at the high fraction, resume
  under the low one;
- a consuming segment's superseded snapshots leave every tier.
"""
import gc
import os
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from pinot_tpu.engine.device import clear_staging_cache as ref_clear_staging_cache
from pinot_tpu.engine.device import get_staged as ref_get_staged
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.engine.residency import RESIDENCY as REF_RESIDENCY
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.common.faults import DeviceFaultInjector
from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType, Schema, TimeFieldSpec
from pinot_tpu_torch.engine import device as device_mod
from pinot_tpu_torch.engine.device import _ROLE_ATTRS, get_staged
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.engine.residency import restore_staged, snapshot_staged
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.realtime import llc
from pinot_tpu_torch.realtime.backpressure import IngestBackpressure
from pinot_tpu_torch.realtime.stream import MemoryStreamProvider
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.tools.cluster_harness import InProcessCluster

REL, ABS = 1e-9, 2e-5
SCHEMA = make_test_schema(with_mv=True)
COLS = ["dimStr", "dimInt", "metInt", "metDouble", "dimIntMV"]
CPU = torch.device("cpu")


def _ref_segs(table: str, n: int = 200, seed: int = 5):
    rows = random_rows(SCHEMA, n, seed=seed)
    return [ref_build_segment(SCHEMA, rows[: n // 2], table, f"{table}a"),
            ref_build_segment(SCHEMA, rows[n // 2:], table, f"{table}b")]


def _segs(table: str, n: int = 200, seed: int = 5):
    return [segment_from_arrays(**segment_arrays_of(s)) for s in _ref_segs(table, n, seed)]


def _executor(**caps):
    return QueryExecutor(device="cpu", precision="x64", **caps)


def _stage(ex, segs, cols=COLS, pin=False, **roles):
    """``get_staged`` through the executor's cache and manager, as its
    scan section stages."""
    with ex._stage_lock:
        return get_staged(ex._staged, segs, cols, ex.device, ex.precision, residency=ex.residency, pin=pin,
                          **roles)


def _arrays_of(st):
    """Every tensor of a staged table as numpy, keyed (column, role)."""
    out = {(name, attr): getattr(col, attr).numpy()
           for name, col in st.columns.items() for attr, _ in _ROLE_ATTRS if getattr(col, attr) is not None}
    out[("nd", "num_docs_arr")] = st.num_docs_arr.numpy()
    return out


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


# -- the reference's ten (tests/test_residency.py), on the port ------------
def test_snapshot_restore_round_trip_is_byte_identical():
    ex = _executor()
    st = _stage(ex, _segs("rtrip"), raw_columns=["metDouble"])
    before = _arrays_of(st)
    snap, nbytes = snapshot_staged(st)
    assert nbytes == st.nbytes() > 0
    restored = restore_staged(snap, CPU, ex.precision)
    _assert_same_arrays(_arrays_of(restored), before)
    assert restored.token != st.token  # promotion mints a new token
    assert sorted(st.columns) == sorted(restored.columns)
    for name, a in st.columns.items():
        b = restored.columns[name]
        assert (a.stored_type, a.single_value, a.cards, a.card_pad, a.mv_pad) == \
            (b.stored_type, b.single_value, b.cards, b.card_pad, b.mv_pad)


def test_demote_promote_keeps_ledger_exact():
    ex = _executor()
    segs = _segs("ledg")
    st = _stage(ex, segs)
    hot = ex.ledger.total_bytes()
    assert hot == st.nbytes() > 0 and ex.staged_bytes() == hot
    ex.residency.hbm_cap_bytes = 1
    assert ex.residency.enforce() == hot
    assert ex.ledger.total_bytes() == 0 and ex.residency.warm_bytes() == hot and not ex._staged
    ex.residency.hbm_cap_bytes = 0
    st2 = _stage(ex, segs)
    assert st2.token != st.token and ex.ledger.total_bytes() == hot
    assert ex.residency.counter("promotions") == 1 and ex.residency.counter("demotions") == 1
    assert ex.transfers.snapshot() == {"h2dBytes": 2 * hot, "h2dTransfers": 2, "d2hBytes": hot, "d2hTransfers": 1}


def test_promoted_arrays_match_fresh_staging():
    ex = _executor()
    segs = _segs("prom")
    want = _arrays_of(_stage(ex, segs, raw_columns=["metInt"]))
    ex.residency.hbm_cap_bytes = 1
    ex.residency.enforce()
    ex.residency.hbm_cap_bytes = 0
    _assert_same_arrays(_arrays_of(_stage(ex, segs, raw_columns=["metInt"])), want)
    # and a fresh staging by another executor
    _assert_same_arrays(_arrays_of(_stage(_executor(), segs, raw_columns=["metInt"])), want)


def test_warm_spills_cold_and_reloads(tmp_path):
    ex = _executor(residency_dir=str(tmp_path))
    segs = _segs("cold")
    want = _arrays_of(_stage(ex, segs))
    ex.residency.hbm_cap_bytes = ex.residency.host_cap_bytes = 1
    ex.residency.enforce()
    assert ex.residency.counter("coldDemotions") == 1
    assert ex.residency.cold_bytes() > 0 and ex.residency.warm_bytes() == 0
    assert len(list(tmp_path.glob("*.npz"))) == 1
    ex.residency.hbm_cap_bytes = ex.residency.host_cap_bytes = 0
    _assert_same_arrays(_arrays_of(_stage(ex, segs)), want)
    assert ex.residency.counter("coldLoads") == 1 and ex.residency.counter("promotions") == 1
    assert not list(tmp_path.glob("*.npz"))  # the spool file went with the reload


def test_pin_blocks_demotion_until_unpin():
    ex = _executor()
    st = _stage(ex, _segs("pin"), pin=True)
    ex.residency.hbm_cap_bytes = 1
    assert ex.residency.enforce() == 0 and ex.ledger.total_bytes() > 0
    ex.residency.unpin(st.token)
    assert ex.residency.enforce() > 0 and ex.ledger.total_bytes() == 0


def test_pin_refcount_survives_nested_queries():
    ex = _executor()
    segs = _segs("ref")
    st = _stage(ex, segs, pin=True)
    _stage(ex, segs, pin=True)
    assert ex.residency.pin_count(st.token) == 2
    ex.residency.unpin(st.token)
    ex.residency.hbm_cap_bytes = 1
    assert ex.residency.enforce() == 0
    ex.residency.unpin(st.token)
    assert ex.residency.enforce() > 0 and ex.residency.pin_count(st.token) == 0


def test_entry_cap_demotes_coldest_not_clears_all():
    ex = _executor(stage_cache_entries=2)
    tables = [_segs(f"cap{i}", n=60, seed=i) for i in range(4)]
    for segs in tables:
        _stage(ex, segs)
    assert len(ex._staged) <= 2 and ex.residency.counter("demotions") >= 2
    snap = ex.residency.snapshot()
    assert snap["hotTables"] + snap["warmTables"] + snap["coldTables"] == 4
    # the two oldest went warm
    assert ex.residency.segment_tiers("", ["cap0a", "cap1a", "cap2a", "cap3a"]) == \
        {"cap0a": "warm", "cap1a": "warm", "cap2a": "hot", "cap3a": "hot"}


def test_concurrent_staging_races_entry_cap_eviction():
    ex = _executor(stage_cache_entries=2)
    tables = [_segs(f"race{i}", n=60, seed=10 + i) for i in range(5)]
    want_nd = [sum(s.num_docs for s in segs) for segs in tables]
    errors = []

    def worker(idx: int) -> None:
        try:
            for round_ in range(8):
                i = (idx + round_) % len(tables)
                st = _stage(ex, tables[i], pin=True)
                try:
                    if int(st.num_docs_arr.sum()) != want_nd[i]:
                        errors.append(f"docs {int(st.num_docs_arr.sum())} != {want_nd[i]}")
                finally:
                    ex.residency.unpin(st.token)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[:4]
    assert ex.residency.snapshot()["pinnedTokens"] == 0
    assert len(ex._staged) <= 2 + 4
    assert ex.ledger.total_bytes() == sum(st.nbytes() for st in ex._staged.values())


def test_clear_staging_cache_resets_all_tiers():
    ex = _executor()
    segs = _segs("clr")
    _stage(ex, segs)
    ex.residency.hbm_cap_bytes = 1
    ex.residency.enforce()
    assert ex.residency.warm_bytes() > 0
    ex.free_staging()
    snap = ex.residency.snapshot()
    assert snap["hotTables"] == snap["warmTables"] == snap["coldTables"] == 0
    ex.residency.hbm_cap_bytes = 0
    _stage(ex, segs)
    assert ex.residency.counter("promotions") == 0


def test_drop_segment_drops_every_tier():
    ex = _executor()
    segs = _segs("dropseg")
    _stage(ex, segs)
    ex.residency.hbm_cap_bytes = 1
    ex.residency.enforce()
    ex.residency.hbm_cap_bytes = 0
    assert ex.residency.drop_segment(segs[0].segment_name) == 1
    assert ex.residency.warm_bytes() == 0
    _stage(ex, segs)
    assert ex.residency.counter("promotions") == 0
    # the executor's eviction (a replaced or dropped segment) drops a hot set
    ex.evict_segment(segs[1].segment_name)
    assert not ex._staged and ex.ledger.total_bytes() == 0 and ex.residency.snapshot()["hotTables"] == 0


# -- the differential: the same tiers and counters as the reference --------
DIFF_ROWS = random_rows(SCHEMA, 120, seed=41, cardinality=20)
# (table index, touches): stage order; a re-staging of a hot table touches it
DIFF_SEQUENCE = [0, 1, 0, 2, 3, 0, 1, 4, 2, 0, 3, 4, 1]
DIFF_TABLES = 5


def _diff_ref_tables():
    return [[ref_build_segment(SCHEMA, DIFF_ROWS[:60], f"d{i}", f"d{i}a"),
             ref_build_segment(SCHEMA, DIFF_ROWS[60:], f"d{i}", f"d{i}b")] for i in range(DIFF_TABLES)]


@pytest.fixture
def ref_tiers():
    ref_clear_staging_cache()
    yield
    for k in ("PINOT_TPU_HBM_CAP_BYTES", "PINOT_TPU_HOST_CAP_BYTES", "PINOT_TPU_STAGE_CACHE_ENTRIES"):
        os.environ.pop(k, None)
    ref_clear_staging_cache()


@pytest.mark.parametrize("caps", ["entry_cap", "byte_cap", "byte_and_host_cap"])
def test_tiers_and_counters_equal_the_reference(caps, ref_tiers, tmp_path, monkeypatch):
    ref_tables = _diff_ref_tables()
    port_tables = [[segment_from_arrays(**segment_arrays_of(s)) for s in segs] for segs in ref_tables]
    # one table's bytes in each package: every table holds the same rows
    ref_one = ref_get_staged(ref_tables[0], COLS)
    ref_bytes = REF_RESIDENCY.hot_bytes()
    port_one = _stage(_executor(), port_tables[0])
    port_bytes = port_one.nbytes()
    ref_clear_staging_cache()
    del ref_one, port_one
    # caps that hold the same number of tables in both packages
    hot_cap = int(2.5 * max(ref_bytes, port_bytes))
    assert hot_cap < 3 * min(ref_bytes, port_bytes)
    host_cap = int(1.5 * max(ref_bytes, port_bytes))
    assert host_cap < 2 * min(ref_bytes, port_bytes)
    # (entries, HBM bytes, host bytes)
    entry_cap, hbm_cap, host_cap = {"entry_cap": (3, 0, 0), "byte_cap": (32, hot_cap, 0),
                                    "byte_and_host_cap": (32, hot_cap, host_cap)}[caps]
    monkeypatch.setenv("PINOT_TPU_STAGE_CACHE_ENTRIES", str(entry_cap))
    monkeypatch.setenv("PINOT_TPU_HBM_CAP_BYTES", str(hbm_cap))
    monkeypatch.setenv("PINOT_TPU_HOST_CAP_BYTES", str(host_cap))
    monkeypatch.setenv("PINOT_TPU_RESIDENCY_DIR", str(tmp_path / "ref"))
    ex = _executor(stage_cache_entries=entry_cap, hbm_cap_bytes=hbm_cap, host_cap_bytes=host_cap,
                   residency_dir=str(tmp_path / "port"))
    names = [s.segment_name for segs in port_tables for s in segs]
    for step, i in enumerate(DIFF_SEQUENCE):
        ref_get_staged(ref_tables[i], COLS)
        _stage(ex, port_tables[i])
        want = REF_RESIDENCY.segment_tiers("", names)
        assert ex.residency.segment_tiers("", names) == want, (step, i)
    keys = ("demotions", "promotions", "coldDemotions", "coldLoads", "pressureDemotions", "capEvictions")
    want = {k: REF_RESIDENCY.counter(k) for k in keys}
    assert {k: ex.residency.counter(k) for k in keys} == want
    assert want["demotions"] > 0 and want["promotions"] > 0
    if caps == "byte_and_host_cap":
        assert want["coldDemotions"] > 0 and want["coldLoads"] > 0
    # and an OOM heal's demotion picks the same victim
    ref_freed = REF_RESIDENCY.demote_for_pressure()
    assert ex.residency.demote_for_pressure() > 0 and ref_freed > 0
    assert ex.residency.segment_tiers("", names) == REF_RESIDENCY.segment_tiers("", names)


# -- the OOM ladder ---------------------------------------------------------
LADDER_SCHEMA = make_test_schema(with_mv=False)
LADDER_ROWS = random_rows(LADDER_SCHEMA, 600, seed=13)
LADDER_REF = [ref_build_segment(LADDER_SCHEMA, LADDER_ROWS[:300], "lt", "la"),
              ref_build_segment(LADDER_SCHEMA, LADDER_ROWS[300:], "lt", "lb")]
LADDER_QUERY = "SELECT sum(metInt), count(*) FROM lt GROUP BY dimStr TOP 10"
OTHER_QUERY = "SELECT max(metDouble), min(metFloat) FROM lt WHERE dimInt > 5"


def _reference_payload(pql):
    req = ref_optimize(ref_parse(pql))
    return canonical_payload(req, RefExecutor().execute(LADDER_REF, req))


@pytest.mark.parametrize("where", ["launch", "staging"])
def test_an_oom_demotes_and_answers_from_the_device(where, monkeypatch):
    """A CUDA allocation failure on the first attempt (at the launch,
    through the device fault injector; or inside staging) demotes the
    coldest unpinned table, and the retry answers from the device: one
    ``heal.resourceExhausted`` with the freed bytes, no host failover."""
    inj = DeviceFaultInjector()
    server = ServerInstance("oom", device="cpu", device_fault_injector=inj, bitsliced=False)
    try:
        segs = [segment_from_arrays(**segment_arrays_of(s)) for s in LADDER_REF]
        ex = server.executor
        other = optimize_request(parse_pql(OTHER_QUERY))
        ex.execute(segs, other)  # a second hot table, the victim
        before = dict(ex.residency.counters)
        if where == "launch":
            inj.alloc_fail_next(1)
        else:
            real = device_mod.stage_segments
            calls = []

            def failing(*a, **k):
                calls.append(1)
                if len(calls) == 1:
                    raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
                return real(*a, **k)

            monkeypatch.setattr(device_mod, "stage_segments", failing)
        req = optimize_request(parse_pql(LADDER_QUERY))
        res = ex.execute(segs, req)
        heal = ex.healing_stats()
        assert res._served_tier == "device" and not res.cost.get("segmentsHost")
        assert heal["resourceExhausted"] == 1 and heal["hostFailovers"] == 0 and heal["poisonedPlans"] == 0
        assert ex.residency.counters["pressureDemotions"] == before["pressureDemotions"] + 1
        assert ex.residency.segment_tiers("", ["la"]) == {"la": "hot"}
        assert ex.residency.snapshot()["warmTables"] == 1  # the other query's table
        if where == "launch":
            assert [r.outcome for r in inj.launches][-2:] == ["alloc_fail", "ok"]
        got = strip_accounting(reduce_to_response(req, [res]).to_json())
        assert payloads_equivalent(got, _reference_payload(LADDER_QUERY), rel_tol=REL, abs_tol=ABS)
        # the demoted table promotes back for its own query, equal again
        again = ex.execute(segs, other)
        assert again._served_tier == "device" and ex.residency.counter("promotions") >= 1
        got = strip_accounting(reduce_to_response(other, [again]).to_json())
        assert payloads_equivalent(got, _reference_payload(OTHER_QUERY), rel_tol=REL, abs_tol=ABS)
    finally:
        server.shutdown()


def test_a_demoted_table_is_freed_at_once():
    """A demotion frees the table's tensors at once, with the garbage
    collector off: no reference cycle (the planner's recursive filter
    encoder) and no lane thread's frame (the last dispatch, the
    watchdog's in-flight record) keeps them, so an OOM heal's demotion
    makes room on the card before its retry."""
    server = ServerInstance("free", device="cpu", bitsliced=False)
    ex = server.executor
    gc.collect()
    gc.disable()
    try:
        segs = [segment_from_arrays(**segment_arrays_of(s)) for s in LADDER_REF]
        for pql in (LADDER_QUERY, OTHER_QUERY):
            assert ex.execute(segs, optimize_request(parse_pql(pql)))._served_tier == "device"
        refs = [weakref.ref(t) for st in ex._staged.values() for c in st.columns.values() for t in c.tensors()]
        assert len(ex._staged) == 2 and refs
        ex.residency.hbm_cap_bytes = 1
        ex.residency.enforce()
        assert ex.residency.snapshot()["warmTables"] == 2
        end = time.monotonic() + 5.0  # the lane thread may still be finishing its last delivery
        while any(r() is not None for r in refs) and time.monotonic() < end:
            time.sleep(0.01)
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
        server.shutdown()


def test_the_injector_raises_cuda_out_of_memory():
    inj = DeviceFaultInjector()
    inj.alloc_fail_next(1)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        inj.on_launch("d", ("k",))


# -- the ingest governor's residency pool -----------------------------------
class _Tiers:
    def __init__(self, cap):
        self.hbm_cap_bytes = cap
        self.hot = 0.0

    def pressure(self):
        return self.hot / self.hbm_cap_bytes if self.hbm_cap_bytes > 0 else 0.0


def test_governor_residency_pool_pauses_high_and_resumes_low():
    tiers = _Tiers(1000)
    gov = IngestBackpressure(hbm_high_bytes=0, mutable_high_bytes=0, poll_interval_s=0.0, residency=tiers)
    assert gov.enabled and gov.consume_allowed()
    tiers.hot = 960  # 0.96 >= 0.95
    assert not gov.consume_allowed() and "residency pressure" in gov.reason
    tiers.hot = 850  # between the fractions: still paused
    assert not gov.consume_allowed()
    tiers.hot = 790  # <= 0.8: resumed
    assert gov.consume_allowed()
    snap = gov.snapshot()
    assert (snap["pauses"], snap["resumes"]) == (1, 1)
    assert snap["watermarks"]["residencyHighFrac"] == 0.95 and snap["watermarks"]["residencyLowFrac"] == 0.8
    # without a cap the pool is off
    tiers.hbm_cap_bytes = 0
    assert not gov.enabled


def test_governor_reads_a_servers_residency_pressure():
    server = ServerInstance("gov", device="cpu", hbm_cap_bytes=1 << 40)
    try:
        gov = server.ingest_backpressure
        assert gov.enabled and gov._residency is server.executor.residency
        assert server.status()["residency"]["hbmCapBytes"] == 1 << 40
        assert server.metrics.gauge("residency.pressure").value == 0.0
    finally:
        server.shutdown()


# -- superseded snapshots of a consuming segment ----------------------------
def test_superseded_snapshots_leave_every_tier(tmp_path, monkeypatch):
    """Many watermarks of one consuming segment under a one-entry cap: each
    newer snapshot drops the older one's set from every tier (the reference
    would demote it to the warm tier, where it would stay), so one hot set
    remains and nothing is warm or cold."""
    monkeypatch.setenv("PINOT_TPU_STAGE_CACHE_ENTRIES", "1")
    cluster = InProcessCluster(num_servers=1, data_dir=str(tmp_path), device="cpu")
    try:
        stream = MemoryStreamProvider(1)
        schema = Schema("meetupRsvp", dimensions=[FieldSpec("venue_name", DataType.STRING)],
                        metrics=[FieldSpec("rsvp_count", DataType.INT, FieldType.METRIC)],
                        time_field=TimeFieldSpec("mtime", DataType.LONG, time_unit="MILLISECONDS"))
        physical = cluster.add_realtime_table(schema, stream, rows_per_segment=100_000)
        for i in range(400):
            stream.produce({"venue_name": f"venue{i % 7}", "rsvp_count": i % 9, "mtime": 1_000_000 + i},
                           partition=0)
        ex = cluster.servers[0].executor
        assert ex.residency.stage_cache_entries == 1
        dm = cluster.controller.realtime_manager.consumers_of(llc.make_segment_name(physical, 0, 0))[0]
        for step in range(12):
            dm.consume_step(max_rows=31)
            assert not cluster.query("SELECT sum(rsvp_count) FROM meetupRsvp GROUP BY venue_name").exceptions
            snap = ex.residency.snapshot()
            assert (snap["hotTables"], snap["warmTables"], snap["coldTables"]) == (1, 0, 0), (step, snap)
        assert ex.residency.counter("demotions") == 0
        assert ex.ledger.evictions >= 11  # each superseded set left the ledger
    finally:
        cluster.stop()
