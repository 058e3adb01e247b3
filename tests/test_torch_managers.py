"""The controller's periodic managers, its roll-ups, REST routes and
dashboard pages in the port against the JAX package.

Each manager's ``run_once`` on the reference's cases (``tests/
test_stabilizer.py``, ``test_controller.py``, ``test_audit.py``,
``test_disaster_recovery.py``): retention with zero, negative and real
windows, with missing metadata and with a delete racing its snapshot;
the status checker's counts; the validation repair; the cross-replica
CRC sweep; the deep-store scrubber restoring a corrupt copy from a
donor's bytes with its CRC, and requeueing a suspect its budget denied.
A stopped manager leaves no thread.  The routes (``/debug/capacity``,
``/debug/slo``, ``/debug/stabilizer`` ...) and the dashboard's pages
answer with the reference's keys.
"""
import importlib
import json
import os
import time
import urllib.request

import pytest

from pinot_tpu.tools.datagen import make_test_schema, random_rows

PKGS = ["pinot_tpu", "pinot_tpu_torch"]
PKG = pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
REF_SCHEMA = make_test_schema(with_mv=False)


def M(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _dev(pkg: str) -> dict:
    return {"device": "cpu"} if pkg == "pinot_tpu_torch" else {}


def _schema(pkg: str):
    return M(pkg, "common.schema").Schema.from_json(REF_SCHEMA.to_json())


def _cluster(pkg: str, path, num_servers: int = 1, **kwargs):
    return M(pkg, "tools.cluster_harness").InProcessCluster(
        num_servers=num_servers, data_dir=str(path), **kwargs, **_dev(pkg))


def _both(tmp_path, fn):
    return {pkg: fn(pkg, tmp_path / pkg) for pkg in PKGS}


# ------------------------------------------------------- lifecycle
@PKG
def test_manager_stop_joins_its_thread_and_counts_failures(pkg):
    managers = M(pkg, "controller.managers")

    class _Tick(managers._PeriodicManager):
        def __init__(self):
            super().__init__(0.005)
            self.runs = 0

        def run_once(self):
            self.runs += 1

    class _Boom(managers._PeriodicManager):
        def run_once(self):
            raise RuntimeError("boom")

    tick, boom = _Tick(), _Boom(0.005)
    tick.start()
    boom.start()
    meter = boom.metrics.meter("manager._Boom.failures")
    deadline = time.monotonic() + 5
    while (tick.runs == 0 or meter.count < 2) and time.monotonic() < deadline:
        time.sleep(0.005)
    tick.stop()
    boom.stop()
    assert tick.runs >= 1 and not tick._thread.is_alive()
    assert meter.count >= 2  # counted, not only logged
    assert managers.leaked_manager_threads() == []


@PKG
def test_a_controller_with_managers_stops_them_all(pkg, tmp_path):
    """``start_managers=True`` (what ``StartController`` runs) starts the
    five managers and the stabilizer on their threads; ``stop`` joins
    every one of them."""
    ctrl = M(pkg, "controller.controller").Controller(str(tmp_path), start_managers=True)
    threads = [m._thread for m in (ctrl.retention_manager, ctrl.validation_manager, ctrl.status_checker,
                                   ctrl.crc_audit, ctrl.deepstore_scrubber, ctrl.stabilizer)]
    assert all(t is not None and t.is_alive() for t in threads)
    assert ctrl.validation_manager.realtime_manager is ctrl.realtime_manager
    assert ctrl.resources.report_store_suspect == ctrl.deepstore_scrubber.report_suspect
    ctrl.stop()
    assert M(pkg, "controller.managers").leaked_manager_threads() == []


# ------------------------------------------------------- retention
def _retention_cluster(pkg, path, value):
    sm = M(pkg, "common.schema")
    tc = M(pkg, "common.tableconfig")
    cluster = _cluster(pkg, path)
    schema = sm.Schema("rt", metrics=[sm.FieldSpec("m", sm.DataType.INT, sm.FieldType.METRIC)],
                       time_field=sm.TimeFieldSpec("days", sm.DataType.INT, time_unit="DAYS"))
    cluster.controller.add_schema(schema)
    physical = cluster.controller.add_table(tc.TableConfig(
        table_name="rt", retention=tc.RetentionConfig(retention_time_unit="DAYS", retention_time_value=value)))
    return cluster, schema, physical


def _retention(pkg, path):
    build = M(pkg, "segment.builder").build_segment
    out = {}
    now_days = int(time.time() // 86400)
    for value in (0, -5, 30):
        cluster, schema, physical = _retention_cluster(pkg, path / str(value), value)
        try:
            cluster.upload(physical, build(schema, [{"m": 1, "days": now_days - 100}], physical, "old"))
            cluster.upload(physical, build(schema, [{"m": 2, "days": now_days}], physical, "fresh"))
            before = cluster.query("SELECT count(*) FROM rt").num_docs_scanned
            cluster.controller.retention_manager.run_once()
            out[value] = (before, sorted(cluster.controller.resources.segments_of(physical)),
                          cluster.query("SELECT count(*) FROM rt").num_docs_scanned,
                          cluster.controller.store.exists(physical, "old"))
        finally:
            cluster.stop()
    return out


def test_retention_windows(tmp_path):
    """A zero or negative window never deletes; a 30-day window deletes
    the 100-day-old segment, its store copy and its docs."""
    got = _both(tmp_path, _retention)
    port = got["pinot_tpu_torch"]
    assert port[0] == port[-5] == (2, ["fresh", "old"], 2, True)
    assert port[30] == (2, ["fresh"], 1, False)
    assert port == got["pinot_tpu"]


def _retention_edges(pkg, path):
    cluster, schema, physical = _retention_cluster(pkg, path, 30)
    try:
        res = cluster.controller.resources
        cluster.controller.retention_manager.run_once()  # an empty table
        cluster.controller.status_checker.run_once()
        empty = cluster.controller.status_checker.metrics.snapshot()["gauges"]
        with res._lock:  # a ghost ideal-state entry with no metadata record
            res.ideal_states[physical]["ghost"] = {"server0": "ONLINE"}
        cluster.controller.retention_manager.run_once()
        cluster.controller.status_checker.run_once()
        ghost = cluster.controller.status_checker.metrics.snapshot()["gauges"]
        return {"empty": {k: v for k, v in empty.items() if k.startswith(physical)},
                "ghostKept": "ghost" in res.segments_of(physical),
                "ghost": {k: v for k, v in ghost.items() if k.startswith(physical)}}
    finally:
        cluster.stop()


def test_retention_and_status_edges(tmp_path):
    got = _both(tmp_path, _retention_edges)
    port = got["pinot_tpu_torch"]
    assert port["empty"] == {"rt_OFFLINE.percentSegmentsAvailable": 100.0, "rt_OFFLINE.segmentCount": 0}
    assert port["ghostKept"] and port["ghost"]["rt_OFFLINE.segmentCount"] == 1
    assert port == got["pinot_tpu"]


@PKG
def test_retention_tolerates_a_delete_racing_its_snapshot(pkg, tmp_path, monkeypatch):
    cluster, schema, physical = _retention_cluster(pkg, tmp_path, 30)
    build = M(pkg, "segment.builder").build_segment
    try:
        now_days = int(time.time() // 86400)
        cluster.upload(physical, build(schema, [{"m": 1, "days": now_days - 100}], physical, "old"))
        cluster.upload(physical, build(schema, [{"m": 2, "days": now_days}], physical, "fresh"))
        res = cluster.controller.resources
        orig = res.segments_of

        def racy(table):
            segs = orig(table)
            if "old" in segs:  # a delete after the snapshot
                cluster.controller.delete_segment(physical, "old")
            return segs

        monkeypatch.setattr(res, "segments_of", racy)
        cluster.controller.retention_manager.run_once()
        monkeypatch.undo()
        assert res.segments_of(physical) == ["fresh"]
    finally:
        cluster.stop()


# ------------------------------------------------ status / validation
def _offline(pkg, path, num_servers=1, replication=1, segments=2, docs=50):
    cluster = _cluster(pkg, path, num_servers)
    schema = _schema(pkg)
    physical = cluster.add_offline_table(schema, replication=replication)
    rows = random_rows(REF_SCHEMA, docs, seed=6)
    build = M(pkg, "segment.builder").build_segment
    for i in range(segments):
        cluster.upload(physical, build(schema, rows, physical, f"v{i}"))
    return cluster, physical


def _status_and_validation(pkg, path):
    cluster, physical = _offline(pkg, path)
    try:
        res = cluster.controller.resources
        cluster.controller.status_checker.run_once()
        out = {"full": cluster.controller.status_checker.metrics.snapshot()["gauges"][
            f"{physical}.percentSegmentsAvailable"]}
        # one server lost v0 (a restart without its disk): the checker sees
        # half the segments; the validation repair reloads it
        cluster.servers[0].remove_segment(physical, "v0")
        with res._lock:
            res.external_views[physical]["v0"]["server0"] = "OFFLINE"
        cluster.controller.status_checker.run_once()
        out["half"] = cluster.controller.status_checker.metrics.snapshot()["gauges"][
            f"{physical}.percentSegmentsAvailable"]
        cluster.controller.validation_manager.run_once()
        vm = cluster.controller.validation_manager.metrics.snapshot()["gauges"]
        out["missing"] = vm[f"{physical}.missingReplicas"]
        out["view"] = res.get_external_view(physical)
        out["count"] = cluster.query("SELECT count(*) FROM testTable").num_docs_scanned
        return out
    finally:
        cluster.stop()


def test_status_checker_and_validation_repair(tmp_path):
    got = _both(tmp_path, _status_and_validation)
    port = got["pinot_tpu_torch"]
    assert (port["full"], port["half"], port["missing"], port["count"]) == (100.0, 50.0, 1, 100)
    assert port == got["pinot_tpu"]


# --------------------------------------------------------- CRC sweep
def _crc_sweep(pkg, path):
    cluster = _cluster(pkg, path, 2)
    try:
        schema = _schema(pkg)
        physical = cluster.add_offline_table(schema, replication=2)
        rows = random_rows(REF_SCHEMA, 120, seed=7)
        build = M(pkg, "segment.builder").build_segment
        cluster.upload(physical, build(schema, rows[:60], physical, "s1"))
        cluster.upload(physical, build(schema, rows[60:], physical, "s2"))
        for name, inst in cluster.controller.resources.instances.items():
            if inst.role == "server":
                inst.url = f"inproc://{name}"
        claims = {s.name: dict(s.segment_crcs()["segments"]) for s in cluster.servers}
        mgr = M(pkg, "controller.managers").CrcAuditManager(
            cluster.controller.resources, crc_fn=lambda name, url: claims[name])
        mgr.run_once()
        clean = mgr.snapshot()
        claims["server0"] = {physical: dict(claims["server0"][physical], s1=0xBAD)}
        mgr.run_once()
        dirty = mgr.snapshot()
        mgr.stop()
        return {"claims": claims, "clean": clean, "dirty": dirty,
                "gauge": mgr.metrics.gauge("audit.crcMismatches").value}
    finally:
        cluster.stop()


def test_crc_audit_finds_a_diverging_replica(tmp_path):
    """The sweep compares every replica's claimed CRC with the others and
    the registered one: none on a clean cluster, one evidence row after
    one replica's claim for s1 is corrupted."""
    got = _both(tmp_path, _crc_sweep)
    port = got["pinot_tpu_torch"]
    assert port["clean"]["mismatches"] == [] and port["clean"]["segmentsChecked"] == 2
    assert len(port["dirty"]["mismatches"]) == 1 and port["gauge"] == 1
    assert port["dirty"]["mismatches"][0]["replicaCrcs"]["server0"] == 0xBAD
    assert port == got["pinot_tpu"]


# ------------------------------------------------------ deep store
class _NoTables:
    def tables(self):
        return []

    def get_ideal_state(self, table):
        return {}

    def get_segment_metadata(self, table, segment):
        return {}


class _OneSegment:
    def tables(self):
        return ["t_OFFLINE"]

    def get_ideal_state(self, table):
        return {"seg0": {"server0": "ONLINE"}}

    def get_external_view(self, table):
        return {"seg0": {"server0": "ONLINE"}}

    def get_segment_metadata(self, table, segment):
        return {}

    def instances_snapshot(self):
        class _I:
            name, url, role, alive = "server0", "inproc://server0", "server", True

        return [_I()]


def _scrub(pkg, path):
    store = M(pkg, "controller.store").SegmentStore(str(path / "segments"))
    seg = M(pkg, "tools.datagen").synthetic_lineitem_segment(300, seed=11, name="seg0")
    seg.metadata.custom["dataCrc"] = True  # a verifiable claim, as build_segment stamps it
    seg.metadata.crc = seg.compute_crc()
    M(pkg, "segment.format").write_segment(seg, store.segment_dir("t_OFFLINE", "seg0"))
    fpath = store.segment_file_path("t_OFFLINE", "seg0")
    with open(fpath, "rb") as f:
        good = f.read()
    with open(fpath, "r+b") as f:
        f.seek(-16, os.SEEK_END)
        f.write(b"\xde\xad\xbe\xef" * 4)
    budget = M(pkg, "utils.audit").SamplerBudget
    scrub = M(pkg, "controller.managers").DeepStoreScrubber(
        _OneSegment(), store, budget=budget(per_s=1000.0, burst=100.0), copy_fn=lambda *a: good)
    scrub.run_once()
    snap = scrub.snapshot()
    store.verify_copy("t_OFFLINE", "seg0")  # the healed copy passes its CRC
    with open(fpath, "rb") as f:
        restored = f.read() == good
    denied = M(pkg, "controller.managers").DeepStoreScrubber(_NoTables(), None, budget=budget(per_s=0.0))
    denied.report_suspect("t", "seg0", source="server1")
    denied.run_once()
    return {"snap": {k: snap[k] for k in ("corruptCopies", "repairs", "copiesChecked", "repairFailures")},
            "donor": snap["evidence"][0]["repairedFrom"], "restored": restored,
            "denied": {k: denied.snapshot()[k] for k in ("budgetDenied", "copiesChecked", "suspectsPending")}}


def test_deep_store_scrubber_restores_a_corrupt_copy(tmp_path):
    """Rot in the store's copy is found and repaired with a donor's bytes,
    which pass the registered CRC; a suspect its budget denies stays
    queued for the next round."""
    got = _both(tmp_path, _scrub)
    port = got["pinot_tpu_torch"]
    assert port["snap"]["corruptCopies"] == port["snap"]["repairs"] == 1 and port["restored"]
    assert port["denied"] == {"budgetDenied": 1, "copiesChecked": 0, "suspectsPending": 1}
    assert port == got["pinot_tpu"]


@PKG
def test_a_server_donates_only_verified_sealed_copies(pkg, tmp_path):
    """``segment_copy_bytes`` gives a loaded sealed segment's file bytes
    (the scrubber's donor) and None for a segment not hosted."""
    cluster, physical = _offline(pkg, tmp_path, segments=1)
    try:
        s = cluster.servers[0]
        data = s.segment_copy_bytes(physical, "v0")
        assert data and s.segment_copy_bytes(physical, "nope") is None
        d = tmp_path / "donated"
        d.mkdir()
        (d / M(pkg, "segment.format").SEGMENT_FILE_NAME).write_bytes(data)
        assert M(pkg, "segment.format").read_segment(str(d)).num_docs == 50
        assert s.segment_crcs()["segments"][physical]["v0"] == int(
            cluster.controller.resources.get_segment_metadata(physical, "v0")["metadata"].crc)
    finally:
        cluster.stop()


# ------------------------------------------------------- roll-ups
@PKG
def test_skew_inputs_from_the_roll_ups(pkg):
    ctl = M(pkg, "controller.controller")
    capacity = {"tables": {"a": {"docsScannedRate1m": 12.5}, "b": {"docsScannedRate1m": "x"}},
                "servers": {"s0": {"residency": {"pressure": 0.75}}, "s1": {"residency": {}}, "s2": {}}}
    util = {"servers": {"s0": {"device": {"occupancy": {"busyFraction": 0.25}}}, "s1": {"device": {}}}}
    assert ctl.cost_rates_from_capacity(capacity) == {"a": 12.5}
    assert ctl.tier_pressure_from_capacity(capacity) == {"s0": 0.75}
    assert ctl.busy_from_utilization(util) == {"s0": 0.25, "s1": 0.0}


# ------------------------------------------------ routes and pages
_ROUTES = ["/debug/capacity", "/debug/slo", "/debug/stabilizer", "/debug/clustermetrics", "/debug/audit",
           "/debug/deepstore", "/debug/flightrec", "/debug/metrics", "/tenants"]
_PAGES = ["/", "/dashboard/query", "/dashboard/metrics", "/dashboard/capacity", "/dashboard/workload",
          "/dashboard/utilization", "/dashboard/slo"]


def _routes_and_pages(pkg, path):
    cluster = _cluster(pkg, path, 1, http=True)
    schema = _schema(pkg)
    physical = cluster.add_offline_table(schema)
    cluster.upload(physical, M(pkg, "segment.builder").build_segment(
        schema, random_rows(REF_SCHEMA, 30, seed=8), physical, "dash1"))
    http = M(pkg, "controller.controller").ControllerHttpServer(cluster.controller)
    http.start()
    base = f"http://127.0.0.1:{http.port}"
    out = {"keys": {}, "pages": {}}
    try:
        for route in _ROUTES:
            with urllib.request.urlopen(base + route, timeout=10) as r:
                out["keys"][route] = sorted(json.loads(r.read()))
        for page in _PAGES + [f"/dashboard/table/{physical}"]:
            with urllib.request.urlopen(base + page, timeout=10) as r:
                out["pages"][page] = (r.status, r.headers["Content-Type"])
                body = r.read().decode()
            if page == "/":
                out["homeHasTable"] = physical in body and "server0" in body
            if page.startswith("/dashboard/table/"):
                out["tableHasSegment"] = "dash1" in body and "dimStr" in body
        req = urllib.request.Request(base + "/pql", data=json.dumps({"pql": "SELECT count(*) FROM testTable"}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            out["pql"] = json.loads(r.read())["numDocsScanned"]
        with urllib.request.urlopen(base + "/debug/capacity", timeout=10) as r:
            cap = json.loads(r.read())
        out["capacityTotals"] = sorted(cap["totals"])
        return out
    finally:
        http.stop()
        cluster.stop()


def test_routes_and_dashboard_pages(tmp_path):
    """Every roll-up route answers with the reference's keys, every
    dashboard page answers 200 as HTML, and the query console's ``/pql``
    proxy reaches the broker."""
    got = _both(tmp_path, _routes_and_pages)
    port = got["pinot_tpu_torch"]
    assert all(status == 200 and ctype.startswith("text/html") for status, ctype in port["pages"].values())
    assert port["homeHasTable"] and port["tableHasSegment"] and port["pql"] == 30
    assert port == got["pinot_tpu"]
