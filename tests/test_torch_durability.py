"""The controller's durable state in the port against the JAX package:
the same calls on both, the same records after a restart.

A controller over a ``data_dir`` keeps schemas, table configs, ideal
states and segment records (the LLC offset checkpoints among them) in a
journaled property store, so a fresh controller over the same directory
recovers the cluster; re-registering servers replay the ideal state and
reload their segments, and a realtime table resumes consuming from its
committed offsets.  Before the port had the store, a restarted port
controller recovered no table and no schema
(``test_restart_recovers_what_the_reference_recovers``).

Also: ``delete_table`` clears the store; a store written by either
package opens in the other with the same records; a zombie controller's
write raises ``StaleEpochError``; the journal's frames, snapshots and
fence, and ``ServingLease.remaining_s`` / ``expire``.  The port runs
with ``device="cpu"``; answers are compared with ``payloads_equivalent``
after ``strip_accounting``.
"""
import importlib
import json

import pytest

from pinot_tpu.tools.datagen import make_test_schema, random_rows

PKGS = ["pinot_tpu", "pinot_tpu_torch"]
PKG = pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
TABLE = "testTable"
REF_SCHEMA = make_test_schema(with_mv=False)
ROWS = random_rows(REF_SCHEMA, 300, seed=17)
GROUPS = "SELECT sum(metInt), count(*) FROM testTable GROUP BY dimStr TOP 10"


def M(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _schema(pkg: str):
    return M(pkg, "common.schema").Schema.from_json(REF_SCHEMA.to_json())


class _Servers:
    """Servers of either package; the port's run on the CPU and are shut
    down at the end (their lane and scheduler threads)."""

    def __init__(self) -> None:
        self.made = []

    def __call__(self, pkg: str, name: str, resources):
        kwargs = {"device": "cpu"} if pkg == "pinot_tpu_torch" else {}
        s = M(pkg, "server.instance").ServerInstance(name, **kwargs)
        M(pkg, "server.starter").ServerStarter(s, resources).start()
        self.made.append(s)
        return s

    def close(self) -> None:
        for s in self.made:
            if hasattr(s, "shutdown"):
                s.shutdown()


@pytest.fixture
def servers():
    made = _Servers()
    try:
        yield made
    finally:
        made.close()


def _ask(pkg: str, server, physical: str, pql: str):
    """One query on one server, reduced as a broker reduces it."""
    dt = M(pkg, "common.datatable")
    payload = dt.serialize_instance_request(1, pql.replace(TABLE, physical), physical, [], 10_000)
    result = dt.deserialize_result(server.handle_request(payload))
    request = M(pkg, "pql").parse_pql(pql.replace(TABLE, physical))
    return result, M(pkg, "utils.audit").canonical_payload(request, result)


def _offline_restart(pkg: str, data_dir: str, servers) -> dict:
    TableConfig = M(pkg, "common.tableconfig").TableConfig
    Controller = M(pkg, "controller.controller").Controller
    build_segment = M(pkg, "segment.builder").build_segment
    schema = _schema(pkg)
    c1 = Controller(data_dir)
    server = servers(pkg, "srvA", c1.resources)
    c1.add_schema(schema)
    physical = c1.add_table(TableConfig(table_name=TABLE, table_type="OFFLINE"))
    for i in range(2):
        c1.upload_segment(physical, build_segment(schema, ROWS[i * 150:(i + 1) * 150], physical, f"d{i}"))
    ideal_before = c1.resources.get_ideal_state(physical)
    docs_before = _ask(pkg, server, physical, "SELECT count(*) FROM testTable")[0].num_docs_scanned
    epoch1 = c1.epoch
    c1.stop()  # nothing survives but the data dir

    c2 = Controller(data_dir)
    info = c2.resources.get_segment_metadata(physical, "d0")
    out = {
        "epochGrew": c2.epoch > epoch1,
        "schema": c2.resources.get_schema(TABLE).to_json(),
        "tables": c2.resources.tables(),
        "config": c2.resources.table_configs[physical].to_json(),
        "idealRecovered": c2.resources.get_ideal_state(physical) == ideal_before,
        "ideal": c2.resources.get_ideal_state(physical),
        "d0Docs": info["metadata"].num_docs,
        "d0HasDir": bool(info["dir"]),
        "viewAtStart": c2.resources.get_external_view(physical),
        "docsBefore": docs_before,
    }
    server2 = servers(pkg, "srvA", c2.resources)
    out["viewAfterRegister"] = c2.resources.get_external_view(physical)
    out["docsAfter"] = _ask(pkg, server2, physical, "SELECT count(*) FROM testTable")[0].num_docs_scanned
    out["groups"] = _ask(pkg, server2, physical, GROUPS)[1]
    c2.stop()
    return out


def test_offline_state_survives_controller_restart(tmp_path, servers):
    """The reference's ``test_offline_state_survives_controller_restart``
    on both packages: the recovered schema, config, ideal state and
    segment record are the reference's, the view starts empty and
    refills when the server re-registers, and the answers agree."""
    audit = M("pinot_tpu", "utils.audit")
    ref = _offline_restart("pinot_tpu", str(tmp_path / "ref"), servers)
    port = _offline_restart("pinot_tpu_torch", str(tmp_path / "port"), servers)
    assert port["idealRecovered"] and port["epochGrew"]
    assert port["viewAtStart"] == {}
    assert port["viewAfterRegister"] == {"d0": {"srvA": "ONLINE"}, "d1": {"srvA": "ONLINE"}}
    assert port["docsBefore"] == port["docsAfter"] == 300 and port["d0Docs"] == 150
    ref_groups, port_groups = ref.pop("groups"), port.pop("groups")
    assert port == ref
    assert audit.payloads_equivalent(port_groups, ref_groups)


def test_restart_recovers_what_the_reference_recovers(tmp_path):
    """The restart probe: a schema and an OFFLINE table, the controller
    dropped, a new one over the same ``data_dir``.  The reference
    recovers ``['testTable_OFFLINE']`` and the schema; the port recovered
    ``[]`` and no schema before it had the property store."""
    got = {}
    for pkg in PKGS:
        Controller = M(pkg, "controller.controller").Controller
        d = str(tmp_path / pkg)
        c = Controller(d)
        c.add_schema(_schema(pkg))
        c.add_table(M(pkg, "common.tableconfig").TableConfig(table_name=TABLE, table_type="OFFLINE"))
        c.stop()
        c2 = Controller(d)
        got[pkg] = (c2.resources.tables(), c2.resources.get_schema(TABLE) is not None)
        c2.stop()
    assert got["pinot_tpu"] == (["testTable_OFFLINE"], True)
    assert got["pinot_tpu_torch"] == got["pinot_tpu"]


def _realtime_restart(pkg: str, tmp_path, servers) -> dict:
    TableConfig = M(pkg, "common.tableconfig").TableConfig
    StreamConfig = M(pkg, "common.tableconfig").StreamConfig
    Controller = M(pkg, "controller.controller").Controller
    llc = M(pkg, "realtime.llc")
    stream_file = tmp_path / f"{pkg}-p0.jsonl"
    with open(stream_file, "w") as f:
        for r in ROWS[:75]:
            f.write(json.dumps(r) + "\n")
    stream = M(pkg, "realtime.stream").FileBasedStreamProvider([str(stream_file)])
    data_dir = str(tmp_path / pkg)
    c1 = Controller(data_dir)
    server = servers(pkg, "srvA", c1.resources)
    c1.add_schema(_schema(pkg))
    physical = c1.add_realtime_table(
        TableConfig(table_name=TABLE, table_type="REALTIME", stream=StreamConfig(rows_per_segment=50)), stream)
    seg0, seg1, seg2 = (llc.make_segment_name(physical, 0, i) for i in range(3))
    # 75 rows: seg0 seals at 50, seg1 holds 25 uncommitted
    dm0 = c1.realtime_manager.consumers_of(seg0)[0]
    dm0.consume_step(max_rows=1000)
    out = {"commit0": dm0.try_commit()}
    c1.realtime_manager.consumers_of(seg1)[0].consume_step(max_rows=1000)
    out["docsBefore"] = _ask(pkg, server, physical, "SELECT count(*) FROM testTable")[0].num_docs_scanned
    for dm in c1.realtime_manager._consumers.values():
        dm.stop()
    c1.stop()

    c2 = Controller(data_dir)
    out["endOffset0"] = c2.resources.get_segment_metadata(physical, seg0)["metadata"].custom["endOffset"]
    out["ideal"] = c2.resources.get_ideal_state(physical)
    server2 = servers(pkg, "srvA", c2.resources)
    dm1 = c2.realtime_manager.consumers_of(seg1)[0]
    out["resumeOffset"] = dm1.offset
    dm1.consume_step(max_rows=1000)
    out["docsAfterRestart"] = _ask(pkg, server2, physical, "SELECT count(*) FROM testTable")[0].num_docs_scanned
    with open(stream_file, "a") as f:
        for r in ROWS[75:100]:
            f.write(json.dumps(r) + "\n")
    dm1.consume_step(max_rows=1000)
    out["commit1"] = dm1.try_commit()
    out["rolledOver"] = bool(c2.realtime_manager.consumers_of(seg2))
    out["docsFinal"] = _ask(pkg, server2, physical, "SELECT count(*) FROM testTable")[0].num_docs_scanned
    out["groups"] = _ask(pkg, server2, physical, GROUPS)[1]
    for dm in c2.realtime_manager._consumers.values():
        dm.stop()
    c2.stop()
    return out


def test_realtime_offsets_survive_controller_restart(tmp_path, servers):
    """The reference's realtime restart on both packages: the offsets and
    the stream's descriptor are recovered, the consumer resumes at the
    committed offset 50 (the 25 uncommitted rows are consumed again, not
    twice), and after the restart the stream seals seg1 and rolls over,
    every produced row counted once."""
    audit = M("pinot_tpu", "utils.audit")
    ref = _realtime_restart("pinot_tpu", tmp_path, servers)
    port = _realtime_restart("pinot_tpu_torch", tmp_path, servers)
    assert port["resumeOffset"] == 50 and port["endOffset0"] == 50
    assert port["docsBefore"] == port["docsAfterRestart"] == 75 and port["docsFinal"] == 100
    assert port["rolledOver"]
    ref_groups, port_groups = ref.pop("groups"), port.pop("groups")
    assert port == ref
    assert audit.payloads_equivalent(port_groups, ref_groups)


@PKG
def test_delete_table_clears_property_store(pkg, tmp_path, servers):
    Controller = M(pkg, "controller.controller").Controller
    schema = _schema(pkg)
    c1 = Controller(str(tmp_path))
    servers(pkg, "srvA", c1.resources)
    c1.add_schema(schema)
    physical = c1.add_table(M(pkg, "common.tableconfig").TableConfig(table_name=TABLE, table_type="OFFLINE"))
    c1.upload_segment(physical, M(pkg, "segment.builder").build_segment(schema, ROWS[:50], physical, "d0"))
    c1.delete_table(physical)
    c1.stop()
    c2 = Controller(str(tmp_path))
    assert physical not in c2.resources.tables()
    assert c2.resources.get_segment_metadata(physical, "d0") is None
    assert c2.property_store.list_keys(f"segments/{physical}") == []
    c2.stop()


def _store_records(ctrl, physical: str) -> dict:
    ps = ctrl.property_store
    return {
        "schemas": {k: ps.get("schemas", k) for k in ps.list_keys("schemas")},
        "tables": {k: ps.get("tables", k) for k in ps.list_keys("tables")},
        "ideal": ps.get("idealstates", physical),
        "segments": {k: {f: v for f, v in ps.get(f"segments/{physical}", k).items() if f not in ("dir", "downloadUri")}
                     for k in ps.list_keys(f"segments/{physical}")},
        "instances": {k: ps.get("instances", k) for k in ps.list_keys("instances")},
    }


@pytest.mark.parametrize("writer,reader", [("pinot_tpu", "pinot_tpu_torch"), ("pinot_tpu_torch", "pinot_tpu")],
                         ids=["reference-to-port", "port-to-reference"])
def test_a_store_opens_in_the_other_package(writer, reader, tmp_path, servers):
    """A store written by one package and opened by the other gives the
    same schemas, table configs, ideal state, segment records and drain
    flag, and its next epoch; the reader's re-registered server serves
    the writer's segment files."""
    d = str(tmp_path)
    w = M(writer, "controller.controller").Controller(d)
    servers(writer, "srvA", w.resources)
    servers(writer, "srvB", w.resources)
    schema = _schema(writer)
    w.add_schema(schema)
    physical = w.add_table(M(writer, "common.tableconfig").TableConfig(
        table_name=TABLE, table_type="OFFLINE", replication=2))
    build = M(writer, "segment.builder").build_segment
    for i in range(2):
        w.upload_segment(physical, build(schema, ROWS[i * 100:(i + 1) * 100], physical, f"x{i}"))
    w.drain_instance("srvB")
    written = _store_records(w, physical)
    epoch = w.epoch
    w.stop()

    r = M(reader, "controller.controller").Controller(d)
    assert r.epoch == epoch + 1
    assert _store_records(r, physical) == written
    assert r.resources.get_ideal_state(physical) == written["ideal"]
    assert r.drain_status("srvB")["draining"]
    s = servers(reader, "srvA", r.resources)
    assert r.resources.get_external_view(physical) == {"x0": {"srvA": "ONLINE"}, "x1": {"srvA": "ONLINE"}}
    assert _ask(reader, s, physical, "SELECT count(*) FROM testTable")[0].num_docs_scanned == 200
    r.stop()


@PKG
def test_a_zombie_controllers_writes_raise_stale_epoch(pkg, tmp_path, servers):
    """Two controllers over one store: the second claims the next epoch,
    and every durable write of the first raises ``StaleEpochError`` and
    leaves the store as the second sees it."""
    Controller = M(pkg, "controller.controller").Controller
    StaleEpochError = M(pkg, "common.fencing").StaleEpochError
    a = Controller(str(tmp_path))
    servers(pkg, "srvA", a.resources)
    schema = _schema(pkg)
    a.add_schema(schema)
    physical = a.add_table(M(pkg, "common.tableconfig").TableConfig(table_name=TABLE, table_type="OFFLINE"))
    b = Controller(str(tmp_path))
    assert b.epoch == a.epoch + 1
    before = _store_records(b, physical)
    with pytest.raises(StaleEpochError):
        a.add_schema(schema)
    with pytest.raises(StaleEpochError):
        a.resources.update_table_quota(physical, 5.0)
    with pytest.raises(StaleEpochError):
        a.drain_instance("srvA")
    assert _store_records(b, physical) == before
    b.stop()
    a.stop()


@PKG
def test_journal_recovers_frames_and_snapshots(pkg, tmp_path):
    """Journal replay after many puts and deletes across snapshot
    boundaries gives the live store's records; a torn tail frame is
    dropped, not fatal."""
    PropertyStore = M(pkg, "controller.property_store").PropertyStore
    ps = PropertyStore(str(tmp_path))
    ps.claim_epoch()
    for i in range(40):
        ps.put("tables", f"t{i % 7}", {"v": i})
        if i % 5 == 0:
            ps.delete("tables", f"t{(i + 3) % 7}")
    live = {k: ps.get("tables", k) for k in ps.list_keys("tables")}
    ps.close()
    ps2 = PropertyStore(str(tmp_path))
    assert {k: ps2.get("tables", k) for k in ps2.list_keys("tables")} == live
    ps2.close()


@pytest.mark.parametrize("cut", [3, 17, 40])
def test_a_torn_journal_opens_alike(cut, tmp_path):
    """The same puts on both packages' stores, each journal cut at the
    same byte offset from its end: both reopen with the same records
    (the mirror files survive a torn tail)."""
    import os

    got = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg)
        PropertyStore = M(pkg, "controller.property_store").PropertyStore
        ps = PropertyStore(d)
        for i in range(1, 6):
            ps.put("tables", f"t{i}", {"i": i})
        ps.close()
        log = os.path.join(d, ".journal", "journal.log")
        with open(log, "r+b") as f:
            f.truncate(max(0, os.path.getsize(log) - cut))
        ps2 = PropertyStore(d)
        got[pkg] = {k: ps2.get("tables", k) for k in ps2.list_keys("tables")}
        ps2.close()
    assert got["pinot_tpu_torch"] == got["pinot_tpu"] == {f"t{i}": {"i": i} for i in range(1, 6)}


@PKG
def test_a_corrupt_record_heals_or_raises_typed(pkg, tmp_path):
    """A torn mirror file heals from the journal's state (and is
    quarantined aside); a garbled record with no journal backing raises
    ``CorruptRecordError``."""
    import os

    mod = M(pkg, "controller.property_store")
    ps = mod.PropertyStore(str(tmp_path))
    ps.put("schemas", "s1", {"cols": [1, 2, 3]})
    path = ps._path("schemas", "s1")
    with open(path, "w") as f:
        f.write('{"cols": [1,')
    assert ps.get("schemas", "s1") == {"cols": [1, 2, 3]}
    assert any(".corrupt." in fn for fn in os.listdir(os.path.dirname(path)))
    assert ps.metrics.meter("durability.recordsHealed").count >= 1
    rogue = os.path.join(os.path.dirname(path), "rogue.json")
    with open(rogue, "w") as f:
        f.write("not json")
    with pytest.raises(mod.CorruptRecordError) as ei:
        ps.get("schemas", "rogue")
    assert ei.value.key == "rogue" and not os.path.exists(rogue)
    ps.close()


@PKG
def test_serving_lease_remaining_and_expire(pkg):
    clock = [100.0]
    lease = M(pkg, "common.fencing").ServingLease(clock=lambda: clock[0])
    assert lease.remaining_s() == float("inf") and lease.held()
    lease.renew({"epoch": 3, "durationS": 10.0})
    clock[0] = 104.0
    assert lease.remaining_s() == pytest.approx(6.0)
    lease.expire()
    assert not lease.held() and lease.remaining_s() == 0.0
