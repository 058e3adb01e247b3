"""The stabilizer, drain and the chaos scenarios in the port against the
JAX package: the same scenario code on both in-process clusters (the
port's servers on the CPU), the same final ideal states, replication
flags and zero failed queries.

The cases are the reference's ``tests/test_stabilizer.py``: the kill,
drain, rolling-restart (cold and warm) and split-brain scenarios; the
grace window; doc-weighted re-replication; the consuming hand-off at the
committed offset; a drain shedding a replicated consuming replica; the
drain routes; flap hysteresis; a controller restarted in the middle of a
stabilization; a drain flag surviving a restart.  The stabilizer is
stepped with ``run_once`` (and an injected clock where time matters),
never on a sleeping thread.
"""
import importlib
import json
import os
import urllib.error
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


def _cluster(pkg: str, path, num_servers: int = 3):
    return M(pkg, "tools.cluster_harness").InProcessCluster(num_servers=num_servers, data_dir=str(path), **_dev(pkg))


def _offline_cluster(pkg, path, num_servers=3, replication=2, segments=3, docs=60):
    cluster = _cluster(pkg, path, num_servers)
    schema = _schema(pkg)
    physical = cluster.add_offline_table(schema, replication=replication)
    rows = random_rows(REF_SCHEMA, docs, seed=3)
    build = M(pkg, "segment.builder").build_segment
    for i in range(segments):
        cluster.upload(physical, build(schema, rows, physical, f"g{i}"))
    return cluster, physical


def _scenario(pkg: str, name: str, **kwargs) -> dict:
    return getattr(M(pkg, "tools.cluster_harness"), name)(**kwargs, **_dev(pkg))


# the keys of a scenario's result that timing does not move
_STABLE = ("segments", "replicaSetSizes", "onExcluded", "viewConverged", "finalDocs", "expectedDocs",
           "failedQueries", "replicationRestored", "finalComplete", "drainStatus", "roundsToDrain",
           "roundsPerServer", "noSegmentLoss", "scenario", "victim", "rounds")


def _stable(out: dict) -> dict:
    return {k: out[k] for k in _STABLE if k in out}


@pytest.mark.parametrize("name", ["run_kill_server_scenario", "run_drain_scenario",
                                  "run_rolling_restart_scenario"])
def test_chaos_scenario_matches_the_reference(name, tmp_path):
    """Each scenario on both packages: no failed query, the reference's
    replication flags, replica-set sizes and drain accounting."""
    ref = _scenario("pinot_tpu", name, data_dir=str(tmp_path / "ref"))
    port = _scenario("pinot_tpu_torch", name, data_dir=str(tmp_path / "port"))
    assert port["failedQueries"] == 0, port["failures"]
    assert port["viewConverged"] and port.get("finalDocs") == port.get("expectedDocs", port.get("finalDocs"))
    assert _stable(port) == _stable(ref)
    if name == "run_kill_server_scenario":
        for meter in ("stabilizer.replicasAdded", "stabilizer.replicasDropped"):
            assert port["stabilizer"][meter]["count"] == ref["stabilizer"][meter]["count"] > 0


def test_rolling_restart_warm_scenario(tmp_path):
    """The warm rolling restart on the port: no failed query, no cold
    compile on a restarted server, no segment lost; the reference's run
    holds the same flags."""
    ref = _scenario("pinot_tpu", "run_rolling_restart_warm_scenario", data_dir=str(tmp_path / "ref"),
                    cache_dir=str(tmp_path / "ref_cache"), steady_s=0.3)
    port = _scenario("pinot_tpu_torch", "run_rolling_restart_warm_scenario", data_dir=str(tmp_path / "port"),
                     cache_dir=str(tmp_path / "port_cache"), steady_s=0.3)
    assert port["failedQueries"] == 0, port["failures"]
    assert port["noSegmentLoss"] and port["finalComplete"] and port["laneWatchdogClean"]
    assert port["coldCompilesOnRestarted"] == 0
    for key in ("failedQueries", "noSegmentLoss", "finalComplete", "replicaSetSizes", "restarted",
                "finalDocs", "expectedDocs"):
        assert port[key] == ref[key], key


def test_split_brain_scenario(tmp_path):
    """A zombie controller's every write raises ``StaleEpochError`` and
    leaves the store unchanged; the live one converges: the reference's
    result, key for key."""
    ref = _scenario("pinot_tpu", "run_split_brain_scenario", data_dir=str(tmp_path / "ref"))
    port = _scenario("pinot_tpu_torch", "run_split_brain_scenario", data_dir=str(tmp_path / "port"))
    assert port["allStaleWritesRejected"] and port["durableStoreUnchangedByZombie"]
    assert port["liveControllerConverged"] and port["failedQueries"] == 0
    assert port == ref


def _grace(pkg, path):
    cluster, physical = _offline_cluster(pkg, path)
    res = cluster.controller.resources
    clock = [100.0]
    st = M(pkg, "controller.stabilizer").SelfStabilizer(res, grace_s=10.0, now=lambda: clock[0])
    before = res.get_ideal_state(physical)
    out = {}
    try:
        res.set_instance_alive("server0", False)
        st.run_once()
        out["deferred"] = res.get_ideal_state(physical) == before
        out["graceDeferrals"] = st.metrics.meter("stabilizer.graceDeferrals").count
        out["dead1"] = st.metrics.gauge("stabilizer.deadServers").value
        res.set_instance_alive("server0", True)
        clock[0] = 105.0
        st.run_once()
        out["dead2"] = st.metrics.gauge("stabilizer.deadServers").value
        res.set_instance_alive("server0", False)
        clock[0] = 109.0  # 4 s into the new window
        st.run_once()
        out["stillDeferred"] = res.get_ideal_state(physical) == before
        clock[0] = 125.0
        st.run_once()
        out["afterAdd"] = res.get_ideal_state(physical)
        st.run_once()
        out["afterDrop"] = res.get_ideal_state(physical)
        out["events"] = [e["event"] for e in st.events()]
        return out
    finally:
        cluster.stop()


def test_grace_window_defers_movement(tmp_path):
    ref = _grace("pinot_tpu", tmp_path / "ref")
    port = _grace("pinot_tpu_torch", tmp_path / "port")
    assert port["deferred"] and port["stillDeferred"] and port["graceDeferrals"] == 1
    assert all("server0" not in r for r in port["afterDrop"].values())
    assert port == ref


def _skew(pkg, path):
    cluster = _cluster(pkg, path, 3)
    try:
        schema = _schema(pkg)
        physical = cluster.add_offline_table(schema, replication=1)
        res = cluster.controller.resources
        rows = random_rows(REF_SCHEMA, 200, seed=9)
        build = M(pkg, "segment.builder").build_segment
        for name, n in (("big", 200), ("t1", 10), ("t2", 10), ("t3", 10)):
            seg = build(schema, rows[:n], physical, name)
            path_ = cluster.controller.store.save(physical, seg)
            res.add_segment(physical, seg.metadata, {"dir": path_, "downloadUri": "file://" + os.path.abspath(path_)},
                            servers=["server0"])
        res.set_instance_alive("server0", False)
        st = cluster.controller.stabilizer
        st.grace_s = 0.0
        st.run_once()
        st.run_once()
        resp = cluster.query("SELECT count(*) FROM testTable")
        return {"ideal": res.get_ideal_state(physical), "count": resp.num_docs_scanned,
                "exceptions": len(resp.exceptions)}
    finally:
        cluster.stop()


def test_skew_aware_replacement_placement(tmp_path):
    """Re-replication balances docs, not segment counts: the 200-doc
    segment sits alone, the three 10-doc ones share a server."""
    ref = _skew("pinot_tpu", tmp_path / "ref")
    port = _skew("pinot_tpu_torch", tmp_path / "port")
    by_server = {}
    for seg, replicas in port["ideal"].items():
        for s in replicas:
            by_server.setdefault(s, set()).add(seg)
    big_host = next(s for s, segs in by_server.items() if "big" in segs)
    assert by_server[big_host] == {"big"} and "server0" not in by_server
    assert port["count"] == 230 and port["exceptions"] == 0
    assert port == ref


def _rt_schema(pkg):
    sm = M(pkg, "common.schema")
    return sm.Schema(
        "meetupRsvp",
        dimensions=[sm.FieldSpec("venue_name", sm.DataType.STRING)],
        metrics=[sm.FieldSpec("rsvp_count", sm.DataType.INT, sm.FieldType.METRIC)],
        time_field=sm.TimeFieldSpec("mtime", sm.DataType.LONG, time_unit="MILLISECONDS"),
    )


def _handoff(pkg, path):
    llc = M(pkg, "realtime.llc")
    cluster = _cluster(pkg, path, 2)
    try:
        stream = M(pkg, "realtime.stream").MemoryStreamProvider(num_partitions=1)
        physical = cluster.add_realtime_table(_rt_schema(pkg), stream, rows_per_segment=50)
        for i in range(70):
            stream.produce({"venue_name": f"v{i % 3}", "rsvp_count": i % 5, "mtime": 10_000 + i})
        rm = cluster.controller.realtime_manager
        res = cluster.controller.resources
        seg0, seg1 = llc.make_segment_name(physical, 0, 0), llc.make_segment_name(physical, 0, 1)
        dm = rm.consumers_of(seg0)[0]
        dm.consume_step(max_rows=1000)
        out = {"commit": dm.try_commit()}
        holder = next(iter(res.get_ideal_state(physical)[seg1]))
        next(c for c in rm.consumers_of(seg1) if c.server.name == holder).consume_step(max_rows=20)
        res.set_instance_alive(holder, False)
        st = cluster.controller.stabilizer
        st.grace_s = 0.0
        st.run_once()
        st.run_once()
        ideal = res.get_ideal_state(physical)
        out["holder"] = holder
        out["seg1"] = ideal[seg1]
        out["reassigned"] = st.metrics.meter("stabilizer.consumingReassigned").count
        new_dm = rm.consumers_of(seg1)
        out["newConsumers"] = [(d.server.name, d.offset) for d in new_dm]
        new_dm[0].consume_step(max_rows=20)
        resp = cluster.query("SELECT count(*) FROM meetupRsvp")
        out["count"], out["partial"] = resp.num_docs_scanned, resp.partial_response
        return out
    finally:
        cluster.stop()


def test_consuming_handoff_resumes_at_committed_offset(tmp_path):
    """The server holding a CONSUMING segment dies: the segment is
    retired and recreated on a live server at the committed offset 50,
    and the 20 lost uncommitted rows are consumed again, once."""
    ref = _handoff("pinot_tpu", tmp_path / "ref")
    port = _handoff("pinot_tpu_torch", tmp_path / "port")
    assert port["reassigned"] == 1 and port["newConsumers"][0][1] == 50
    assert port["count"] == 70 and port["partial"] is False
    assert port == ref


def _drain_consuming(pkg, path):
    llc = M(pkg, "realtime.llc")
    cluster = _cluster(pkg, path, 2)
    try:
        stream = M(pkg, "realtime.stream").MemoryStreamProvider(num_partitions=1)
        physical = cluster.add_realtime_table(_rt_schema(pkg), stream, rows_per_segment=50, replication=2)
        seg0 = llc.make_segment_name(physical, 0, 0)
        cluster.controller.drain_instance("server0")
        st = cluster.controller.stabilizer
        st.grace_s = 0.0
        st.run_once()
        return {"drained": cluster.controller.drain_status("server0")["drained"],
                "ideal": cluster.controller.resources.get_ideal_state(physical)[seg0],
                "holders": sorted(dm.server.name for dm in cluster.controller.realtime_manager.consumers_of(seg0))}
    finally:
        cluster.stop()


def test_drain_sheds_a_replicated_consuming_replica(tmp_path):
    ref = _drain_consuming("pinot_tpu", tmp_path / "ref")
    port = _drain_consuming("pinot_tpu_torch", tmp_path / "port")
    assert port == {"drained": True, "ideal": {"server1": "CONSUMING"}, "holders": ["server1"]}
    assert port == ref


def _drain_http(pkg, path):
    cluster, physical = _offline_cluster(pkg, path)
    cluster.controller.stabilizer.grace_s = 0.0
    http = M(pkg, "controller.controller").ControllerHttpServer(cluster.controller)
    http.start()
    base = f"http://127.0.0.1:{http.port}"

    def post(p):
        with urllib.request.urlopen(urllib.request.Request(base + p, data=b"{}"), timeout=5) as r:
            return json.loads(r.read())

    def get(p):
        with urllib.request.urlopen(base + p, timeout=5) as r:
            return json.loads(r.read())

    try:
        out = {"drain": post("/instances/server0/drain")}
        out["coverHasServer0"] = "server0" in cluster.broker.routing.find_servers(physical)
        state = get("/clusterstate")
        out["state"] = {k: state[k] for k in ("drainingServers", "deadServers")}
        out["stateTableHasServer0"] = any("server0" in r for r in state["tables"][physical].values())
        cluster.controller.stabilizer.run_once()
        cluster.controller.stabilizer.run_once()
        out["poll"] = get("/instances/server0/drain")
        out["undrain"] = post("/instances/server0/undrain")
        dbg = get("/debug/stabilizer")
        out["debugKeys"] = sorted(dbg)
        out["rebalanceKeys"] = sorted(dbg["rebalance"])
        out["replicaAdded"] = any(e["event"] == "replicaAdded" for e in dbg["events"])
        out["dropped"] = dbg["metrics"]["meters"]["stabilizer.replicasDropped"]["count"]
        resp = cluster.query("SELECT count(*) FROM testTable")
        out["count"], out["exceptions"] = resp.num_docs_scanned, len(resp.exceptions)
        with pytest.raises(urllib.error.HTTPError) as ei:
            get("/instances/serverO/drain")
        out["typo"] = ei.value.code
        return out
    finally:
        http.stop()
        cluster.stop()


def test_drain_routes(tmp_path):
    """POST drain / undrain and the GET poll: the draining server leaves
    the broker's covers and the cluster state's tables, is listed as
    draining (not dead), drains in two rounds; a mistyped name is 404;
    ``/debug/stabilizer`` has the reference's keys."""
    ref = _drain_http("pinot_tpu", tmp_path / "ref")
    port = _drain_http("pinot_tpu_torch", tmp_path / "port")
    assert port["drain"]["draining"] and not port["drain"]["drained"] and not port["coverHasServer0"]
    assert port["poll"]["drained"] and port["typo"] == 404 and port["replicaAdded"]
    assert port == ref


def _flap(pkg):
    res = M(pkg, "controller.resource_manager").ClusterResourceManager()
    clock = [0.0]
    metrics = M(pkg, "utils.metrics").ControllerMetrics("controller")
    gw = M(pkg, "controller.network").ParticipantGateway(
        res, metrics=metrics, flap_window_s=60.0, flap_threshold=3, flap_hold_base_s=5.0, clock=lambda: clock[0])
    gw.register({"name": "s1", "role": "server"})
    seen = []
    for t in (1.0, 2.0, 3.0):
        res.set_instance_alive("s1", False)
        clock[0] = t
        seen.append((gw.heartbeat("s1")["status"], res.instances["s1"].alive))
    seen.append(("flaps", metrics.meter("gateway.flaps").count))
    res.set_instance_alive("s1", False)
    for t, call in ((4.0, "hb"), (6.0, "hb"), (7.0, "reg"), (10.0, "hb"), (80.0, "hb")):
        clock[0] = t
        out = gw.heartbeat("s1") if call == "hb" else gw.register({"name": "s1", "role": "server"})
        seen.append((out["status"], out.get("holdSeconds"), res.instances["s1"].alive))
    gw.stop()
    return seen


def test_flap_hysteresis_holds_readmit():
    """Three revives in the window are admitted; the fourth is held 5 s,
    a re-registration does not get past the hold, the next one is held
    10 s, and once the window drains the instance is admitted."""
    port = _flap("pinot_tpu_torch")
    assert port[3] == ("flaps", 2)
    assert port[4] == ("held", 5.0, False) and port[6][0] == "held" and port[7] == ("held", 10.0, False)
    assert port[-1][0] == "ok" and port[-1][2]
    assert port == _flap("pinot_tpu")


def _restart_mid(pkg, path):
    # the uninterrupted run: placement is deterministic, so this is the
    # fixpoint an interrupted run must reach too
    cluster, physical = _offline_cluster(pkg, path / "uninterrupted", segments=4)
    res = cluster.controller.resources
    res.set_instance_alive("server0", False)
    st = cluster.controller.stabilizer
    st.grace_s = 0.0
    st.run_once()
    st.run_once()
    expected = res.get_ideal_state(physical)
    cluster.stop()

    data_dir = path / "live"
    cluster, _ = _offline_cluster(pkg, data_dir, segments=4)
    res = cluster.controller.resources
    res.set_instance_alive("server0", False)
    st = cluster.controller.stabilizer
    st.grace_s = 0.0
    st.run_once()  # the add phase; the dead replicas are not dropped yet
    mid = res.get_ideal_state(physical)
    cluster.stop()  # the controller goes down here

    ctrl2 = M(pkg, "controller.controller").Controller(str(data_dir))
    ctrl2.stabilizer.grace_s = 0.0
    servers = {}
    try:
        for name in ("server1", "server2"):
            s = M(pkg, "server.instance").ServerInstance(name, **_dev(pkg))
            M(pkg, "server.starter").ServerStarter(s, ctrl2.resources).start()
            servers[name] = s
        ctrl2.stabilizer.run_once()
        ctrl2.stabilizer.run_once()
        ideal = ctrl2.resources.get_ideal_state(physical)
        out = {"halfApplied": any("server0" in r for r in mid.values()), "sameFixpoint": ideal == expected,
               "ideal": ideal, "viewConverged": ctrl2.resources.get_external_view(physical) == ideal}
        ctrl2.stabilizer.run_once()
        out["idempotent"] = ctrl2.resources.get_ideal_state(physical) == ideal
        out["hosted"] = {n: sorted(s.data_manager.table(physical).segment_names()) for n, s in servers.items()}
        out["wanted"] = {n: sorted(seg for seg, r in ideal.items() if n in r) for n in servers}
        return out
    finally:
        for s in servers.values():
            if hasattr(s, "shutdown"):
                s.shutdown()
        ctrl2.stop()


def test_controller_restart_mid_stabilization(tmp_path):
    """The controller goes down between the stabilizer's add and drop
    phases; the recovered one replays the half-applied plan from the
    store and reaches the uninterrupted run's ideal state, idempotently,
    with every server holding exactly its ideal-state segments."""
    ref = _restart_mid("pinot_tpu", tmp_path / "ref")
    port = _restart_mid("pinot_tpu_torch", tmp_path / "port")
    assert port["halfApplied"] and port["sameFixpoint"] and port["viewConverged"] and port["idempotent"]
    assert port["hosted"] == port["wanted"]
    assert port == ref


def _drain_flag(pkg, path):
    cluster, physical = _offline_cluster(pkg, path, num_servers=2, replication=1)
    cluster.controller.drain_instance("server0")
    out = {"draining": cluster.controller.resources.instances["server0"].draining}
    cluster.stop()
    Controller = M(pkg, "controller.controller").Controller
    ctrl2 = Controller(str(path))
    out["recovered"] = ctrl2.drain_status("server0")["draining"]
    s0 = M(pkg, "server.instance").ServerInstance("server0", **_dev(pkg))
    try:
        M(pkg, "server.starter").ServerStarter(s0, ctrl2.resources).start()
        out["afterRegister"] = ctrl2.resources.instances["server0"].draining
        ctrl2.undrain_instance("server0")
        out["afterUndrain"] = ctrl2.resources.instances["server0"].draining
    finally:
        if hasattr(s0, "shutdown"):
            s0.shutdown()
        ctrl2.stop()
    ctrl3 = Controller(str(path))
    out["afterSecondRestart"] = ctrl3.drain_status("server0")["draining"]
    ctrl3.stop()
    return out


def test_drain_flag_survives_controller_restart(tmp_path):
    """A drain flag is recovered before the instance re-registers, is not
    cleared by its registration, and only an undrain clears it, durably."""
    port = _drain_flag("pinot_tpu_torch", tmp_path / "port")
    assert port == {"draining": True, "recovered": True, "afterRegister": True, "afterUndrain": False,
                    "afterSecondRestart": False}
    assert port == _drain_flag("pinot_tpu", tmp_path / "ref")


@PKG
def test_stabilizer_constants_are_the_references(pkg, monkeypatch):
    for name in ("PINOT_TPU_STABILIZE_GRACE_S", "PINOT_TPU_REBALANCE_SKEW_RATIO", "PINOT_TPU_REBALANCE_HYSTERESIS",
                 "PINOT_TPU_REBALANCE_MAX_MOVES", "PINOT_TPU_REBALANCE", "PINOT_TPU_PREWARM_TIMEOUT_S"):
        monkeypatch.delenv(name, raising=False)
    res = M(pkg, "controller.resource_manager").ClusterResourceManager()
    st = M(pkg, "controller.stabilizer").SelfStabilizer(res)
    assert (st.grace_s, st.rebalance_skew_ratio, st.rebalance_hysteresis, st.rebalance_max_moves,
            st.rebalance_enabled, st.interval_s) == (5.0, 2.0, 3, 2, True, 2.0)
