"""Tenants and rebalance in the port against the JAX package: the same
calls on both in-process clusters (the port's servers on the CPU), the
same tagged instances, dry-run plans, moves and final ideal states, and
answers that agree after the moves.

The cases are the reference's ``tests/test_tenant_rebalance.py``:
``create_tenant`` / ``list_tenants`` / ``tenant_instances`` and a table on
a tenant, ``rebalance_table`` onto a new server (its dry run changes
nothing; a second run moves nothing) and after a server's death, the
tenant and rebalance REST routes and the admin CLI's ``AddTenant``,
``ListTenants`` and ``RebalanceTable``.
"""
import importlib
import json
import urllib.request

import pytest

from pinot_tpu.tools.datagen import make_test_schema, random_rows

PKGS = ["pinot_tpu", "pinot_tpu_torch"]
REF_SCHEMA = make_test_schema(with_mv=False)
GROUPS = "SELECT sum(metInt), count(*) FROM testTable GROUP BY dimStr TOP 10"


def M(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _schema(pkg: str):
    return M(pkg, "common.schema").Schema.from_json(REF_SCHEMA.to_json())


def _cluster(pkg: str, path, num_servers: int):
    kwargs = {"device": "cpu"} if pkg == "pinot_tpu_torch" else {}
    return M(pkg, "tools.cluster_harness").InProcessCluster(num_servers=num_servers, data_dir=str(path), **kwargs)


def _payload(pkg: str, resp):
    return M(pkg, "utils.audit").strip_accounting(resp.to_json())


def _both(tmp_path, fn):
    """``fn(pkg, path)`` on the reference, then on the port."""
    return {pkg: fn(pkg, tmp_path / pkg) for pkg in PKGS}


def _tenants(pkg, path):
    TableConfig = M(pkg, "common.tableconfig").TableConfig
    cluster = _cluster(pkg, path, 3)
    try:
        schema = _schema(pkg)
        cluster.controller.add_schema(schema)
        res = cluster.controller.resources
        out = {"tagged": res.create_tenant("analyticsTenant", "server", 2)}
        out["members"] = res.tenant_instances("analyticsTenant", "server")
        out["tenants"] = res.list_tenants()
        with pytest.raises(RuntimeError):
            res.create_tenant("otherTenant", "server", 2)  # one untagged server left
        with pytest.raises(ValueError):
            cluster.controller.add_table(TableConfig(table_name=schema.schema_name, server_tenant="ghostTenant"))
        physical = cluster.controller.add_table(
            TableConfig(table_name=schema.schema_name, server_tenant="analyticsTenant", replication=2))
        rows = random_rows(REF_SCHEMA, 120, seed=7)
        cluster.upload(physical, M(pkg, "segment.builder").build_segment(schema, rows, physical, "t1"))
        out["ideal"] = res.get_ideal_state(physical)
        out["count"] = cluster.query("SELECT count(*) FROM testTable").num_docs_scanned
        out["groups"] = _payload(pkg, cluster.query(GROUPS))
        return out
    finally:
        cluster.stop()


def test_tenant_create_and_table_on_a_tenant(tmp_path):
    got = _both(tmp_path, _tenants)
    ref, port = got["pinot_tpu"], got["pinot_tpu_torch"]
    assert set(port["ideal"]["t1"]) == set(port["tagged"]) and port["count"] == 120
    assert M("pinot_tpu", "utils.audit").payloads_equivalent(port.pop("groups"), ref.pop("groups"))
    assert port == ref


def _rebalance_new_server(pkg, path):
    cluster = _cluster(pkg, path, 2)
    try:
        schema = _schema(pkg)
        physical = cluster.add_offline_table(schema, replication=1)
        rows = random_rows(REF_SCHEMA, 100, seed=11)
        build = M(pkg, "segment.builder").build_segment
        for i in range(6):
            cluster.upload(physical, build(schema, rows[:50 + i], physical, f"seg{i}"))
        res = cluster.controller.resources
        before = res.get_ideal_state(physical)
        cluster.add_server("server2")
        dry = cluster.controller.rebalance_table(physical, dry_run=True)
        out = {"before": before, "dry": dry, "dryChangedNothing": res.get_ideal_state(physical) == before}
        out["result"] = cluster.controller.rebalance_table(physical)
        out["after"] = res.get_ideal_state(physical)
        out["viewConverged"] = res.get_external_view(physical) == out["after"]
        resp = cluster.query("SELECT count(*) FROM testTable")
        out["count"], out["exceptions"] = resp.num_docs_scanned, len(resp.exceptions)
        out["groups"] = _payload(pkg, cluster.query(GROUPS))
        out["again"] = cluster.controller.rebalance_table(physical)["segmentsMoved"]
        return out
    finally:
        cluster.stop()


def test_rebalance_moves_segments_to_a_new_server(tmp_path):
    """The reference's case: the dry run's plan, the moves and the final
    ideal state (two segments on each of three servers) are the
    reference's, the view converges, the answers agree, and a second
    rebalance moves nothing."""
    got = _both(tmp_path, _rebalance_new_server)
    ref, port = got["pinot_tpu"], got["pinot_tpu_torch"]
    counts = {}
    for replicas in port["after"].values():
        for srv in replicas:
            counts[srv] = counts.get(srv, 0) + 1
    assert counts == {"server0": 2, "server1": 2, "server2": 2}
    assert port["dry"]["dryRun"] and port["dry"]["segmentsMoved"] > 0 and port["dryChangedNothing"]
    assert port["viewConverged"] and port["exceptions"] == 0 and port["again"] == 0
    assert port["count"] == sum(50 + i for i in range(6))
    assert M("pinot_tpu", "utils.audit").payloads_equivalent(port.pop("groups"), ref.pop("groups"))
    assert port == ref


def _rebalance_after_death(pkg, path):
    cluster = _cluster(pkg, path, 3)
    try:
        schema = _schema(pkg)
        physical = cluster.add_offline_table(schema, replication=2)
        rows = random_rows(REF_SCHEMA, 90, seed=13)
        build = M(pkg, "segment.builder").build_segment
        for i in range(3):
            cluster.upload(physical, build(schema, rows, physical, f"s{i}"))
        res = cluster.controller.resources
        res.set_instance_alive("server1", False)
        result = cluster.controller.rebalance_table(physical)
        resp = cluster.query("SELECT count(*) FROM testTable")
        return {"result": result, "after": res.get_ideal_state(physical), "count": resp.num_docs_scanned,
                "exceptions": len(resp.exceptions)}
    finally:
        cluster.stop()


def test_rebalance_after_a_servers_death(tmp_path):
    got = _both(tmp_path, _rebalance_after_death)
    port = got["pinot_tpu_torch"]
    assert all(len(r) == 2 and "server1" not in r for r in port["after"].values())
    assert port["count"] == 270 and port["exceptions"] == 0
    assert port == got["pinot_tpu"]


def _rest(pkg, path):
    cluster = _cluster(pkg, path, 2)
    http = M(pkg, "controller.controller").ControllerHttpServer(cluster.controller)
    http.start()
    base = f"http://127.0.0.1:{http.port}"
    try:
        schema = _schema(pkg)
        physical = cluster.add_offline_table(schema)
        rows = random_rows(REF_SCHEMA, 60, seed=19)
        build = M(pkg, "segment.builder").build_segment
        cluster.upload(physical, build(schema, rows, physical, "r1"))
        cluster.upload(physical, build(schema, rows, physical, "r2"))
        req = urllib.request.Request(base + "/tenants", data=json.dumps(
            {"name": "restTenant", "role": "server", "count": 1}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as r:
            out = {"create": json.loads(r.read())}
        with urllib.request.urlopen(base + "/tenants", timeout=5) as r:
            out["tenants"] = json.loads(r.read())
        with urllib.request.urlopen(base + "/tenants/restTenant", timeout=5) as r:
            out["tenant"] = json.loads(r.read())
        req = urllib.request.Request(base + f"/tables/{physical}/rebalance?dryRun=true", data=b"{}")
        with urllib.request.urlopen(req, timeout=5) as r:
            out["dry"] = json.loads(r.read())
        with urllib.request.urlopen(base + f"/tables/{physical}/size", timeout=5) as r:
            out["sizePositive"] = json.loads(r.read())["reportedSizeInBytes"] > 0
        return out
    finally:
        http.stop()
        cluster.stop()


def test_tenant_and_rebalance_routes(tmp_path):
    got = _both(tmp_path, _rest)
    port = got["pinot_tpu_torch"]
    assert port["create"]["status"] == "ok" and len(port["create"]["instances"]) == 1
    assert port["tenant"]["ServerInstances"] == port["create"]["instances"]
    assert port["dry"]["dryRun"] is True and port["sizePositive"]
    assert port == got["pinot_tpu"]


def test_admin_tenant_and_rebalance_commands(tmp_path, capsys):
    """``AddTenant``, ``ListTenants`` and ``RebalanceTable`` of the port's
    CLI against a port controller over HTTP print what the reference's
    print against a reference controller."""
    printed = {}
    for pkg in PKGS:
        cluster = _cluster(pkg, tmp_path / pkg, 2)
        http = M(pkg, "controller.controller").ControllerHttpServer(cluster.controller)
        http.start()
        url = f"http://127.0.0.1:{http.port}"
        try:
            schema = _schema(pkg)
            physical = cluster.add_offline_table(schema)
            cluster.upload(physical, M(pkg, "segment.builder").build_segment(
                schema, random_rows(REF_SCHEMA, 40, seed=3), physical, "a1"))
            main = M(pkg, "tools.admin").main
            capsys.readouterr()
            main(["AddTenant", "-controller", url, "-name", "cliTenant", "-count", "1"])
            main(["ListTenants", "-controller", url])
            main(["RebalanceTable", "-controller", url, "-table", physical, "-dry-run"])
            printed[pkg] = capsys.readouterr().out
        finally:
            http.stop()
            cluster.stop()
    assert "cliTenant" in printed["pinot_tpu_torch"]
    assert printed["pinot_tpu_torch"] == printed["pinot_tpu"]
