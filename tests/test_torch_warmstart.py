"""The warm start in the port: the compile cache (``engine/compilecache.py``:
the kernels' library directory and the plan ledger), the lane's
persistent / prewarmed classification, the prewarm worker
(``server/prewarm.py``, ``engine/explain.build_prewarm_spec``) and the
warming flag from the server's heartbeat to the broker's routing.

The reference's ``tests/test_warmstart.py`` cases on the port
(``device="cpu"``): the ledger's corruption battery, every fingerprint
axis separating keys, the cache off without its environment variable, a
restart over the same cache root classifying its first launch
``persistent`` with EXPLAIN's compile state walking cold -> persistent ->
warm, a prewarm pass ahead of serving with EXPLAIN reading "prewarmed",
a stalled workload feed never blocking serving, the worker inert
without a feed, and routing deprioritizing (never excluding) a warming
replica.  The stabilizer's trim that waits for a warming destination and
the rolling-restart chaos scenario wait for ROADMAP queue 1 item 30
(rebalance and the stabilizer); they have no port case here yet.
"""
import json
import os
import tempfile
import threading
import time
from pathlib import Path

import pytest

from pinot_tpu.engine.plandigest import plan_shape_digest as ref_plan_shape_digest
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.tools.datagen import make_test_schema, random_rows

from pinot_tpu_torch.broker.health import ServerHealthTracker
from pinot_tpu_torch.broker.network_starter import NetworkedBrokerStarter
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.controller.controller import Controller
from pinot_tpu_torch.engine import compilecache, kernels
from pinot_tpu_torch.engine.explain import build_prewarm_spec
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.server.prewarm import leaked_prewarm_threads
from pinot_tpu_torch.tools.cluster_harness import single_server_broker

REF_SCHEMA = make_test_schema(with_mv=False)
SCHEMA = Schema.from_json(REF_SCHEMA.to_json())
PQL = "SELECT sum(metInt), count(*) FROM warmT GROUP BY dimStr TOP 5"


def _meter(server, name):
    return int(server.metrics.snapshot()["meters"].get(name, {}).get("count", 0))


def _build_segments(seed=11, num=2, rows_per=60):
    rows = random_rows(REF_SCHEMA, rows_per * num, seed=seed)
    return [build_segment(SCHEMA, rows[i * rows_per:(i + 1) * rows_per], "warmT", f"seg{i}") for i in range(num)]


def _broker():
    return single_server_broker("warmT", _build_segments(), pipeline=True, device="cpu")


def _close(broker):
    broker.shutdown()
    broker.local_servers[0].shutdown()


def _compile_state(broker, pql=PQL):
    return broker.handle_pql("EXPLAIN " + pql).explain["servers"][0]["device"]["compile"]


# ------------------------------------------------------------------
# the compile cache: library directory and plan ledger
# ------------------------------------------------------------------
def test_ledger_hit_and_every_corruption_is_a_miss(tmp_path):
    root = str(tmp_path)
    fp = compilecache.topology_fingerprint()
    assert compilecache.record_plan("d1a2b3c4", fp, root=root)
    assert compilecache.known_plan("d1a2b3c4", fp, root=root)
    assert not compilecache.known_plan("eeeeeeee", fp, root=root)
    assert not compilecache.known_plan("d1a2b3c4", "0" * 16, root=root)
    assert not compilecache.known_plan("", fp, root=root)
    path = compilecache._plan_path(root, "d1a2b3c4", fp)
    for content in ("\x00garbage not json", json.dumps(["alien"]),
                    json.dumps({"digest": "other", "fingerprint": fp}),
                    json.dumps({"digest": "d1a2b3c4", "fingerprint": "alienfp"}),
                    '{"digest": "d1a2b'):
        with open(path, "w") as f:
            f.write(content)
        assert not compilecache.known_plan("d1a2b3c4", fp, root=root), content
    assert compilecache.record_plan("d1a2b3c4", fp, root=root)  # a healthy re-record repairs it
    assert compilecache.known_plan("d1a2b3c4", fp, root=root)
    assert compilecache._plan_path(root, "../../escape", fp).startswith(os.path.join(root, "plans"))


def test_fingerprint_every_axis_separates_keys():
    base = compilecache.topology_fingerprint()
    assert base == compilecache.topology_fingerprint()
    variants = [
        compilecache.topology_fingerprint(torch_version="99.99.99"),
        compilecache.topology_fingerprint(cuda_version="13.9"),
        compilecache.topology_fingerprint(device_name="NVIDIA H100 80GB HBM3"),
        compilecache.topology_fingerprint(capability="9.0"),
        compilecache.topology_fingerprint(device_count=8),
        compilecache.topology_fingerprint(x64=False),
    ]
    assert all(v != base for v in variants), variants
    assert len(set(variants)) == len(variants)
    fp_a = compilecache.topology_fingerprint(device_count=8)
    fp_b = compilecache.topology_fingerprint(device_count=16)
    with tempfile.TemporaryDirectory() as root:
        assert compilecache.record_plan("abcd1234", fp_a, root=root)
        assert compilecache.known_plan("abcd1234", fp_a, root=root)
        assert not compilecache.known_plan("abcd1234", fp_b, root=root)


def test_cache_disabled_without_env(monkeypatch):
    monkeypatch.delenv("PINOT_TPU_COMPILE_CACHE_DIR", raising=False)
    assert compilecache.cache_root() is None and not compilecache.enabled()
    assert compilecache.library_dir() is None
    assert not compilecache.record_plan("d1") and not compilecache.known_plan("d1")
    # the kernels build in the checkout's build/ as before
    assert kernels.library_path("fused_groupby").parent == kernels.BUILD_DIR


def test_kernel_libraries_build_under_the_cache_root(tmp_path, monkeypatch):
    """With the cache on, each library's path lies under
    ``<root>/ext/<fingerprint>``, with the same file name as in build/
    (keyed by source and flags); a changed toolkit or card moves it."""
    plain = kernels.library_path("value_state_counts")
    monkeypatch.setenv("PINOT_TPU_COMPILE_CACHE_DIR", str(tmp_path))
    cached = kernels.library_path("value_state_counts")
    assert cached.parent == Path(tmp_path) / "ext" / compilecache.topology_fingerprint()
    assert cached.name == plain.name
    monkeypatch.setattr(compilecache.torch.version, "cuda", "99.9")
    assert kernels.library_path("value_state_counts").parent != cached.parent


# ------------------------------------------------------------------
# compile accounting across a restart
# ------------------------------------------------------------------
def test_persistent_hit_classification_across_restart(tmp_path, monkeypatch):
    """Generation 1 launches cold (``persistentMiss``); a fresh server over
    the same cache root classifies its first launch ``persistentHit`` with
    ``compile.cold == 0``; EXPLAIN walks cold -> persistent -> warm."""
    monkeypatch.setenv("PINOT_TPU_COMPILE_CACHE_DIR", str(tmp_path))
    broker1 = _broker()
    s1 = broker1.local_servers[0]
    try:
        assert _compile_state(broker1)["state"] == "cold"
        assert not broker1.handle_pql(PQL).exceptions
        assert _meter(s1, "compile.cold") == 1
        assert _meter(s1, "compile.persistentMiss") == 1 and _meter(s1, "compile.persistentHit") == 0
        assert _compile_state(broker1)["state"] == "warm"
    finally:
        _close(broker1)
    broker2 = _broker()
    s2 = broker2.local_servers[0]
    try:
        comp = _compile_state(broker2)
        assert comp == {"state": "persistent", "costAnalysis": "unavailable"}
        resp = broker2.handle_pql(PQL)
        assert not resp.exceptions
        assert _meter(s2, "compile.cold") == 0 and s2.metrics.timer("compile.firstCallMs").count == 0
        assert _meter(s2, "compile.persistentHit") == 1 and _meter(s2, "compile.persistentMiss") == 0
        comp = _compile_state(broker2)
        assert comp["state"] == "warm" and comp["via"] == "persistent" and comp["launches"] == 1
    finally:
        _close(broker2)


def test_without_the_cache_a_restart_is_cold_again(monkeypatch):
    monkeypatch.delenv("PINOT_TPU_COMPILE_CACHE_DIR", raising=False)
    for _ in range(2):
        broker = _broker()
        try:
            assert _compile_state(broker)["state"] == "cold"
            assert not broker.handle_pql(PQL).exceptions
            assert _meter(broker.local_servers[0], "compile.cold") == 1
            assert _meter(broker.local_servers[0], "compile.persistentMiss") == 0
        finally:
            _close(broker)


# ------------------------------------------------------------------
# prewarm worker
# ------------------------------------------------------------------
def test_prewarm_launches_ahead_and_reports_readiness(tmp_path, monkeypatch):
    """The worker replays the fleet's workload feed through the phantom
    BEFORE any query: the warming flag flips synchronously and clears when
    the pass drains, EXPLAIN reads "prewarmed", and the first serving
    query counts warm, never cold."""
    monkeypatch.setenv("PINOT_TPU_COMPILE_CACHE_DIR", str(tmp_path))
    broker1 = _broker()
    try:
        assert not broker1.handle_pql(PQL).exceptions
        entries = broker1.workload_snapshot(top=8)["topByCount"]
        assert entries and entries[0]["exemplarPql"] == PQL
        # the digest the feed carries is the reference's shape digest
        assert entries[0]["digest"] == ref_plan_shape_digest(ref_optimize(ref_parse(PQL)))
    finally:
        _close(broker1)
    broker2 = _broker()
    s2 = broker2.local_servers[0]
    try:
        assert not s2.prewarm.enabled
        staged_before = s2.executor.staged_bytes()
        s2.prewarm.workload_source = lambda tables, n: entries
        s2.prewarm.request_prewarm("warmT")
        assert s2.prewarm.warming
        deadline = time.monotonic() + 30.0
        while s2.prewarm.warming and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not s2.prewarm.warming, s2.prewarm.state()
        assert _meter(s2, "prewarm.compiled") == 1 and _meter(s2, "compile.prewarmed") == 1
        assert _meter(s2, "prewarm.failed") == 0 and _meter(s2, "compile.cold") == 0
        # nothing of the table was staged, and the lane never launched
        assert s2.executor.staged_bytes() == staged_before == 0 and s2.lane.stats()["dispatches"] == 0
        comp = _compile_state(broker2)
        assert comp["state"] == "prewarmed" and comp["launches"] == 0 and comp["firstCallMs"] > 0
        assert not broker2.handle_pql(PQL).exceptions
        assert _meter(s2, "compile.cold") == 0 and _meter(s2, "compile.warm") == 1
        assert _compile_state(broker2)["state"] == "warm"
        st = s2.prewarm.state()
        assert st["ready"] and st["compiled"] == 1 and st["lastPassMs"] is not None
    finally:
        _close(broker2)
    assert not leaked_prewarm_threads()


@pytest.mark.parametrize("pql", [
    "SELECT sum(metInt) FROM warmT WHERE dimInt > 30 GROUP BY dimStr TOP 5",
    "SELECT distinctcount(dimInt) FROM warmT GROUP BY dimStr TOP 5",
    "SELECT percentile90(metInt) FROM warmT",
    "SELECT sum(metFloat) FROM warmT GROUP BY dimStr, dimInt TOP 5",
])
def test_prewarm_spec_digest_is_the_one_execution_launches(pql):
    """``build_prewarm_spec`` yields the digest the lane records when the
    query runs, launches without staging the table, and skips a digest
    that already launched."""
    broker = _broker()
    server = broker.local_servers[0]
    try:
        request = optimize_request(parse_pql(pql))
        segs = [a.query_view() for a in server.data_manager.table("warmT").acquire_segments()]
        spec = build_prewarm_spec(server.executor, segs, request)
        assert spec is not None and spec["lane"] is server.lane
        spec["compile"]()
        assert server.executor.staged_bytes() == 0
        assert not broker.handle_pql(pql).exceptions
        assert server.lane.compile_info(spec["planDigest"]) is not None
        assert build_prewarm_spec(server.executor, segs, request) is None
    finally:
        _close(broker)


def test_prewarm_spec_skips_shapes_without_a_table_kernel():
    """A shape the bit-sliced tier or the host serves launches no table
    kernel: nothing to prewarm."""
    broker = _broker()
    server = broker.local_servers[0]
    try:
        segs = [a.query_view() for a in server.data_manager.table("warmT").acquire_segments()]
        for pql in ("SELECT count(*) FROM warmT WHERE dimInt BETWEEN 10 AND 40",
                    "SELECT avg(metFloat) FROM warmT WHERE dimStr = 'a'"):
            assert build_prewarm_spec(server.executor, segs, optimize_request(parse_pql(pql))) is None, pql
    finally:
        _close(broker)


def test_prewarm_never_blocks_serving():
    broker = _broker()
    server = broker.local_servers[0]
    entered, release = threading.Event(), threading.Event()

    def stalled_source(tables, n):
        entered.set()
        release.wait(timeout=10.0)
        return []

    try:
        server.prewarm.workload_source = stalled_source
        server.prewarm.request_prewarm()
        assert entered.wait(timeout=5.0)
        assert not broker.handle_pql(PQL).exceptions
        assert server.prewarm.warming
    finally:
        release.set()
        _close(broker)
    assert not server.prewarm.warming


def test_prewarm_disabled_without_feed_or_topk():
    broker = _broker()
    server = broker.local_servers[0]
    try:
        assert not server.prewarm.enabled
        server.prewarm.request_prewarm("warmT")
        assert not server.prewarm.warming and server.prewarm._thread is None
        server.prewarm.workload_source = lambda tables, n: []
        server.prewarm.top_k = 0
        assert not server.prewarm.enabled
        server.prewarm.request_prewarm("warmT")
        assert not server.prewarm.warming
    finally:
        _close(broker)


# ------------------------------------------------------------------
# the warming flag: heartbeat -> controller -> broker routing
# ------------------------------------------------------------------
def test_routing_deprioritizes_warming_replica():
    provider = RoutingTableProvider(num_tables=4)
    segments = [f"seg{i}" for i in range(4)]
    provider.update("t_OFFLINE", {seg: {"s1": "ONLINE", "s2": "ONLINE"} for seg in segments})
    health = ServerHealthTracker()
    health.set_warming("s1", True)
    for _ in range(10):
        rt = provider.find_servers("t_OFFLINE", health=health)
        assert set(rt) == {"s2"} and sorted(sum(rt.values(), [])) == segments
    health.set_warming("s1", False)
    seen = set()
    for _ in range(40):
        seen.update(provider.find_servers("t_OFFLINE", health=health))
    assert seen == {"s1", "s2"}
    provider.update("sole_OFFLINE", {seg: {"s1": "ONLINE"} for seg in segments})
    health.set_warming("s1", True)
    rt = provider.find_servers("sole_OFFLINE", health=health)
    assert set(rt) == {"s1"} and sorted(sum(rt.values(), [])) == segments
    health.set_warming_servers({"s2"})
    assert health.is_warming("s2") and not health.is_warming("s1")
    assert health.warming_servers() == {"s2"}


def test_heartbeat_warming_flag_reaches_the_broker(tmp_path):
    """A server's heartbeat ``warming`` flag lands on its controller
    instance, bumps the cluster-state version and lists it in
    ``warmingServers``, which the networked broker mirrors into its
    health tracker; a heartbeat without the key leaves it alone."""
    ctrl = Controller(str(tmp_path))
    gw = ctrl.gateway
    gw.register({"name": "s1", "role": "server", "addr": ["127.0.0.1", 9]})
    gw.register({"name": "s2", "role": "server", "addr": ["127.0.0.1", 10]})
    v0 = gw.cluster_state()["version"]
    gw.heartbeat("s1", {"warming": True})
    state = gw.cluster_state()
    assert state["warmingServers"] == ["s1"] and state["version"] > v0
    assert ctrl.resources.is_instance_warming("s1")
    gw.heartbeat("s1", {})
    assert gw.cluster_state()["warmingServers"] == ["s1"]
    starter = NetworkedBrokerStarter("http://127.0.0.1:9")
    try:
        starter._apply_state(state)
        assert starter.handler.health.warming_servers() == {"s1"}
        gw.heartbeat("s1", {"warming": False})
        starter._apply_state(gw.cluster_state())
        assert starter.handler.health.warming_servers() == set()
    finally:
        starter.http._httpd.server_close()
        starter.handler.shutdown()
