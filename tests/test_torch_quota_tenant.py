"""Quotas and tenants in the port against the JAX package, on the same
schema, rows and calls.

Three faults the port had and the reference does not:

- the storage quota (``QuotaConfig.storage``): the reference refuses an
  upload that would push a table's durable copy past it, fresh or a
  refresh, before its store is touched (``Controller.
  _check_storage_quota``); the port stored and served it (440 docs where
  the reference serves 40);
- the query-rate quota (``QuotaConfig.max_queries_per_second``): the
  reference's broker sheds a query past the rate with 429 before any
  scatter (``broker/quota.py``); the port answered every query;
- a table on a tenant with no live servers: the reference refuses it
  (``validate_tenants``); the port accepted it and failed at the first
  upload.

Beside them, the reference's token-bucket and quota-manager cases
(``tests/test_conf_quota.py``) run against both packages' ``quota.py``,
and the live quota update reaches the port's in-process and networked
brokers.
"""
import json
import re
import tempfile
import urllib.error
import urllib.request

import pytest

import pinot_tpu.broker.quota as ref_quota
from pinot_tpu.common.tableconfig import QuotaConfig as RefQuotaConfig
from pinot_tpu.common.tableconfig import TableConfig as RefTableConfig
from pinot_tpu.controller.controller import Controller as RefController
from pinot_tpu.controller.controller import ControllerHttpServer as RefControllerHttpServer
from pinot_tpu.realtime.stream import MemoryStreamProvider as RefStream
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.segment.format import write_segment as ref_write_segment
from pinot_tpu.tools.cluster_harness import InProcessCluster as RefCluster
from pinot_tpu.tools.datagen import make_test_schema, random_rows

import pinot_tpu_torch.broker.quota as port_quota
from pinot_tpu_torch.broker.network_starter import NetworkedBrokerStarter
from pinot_tpu_torch.common.response import ErrorCode
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.tableconfig import QuotaConfig, StreamConfig, TableConfig
from pinot_tpu_torch.controller.controller import Controller, ControllerHttpServer
from pinot_tpu_torch.realtime.stream import MemoryStreamProvider
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.segment.format import write_segment
from pinot_tpu_torch.tools.cluster_harness import InProcessCluster

REF_SCHEMA = make_test_schema(with_mv=False)
SCHEMA = Schema.from_json(REF_SCHEMA.to_json())
COUNT = "SELECT count(*) FROM testTable"
QUOTA_MODULES = pytest.mark.parametrize("quota", [ref_quota, port_quota], ids=["reference", "port"])


@pytest.fixture
def clusters(tmp_path):
    """(reference, port) in-process clusters of one server each."""
    ref = RefCluster(num_servers=1, data_dir=str(tmp_path / "ref"))
    port = InProcessCluster(num_servers=1, data_dir=str(tmp_path / "port"), device="cpu")
    try:
        yield ref, port
    finally:
        port.stop()
        ref.stop()


def _codes(resp):
    return [(e.error_code, e.message) for e in resp.exceptions]


# ------------------------------------------------------- fault 19: storage
def test_storage_quota_rejects_upload_as_the_reference(clusters):
    """The steps of the reference's ``test_storage_quota_rejects_upload``
    on both clusters: the larger upload is refused with the reference's
    ValueError and leaves no trace, and a refresh past the quota leaves
    the previous copy intact; both serve 40 docs (the port served 440)."""
    ref, port = clusters
    rows = random_rows(REF_SCHEMA, 400, seed=17)
    ref_phys = ref.add_offline_table(REF_SCHEMA, quota=RefQuotaConfig(storage="5K"))
    phys = port.add_offline_table(SCHEMA, quota=QuotaConfig(storage="5K"))
    assert phys == ref_phys
    ref.upload(ref_phys, ref_build_segment(REF_SCHEMA, rows[:40], ref_phys, "small"))
    port.upload(phys, build_segment(SCHEMA, rows[:40], phys, "small"))
    errors = []
    for cluster, build, schema in ((ref, ref_build_segment, REF_SCHEMA), (port, build_segment, SCHEMA)):
        with pytest.raises(ValueError, match="storage quota") as e:
            cluster.upload(phys, build(schema, rows, phys, "big"))
        errors.append(str(e.value))
        assert not cluster.controller.store.exists(phys, "big")
        assert "big" not in cluster.controller.resources.segments_of(phys)
    pattern = rf"storage quota exceeded for {phys}: \d+ used \+ \d+ incoming > 5120 quota"
    assert all(re.fullmatch(pattern, m) for m in errors), errors
    assert port.query(COUNT).num_docs_scanned == ref.query(COUNT).num_docs_scanned == 40

    # a refresh past the quota is refused before the store is touched
    for cluster, build, schema in ((ref, ref_build_segment, REF_SCHEMA), (port, build_segment, SCHEMA)):
        before = cluster.controller.store.segment_size_bytes(phys, "small")
        with pytest.raises(ValueError, match="storage quota"):
            cluster.upload(phys, build(schema, rows, phys, "small"))
        assert cluster.controller.store.segment_size_bytes(phys, "small") == before
    assert port.query(COUNT).num_docs_scanned == ref.query(COUNT).num_docs_scanned == 40


def _post(url: str, data: bytes, ctype: str = "application/json"):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_upload_over_the_storage_quota_answers_as_the_reference(tmp_path):
    """``POST /segments/<table>`` past the quota: the reference's status
    (400) and message, nothing stored; an upload within it is taken."""
    rows = random_rows(REF_SCHEMA, 400, seed=3)
    replies = []
    for label, ctrl_cls, http_cls, config_cls, quota_cls, build, write, schema in (
        ("ref", RefController, RefControllerHttpServer, RefTableConfig, RefQuotaConfig, ref_build_segment,
         ref_write_segment, REF_SCHEMA),
        ("port", Controller, ControllerHttpServer, TableConfig, QuotaConfig, build_segment, write_segment, SCHEMA),
    ):
        ctrl = ctrl_cls(str(tmp_path / label))
        http = http_cls(ctrl)
        http.start()
        try:
            # a remote server to assign to (its transitions just queue)
            ctrl.gateway.register({"name": "s0", "role": "server", "addr": ["127.0.0.1", 9]})
            ctrl.add_schema(schema)
            phys = ctrl.add_table(config_cls("testTable", quota=quota_cls(storage="8K")))
            statuses = []
            for name, part in (("small", rows[:30]), ("big", rows)):
                with tempfile.TemporaryDirectory() as td:
                    path = write(build(schema, part, phys, name), td)
                    with open(path, "rb") as f:
                        data = f.read()
                statuses.append(_post(f"http://{http.host}:{http.port}/segments/{phys}", data, "application/octet-stream"))
            assert not ctrl.store.exists(phys, "big")
            replies.append(statuses)
        finally:
            http.stop()
    (ref_small, ref_big), (small, big) = replies
    assert small[0] == ref_small[0] == 200 and small[1]["status"] == ref_small[1]["status"] == "ok"
    assert big[0] == ref_big[0] == 400
    pattern = r"storage quota exceeded for testTable_OFFLINE: \d+ used \+ \d+ incoming > 8192 quota"
    assert re.fullmatch(pattern, big[1]["error"]) and re.fullmatch(pattern, ref_big[1]["error"])


# --------------------------------------------------------- fault 20: rate
def test_query_rate_quota_sheds_as_the_reference(clusters):
    """A table at 1.0 qps, five queries in a row: both brokers answer the
    first and shed the next four with 429 and the same message (the port
    answered all five)."""
    ref, port = clusters
    rows = random_rows(REF_SCHEMA, 10, seed=1)
    ref_phys = ref.add_offline_table(REF_SCHEMA, quota=RefQuotaConfig(max_queries_per_second=1.0))
    phys = port.add_offline_table(SCHEMA, quota=QuotaConfig(max_queries_per_second=1.0))
    ref.upload(ref_phys, ref_build_segment(REF_SCHEMA, rows, ref_phys, "q1"))
    port.upload(phys, build_segment(SCHEMA, rows, phys, "q1"))
    ref_codes = [_codes(ref.query(COUNT)) for _ in range(5)]
    codes = [_codes(port.query(COUNT)) for _ in range(5)]
    assert codes == ref_codes
    assert codes[0] == [] and all(
        c == [(ErrorCode.TOO_MANY_REQUESTS, "query rate on table testTable exceeds the configured quota")]
        for c in codes[1:])
    assert port.broker.metrics.meter("admission.shedQuota").count == 4


def test_quota_live_update_reaches_the_inprocess_broker(clusters):
    """``update_table_quota`` (the reference's live path): the running
    broker enforces a new rate on the next query and stops at a removal,
    as the reference's does."""
    ref, port = clusters
    rows = random_rows(REF_SCHEMA, 10, seed=1)
    outcomes = []
    for cluster, build, schema in ((ref, ref_build_segment, REF_SCHEMA), (port, build_segment, SCHEMA)):
        phys = cluster.add_offline_table(schema)
        cluster.upload(phys, build(schema, rows, phys, "q1"))
        seen = [_codes(cluster.query(COUNT))]
        cluster.controller.resources.update_table_quota(phys, 1.0)
        seen += [_codes(cluster.query(COUNT)) for _ in range(2)]
        cluster.controller.resources.update_table_quota(phys, None)
        seen.append(_codes(cluster.query(COUNT)))
        outcomes.append(seen)
    assert outcomes[1] == outcomes[0]
    assert [bool(c) for c in outcomes[1]] == [False, False, True, False]
    with pytest.raises(KeyError):
        port.controller.resources.update_table_quota("nope_OFFLINE", 1.0)


def test_networked_broker_follows_quota_updates_and_removal():
    """The reference's ``test_networked_quota_propagation_update_and_
    removal`` on the port's networked broker: the snapshot's quota lands,
    an unchanged re-poll and an update never refill the drained bucket,
    and a removal clears it."""
    starter = NetworkedBrokerStarter("http://127.0.0.1:9")  # never polled
    try:
        quota = starter.handler.quota

        def snap(version, quotas):
            return {"version": version, "epoch": "e1", "servers": {}, "tables": {}, "quotas": quotas}

        starter._apply_state(snap(1, {"T_OFFLINE": {"rawName": "T", "maxQueriesPerSecond": 2.0}}))
        assert quota.allow("T") and quota.allow("T") and not quota.allow("T")
        starter._apply_state(snap(2, {"T_OFFLINE": {"rawName": "T", "maxQueriesPerSecond": 2.0}}))
        assert not quota.allow("T")
        starter._apply_state(snap(3, {"T_OFFLINE": {"rawName": "T", "maxQueriesPerSecond": 50.0,
                                                    "burstQueries": 60.0}}))
        assert not quota.allow("T")
        starter._apply_state(snap(4, {}))
        assert quota.allow("T") and quota.tables() == []
    finally:
        starter.http._httpd.server_close()
        starter.handler.shutdown()


def test_controller_quota_route_moves_the_cluster_state(tmp_path):
    """``POST /tables/<t>/quota`` updates the table's quota in the
    snapshot networked brokers poll, at a new version; a null rate
    removes it; an unknown table is a 404."""
    ctrl = Controller(str(tmp_path))
    http = ControllerHttpServer(ctrl)
    http.start()
    try:
        ctrl.add_schema(SCHEMA)
        phys = ctrl.add_table(TableConfig("testTable"))
        v0 = ctrl.gateway.cluster_state()["version"]
        status, body = _post(f"{http.url}/tables/{phys}/quota",
                             json.dumps({"maxQueriesPerSecond": 3.0, "burstQueries": 6.0}).encode())
        assert status == 200 and body == {"status": "ok", "table": phys}
        state = ctrl.gateway.cluster_state()
        assert state["version"] > v0
        assert state["quotas"][phys]["maxQueriesPerSecond"] == 3.0 and state["quotas"][phys]["burstQueries"] == 6.0
        _post(f"{http.url}/tables/{phys}/quota", json.dumps({"maxQueriesPerSecond": None}).encode())
        assert ctrl.gateway.cluster_state()["quotas"][phys]["maxQueriesPerSecond"] is None
        assert _post(f"{http.url}/tables/nope_OFFLINE/quota", b"{}")[0] == 404
    finally:
        http.stop()


# ------------------------------------------- the reference's bucket cases
@QUOTA_MODULES
def test_token_bucket_quota(quota):
    qm = quota.QueryQuotaManager()
    qm.set_quota("t", 2.0)
    assert qm.allow("t") and qm.allow("t")
    assert not qm.allow("t")
    assert qm.allow("other")
    qm.set_quota("t", None)
    assert qm.allow("t")


@QUOTA_MODULES
def test_quota_headroom(quota):
    qm = quota.QueryQuotaManager()
    assert qm.headroom("unlimited") == 1.0
    qm.set_quota("t", 2.0)
    assert qm.headroom("t") == 1.0
    qm.allow("t")
    qm.allow("t")
    assert qm.headroom("t") < 0.5


@QUOTA_MODULES
def test_token_bucket_fractional_qps(quota):
    b = quota._TokenBucket(0.5)
    assert b.capacity == 1.0
    assert b.try_acquire() and not b.try_acquire()
    b.last -= 1.0
    assert not b.try_acquire()
    b.last -= 1.5
    assert b.try_acquire()


@QUOTA_MODULES
def test_token_bucket_burst_capacity(quota):
    b = quota._TokenBucket(2.0, burst=5.0)
    assert b.capacity == 5.0
    for _ in range(5):
        assert b.try_acquire()
    assert not b.try_acquire()
    b.last -= 1.0
    assert b.try_acquire() and b.try_acquire()
    assert not b.try_acquire()
    b.last -= 60.0
    assert b.headroom() == 1.0


@QUOTA_MODULES
def test_token_bucket_sub_one_burst_cannot_block_table(quota):
    b = quota._TokenBucket(4.0, burst=0.5)
    assert b.capacity == 1.0 and b.try_acquire()
    b2 = quota._TokenBucket(4.0)
    b2.reconfigure(4.0, burst=0.25)
    assert b2.capacity == 1.0 and b2.try_acquire()


@QUOTA_MODULES
def test_token_bucket_reconfigure_preserves_tokens(quota):
    b = quota._TokenBucket(2.0)
    assert b.try_acquire() and b.try_acquire()
    b.reconfigure(10.0)
    assert not b.try_acquire() and b.qps == 10.0
    b2 = quota._TokenBucket(4.0, burst=8.0)
    b2.reconfigure(1.0)
    assert b2.tokens == 1.0 == b2.capacity


@QUOTA_MODULES
def test_quota_manager_set_quota_idempotent_no_refill(quota):
    qm = quota.QueryQuotaManager()
    qm.set_quota("t", 2.0)
    assert qm.allow("t") and qm.allow("t") and not qm.allow("t")
    qm.set_quota("t", 2.0)
    assert not qm.allow("t")
    qm.set_quota("t", 5.0)
    assert not qm.allow("t")
    assert qm.tables() == ["t"]
    qm.set_quota("t", None)
    assert qm.allow("t") and qm.tables() == []


@QUOTA_MODULES
def test_quota_headroom_edges(quota):
    qm = quota.QueryQuotaManager()
    qm.set_quota("t", 1.0)
    assert qm.headroom("t") == 1.0
    qm.allow("t")
    assert qm.headroom("t") < 0.1
    qm.set_quota("b", 2.0, burst=10.0)
    qm.allow("b")
    assert 0.85 < qm.headroom("b") < 0.95


# ------------------------------------------------------ fault 21: tenants
@pytest.mark.parametrize("kind", ["OFFLINE", "REALTIME"])
def test_table_on_a_dead_tenant_is_refused_as_the_reference(clusters, kind):
    """A table on ``server_tenant="T1"``, which has no servers: both
    controllers refuse it with the reference's ValueError and keep no
    trace (the port accepted it and failed at the first upload)."""
    ref, port = clusters
    errors = []
    for cluster, schema, config_cls, stream_of in (
        (ref, REF_SCHEMA, RefTableConfig, lambda: RefStream(1)),
        (port, SCHEMA, TableConfig, lambda: MemoryStreamProvider(1)),
    ):
        cluster.controller.add_schema(schema)
        kwargs = {"server_tenant": "T1"}
        with pytest.raises(ValueError) as e:
            if kind == "OFFLINE":
                cluster.controller.add_table(config_cls("testTable", **kwargs))
            else:
                stream_kw = {}
                if config_cls is TableConfig:
                    stream_kw["stream"] = StreamConfig(stream_type="memory", rows_per_segment=100)
                cluster.controller.add_realtime_table(
                    config_cls("testTable", table_type="REALTIME", **kwargs, **stream_kw), stream_of())
        errors.append(str(e.value))
        assert cluster.controller.resources.tables() == []
    assert errors[1] == errors[0] == "server tenant 'T1' has no live servers"
    # the default tenant and a broker tenant of the live broker are taken
    for cluster, config_cls in ((ref, RefTableConfig), (port, TableConfig)):
        with pytest.raises(ValueError, match="broker tenant 'B1' has no live brokers"):
            cluster.controller.add_table(config_cls("testTable", broker_tenant="B1"))
    assert port.controller.add_table(TableConfig("testTable")) == "testTable_OFFLINE"
