"""The port's high-level consumers (HLC) on the CPU, held against the JAX
package.

An HLC table has one consumer a server, a member of the table's consumer
group: the stream broker (or, for a Kafka stream, Kafka's group
coordinator) assigns it partitions and rebalances them as members come and
go; its segment seals at the row threshold, uploads pinned to its server,
then the group's offsets commit and consumption rolls to the next
sequence.  Delivery is at least once across a rebalance.

- ``ensure_hlc_consumers`` in the window between a seal's upload and its
  roll continues the server's own idx (the reference's regression case),
  with the same ideal states as the reference.
- A two-member group of port ``NetworkedServerStarter``s (``device="cpu"``)
  over the native stream's consumer groups and over the Kafka group
  protocol: segments seal, roll and answer, equal to the reference
  executor over the same rows.
- A member leaving mid-segment: the survivor's revoke seals and commits
  before it takes the partitions over, and no committed row is lost.
- The ``kafka`` / ``highlevel`` table configs round-trip to the
  reference's JSON.
Every wait has a deadline; each test stops what it starts.
"""
import contextlib
import importlib
import json
import signal
import time
import urllib.request

import pytest

from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import make_test_schema
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

PKGS = ("pinot_tpu", "pinot_tpu_torch")
TABLE = "hlcTable"
PHYSICAL = "hlcTable_REALTIME"
REL, ABS = 5e-4, 1e-3
QUERIES = (
    "SELECT count(*) FROM hlcTable",
    "SELECT sum(metInt), sum(metDouble), count(*) FROM hlcTable GROUP BY dimStr TOP 10",
    "SELECT distinctcount(dimInt) FROM hlcTable WHERE metInt > 20",
)


def M(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@contextlib.contextmanager
def time_limit(seconds: int):
    """Fail the test with TimeoutError past ``seconds`` (its own limit)."""
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _wait(cond, what, deadline_s=60.0):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out after {deadline_s} s waiting for {what}")


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _row(i):
    return {"dimStr": f"v{i % 5}", "dimInt": i % 7, "dimLong": i, "metInt": i, "metFloat": 0.5 * i,
            "metDouble": 0.25 * i, "daysSinceEpoch": 17000 + i}


def _schema(pkg: str):
    schema = M(pkg, "common.schema").Schema.from_json(make_test_schema(with_mv=False).to_json())
    schema.schema_name = TABLE
    return schema


# -------------------------------------------------------- the controller side
def _mid_roll(pkg: str) -> list:
    rm_mod, llc = M(pkg, "controller.resource_manager"), M(pkg, "realtime.llc")
    tc = M(pkg, "common.tableconfig")
    rm = rm_mod.ClusterResourceManager()
    rm.register_instance(rm_mod.InstanceState(name="srvA", role="server"))
    config = tc.TableConfig(table_name="hlcRace", table_type="REALTIME", stream=tc.StreamConfig(
        stream_type="memory", topic="t", consumer_type="highlevel"))
    mgr = llc.RealtimeSegmentManager(rm, store=None)
    physical = mgr.setup_table(config, _schema(pkg), M(pkg, "realtime.stream").MemoryStreamProvider(2))
    seen = [rm.get_ideal_state(physical)]
    seg0 = llc.make_segment_name(physical, 0, 0)
    # the mid-roll window: the sealed upload turned the entry ONLINE (still
    # pinned to srvA) and the roll has not registered seq 1 yet
    with rm._lock:
        rm.ideal_states[physical][seg0] = {"srvA": rm_mod.ONLINE}
    mgr.ensure_hlc_consumers(physical)
    seen.append(rm.get_ideal_state(physical))
    mgr.register_hlc_roll(physical, "srvA", 0, 1)  # the server's own roll dedupes
    seen.append(rm.get_ideal_state(physical))
    # a second live server gets a fresh idx; the validation hook repairs HLC
    rm.register_instance(rm_mod.InstanceState(name="srvB", role="server"))
    mgr.ensure_consuming_segments()
    seen.append(rm.get_ideal_state(physical))
    with pytest.raises(ValueError, match="not a highlevel-consumer table"):
        mgr.register_hlc_roll("other_REALTIME", "srvA", 0, 1)
    return seen


def test_ensure_hlc_consumers_resumes_owned_idx_mid_roll():
    with time_limit(30):
        ref, port = (_mid_roll(pkg) for pkg in PKGS)
    assert ref[0] == {"hlcRace_REALTIME__0__0": {"srvA": "CONSUMING"}}
    assert ref[1] == {"hlcRace_REALTIME__0__0": {"srvA": "ONLINE"}, "hlcRace_REALTIME__0__1": {"srvA": "CONSUMING"}}
    assert ref[2] == ref[1] and ref[3]["hlcRace_REALTIME__1__0"] == {"srvB": "CONSUMING"}
    assert port == ref


def test_kafka_and_highlevel_configs_round_trip_to_reference_json():
    for stream_type in ("kafka", "network"):
        for consumer in ("highlevel", "lowlevel"):
            ref_tc, port_tc = (M(pkg, "common.tableconfig") for pkg in PKGS)
            ref = ref_tc.TableConfig("rt", table_type="REALTIME", replication=2, stream=ref_tc.StreamConfig(
                stream_type=stream_type, topic="t", rows_per_segment=5000, consumer_type=consumer,
                properties={"host": "127.0.0.1", "port": 9092}))
            port = port_tc.TableConfig.from_json(ref.to_json())
            assert port.stream.stream_type == stream_type and port.stream.consumer_type == consumer
            assert port.to_json() == ref.to_json()
            assert json.dumps(ref_tc.TableConfig.from_json(port.to_json()).to_json()) == json.dumps(ref.to_json())


# ------------------------------------------------------------ the deployment
@contextlib.contextmanager
def _cluster(tmp_path, protocol: str, rows_per_segment: int, partitions: int = 4, servers: int = 2):
    """A port controller over HTTP, ``servers`` NetworkedServerStarters on
    the CPU and a NetworkedBrokerStarter, with an HLC table over a stream of
    ``partitions`` partitions (the native stream broker's groups, or Kafka's
    through the shim).  Yields (ctrl, starters, broker query URL, producer,
    group describer)."""
    from pinot_tpu_torch.broker.network_starter import NetworkedBrokerStarter
    from pinot_tpu_torch.common.tableconfig import StreamConfig, TableConfig
    from pinot_tpu_torch.controller.controller import Controller, ControllerHttpServer
    from pinot_tpu_torch.realtime.kafka import KafkaProtocolShim
    from pinot_tpu_torch.realtime.netstream import HLConsumer, NetworkStreamProvider, StreamBrokerServer
    from pinot_tpu_torch.server.network_starter import NetworkedServerStarter

    sb = StreamBrokerServer()
    sb.start()
    shim = ctrl = http = broker = None
    starters = []
    try:
        host, port = sb.address
        producer = NetworkStreamProvider(host, port, "hltopic")
        producer.create_topic(partitions)
        s_host, s_port = host, port
        if protocol == "kafka":
            shim = KafkaProtocolShim(sb).start()
            s_host, s_port = shim.address
        ctrl = Controller(str(tmp_path / "controller"), heartbeat_timeout_s=2.0)
        http = ControllerHttpServer(ctrl)
        http.start()
        for i in range(servers):
            s = NetworkedServerStarter(http.url, f"h{i}", device="cpu", precision="x64", heartbeat_interval_s=0.3,
                                       poll_interval_s=0.1)
            s.start()
            starters.append(s)
        broker = NetworkedBrokerStarter(http.url, "broker0", port=0)
        broker.start()
        _post(http.url + "/schemas", _schema("pinot_tpu_torch").to_json())
        config = TableConfig(TABLE, table_type="REALTIME", stream=StreamConfig(
            stream_type="kafka" if protocol == "kafka" else "network", topic="hltopic",
            rows_per_segment=rows_per_segment, consumer_type="highlevel", properties={"host": s_host, "port": s_port}))
        assert _post(http.url + "/tables", config.to_json()) == {"status": "ok", "table": PHYSICAL}

        if protocol == "kafka":
            def members():
                return sorted({c.consumer.member_id for s in starters for c in s._consumers.values()
                               if getattr(c, "rolls_locally", False) and c.consumer.generation > 0
                               and c.consumer.assignment})
        else:
            probe = HLConsumer(host, port, "hltopic", PHYSICAL, "probe")

            def members():
                d = probe.describe_group()
                return [] if d["syncPending"] else d["members"]
        yield ctrl, starters, f"http://127.0.0.1:{broker.http.port}/query", producer, members
    finally:
        if broker is not None:
            broker.stop()
        for s in starters:
            s.stop()
        if http is not None:
            http.stop()
        if ctrl is not None:
            ctrl.stop()
        if shim is not None:
            shim.stop()
        sb.stop()


def _count(url) -> int:
    resp = _post(url, {"pql": QUERIES[0]})
    return -1 if resp.get("exceptions") else int(resp["numDocsScanned"])


def _check_answers(url, rows) -> None:
    ref_seg = ref_build_segment(make_test_schema(with_mv=False), rows, PHYSICAL, "all")
    for pql in QUERIES:
        got = _post(url, {"pql": pql})
        assert not got["exceptions"], got
        req = ref_optimize(ref_parse(pql))
        want = canonical_payload(req, RefExecutor().execute([ref_seg], req))
        assert payloads_equivalent(strip_accounting(got), want, rel_tol=REL, abs_tol=ABS), (pql, got, want)


@pytest.mark.parametrize("protocol", ["native", "kafka"])
def test_two_member_group_seals_rolls_and_answers(tmp_path, protocol):
    """Two servers of one group split four partitions; each seals its
    segment at 40 rows, uploads it pinned to itself and rolls; the answers
    equal the reference executor's over the rows produced."""
    from pinot_tpu_torch.realtime.llc import parse_segment_name

    with time_limit(150), _cluster(tmp_path, protocol, rows_per_segment=40) as (ctrl, starters, url, producer,
                                                                                   members):
        _wait(lambda: len(members()) == 2, "both servers in the group")
        rows = [_row(i) for i in range(120)]
        for i, r in enumerate(rows):
            producer.produce(r, partition=i % 4)
        _wait(lambda: _count(url) == len(rows), "every row counted once", 90)

        def sealed():
            view = ctrl.resources.get_external_view(PHYSICAL)
            online = {s: r for s, r in view.items() if "ONLINE" in r.values()}
            return online if len({next(iter(r)) for r in online.values()}) == 2 else None

        online = _wait(sealed, "a sealed segment ONLINE on each server", 60)
        for seg, replicas in online.items():
            (server,) = replicas  # pinned to the server that consumed it
            meta = ctrl.resources.get_segment_metadata(PHYSICAL, seg)["metadata"]
            assert meta.num_docs >= 40, (seg, meta.num_docs)
            _, idx, seq = parse_segment_name(seg)
            consumer = next(c for c in next(s for s in starters if s.name == server)._consumers.values())
            assert consumer.idx == idx and consumer.seq > seq  # rolled on
        _wait(lambda: _count(url) == len(rows), "every row counted once after the seals", 60)
        _check_answers(url, rows)
        for s in starters:
            st = s.server.status()
            assert st["metrics"]["meters"]["ingest.rowsConsumed"]["count"] >= 40
            assert st["metrics"]["timers"]["ingest.commitUploadMs"]["count"] >= 1


def test_revoke_mid_segment_loses_no_committed_row(tmp_path):
    """A member leaves with rows in its unsealed segment; the survivor's
    next poll sees the rebalance, seals and commits its own rows (the
    revoke), then reads the partitions it took over from their committed
    offsets: every produced row is counted, the committed ones once."""
    from pinot_tpu_torch.realtime.netstream import HLConsumer

    with time_limit(150), _cluster(tmp_path, "native", rows_per_segment=1000) as (ctrl, starters, url, producer,
                                                                                     members):
        _wait(lambda: len(members()) == 2, "both servers in the group")
        rows = [_row(i) for i in range(60)]
        for i, r in enumerate(rows):
            producer.produce(r, partition=i % 4)
        _wait(lambda: _count(url) == 60, "60 rows, none sealed")
        survivor, leaver = starters
        assert not ctrl.resources.get_external_view(PHYSICAL) or all(
            "ONLINE" not in r.values() for r in ctrl.resources.get_external_view(PHYSICAL).values())
        leaver.stop()  # leaves the group; its unsealed rows were never committed
        starters.remove(leaver)
        _wait(lambda: members() == ["h0"], "the group down to the survivor")

        def revoked():
            view = ctrl.resources.get_external_view(PHYSICAL)
            return [s for s, r in view.items() if r == {"h0": "ONLINE"}]

        (sealed,) = _wait(revoked, "the survivor's revoke-time seal ONLINE")
        assert ctrl.resources.get_segment_metadata(PHYSICAL, sealed)["metadata"].num_docs == 30
        for i in range(60, 120):
            rows.append(_row(i))
            producer.produce(rows[-1], partition=i % 4)
        # the leaver's replicas drop out of routing once it is declared dead;
        # the survivor re-read its 30 uncommitted rows, so each row counts once
        _wait(lambda: _count(url) == 120, "120 rows after the rebalance", 90)
        _check_answers(url, rows)
        probe = HLConsumer(producer.host, producer.port, "hltopic", PHYSICAL, "probe")
        committed = probe.committed_offsets()
        assert sum(committed.values()) >= 30  # the survivor's revoke commit


# ------------------------------------------------------------ the quickstarts
def test_network_quickstart_through_a_kafka_consumer_group(tmp_path):
    """The CLI's networked quickstart with ``-consumer-type highlevel
    -stream-protocol kafka``: a controller, a server and a broker process;
    the server's HLC consumer joins the group through the Kafka
    coordinator APIs, seals at 500 rows and rolls; every event is counted."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    out = subprocess.run(
        [sys.executable, "-m", "pinot_tpu_torch.tools.admin", "NetworkRealtimeQuickstart", "-device", "cpu",
         "-events", "1200", "-consumer-type", "highlevel", "-stream-protocol", "kafka"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    assert "DONE networked realtime quickstart: 1200 events ingested (highlevel, kafka stream)" in out.stdout


def test_hybrid_quickstart_counts_each_row_once_as_reference():
    """The hybrid quickstart on both packages: an OFFLINE side of 1,500
    events and a REALTIME stream of the last 100 of them and 800 more; the
    broker splits at the offline side's max time, so count(*) is 2,300 and
    the city sums equal the reference's."""
    from pinot_tpu_torch.tools.quickstart import HYBRID_SAMPLE_QUERIES, hybrid_events, run_hybrid_quickstart

    with time_limit(120):
        port = run_hybrid_quickstart(verbose=False, device="cpu", base_ms=1_600_000_000_000)
        try:
            got = [port.query(pql).to_json() for pql in HYBRID_SAMPLE_QUERIES]
        finally:
            port.stop()
        ref_cluster = M("pinot_tpu", "tools.quickstart").run_hybrid_quickstart(verbose=False)
        try:
            want = [ref_cluster.query(pql).to_json() for pql in HYBRID_SAMPLE_QUERIES]
        finally:
            ref_cluster.stop()
    offline, realtime = hybrid_events(1500, 800, 1_600_000_000_000)
    boundary = offline[-1]["mtime"]
    once = offline + [e for e in realtime if e["mtime"] > boundary]
    cities = {}
    for e in once:
        cities[e["group_city"]] = cities.get(e["group_city"], 0) + e["rsvp_count"]
    assert [g["exceptions"] for g in got] == [[], [], []]
    assert float(got[0]["aggregationResults"][0]["value"]) == len(once) == 2300
    assert float(got[1]["aggregationResults"][0]["value"]) == realtime[-1]["mtime"]
    assert {g["group"][0]: float(g["value"]) for g in got[2]["aggregationResults"][0]["groupByResult"]} == cities
    for g, w in ((got[0], want[0]), (got[2], want[2])):  # the reference's events start a day before now
        assert g["aggregationResults"] == w["aggregationResults"]
