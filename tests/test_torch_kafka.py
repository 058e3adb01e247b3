"""The port's Kafka path on the CPU, held against the JAX package.

- The codecs: snappy and lz4 round trips, and the port's compressed bytes
  equal to the reference's on seeded inputs (``xxh32`` too).
- Message sets byte for byte: the v0 encoding, the compressed wrappers,
  a truncated tail dropped, a CRC checked.
- Over real sockets: the port's ``KafkaWireClient`` against the
  reference's ``KafkaProtocolShim`` and the reference's client against the
  port's shim (Metadata, ListOffsets, Fetch, plain and compressed, the
  oversized message that makes the client grow its fetch).
- The typed error of a columnar partition.
- The group protocol (JoinGroup, SyncGroup, Heartbeat, OffsetCommit,
  OffsetFetch, LeaveGroup) run on both packages: the same assignments and
  the same offsets across a membership change.
- LLC over the port's shim into a REALTIME table of a deployed port
  cluster (a controller over HTTP, a ``NetworkedServerStarter`` on the CPU,
  a ``NetworkedBrokerStarter``): q1, count(*) and distinctcount equal the
  reference executor's over the same rows, and each partition commits at
  its exact offsets.
Every wait has a deadline; each test stops what it starts.
"""
import contextlib
import importlib
import json
import signal
import threading
import time
import urllib.request

import numpy as np
import pytest

from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.datagen import lineitem_rows
from pinot_tpu.tools.datagen import lineitem_schema as ref_lineitem_schema
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

PKGS = ("pinot_tpu", "pinot_tpu_torch")
CODECS = ("gzip", "snappy", "lz4")
REL, ABS = 5e-4, 1e-3


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


def _payloads(seed: int):
    rng = np.random.default_rng(seed)
    words = [f"w{int(i)}".encode() for i in rng.integers(0, 50, 4000)]
    return [b"", b"abc", b"x" * 70000, bytes(range(256)) * 300, b" ".join(words),
            rng.integers(0, 256, 20000, dtype=np.uint8).tobytes(),
            json.dumps(lineitem_rows(200, seed=seed)).encode()]


# ------------------------------------------------------------------ codecs
@pytest.mark.parametrize("codec", ["snappy", "lz4"])
def test_codec_bytes_equal_reference(codec):
    with time_limit(60):
        ref, port = (M(pkg, f"utils.{codec}") for pkg in PKGS)
        compress = "compress" if codec == "snappy" else "compress_frame"
        for seed in (1, 2):
            for payload in _payloads(seed):
                got = getattr(port, compress)(payload)
                assert got == getattr(ref, compress)(payload)
                assert port.decompress(got) == payload
                assert ref.decompress(got) == payload
        if codec == "lz4":
            for payload in _payloads(3):
                assert port.xxh32(payload) == ref.xxh32(payload)
                assert port.xxh32(payload, seed=7) == ref.xxh32(payload, seed=7)
                block = port.compress_block(payload)
                assert block == ref.compress_block(payload)
                assert port.decompress_block(block, max_output=len(payload) + 16) == payload


def _message_sets(pkg: str) -> dict:
    k = M(pkg, "realtime.kafka")
    rows = lineitem_rows(50, seed=5)
    raw = b"".join(k.encode_message(i, json.dumps(r).encode(), key=b"k%d" % i if i % 3 else None)
                   for i, r in enumerate(rows))
    out = {"raw": raw, "decoded": k.decode_message_set(raw),
           "truncated": [o for o, _, _ in k.decode_message_set(raw[:-30])]}
    for codec in CODECS:
        wrapped = k.encode_message(49, k.compress_message_set(raw, codec), codec=k._CODEC_IDS[codec])
        out[codec] = k.decode_message_set(wrapped)
        if codec != "gzip":  # gzip stamps the time into its header
            out[f"{codec}_bytes"] = wrapped
    bad = bytearray(k.encode_message(0, b"payload"))
    bad[-2] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        k.decode_message_set(bytes(bad))
    with pytest.raises(ValueError, match="unsupported message compression codec"):
        k.decode_message_set(k.encode_message(0, b"zz", codec=4))
    return out


def test_message_sets_equal_reference():
    with time_limit(60):
        ref, port = (_message_sets(pkg) for pkg in PKGS)
    assert ref["truncated"] == list(range(49))
    assert [o for o, _, _ in ref["gzip"]] == list(range(50))
    assert port == ref


# ------------------------------------------------------ client and shim
@contextlib.contextmanager
def _stack(pkg: str, compression=None, partitions: int = 2):
    """A ``pkg`` stream broker with a topic of row partitions and its Kafka
    shim; yields (broker, producer, shim)."""
    ns = M(pkg, "realtime.netstream")
    sb = ns.StreamBrokerServer()
    sb.start()
    shim = None
    try:
        host, port = sb.address
        producer = ns.NetworkStreamProvider(host, port, "ktopic")
        producer.create_topic(partitions)
        shim = M(pkg, "realtime.kafka").KafkaProtocolShim(sb, compression=compression).start()
        yield sb, producer, shim
    finally:
        if shim is not None:
            shim.stop()
        sb.stop()


def _client_exchange(client_pkg: str, shim_pkg: str, compression) -> list:
    k = M(client_pkg, "realtime.kafka")
    seen = []
    with _stack(shim_pkg, compression) as (_, producer, shim):
        for p in range(2):
            producer.produce_batch([{"i": i, "p": p, "pad": "y" * (i % 40)} for i in range(60)], partition=p)
        producer.produce({"big": "z" * 300_000}, partition=1)  # past the first fetch's max_bytes
        host, port = shim.address
        client = k.KafkaWireClient(host, port)
        try:
            meta = client.metadata(["ktopic", "missing"])
            seen.append({t: {"error": v["error"], "partitions": sorted(v["partitions"])}
                         for t, v in meta["topics"].items()})
            seen.append([client.list_offsets("ktopic", p, t) for p in range(2) for t in (k.EARLIEST, k.LATEST)])
            seen.append([(o, key, v) for o, key, v in client.fetch("ktopic", 0, 0)])
            seen.append([o for o, _, _ in client.fetch("ktopic", 0, 17, max_bytes=600)])
            seen.append([len(v) for _, _, v in client.fetch("ktopic", 1, 60, max_bytes=1024)])
            with pytest.raises(IndexError):
                client.fetch("ktopic", 0, 61)
            provider = k.KafkaStreamProvider(host, port, "ktopic")
            seen.append([provider.partition_count(), provider.latest_offset(1), provider.fetch(0, 10, 5)])
            provider.client.close()
        finally:
            client.close()
    return seen


@pytest.mark.parametrize("compression", [None, *CODECS])
@pytest.mark.parametrize("direction", ["port_client_ref_shim", "ref_client_port_shim"])
def test_wire_client_against_the_other_shim(direction, compression):
    client_pkg, shim_pkg = PKGS[::-1] if direction == "port_client_ref_shim" else PKGS
    with time_limit(60):
        want = _client_exchange("pinot_tpu", "pinot_tpu", compression)
        got = _client_exchange(client_pkg, shim_pkg, compression)
    assert want[0] == {"ktopic": {"error": 0, "partitions": [0, 1]}, "missing": {"error": 3, "partitions": []}}
    assert want[4] == [300_010]  # the oversized message, after the fetch grew
    assert got == want


@pytest.mark.parametrize("client_pkg", PKGS)
def test_columnar_partition_is_a_typed_error(client_pkg):
    k = M(client_pkg, "realtime.kafka")
    with time_limit(30), _stack("pinot_tpu_torch") as (_, producer, shim):
        producer.produce_columns({"i": np.arange(8, dtype=np.int64)}, partition=0)
        producer.produce({"i": 99}, partition=1)
        client = k.KafkaWireClient(*shim.address)
        try:
            with pytest.raises(k.ColumnarPartitionError, match="columnar partition"):
                client.fetch("ktopic", 0, 0)
            with pytest.raises(k.ColumnarPartitionError, match="columnar partition"):
                client.list_offsets("ktopic", 0, k.LATEST)
            assert client.list_offsets("ktopic", 1, k.LATEST) == [1]
            assert [o for o, _, _ in client.fetch("ktopic", 1, 0)] == [0]
        finally:
            client.close()
    assert k.ERR_COLUMNAR_PARTITION == 87


# --------------------------------------------------------- group protocol
def _group_scenario(pkg: str) -> list:
    """Join, sync and heartbeat of two members over ``pkg``'s shim, a
    leave, and a fresh member resuming from the committed offsets."""
    kg = M(pkg, "realtime.kafka_group")
    seen = []
    with _stack(pkg, partitions=3) as (_, producer, shim):
        for i in range(30):
            producer.produce({"i": i}, partition=i % 3)
        host, port = shim.address
        a = kg.KafkaGroupConsumer(host, port, "ktopic", group="g", consumer_id="a")
        seen.append(a.join())
        rows = a.poll()
        seen.append(sorted((p, r["i"]) for p, r in rows))
        assert a.commit()
        seen.append(a.committed_offsets())
        b = kg.KafkaGroupConsumer(host, port, "ktopic", group="g", consumer_id="b")
        box = {}
        t = threading.Thread(target=lambda: box.update(b=b.join()))
        t.start()
        for _ in range(200):  # a sees the rebalance on its heartbeat, commits and rejoins
            a.poll()
            if not t.is_alive():
                break
            time.sleep(0.05)
        t.join(timeout=10)
        assert not t.is_alive()
        seen.append((sorted(a.assignment), sorted(box["b"]), a.generation == b.generation))
        for i in range(30, 45):
            producer.produce({"i": i}, partition=i % 3)
        got = {}
        for _ in range(40):
            for member in (a, b):
                for p, r in member.poll():
                    got.setdefault(p, []).append(r["i"])
            if sum(map(len, got.values())) >= 15:
                break
        seen.append({p: sorted(v) for p, v in sorted(got.items())})
        assert a.commit() and b.commit()
        seen.append(a.committed_offsets())
        a.close()
        b.close()
        c = kg.KafkaGroupConsumer(host, port, "ktopic", group="g", consumer_id="c")
        seen.append((c.join(), c.positions, c.poll()))
        c.close()
    return seen


def test_group_protocol_and_offsets_across_membership():
    with time_limit(90):
        ref, port = (_group_scenario(pkg) for pkg in PKGS)
    assert ref[0] == [0, 1, 2] and ref[2] == {0: 10, 1: 10, 2: 10}
    assert ref[3][2] and sorted(ref[3][0] + ref[3][1]) == [0, 1, 2]
    assert ref[-1] == ([0, 1, 2], {0: 15, 1: 15, 2: 15}, [])
    assert port == ref


def test_group_codecs_equal_reference():
    ref, port = (M(pkg, "realtime.kafka_group") for pkg in PKGS)
    members = [("m1", ["t1", "t2"]), ("m2", ["t1"]), ("m3", ["t2", "t3"])]
    parts = {"t1": 5, "t2": 4, "t3": 1}
    assert port.range_assign(members, parts) == ref.range_assign(members, parts)
    for topics in (["a"], ["a", "bb", "ccc"], []):
        assert port.encode_subscription(topics) == ref.encode_subscription(topics)
        assert port.decode_subscription(ref.encode_subscription(topics)) == topics
    plan = {"t1": [0, 2], "t2": [1]}
    assert port.encode_assignment(plan) == ref.encode_assignment(plan)
    assert port.decode_assignment(ref.encode_assignment(plan)) == plan and port.decode_assignment(b"") == {}


# ------------------------------------------------- LLC over Kafka, deployed
KAFKA_QUERIES = (
    "SELECT sum(l_quantity), sum(l_extendedprice), sum(l_discount), count(*) FROM lineitem "
    "WHERE l_shipdate <= '1998-09-02' GROUP BY l_returnflag, l_linestatus TOP 10",
    "SELECT count(*) FROM lineitem",
    "SELECT distinctcount(l_extendedprice) FROM lineitem WHERE l_quantity > 25",
)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_llc_over_kafka_table_answers_as_reference(tmp_path):
    """A REALTIME lineitem table whose stream is ``kafka``: the server's
    RemoteConsumers read the shim's two partitions through Fetch, commit
    each partition's first segment through the completion protocol at its
    exact offsets and keep consuming; the broker's answers equal the
    reference executor's over the same rows."""
    from pinot_tpu_torch.broker.network_starter import NetworkedBrokerStarter
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.common.tableconfig import StreamConfig, TableConfig
    from pinot_tpu_torch.controller.controller import Controller, ControllerHttpServer
    from pinot_tpu_torch.realtime.llc import make_segment_name
    from pinot_tpu_torch.server.network_starter import NetworkedServerStarter

    per_segment, per_partition, physical = 60, 90, "lineitem_REALTIME"
    rows = {p: lineitem_rows(per_partition, seed=31 + p) for p in range(2)}
    ctrl = http = server = broker = None
    with time_limit(120), _stack("pinot_tpu_torch") as (_, producer, shim):
        try:
            ctrl = Controller(str(tmp_path / "controller"))
            http = ControllerHttpServer(ctrl)
            http.start()
            server = NetworkedServerStarter(http.url, "kserver0", device="cpu", precision="x64")
            server.start()
            broker = NetworkedBrokerStarter(http.url, "broker0", port=0)
            broker.start()
            _post(http.url + "/schemas", Schema.from_json(ref_lineitem_schema().to_json()).to_json())
            k_host, k_port = shim.address
            config = TableConfig("lineitem", table_type="REALTIME", stream=StreamConfig(
                stream_type="kafka", topic="ktopic", rows_per_segment=per_segment,
                properties={"host": k_host, "port": k_port}))
            assert TableConfig.from_json(config.to_json()).stream.stream_type == "kafka"
            assert _post(http.url + "/tables", config.to_json()) == {"status": "ok", "table": physical}
            for p in range(2):
                producer.produce_batch(rows[p], partition=p)
            broker_url = f"http://127.0.0.1:{broker.http.port}/query"

            def settled():
                view = ctrl.resources.get_external_view(physical)
                want = {make_segment_name(physical, p, 0): "ONLINE" for p in range(2)}
                want.update({make_segment_name(physical, p, 1): "CONSUMING" for p in range(2)})
                if {k: set(v.values()) for k, v in view.items()} != {k: {v} for k, v in want.items()}:
                    return None
                resp = _post(broker_url, {"pql": KAFKA_QUERIES[1]})
                return resp if resp.get("numDocsScanned") == 2 * per_partition and not resp["exceptions"] else None

            _wait(settled, "one commit a partition and every row counted once")
            ref_seg = ref_build_segment(ref_lineitem_schema(), rows[0] + rows[1], physical, "all")
            for pql in KAFKA_QUERIES:
                got = _post(broker_url, {"pql": pql})
                assert not got["exceptions"], got
                req = ref_optimize(ref_parse(pql))
                want = canonical_payload(req, RefExecutor().execute([ref_seg], req))
                assert payloads_equivalent(strip_accounting(got), want, rel_tol=REL, abs_tol=ABS), (pql, got, want)
            for p in range(2):
                meta = ctrl.resources.get_segment_metadata(physical, make_segment_name(physical, p, 0))["metadata"]
                assert (meta.custom["startOffset"], meta.custom["endOffset"]) == (0, per_segment)
            assert ctrl.metrics.meter("segmentCommits").count == 2
        finally:
            if broker is not None:
                broker.stop()
            if server is not None:
                server.stop()
            if http is not None:
                http.stop()
            if ctrl is not None:
                ctrl.stop()


def test_stream_descriptors_round_trip_kafka():
    from pinot_tpu_torch.common.tableconfig import StreamConfig
    from pinot_tpu_torch.realtime.kafka import KafkaStreamProvider
    from pinot_tpu_torch.realtime.stream import describe_stream, stream_from_descriptor, stream_provider_from_config

    sp = stream_provider_from_config(StreamConfig(stream_type="kafka", topic="t",
                                                  properties={"host": "127.0.0.1", "port": 9}))
    assert isinstance(sp, KafkaStreamProvider)
    desc = describe_stream(sp)
    assert desc == {"type": "kafka", "host": "127.0.0.1", "port": 9, "topic": "t"}
    back = stream_from_descriptor(desc)
    assert isinstance(back, KafkaStreamProvider) and describe_stream(back) == desc
    assert M("pinot_tpu", "realtime.stream").describe_stream(
        M("pinot_tpu", "realtime.stream").stream_from_descriptor(desc)) == desc


def test_start_stream_broker_serves_kafka_beside_the_native_protocol(tmp_path):
    """``StartStreamBroker -kafka-port 0``: a process that prints its two
    READY lines, serves a topic produced over the native protocol to the
    reference's Kafka client, and exits 0 on SIGTERM."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from pinot_tpu_torch.realtime.netstream import NetworkStreamProvider

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    proc = subprocess.Popen([sys.executable, "-m", "pinot_tpu_torch.tools.admin", "StartStreamBroker", "-port", "0",
                             "-kafka-port", "0", "-log-dir", str(tmp_path / "log")],
                            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        with time_limit(60):
            ready = {}
            while len(ready) < 2:
                line = proc.stdout.readline()
                assert line, proc.stderr.read()
                if line.startswith("READY "):
                    role, addr = line.split()[1:3]
                    ready[role] = (addr.rsplit(":", 1)[0], int(addr.rsplit(":", 1)[1]))
            producer = NetworkStreamProvider(*ready["streambroker"], "cli_topic")
            producer.create_topic(2)
            producer.produce_batch([{"i": i} for i in range(5)], partition=1)
            client = M("pinot_tpu", "realtime.kafka").KafkaWireClient(*ready["kafka"])
            try:
                assert sorted(client.metadata(["cli_topic"])["topics"]["cli_topic"]["partitions"]) == [0, 1]
                assert [json.loads(v)["i"] for _, _, v in client.fetch("cli_topic", 1, 2)] == [2, 3, 4]
            finally:
                client.close()
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0
        proc.stdout.close()
        proc.stderr.close()
