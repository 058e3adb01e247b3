"""Quickstarts (port of ``pinot_tpu.tools.quickstart``; the
``Quickstart.java:33``, ``RealtimeQuickStart.java`` and
``HybridQuickstart.java`` analogs).

- ``run_offline_quickstart``: baseballStats rows built into 4 segments
  (optionally with star-trees), uploaded to an in-process cluster and
  queried, optionally through the broker's HTTP front;
- ``run_realtime_quickstart``: an in-process cluster over a memory stream,
  consumed and committed in this process;
- ``run_hybrid_quickstart``: one logical table with an OFFLINE side of
  two historical segments and a REALTIME side whose stream starts before
  the offline time boundary; the broker splits each query at the boundary
  (``broker/time_boundary.py``), so every row is counted once;
- ``run_network_realtime_quickstart``: a stream broker in this process, a
  controller, a server and a broker each a process of
  ``python -m pinot_tpu_torch.tools.admin``, the table created over REST
  and the events produced over TCP; the server's ``RemoteConsumer``
  ingests them.
"""
from __future__ import annotations

import json
import os
import random
import select
import subprocess
import sys
import tempfile
import time
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType, Schema, TimeFieldSpec

OFFLINE_SAMPLE_QUERIES = [
    "SELECT count(*) FROM baseballStats",
    "SELECT sum(runs) FROM baseballStats GROUP BY playerName TOP 5",
    "SELECT sum(hits), sum(homeRuns) FROM baseballStats WHERE teamID = 'BOS'",
    "SELECT avg(runs) FROM baseballStats GROUP BY league",
    "SELECT playerName, runs FROM baseballStats ORDER BY runs DESC LIMIT 5",
]

# the demo cluster serves interactively after the samples print, so the
# broker's timeout only caps the worst case
_DEMO_TIMEOUT_MS = 300_000.0


def run_offline_quickstart(
    num_rows: int = 10_000,
    num_segments: int = 4,
    startree: bool = False,
    http: bool = False,
    verbose: bool = True,
    device=None,
):
    """baseballStats offline quickstart: rows -> segments -> cluster -> PQL
    (over HTTP with ``http``).  Returns the running ``InProcessCluster``
    (the caller stops it)."""
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.startree.builder import StarTreeBuilderConfig
    from pinot_tpu_torch.tools.cluster_harness import InProcessCluster
    from pinot_tpu_torch.tools.datagen import baseball_rows, baseball_schema

    schema = baseball_schema()
    rows = baseball_rows(num_rows)
    cluster = InProcessCluster(num_servers=2, http=http, timeout_ms=_DEMO_TIMEOUT_MS, device=device)
    physical = cluster.add_offline_table(schema)

    chunk = max(1, len(rows) // num_segments)
    cfg = StarTreeBuilderConfig(max_leaf_records=100) if startree else None
    for i in range(num_segments):
        part = rows[i * chunk : (i + 1) * chunk if i < num_segments - 1 else len(rows)]
        seg = build_segment(schema, part, physical, f"baseballStats_{i}", startree_config=cfg)
        cluster.upload(physical, seg)

    if verbose:
        for pql in OFFLINE_SAMPLE_QUERIES:
            resp = cluster.query(pql)
            print(f"\n>>> {pql}")
            print(json.dumps(resp.to_json(), indent=2)[:1200])
        if http:
            print(f"\nbroker listening on http://127.0.0.1:{cluster.http.port}/query")
    return cluster


SAMPLE_QUERIES = (
    "SELECT count(*) FROM meetupRsvp",
    "SELECT sum(rsvp_count) FROM meetupRsvp GROUP BY group_city",
    "SELECT count(*) FROM meetupRsvp GROUP BY event_name TOP 3",
)


def meetup_schema() -> Schema:
    return Schema(
        "meetupRsvp",
        dimensions=[
            FieldSpec("venue_name", DataType.STRING),
            FieldSpec("event_name", DataType.STRING),
            FieldSpec("group_city", DataType.STRING),
        ],
        metrics=[FieldSpec("rsvp_count", DataType.INT, FieldType.METRIC)],
        time_field=TimeFieldSpec("mtime", DataType.LONG, time_unit="MILLISECONDS"),
    )


def meetup_events(n: int, seed: int = 1, start_ms: int = 1_500_000_000_000) -> List[Dict[str, Any]]:
    """``n`` seeded RSVP events, one a millisecond from ``start_ms``."""
    rng = random.Random(seed)
    cities = ["sf", "nyc", "seattle", "austin", "chicago"]
    return [{"venue_name": f"venue{rng.randrange(20)}", "event_name": f"event{rng.randrange(8)}",
             "group_city": rng.choice(cities), "rsvp_count": rng.randint(1, 5), "mtime": start_ms + i}
            for i in range(n)]


def drain_stream(cluster, physical: str, max_rows: int = 10_000) -> int:
    """Consume, commit and roll partition 0 until the stream is dry;
    returns the segments committed."""
    from pinot_tpu_torch.realtime.llc import make_segment_name

    seq = 0
    while True:
        dms = cluster.controller.realtime_manager.consumers_of(make_segment_name(physical, 0, seq))
        if not dms:
            break
        dm = dms[0]
        consumed = dm.consume_step(max_rows=max_rows)
        if dm.threshold_reached:
            dm.try_commit()
            seq += 1
        elif consumed == 0:
            break
    return seq


def run_realtime_quickstart(num_events: int = 2000, device=None, verbose: bool = True):
    """Stream -> consuming and committed segments -> the sample queries.
    Returns the running ``InProcessCluster`` (the caller stops it)."""
    from pinot_tpu_torch.realtime.stream import MemoryStreamProvider
    from pinot_tpu_torch.tools.cluster_harness import InProcessCluster

    cluster = InProcessCluster(num_servers=1, device=device)
    stream = MemoryStreamProvider(num_partitions=1)
    physical = cluster.add_realtime_table(meetup_schema(), stream, rows_per_segment=500)
    for row in meetup_events(num_events):
        stream.produce(row)
    committed = drain_stream(cluster, physical)
    if verbose:
        print(f"ingested {num_events} events: {committed} segments committed, the rest consuming")
        for pql in SAMPLE_QUERIES:
            print(f"\n>>> {pql}")
            print(json.dumps(cluster.query(pql).to_json(), indent=2)[:900])
    return cluster


HYBRID_SAMPLE_QUERIES = (
    "SELECT count(*) FROM meetupRsvp",
    "SELECT max(mtime) FROM meetupRsvp",
    "SELECT sum(rsvp_count) FROM meetupRsvp GROUP BY group_city TOP 5",
)


def hybrid_events(num_offline: int, num_realtime: int, base_ms: int,
                  seed: int = 3) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """The hybrid quickstart's events, one a second from ``base_ms``, drawn
    in the reference's order: the offline side's ``num_offline``, then the
    stream's, which starts 100 events before the boundary (those 100 drawn
    again: the boundary sends their times to the offline side) and goes
    ``num_realtime`` past it."""
    rng = random.Random(seed)
    cities = ["sf", "nyc", "seattle", "austin", "chicago"]

    def event(i: int) -> Dict[str, Any]:
        return {"venue_name": f"venue{rng.randrange(20)}", "event_name": f"event{rng.randrange(8)}",
                "group_city": rng.choice(cities), "rsvp_count": rng.randint(1, 5), "mtime": base_ms + i * 1000}

    offline = [event(i) for i in range(num_offline)]
    return offline, [event(i) for i in range(num_offline - 100, num_offline + num_realtime)]


def run_hybrid_quickstart(num_offline: int = 1500, num_realtime: int = 800, http: bool = False,
                          verbose: bool = True, device=None, base_ms: Optional[int] = None):
    """The same logical table served by an OFFLINE side (historical
    segments) and a REALTIME side (the live stream), split at query time
    at the offline side's max time: the offline side answers up to the
    boundary, the realtime side the fresh tail, and each row counts once.
    Returns the running ``InProcessCluster`` (the caller stops it)."""
    from pinot_tpu_torch.realtime.stream import MemoryStreamProvider
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.tools.cluster_harness import InProcessCluster

    schema = meetup_schema()
    cluster = InProcessCluster(num_servers=2, http=http, timeout_ms=_DEMO_TIMEOUT_MS, device=device)
    if base_ms is None:
        base_ms = int(time.time() * 1000) - 86_400_000  # yesterday
    offline_rows, realtime_rows = hybrid_events(num_offline, num_realtime, base_ms)
    # the offline side: two historical segments
    offline = cluster.add_offline_table(schema, table_name="meetupRsvp")
    half = num_offline // 2
    for name, part in (("hist0", offline_rows[:half]), ("hist1", offline_rows[half:])):
        cluster.upload(offline, build_segment(schema, part, offline, name))
    # the realtime side: the live tail starts BEFORE the boundary (the
    # overlap the boundary splits), then goes past it
    stream = MemoryStreamProvider(num_partitions=1)
    rt_physical = cluster.add_realtime_table(schema, stream, rows_per_segment=10_000)
    for row in realtime_rows:
        stream.produce(row)
    # consume, seal and roll until dry, so counts past one segment's
    # budget land too
    drain_stream(cluster, rt_physical, max_rows=1_000_000)
    if verbose:
        for pql in HYBRID_SAMPLE_QUERIES:
            print(f"\n>>> {pql}")
            print(json.dumps(cluster.query(pql).to_json(), indent=2)[:900])
        if http:
            print(f"\nbroker listening on http://127.0.0.1:{cluster.http.port}/query")
    return cluster


def _post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def run_network_realtime_quickstart(num_events: int = 2000, device: str = "cuda", data_dir: Optional[str] = None,
                                    verbose: bool = True, timeout_s: float = 120.0, consumer_type: str = "lowlevel",
                                    stream_protocol: str = "native") -> int:
    """The deployment shape with the stream broker in Kafka's role.
    ``consumer_type="highlevel"`` consumes through a consumer group (two
    partitions); ``stream_protocol="kafka"`` puts the Kafka v0 wire
    protocol (``realtime/kafka.py``) in front of the stream broker and
    makes the table's stream ``kafka``, so the server consumes through
    Metadata / ListOffsets / Fetch (and the group coordinator's APIs for
    an HLC table), as it would from a Kafka 0.8+ broker.  Returns the
    count the broker answered once every event was visible; every process
    it started is stopped before it returns."""
    from pinot_tpu_torch.common.tableconfig import StreamConfig, TableConfig
    from pinot_tpu_torch.realtime.netstream import NetworkStreamProvider, StreamBrokerServer

    root = data_dir or tempfile.mkdtemp(prefix="pinot_tpu_torch_netrt_")
    stream_broker = StreamBrokerServer()
    stream_broker.start()
    host, port = stream_broker.address
    producer = NetworkStreamProvider(host, port, "meetupRsvp")
    producer.create_topic(1 if consumer_type == "lowlevel" else 2)
    shim = None
    if stream_protocol == "kafka":
        from pinot_tpu_torch.realtime.kafka import KafkaProtocolShim

        shim = KafkaProtocolShim(stream_broker).start()
        host, port = shim.address
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs: List[subprocess.Popen] = []

    def spawn(args: List[str]) -> str:
        proc = subprocess.Popen([sys.executable, "-m", "pinot_tpu_torch.tools.admin", *args],
                                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env)
        procs.append(proc)
        deadline = time.time() + 300
        while time.time() < deadline:
            ready, _, _ = select.select([proc.stdout], [], [], 1.0)
            if ready:
                line = proc.stdout.readline()
                if line.startswith("READY"):
                    return line.split()[2]
            if proc.poll() is not None:
                raise RuntimeError(f"process exited early: {args}")
        raise RuntimeError(f"no READY from {args}")

    count = 0
    try:
        ctrl_url = spawn(["StartController", "-port", "0", "-data-dir", os.path.join(root, "store"),
                          "-device", device])
        spawn(["StartServer", "-controller", ctrl_url, "-name", "qs0", "-device", device])
        broker_url = spawn(["StartBroker", "-controller", ctrl_url, "-port", "0", "-device", device,
                            "-timeout-ms", "300000"])
        _post(ctrl_url + "/schemas", meetup_schema().to_json())
        config = TableConfig(table_name="meetupRsvp", table_type="REALTIME", stream=StreamConfig(
            stream_type="kafka" if shim is not None else "network", topic="meetupRsvp", rows_per_segment=500,
            consumer_type=consumer_type, properties={"host": host, "port": port}))
        _post(ctrl_url + "/tables", config.to_json())
        producer.produce_batch(meetup_events(num_events))
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            resp = _post(broker_url + "/query", {"pql": SAMPLE_QUERIES[0]})
            count = resp.get("numDocsScanned", 0)
            if count >= num_events and not resp.get("exceptions"):
                break
            time.sleep(0.25)
        if verbose:
            for pql in SAMPLE_QUERIES:
                print(f"\n>>> {pql}")
                print(json.dumps(_post(broker_url + "/query", {"pql": pql}), indent=2)[:900])
    finally:
        for proc in reversed(procs):
            proc.terminate()
        for proc in reversed(procs):
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
            if proc.stdout is not None:
                proc.stdout.close()
        if shim is not None:
            shim.stop()
        stream_broker.stop()
    return count
