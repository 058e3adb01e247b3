"""Realtime quickstarts (port of ``pinot_tpu.tools.quickstart``'s two
realtime runs; the ``RealtimeQuickStart.java`` analog): a meetupRsvp-shaped
stream of seeded events ingested into a REALTIME table, then counted and
summed through the broker.

- ``run_realtime_quickstart``: an in-process cluster over a memory stream,
  consumed and committed in this process;
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
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType, Schema, TimeFieldSpec

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


def _post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def run_network_realtime_quickstart(num_events: int = 2000, device: str = "cuda", data_dir: Optional[str] = None,
                                    verbose: bool = True, timeout_s: float = 120.0) -> int:
    """The deployment shape with the stream broker in Kafka's role.
    Returns the count the broker answered once every event was visible;
    every process it started is stopped before it returns."""
    from pinot_tpu_torch.common.tableconfig import StreamConfig, TableConfig
    from pinot_tpu_torch.realtime.netstream import NetworkStreamProvider, StreamBrokerServer

    root = data_dir or tempfile.mkdtemp(prefix="pinot_tpu_torch_netrt_")
    stream_broker = StreamBrokerServer()
    stream_broker.start()
    host, port = stream_broker.address
    producer = NetworkStreamProvider(host, port, "meetupRsvp")
    producer.create_topic(1)
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
            stream_type="network", topic="meetupRsvp", rows_per_segment=500,
            properties={"host": host, "port": port}))
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
        stream_broker.stop()
    return count
