"""Admin CLI (port of ``pinot_tpu.tools.admin``, trimmed to the
deployment and segment commands).  Usage::

    python -m pinot_tpu_torch.tools.admin <command> [args]

Commands:
  Quickstart        offline baseballStats demo: 4 segments in an in-process
                    cluster, the sample queries, then the broker over HTTP
                    (-no-http: print and exit)
  StartCluster      an in-process cluster with the broker and the
                    controller over HTTP
  StartController   a controller process over a durable -data-dir (the
                    journaled property store and the segment store): it
                    recovers what the directory holds, claims the next
                    fencing epoch, serves REST, the control plane and the
                    dashboard, and runs the periodic managers and the
                    stabilizer
  StartServer       a server process joining a controller
  StartBroker       a broker process joining a controller
  AddSchema         POST a schema JSON file to a controller (a grown schema
                    evolves the deployed tables on it: their loaded
                    segments get default columns)
  AddTable          POST a table config JSON file to a controller (its
                    "partitioning" block, {"column", "numPartitions"},
                    declares the key partitioning joins colocate on)
  UploadSegment     POST a segment file to a controller
  PostQuery         run PQL against a broker
  AddTenant         tag -count untagged live servers (or brokers) with a
                    tenant
  ListTenants       every tenant and its instances
  RebalanceTable    rebalance a table's segments over its tenant's live
                    servers (-dry-run prints the plan only)
  CreateSegment     build a segment file from CSV, JSONL or Avro rows (a
                    CSV through the columnar path and its native parser;
                    -startree adds a star-tree at its defaults)
  BatchCreateSegments  one segment per input file on a process pool, or on
                    remote build workers (-remote-workers), optionally
                    pushed to a controller
  StartBuildWorker  serve segment-build jobs over TCP
  ShowSegment       print a segment file's metadata
  ConvertSegment    export a segment's rows as CSV or JSONL
  ShowStarTree      print a segment's star-tree summary
  GenerateData      seeded random rows for a schema, as JSONL
  RealtimeQuickstart         a meetupRsvp stream ingested into a REALTIME
                             table of an in-process cluster, then queried
  NetworkRealtimeQuickstart  the same across processes: a TCP stream
                             broker, a controller, a server and a broker
                             (-consumer-type highlevel: a consumer group;
                             -stream-protocol kafka: over the Kafka wire
                             protocol)
  HybridQuickstart  one meetupRsvp table with an OFFLINE and a REALTIME
                    side, split at the time boundary (-no-http: print and
                    exit)
  StartStreamBroker  a TCP stream-broker process (topics, consumer groups;
                    -kafka-port also serves the Kafka v0 wire protocol and
                    its group coordinator over the same topics)

StartController, StartServer, StartBroker and StartStreamBroker print
``READY <role> <address>`` once they serve (StartStreamBroker: ``READY
streambroker host:port``, and ``READY kafka host:port`` with -kafka-port); StartCluster, StartBuildWorker and Quickstart
print the reference's lines.  Each serves until SIGTERM or SIGINT, when
it stops its threads and exits 0.
``-device`` names the device of the role (default ``cuda``, the card;
``cpu`` runs the port's plain torch versions, for tests): a server stages
its segments and launches its kernels there, and so do the quickstarts'
and StartCluster's servers.  The build commands (CreateSegment,
BatchCreateSegments, StartBuildWorker) run on the host and never touch
the card, as the reference's run on the host.
"""
from __future__ import annotations

import argparse
import json
import logging
import signal
import threading
import urllib.request
from typing import Callable, List


def _post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _serve_until_signal(stoppers: List[Callable[[], None]]) -> None:
    """Block until SIGTERM or SIGINT, then run the stoppers in order."""
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    while not done.wait(3600):
        pass
    for stop in stoppers:
        stop()


def _device(args):
    from pinot_tpu_torch.engine import config

    return config.resolve_device(args.device)


def cmd_start_controller(args) -> None:
    """A controller process (ControllerStarter.java:47)."""
    from pinot_tpu_torch.controller.controller import Controller, ControllerHttpServer

    _device(args)
    # a property store that cannot be opened or claimed raises here: the
    # process exits with the error instead of serving from memory
    ctrl = Controller(args.data_dir, start_managers=True, heartbeat_timeout_s=args.heartbeat_timeout)
    http = ControllerHttpServer(ctrl, port=args.port)
    http.start()
    print(f"READY controller http://127.0.0.1:{http.port}", flush=True)
    _serve_until_signal([http.stop, ctrl.stop])


def cmd_start_server(args) -> None:
    """A server process joining a controller (HelixServerStarter.java:63)."""
    from pinot_tpu_torch.server.network_starter import NetworkedServerStarter

    starter = NetworkedServerStarter(
        args.controller, args.name, port=args.port, data_dir=args.data_dir,
        device=_device(args), precision=args.precision,
    )
    starter.start()
    print(f"READY server {starter.tcp.address[0]}:{starter.tcp.address[1]} admin {starter.admin.url}",
          flush=True)
    _serve_until_signal([starter.stop])


def cmd_start_broker(args) -> None:
    """A broker process joining a controller (HelixBrokerStarter.java:57)."""
    from pinot_tpu_torch.broker.network_starter import NetworkedBrokerStarter

    _device(args)
    starter = NetworkedBrokerStarter(args.controller, args.name, port=args.port, timeout_ms=args.timeout_ms)
    starter.start()
    print(f"READY broker http://127.0.0.1:{starter.http.port}", flush=True)
    _serve_until_signal([starter.stop])


def cmd_rebalance_table(args) -> None:
    url = args.controller.rstrip("/") + f"/tables/{args.table}/rebalance"
    if args.dry_run:
        url += "?dryRun=true"
    print(json.dumps(_post(url, {}), indent=2))


def cmd_add_tenant(args) -> None:
    print(_post(args.controller.rstrip("/") + "/tenants", {"name": args.name, "role": args.role, "count": args.count}))


def cmd_list_tenants(args) -> None:
    with urllib.request.urlopen(args.controller.rstrip("/") + "/tenants", timeout=30) as r:
        print(json.dumps(json.loads(r.read()), indent=2))


def cmd_upload_segment(args) -> None:
    with open(args.segment_file, "rb") as f:
        data = f.read()
    url = args.controller.rstrip("/") + f"/segments/{args.table}"
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=120) as r:
        print(json.loads(r.read()))


def cmd_add_schema(args) -> None:
    with open(args.schema_file) as f:
        print(_post(args.controller.rstrip("/") + "/schemas", json.load(f)))


def cmd_add_table(args) -> None:
    with open(args.config_file) as f:
        print(_post(args.controller.rstrip("/") + "/tables", json.load(f)))


def cmd_post_query(args) -> None:
    out = _post(args.broker.rstrip("/") + "/query", {"pql": args.query, "trace": args.trace})
    print(json.dumps(out, indent=2))


def cmd_create_segment(args) -> None:
    """A data file -> a segment file: a CSV through the columnar path (the
    native one-pass parse), Avro or JSONL through the row builder."""
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.segment.columnar import build_segment_from_csv
    from pinot_tpu_torch.segment.format import write_segment
    from pinot_tpu_torch.segment.readers import read_for_path
    from pinot_tpu_torch.startree.builder import StarTreeBuilderConfig

    with open(args.schema_file) as f:
        schema = Schema.from_json(json.load(f))
    cfg = StarTreeBuilderConfig() if args.startree else None
    if args.data_file.endswith(".csv"):
        seg = build_segment_from_csv(schema, args.data_file, args.table, args.segment_name, startree_config=cfg)
    else:
        rows = read_for_path(args.data_file, schema)  # avro / jsonl
        seg = build_segment(schema, rows, args.table, args.segment_name, startree_config=cfg)
    path = write_segment(seg, args.out_dir)
    print(f"built segment {seg.segment_name}: {seg.num_docs} docs -> {path}")


def _worker_addresses(spec: str):
    addrs = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue  # tolerate trailing commas
        host, sep, port = part.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise SystemExit(f"-remote-workers: {part!r} is not host:port "
                             "(expected e.g. 10.0.0.5:9600,10.0.0.6:9600)")
        addrs.append((host, int(port)))
    if not addrs:
        raise SystemExit("-remote-workers: no worker addresses given")
    return addrs


def cmd_batch_create_segments(args) -> None:
    """pinot-hadoop analog: one segment build per input file on a
    worker-process pool or on remote build workers, optionally pushed
    (SegmentCreationJob.java)."""
    import glob
    import os

    from pinot_tpu_torch.tools.batch_build import BatchBuildSpec, run_batch_build, run_distributed_build

    inputs = sorted(f for pat in args.inputs for f in glob.glob(pat) if os.path.isfile(f))
    if not inputs:
        raise SystemExit(f"no input files matched {args.inputs}")
    spec = BatchBuildSpec(
        schema_file=args.schema_file,
        table=args.table,
        input_files=inputs,
        out_dir=args.out_dir,
        controller=args.controller,
        startree=args.startree,
        segment_name_prefix=args.segment_name_prefix,
    )
    if args.remote_workers:
        results = run_distributed_build(spec, _worker_addresses(args.remote_workers))
    else:
        results = run_batch_build(spec, workers=args.workers)
    for r in results:
        print(json.dumps(r))


def cmd_start_build_worker(args) -> None:
    """Serve segment-build jobs over TCP (the SegmentCreationJob mapper
    analog) until SIGTERM or SIGINT."""
    from pinot_tpu_torch.tools.batch_build import serve_build_worker

    server = serve_build_worker(host=args.host, port=args.port)
    print(f"build worker listening on {server.host}:{server.port}", flush=True)
    _serve_until_signal([server.stop])


def cmd_convert_segment(args) -> None:
    from pinot_tpu_torch.tools.converters import segment_to_csv, segment_to_jsonl

    if args.format == "csv":
        n = segment_to_csv(args.segment_dir, args.out_file)
    else:
        n = segment_to_jsonl(args.segment_dir, args.out_file)
    print(f"exported {n} rows -> {args.out_file}")


def cmd_show_star_tree(args) -> None:
    from pinot_tpu_torch.tools.converters import star_tree_summary

    print(json.dumps(star_tree_summary(args.segment_dir, max_nodes=args.max_nodes), indent=2))


def cmd_generate_data(args) -> None:
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.tools.datagen import random_rows

    with open(args.schema_file) as f:
        schema = Schema.from_json(json.load(f))
    rows = random_rows(schema, args.num_rows, seed=args.seed)
    with open(args.out_file, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"generated {len(rows)} rows -> {args.out_file}")


def cmd_quickstart(args) -> None:
    """The offline baseballStats demo (Quickstart.java:33)."""
    from pinot_tpu_torch.tools.quickstart import run_offline_quickstart

    cluster = run_offline_quickstart(num_rows=args.rows, startree=args.startree, http=not args.no_http,
                                     device=_device(args))
    if args.no_http:
        cluster.stop()
        return
    print("Ctrl-C to exit.", flush=True)
    _serve_until_signal([cluster.stop])


def cmd_start_cluster(args) -> None:
    """An in-process cluster with the broker and the controller over HTTP."""
    from pinot_tpu_torch.broker.broker import BrokerHttpServer
    from pinot_tpu_torch.controller.controller import ControllerHttpServer
    from pinot_tpu_torch.tools.cluster_harness import InProcessCluster

    cluster = InProcessCluster(num_servers=args.servers, data_dir=args.data_dir, device=_device(args))
    broker_http = BrokerHttpServer(cluster.broker, port=args.broker_port)
    broker_http.start()
    controller_http = ControllerHttpServer(cluster.controller, port=args.controller_port)
    controller_http.start()
    # the broker's URL, for client discovery
    inst = cluster.controller.resources.instances.get(cluster.broker.name)
    if inst is not None:
        inst.url = f"http://127.0.0.1:{broker_http.port}"
    print(f"controller: http://127.0.0.1:{controller_http.port}", flush=True)
    print(f"broker:     http://127.0.0.1:{broker_http.port}/query", flush=True)
    print("Ctrl-C to exit.", flush=True)
    _serve_until_signal([broker_http.stop, controller_http.stop, cluster.stop])


def cmd_show_segment(args) -> None:
    from pinot_tpu_torch.segment.format import read_segment

    seg = read_segment(args.segment_dir)
    print(json.dumps(seg.metadata.to_json(), indent=2, default=str))


def cmd_realtime_quickstart(args) -> None:
    from pinot_tpu_torch.tools.quickstart import run_realtime_quickstart

    cluster = run_realtime_quickstart(num_events=args.events, device=_device(args))
    cluster.stop()
    print("DONE realtime quickstart", flush=True)


def cmd_network_realtime_quickstart(args) -> None:
    from pinot_tpu_torch.tools.quickstart import run_network_realtime_quickstart

    count = run_network_realtime_quickstart(num_events=args.events, device=str(_device(args)),
                                            consumer_type=args.consumer_type, stream_protocol=args.stream_protocol)
    print(f"DONE networked realtime quickstart: {count} events ingested "
          f"({args.consumer_type}, {args.stream_protocol} stream)", flush=True)
    if count < args.events:
        raise SystemExit(1)


def cmd_hybrid_quickstart(args) -> None:
    """The hybrid demo (HybridQuickstart.java)."""
    from pinot_tpu_torch.tools.quickstart import run_hybrid_quickstart

    cluster = run_hybrid_quickstart(num_offline=args.offline_rows, num_realtime=args.realtime_rows,
                                    http=not args.no_http, device=_device(args))
    if args.no_http:
        cluster.stop()
        print("DONE hybrid quickstart", flush=True)
        return
    print("Ctrl-C to exit.", flush=True)
    _serve_until_signal([cluster.stop])


def cmd_start_stream_broker(args) -> None:
    """A stream-broker process: the Kafka-broker role of realtime ingestion
    (``realtime/netstream.py``), with the Kafka wire protocol beside it on
    -kafka-port (``realtime/kafka.py``)."""
    from pinot_tpu_torch.realtime.netstream import StreamBrokerServer

    broker = StreamBrokerServer(port=args.port, log_dir=args.log_dir)
    broker.start()
    stoppers = [broker.stop]
    print(f"READY streambroker {broker.address[0]}:{broker.address[1]}", flush=True)
    if args.kafka_port is not None:
        from pinot_tpu_torch.realtime.kafka import KafkaProtocolShim

        shim = KafkaProtocolShim(broker, port=args.kafka_port).start()
        stoppers.insert(0, shim.stop)
        print(f"READY kafka {shim.address[0]}:{shim.address[1]}", flush=True)
    _serve_until_signal(stoppers)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    p = argparse.ArgumentParser(prog="pinot_tpu_torch-admin", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    stc = sub.add_parser("StartController")
    stc.add_argument("-port", type=int, default=9000)
    stc.add_argument("-data-dir", required=True, dest="data_dir")
    stc.add_argument("-heartbeat-timeout", type=float, default=6.0, dest="heartbeat_timeout")
    stc.add_argument("-device", default="cuda")
    stc.set_defaults(fn=cmd_start_controller)

    sts = sub.add_parser("StartServer")
    sts.add_argument("-controller", default="http://127.0.0.1:9000")
    sts.add_argument("-name", default="server0")
    sts.add_argument("-port", type=int, default=0)
    sts.add_argument("-data-dir", default=None, dest="data_dir")
    sts.add_argument("-device", default="cuda")
    sts.add_argument("-precision", default="x32", choices=["x32", "x64"])
    sts.set_defaults(fn=cmd_start_server)

    stb = sub.add_parser("StartBroker")
    stb.add_argument("-controller", default="http://127.0.0.1:9000")
    stb.add_argument("-name", default="broker0")
    stb.add_argument("-port", type=int, default=8099)
    stb.add_argument("-timeout-ms", type=float, default=15_000.0, dest="timeout_ms")
    stb.add_argument("-device", default="cuda")
    stb.set_defaults(fn=cmd_start_broker)

    us = sub.add_parser("UploadSegment")
    us.add_argument("-controller", default="http://127.0.0.1:9000")
    us.add_argument("-table", required=True)
    us.add_argument("-segment-file", required=True, dest="segment_file")
    us.set_defaults(fn=cmd_upload_segment)

    asch = sub.add_parser("AddSchema")
    asch.add_argument("-controller", default="http://127.0.0.1:9000")
    asch.add_argument("-schema-file", required=True, dest="schema_file")
    asch.set_defaults(fn=cmd_add_schema)

    at = sub.add_parser("AddTable")
    at.add_argument("-controller", default="http://127.0.0.1:9000")
    at.add_argument("-config-file", required=True, dest="config_file")
    at.set_defaults(fn=cmd_add_table)

    pq = sub.add_parser("PostQuery")
    pq.add_argument("-broker", default="http://127.0.0.1:8099")
    pq.add_argument("-query", required=True)
    pq.add_argument("-trace", action="store_true")
    pq.set_defaults(fn=cmd_post_query)

    q = sub.add_parser("Quickstart")
    q.add_argument("-rows", type=int, default=10_000)
    q.add_argument("-startree", action="store_true")
    q.add_argument("-no-http", action="store_true")
    q.add_argument("-device", default="cuda")
    q.set_defaults(fn=cmd_quickstart)

    sc = sub.add_parser("StartCluster")
    sc.add_argument("-servers", type=int, default=2)
    sc.add_argument("-data-dir", default=None)
    sc.add_argument("-broker-port", type=int, default=8099)
    sc.add_argument("-controller-port", type=int, default=9000)
    sc.add_argument("-device", default="cuda")
    sc.set_defaults(fn=cmd_start_cluster)

    cs = sub.add_parser("CreateSegment", help="build a segment file from .csv, .jsonl or .avro rows "
                        "(a CSV through the columnar path)")
    cs.add_argument("-schema-file", required=True, dest="schema_file")
    cs.add_argument("-data-file", required=True, dest="data_file",
                    help=".csv (the native columnar parse), .jsonl or .avro[.gz]")
    cs.add_argument("-table", required=True)
    cs.add_argument("-segment-name", required=True, dest="segment_name")
    cs.add_argument("-out-dir", required=True, dest="out_dir")
    cs.add_argument("-startree", action="store_true",
                    help="also build a star-tree (StarTreeBuilderConfig defaults)")
    cs.set_defaults(fn=cmd_create_segment)

    bcs = sub.add_parser("BatchCreateSegments")
    bcs.add_argument("-schema-file", required=True, dest="schema_file")
    bcs.add_argument("-inputs", required=True, nargs="+",
                     help="input files/globs (csv/jsonl/avro), one segment each")
    bcs.add_argument("-table", required=True)
    bcs.add_argument("-out-dir", required=True, dest="out_dir")
    bcs.add_argument("-controller", default=None, help="push built segments here when set")
    bcs.add_argument("-workers", type=int, default=0)
    bcs.add_argument("-remote-workers", default=None, dest="remote_workers",
                     help="comma-separated host:port build workers (StartBuildWorker); "
                     "fans shards out over TCP instead of the local process pool")
    bcs.add_argument("-startree", action="store_true")
    bcs.add_argument("-segment-name-prefix", default=None, dest="segment_name_prefix")
    bcs.set_defaults(fn=cmd_batch_create_segments)

    sbw = sub.add_parser("StartBuildWorker", help="long-lived remote segment-build worker (Hadoop-mapper analog)")
    sbw.add_argument("-host", default="0.0.0.0")
    sbw.add_argument("-port", type=int, default=9600)
    sbw.set_defaults(fn=cmd_start_build_worker)

    ss = sub.add_parser("ShowSegment")
    ss.add_argument("-segment-dir", required=True, dest="segment_dir")
    ss.set_defaults(fn=cmd_show_segment)

    cv = sub.add_parser("ConvertSegment")
    cv.add_argument("-segment-dir", required=True, dest="segment_dir")
    cv.add_argument("-format", choices=["csv", "jsonl"], default="jsonl")
    cv.add_argument("-out-file", required=True, dest="out_file")
    cv.set_defaults(fn=cmd_convert_segment)

    sst = sub.add_parser("ShowStarTree")
    sst.add_argument("-segment-dir", required=True, dest="segment_dir")
    sst.add_argument("-max-nodes", type=int, default=50, dest="max_nodes")
    sst.set_defaults(fn=cmd_show_star_tree)

    rb = sub.add_parser("RebalanceTable")
    rb.add_argument("-controller", default="http://127.0.0.1:9000")
    rb.add_argument("-table", required=True)
    rb.add_argument("-dry-run", action="store_true", dest="dry_run")
    rb.set_defaults(fn=cmd_rebalance_table)

    ate = sub.add_parser("AddTenant")
    ate.add_argument("-controller", default="http://127.0.0.1:9000")
    ate.add_argument("-name", required=True)
    ate.add_argument("-role", choices=["server", "broker"], default="server")
    ate.add_argument("-count", type=int, default=1)
    ate.set_defaults(fn=cmd_add_tenant)

    lt = sub.add_parser("ListTenants")
    lt.add_argument("-controller", default="http://127.0.0.1:9000")
    lt.set_defaults(fn=cmd_list_tenants)

    gd = sub.add_parser("GenerateData")
    gd.add_argument("-schema-file", required=True, dest="schema_file")
    gd.add_argument("-num-rows", type=int, default=1000, dest="num_rows")
    gd.add_argument("-seed", type=int, default=0)
    gd.add_argument("-out-file", required=True, dest="out_file")
    gd.set_defaults(fn=cmd_generate_data)

    for cmd, fn in (("RealtimeQuickstart", cmd_realtime_quickstart),
                    ("NetworkRealtimeQuickstart", cmd_network_realtime_quickstart)):
        rq = sub.add_parser(cmd)
        rq.add_argument("-events", type=int, default=2000)
        rq.add_argument("-device", default="cuda")
        if cmd == "NetworkRealtimeQuickstart":
            rq.add_argument("-consumer-type", default="lowlevel", choices=["lowlevel", "highlevel"],
                            dest="consumer_type")
            rq.add_argument("-stream-protocol", default="native", choices=["native", "kafka"],
                            dest="stream_protocol")
        rq.set_defaults(fn=fn)

    hq = sub.add_parser("HybridQuickstart")
    hq.add_argument("-offline-rows", type=int, default=1500, dest="offline_rows")
    hq.add_argument("-realtime-rows", type=int, default=800, dest="realtime_rows")
    hq.add_argument("-no-http", action="store_true")
    hq.add_argument("-device", default="cuda")
    hq.set_defaults(fn=cmd_hybrid_quickstart)

    ssb = sub.add_parser("StartStreamBroker")
    ssb.add_argument("-port", type=int, default=0)
    ssb.add_argument("-log-dir", default=None, dest="log_dir")
    ssb.add_argument("-kafka-port", type=int, default=None, dest="kafka_port")
    ssb.set_defaults(fn=cmd_start_stream_broker)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
