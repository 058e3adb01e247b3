"""Admin CLI (port of ``pinot_tpu.tools.admin``, trimmed to the
deployment and segment commands).  Usage::

    python -m pinot_tpu_torch.tools.admin <command> [args]

Commands:
  StartController   a controller process: segment store, cluster state,
                    REST and control plane
  StartServer       a server process joining a controller
  StartBroker       a broker process joining a controller
  AddSchema         POST a schema JSON file to a controller
  AddTable          POST a table config JSON file to a controller (its
                    "partitioning" block, {"column", "numPartitions"},
                    declares the key partitioning joins colocate on)
  UploadSegment     POST a segment file to a controller
  PostQuery         run PQL against a broker
  CreateSegment     build a segment file from CSV or JSONL rows (the row
                    builder; -startree adds a star-tree at its defaults)
  ShowSegment       print a segment file's metadata
  RealtimeQuickstart         a meetupRsvp stream ingested into a REALTIME
                             table of an in-process cluster, then queried
  NetworkRealtimeQuickstart  the same across processes: a TCP stream
                             broker, a controller, a server and a broker

Each Start* command prints ``READY <role> <address>`` once it serves, then
serves until SIGTERM or SIGINT, when it stops its threads and exits 0.
``-device`` names the device of the role (default ``cuda``, the card;
``cpu`` runs the port's plain torch versions, for tests): a server stages
its segments and launches its kernels there.
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
    ctrl = Controller(args.data_dir, heartbeat_timeout_s=args.heartbeat_timeout)
    http = ControllerHttpServer(ctrl, port=args.port)
    http.start()
    print(f"READY controller http://127.0.0.1:{http.port}", flush=True)
    _serve_until_signal([http.stop])


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
    """Rows -> the two-pass row builder -> a segment file.  A CSV is parsed
    by the row path too (the reference's native columnar CSV path is
    item 31 of the port)."""
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.segment.format import write_segment
    from pinot_tpu_torch.segment.readers import read_for_path
    from pinot_tpu_torch.startree.builder import StarTreeBuilderConfig

    with open(args.schema_file) as f:
        schema = Schema.from_json(json.load(f))
    cfg = StarTreeBuilderConfig() if args.startree else None
    rows = read_for_path(args.data_file, schema)
    seg = build_segment(schema, rows, args.table, args.segment_name, startree_config=cfg)
    path = write_segment(seg, args.out_dir)
    print(f"built segment {seg.segment_name}: {seg.num_docs} docs -> {path}")


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

    count = run_network_realtime_quickstart(num_events=args.events, device=str(_device(args)))
    print(f"DONE networked realtime quickstart: {count} events ingested", flush=True)
    if count < args.events:
        raise SystemExit(1)


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

    cs = sub.add_parser("CreateSegment", help="build a segment file from .csv or .jsonl rows "
                        "(a CSV is parsed by the row path)")
    cs.add_argument("-schema-file", required=True, dest="schema_file")
    cs.add_argument("-data-file", required=True, dest="data_file",
                    help=".csv (parsed row by row) or .jsonl")
    cs.add_argument("-table", required=True)
    cs.add_argument("-segment-name", required=True, dest="segment_name")
    cs.add_argument("-out-dir", required=True, dest="out_dir")
    cs.add_argument("-startree", action="store_true",
                    help="also build a star-tree (StarTreeBuilderConfig defaults)")
    cs.set_defaults(fn=cmd_create_segment)

    ss = sub.add_parser("ShowSegment")
    ss.add_argument("-segment-dir", required=True, dest="segment_dir")
    ss.set_defaults(fn=cmd_show_segment)

    for cmd, fn in (("RealtimeQuickstart", cmd_realtime_quickstart),
                    ("NetworkRealtimeQuickstart", cmd_network_realtime_quickstart)):
        rq = sub.add_parser(cmd)
        rq.add_argument("-events", type=int, default=2000)
        rq.add_argument("-device", default="cuda")
        rq.set_defaults(fn=fn)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
