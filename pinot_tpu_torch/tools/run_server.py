"""Standalone server process: load segments from disk, serve TCP queries
(port of ``pinot_tpu.tools.run_server``).

Used by chaos tests that kill real OS processes with POSIX signals
(ChaosMonkeyIntegrationTest.java:41) and by manual multi-process
deployments.

Usage: python -m pinot_tpu_torch.tools.run_server --name s0 --port 0 \\
          --table myTable_OFFLINE --segments /path/seg1 /path/seg2 [--device cpu]
Prints "READY <port>" on stdout once serving; SIGTERM or SIGINT stops it.
"""
from __future__ import annotations

import argparse
import signal
import threading


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--name", default="server0")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--table", required=True)
    p.add_argument("--segments", nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from pinot_tpu_torch.segment.format import read_segment
    from pinot_tpu_torch.server.instance import ServerInstance
    from pinot_tpu_torch.transport.tcp import TcpServer

    server = ServerInstance(args.name, device=args.device)
    for seg_dir in args.segments:
        server.add_segment(args.table, read_segment(seg_dir))

    tcp = TcpServer(server.handle_request, port=args.port)
    tcp.start()
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    print(f"READY {tcp.port}", flush=True)
    while not done.wait(3600):
        pass
    tcp.stop()
    server.shutdown()


if __name__ == "__main__":
    main()
