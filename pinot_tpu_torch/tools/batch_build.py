"""Distributed/batch segment build: the pinot-hadoop analog (copy of
``pinot_tpu.tools.batch_build``).

Reference: ``pinot-hadoop/.../job/SegmentCreationJob.java`` maps one
segment build per input file across a Hadoop cluster, then
``SegmentTarPushJob`` POSTs the tars to the controller.  Here the same
shape runs on a worker-process pool: shard input files -> build a
segment per shard in a subprocess (CSV fast path uses the native C++
parser) -> write to the output dir -> optionally push to a controller
over HTTP.  Build work is host-side numpy, so worker processes scale it
across cores and never touch the card: a ``.csv`` input goes through the
columnar path (``segment/columnar.py``), an ``.avro`` or ``.jsonl`` input
through ``read_for_path`` and the row builder.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import urllib.request
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


@dataclass
class BatchBuildSpec:
    schema_file: str
    table: str
    input_files: Sequence[str]
    out_dir: str
    controller: Optional[str] = None  # push after build when set
    startree: bool = False
    segment_name_prefix: Optional[str] = None  # default: table name


def _build_one(args: Tuple[str, str, str, str, str, bool, Optional[str]]) -> dict:
    """Worker: build one segment from one input file (runs in a spawned
    subprocess, like one Hadoop mapper)."""
    schema_file, table, input_file, out_dir, segment_name, startree, controller = args
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.segment.columnar import build_segment_from_csv
    from pinot_tpu_torch.segment.format import write_segment
    from pinot_tpu_torch.startree.builder import StarTreeBuilderConfig

    with open(schema_file) as f:
        schema = Schema.from_json(json.load(f))
    cfg = StarTreeBuilderConfig() if startree else None
    if input_file.endswith(".csv"):
        seg = build_segment_from_csv(
            schema, input_file, table, segment_name, startree_config=cfg
        )
    else:
        from pinot_tpu_torch.segment.readers import read_for_path

        rows = read_for_path(input_file, schema)
        seg = build_segment(schema, rows, table, segment_name, startree_config=cfg)
    path = write_segment(seg, os.path.join(out_dir, segment_name))
    result = {
        "segment": segment_name,
        "input": input_file,
        "docs": seg.num_docs,
        "path": path,
        "pushed": False,
    }
    if controller:
        with open(path, "rb") as f:
            data = f.read()
        url = controller.rstrip("/") + f"/segments/{table}"
        req = urllib.request.Request(
            url, data=data, headers={"Content-Type": "application/octet-stream"}
        )
        with urllib.request.urlopen(req, timeout=300) as r:
            json.loads(r.read())
        result["pushed"] = True
    return result


def run_batch_build(spec: BatchBuildSpec, workers: int = 0) -> List[dict]:
    """Build (and optionally push) one segment per input file on a
    process pool; returns per-segment results in input order."""
    if not spec.input_files:
        return []
    os.makedirs(spec.out_dir, exist_ok=True)
    prefix = spec.segment_name_prefix or spec.table
    jobs = [
        (
            spec.schema_file,
            spec.table,
            path,
            spec.out_dir,
            f"{prefix}_{i}",
            spec.startree,
            spec.controller,
        )
        for i, path in enumerate(spec.input_files)
    ]
    workers = workers or min(len(jobs), os.cpu_count() or 2)
    if workers <= 1 or len(jobs) == 1:
        return [_build_one(j) for j in jobs]
    # spawn (not fork): workers must not inherit the parent's CUDA state,
    # which a forked child cannot use
    ctx = mp.get_context("spawn")
    with ctx.Pool(workers) as pool:
        return pool.map(_build_one, jobs)


# ---------------------------------------------------------------------------
# Cross-machine build fan-out (pinot-hadoop parity)
# ---------------------------------------------------------------------------
# Reference: SegmentCreationJob.java distributes one segment build per
# input file across Hadoop mappers; SegmentTarPushJob.java pushes the
# results.  Here remote BUILD WORKERS are long-lived OS processes
# serving length-framed JSON jobs over the framework's own TCP
# transport (transport/tcp.py); the coordinator shards inputs across
# workers and retries failed shards on surviving workers.  Workers
# push finished segments to the controller themselves (the mapper-side
# push), so segment bytes never funnel through the coordinator.


def _worker_handle(payload: bytes) -> bytes:
    """One build job frame -> one result frame (runs inside a worker)."""
    job = json.loads(payload.decode("utf-8"))
    try:
        result = _build_one(
            (
                job["schemaFile"],
                job["table"],
                job["inputFile"],
                job["outDir"],
                job["segmentName"],
                bool(job.get("startree")),
                job.get("controller"),
            )
        )
        return json.dumps({"ok": True, "result": result}).encode("utf-8")
    except Exception as e:  # report, don't kill the worker
        return json.dumps({"ok": False, "error": f"{type(e).__name__}: {e}"}).encode(
            "utf-8"
        )


def serve_build_worker(host: str = "127.0.0.1", port: int = 0):
    """Start a build worker; returns the TcpServer (its .address is the
    (host, port) the coordinator needs)."""
    from pinot_tpu_torch.transport.tcp import TcpServer

    server = TcpServer(_worker_handle, host=host, port=port)
    server.start()
    return server


def run_distributed_build(
    spec: BatchBuildSpec,
    worker_addresses: Sequence[Tuple[str, int]],
    retries: int = 2,
    timeout_s: float = 600.0,
) -> List[dict]:
    """Fan one build job per input file out to remote build workers.

    Shards are dealt round-robin; a shard whose worker fails (connection
    refused, worker crash mid-build, error reply) is retried on the
    next worker, up to ``retries`` extra attempts — the Hadoop-mapper
    re-execution analog.  Raises RuntimeError when a shard exhausts its
    attempts; per-shard results come back in input order."""
    from concurrent.futures import ThreadPoolExecutor

    from pinot_tpu_torch.transport.tcp import TcpTransport, TransportError

    if not spec.input_files:
        return []
    os.makedirs(spec.out_dir, exist_ok=True)
    prefix = spec.segment_name_prefix or spec.table
    with open(spec.schema_file):  # fail fast on a bad schema path
        pass
    transport = TcpTransport()
    n_workers = len(worker_addresses)

    def run_shard(i_path):
        i, path = i_path
        job = json.dumps(
            {
                "schemaFile": spec.schema_file,
                "table": spec.table,
                "inputFile": path,
                "outDir": spec.out_dir,
                "segmentName": f"{prefix}_{i}",
                "startree": spec.startree,
                "controller": spec.controller,
            }
        ).encode("utf-8")
        errors = []
        for attempt in range(retries + 1):
            addr = tuple(worker_addresses[(i + attempt) % n_workers])
            try:
                reply = json.loads(
                    transport.request(addr, job, timeout=timeout_s).decode("utf-8")
                )
            except (TransportError, OSError) as e:
                # OSError covers pool checkout (fresh connect) to a dead
                # worker — connection refused must retry like any failure
                errors.append(f"{addr}: {e}")
                continue
            if reply.get("ok"):
                return reply["result"]
            errors.append(f"{addr}: {reply.get('error')}")
        raise RuntimeError(
            f"shard {i} ({path}) failed on all attempts: {'; '.join(errors)}"
        )

    with ThreadPoolExecutor(max_workers=min(len(spec.input_files), 16)) as pool:
        return list(pool.map(run_shard, enumerate(spec.input_files)))
