"""The port's batch and distributed segment builds (``tools/batch_build.py``,
the pinot-hadoop analog) against the JAX package's builds of the same
files.

- a spawn-context pool of two workers builds one segment a file (a CSV
  through the columnar path, JSONL and Avro through the row builder),
  each equal to the reference's build of the same file, CRC included;
- the builds push to the port's controller over HTTP, and the cluster
  answers over every row;
- two build workers, each a process of the admin CLI's
  ``StartBuildWorker``, take shards over TCP from ``BatchCreateSegments
  -remote-workers``; after one is killed, every shard still builds,
  retried on the survivor.
"""
import csv
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.segment.columnar import build_segment_from_csv as ref_build_from_csv
from pinot_tpu.segment.readers import read_for_path as ref_read_for_path
from pinot_tpu.tools.datagen import make_test_schema, random_rows

from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.controller.controller import ControllerHttpServer
from pinot_tpu_torch.segment.avro import pinot_to_avro_schema, write_avro
from pinot_tpu_torch.segment.format import read_segment
from pinot_tpu_torch.tools import admin
from pinot_tpu_torch.tools.batch_build import BatchBuildSpec, run_batch_build, run_distributed_build
from pinot_tpu_torch.tools.cluster_harness import InProcessCluster

REPO = Path(__file__).resolve().parents[1]
REF_SCHEMA = make_test_schema(with_mv=True)
SCHEMA = Schema.from_json(REF_SCHEMA.to_json())


def _write(tmp_path, fmt: str, i: int, rows_per: int) -> str:
    rows = random_rows(REF_SCHEMA, rows_per, seed=100 + i)
    path = tmp_path / f"shard{i}.{fmt}"
    if fmt == "csv":
        cols = [f.name for f in REF_SCHEMA.all_fields()]
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            for r in rows:
                w.writerow([";".join(map(str, r[c])) if isinstance(r[c], list) else r[c] for c in cols])
    elif fmt == "jsonl":
        path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    else:
        write_avro(str(path), pinot_to_avro_schema(SCHEMA), rows, codec="deflate")
    return str(path)


@pytest.fixture()
def schema_file(tmp_path):
    p = tmp_path / "schema.json"
    p.write_text(json.dumps(REF_SCHEMA.to_json()))
    return str(p)


def _reference_segment(path: str, table: str, name: str):
    if path.endswith(".csv"):
        return ref_build_from_csv(REF_SCHEMA, path, table, name)
    return ref_build_segment(REF_SCHEMA, ref_read_for_path(path, REF_SCHEMA), table, name)


def _assert_equal_to_reference(result, table):
    seg = read_segment(result["path"])
    want = _reference_segment(result["input"], table, result["segment"])
    assert seg.num_docs == want.num_docs == result["docs"]
    assert seg.metadata.crc == want.metadata.crc == seg.compute_crc(), result
    for name, wc in want.columns.items():
        gc = seg.column(name)
        assert list(gc.dictionary.values) == list(wc.dictionary.values), name
        for arr in ("fwd", "mv_values", "mv_offsets"):
            if getattr(wc, arr) is not None:
                np.testing.assert_array_equal(getattr(gc, arr), getattr(wc, arr))


def test_pool_builds_each_format_equal_to_the_reference(tmp_path, schema_file):
    inputs = [_write(tmp_path, fmt, i, 60) for i, fmt in enumerate(("csv", "jsonl", "avro"))]
    spec = BatchBuildSpec(schema_file=schema_file, table="bb", input_files=inputs, out_dir=str(tmp_path / "out"))
    results = run_batch_build(spec, workers=2)
    assert [r["segment"] for r in results] == ["bb_0", "bb_1", "bb_2"]
    assert [r["input"] for r in results] == inputs and not any(r["pushed"] for r in results)
    for r in results:
        _assert_equal_to_reference(r, "bb")


def test_build_and_push_to_the_controller(tmp_path, schema_file):
    cluster = InProcessCluster(num_servers=1, data_dir=str(tmp_path / "ctrl"), device="cpu")
    physical = cluster.add_offline_table(SCHEMA)
    http = ControllerHttpServer(cluster.controller)
    http.start()
    try:
        inputs = [_write(tmp_path, "csv", i, 30) for i in range(2)]
        spec = BatchBuildSpec(schema_file=schema_file, table=physical, input_files=inputs,
                              out_dir=str(tmp_path / "out"), controller=f"http://127.0.0.1:{http.port}",
                              startree=True, segment_name_prefix="pushed")
        # one worker keeps the push in this process; the pool's push is the
        # same HTTP client
        results = run_batch_build(spec, workers=1)
        assert all(r["pushed"] for r in results) and [r["segment"] for r in results] == ["pushed_0", "pushed_1"]
        assert cluster.query("SELECT count(*) FROM testTable").num_docs_scanned == 60
        assert all(getattr(read_segment(r["path"]), "star_tree", None) is not None for r in results)
    finally:
        http.stop()
        cluster.stop()


def _start_worker(tmp_path, name):
    """A build worker as a process of the admin CLI; (process, port)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    log = open(tmp_path / f"{name}.log", "w+")
    proc = subprocess.Popen([sys.executable, "-m", "pinot_tpu_torch.tools.admin", "StartBuildWorker",
                             "-host", "127.0.0.1", "-port", "0"], cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=log, text=True)
    line = proc.stdout.readline()
    assert line.startswith("build worker listening on 127.0.0.1:"), (line, log.read())
    return proc, int(line.rsplit(":", 1)[1])


def test_two_tcp_workers_one_killed_every_shard_builds(tmp_path, schema_file, capsys):
    cluster = InProcessCluster(num_servers=1, data_dir=str(tmp_path / "ctrl"), device="cpu")
    physical = cluster.add_offline_table(SCHEMA)
    http = ControllerHttpServer(cluster.controller)
    http.start()
    workers = []
    try:
        workers = [_start_worker(tmp_path, f"w{i}") for i in range(2)]
        addrs = ",".join(f"127.0.0.1:{port}" for _, port in workers)
        inputs = [_write(tmp_path, "csv", i, 25) for i in range(3)] + [_write(tmp_path, "avro", 3, 25)]
        admin.main(["BatchCreateSegments", "-schema-file", schema_file, "-inputs", str(tmp_path / "shard*"),
                    "-table", physical, "-out-dir", str(tmp_path / "out"), "-remote-workers", addrs,
                    "-controller", f"http://127.0.0.1:{http.port}"])
        results = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
        assert [r["segment"] for r in results] == [f"{physical}_{i}" for i in range(4)]
        assert [r["input"] for r in results] == sorted(inputs) and all(r["pushed"] for r in results)
        for r in results:
            _assert_equal_to_reference(r, physical)
        assert cluster.query("SELECT count(*) FROM testTable").num_docs_scanned == 100

        # kill the first worker: the shards dealt to it are retried on the
        # survivor (the Hadoop mapper's re-execution)
        dead, _ = workers[0]
        dead.send_signal(signal.SIGKILL)
        dead.wait(timeout=30)
        spec = BatchBuildSpec(schema_file=schema_file, table=physical, input_files=inputs,
                              out_dir=str(tmp_path / "out2"), segment_name_prefix="again")
        results = run_distributed_build(spec, [("127.0.0.1", port) for _, port in workers], timeout_s=120.0)
        assert [r["segment"] for r in results] == [f"again_{i}" for i in range(4)]
        for r in results:
            _assert_equal_to_reference(r, physical)
        # with every worker gone a shard fails loudly
        with pytest.raises(RuntimeError, match="failed on all attempts"):
            run_distributed_build(spec, [("127.0.0.1", workers[0][1])], retries=1, timeout_s=10.0)
    finally:
        for proc, _ in workers:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                assert proc.wait(timeout=60) == 0
            proc.stdout.close()
        http.stop()
        cluster.stop()


def test_remote_workers_argument_is_checked(tmp_path, schema_file):
    _write(tmp_path, "csv", 0, 5)
    with pytest.raises(SystemExit, match="not host:port"):
        admin.main(["BatchCreateSegments", "-schema-file", schema_file, "-inputs", str(tmp_path / "*.csv"),
                    "-table", "t", "-out-dir", str(tmp_path / "o"), "-remote-workers", "nohost"])
    with pytest.raises(SystemExit, match="no input files"):
        admin.main(["BatchCreateSegments", "-schema-file", schema_file, "-inputs", str(tmp_path / "*.none"),
                    "-table", "t", "-out-dir", str(tmp_path / "o")])
