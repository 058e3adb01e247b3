"""The port's offline tools against the JAX package's: the offline
``Quickstart`` (in process, through the admin CLI and over the broker's
HTTP front), ``StartCluster`` as a process, the segment converters'
round trip, ``star_tree_summary``, and the ``ConvertSegment`` /
``GenerateData`` / ``ShowStarTree`` commands, each output equal to the
reference's for the same input.  Every port cluster runs with
``device="cpu"``.
"""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from pinot_tpu.common.schema import Schema as RefSchema
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.segment.default_column import inject_default_columns as ref_inject
from pinot_tpu.startree.builder import StarTreeBuilderConfig as RefStarTreeConfig
from pinot_tpu.tools import admin as ref_admin
from pinot_tpu.tools import converters as ref_converters
from pinot_tpu.tools.datagen import baseball_schema, make_test_schema
from pinot_tpu.tools.datagen import random_rows as ref_random_rows
from pinot_tpu.tools.quickstart import run_offline_quickstart as ref_quickstart
from pinot_tpu.utils.audit import payloads_equivalent, strip_accounting

from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.segment.default_column import inject_default_columns
from pinot_tpu_torch.segment.format import write_segment
from pinot_tpu_torch.segment.readers import read_csv, read_jsonl
from pinot_tpu_torch.startree.builder import StarTreeBuilderConfig
from pinot_tpu_torch.tools import admin, converters
from pinot_tpu_torch.tools.datagen import baseball_rows, random_rows
from pinot_tpu_torch.tools.quickstart import OFFLINE_SAMPLE_QUERIES, run_offline_quickstart

REPO = Path(__file__).resolve().parents[1]


def _port(schema):
    return Schema.from_json(schema.to_json())


@pytest.mark.parametrize("startree", [False, True])
def test_offline_quickstart_answers_as_the_reference(startree):
    got = run_offline_quickstart(num_rows=1600, num_segments=4, startree=startree, verbose=False, device="cpu")
    want = ref_quickstart(num_rows=1600, num_segments=4, startree=startree, verbose=False)
    try:
        assert sorted(got.controller.resources.segments_of("baseballStats_OFFLINE")) == \
            [f"baseballStats_{i}" for i in range(4)]
        for pql in OFFLINE_SAMPLE_QUERIES:
            a, b = strip_accounting(got.query(pql).to_json()), strip_accounting(want.query(pql).to_json())
            assert payloads_equivalent(a, b), (pql, a, b)
        if startree:  # the cube answers from its pre-aggregated rows
            assert got.query("SELECT sum(runs), count(*) FROM baseballStats").num_docs_scanned < 1000
    finally:
        got.stop()
        want.stop()


def test_offline_quickstart_over_http():
    cluster = run_offline_quickstart(num_rows=800, http=True, verbose=False, device="cpu")
    try:
        pql = OFFLINE_SAMPLE_QUERIES[1]
        req = urllib.request.Request(f"http://127.0.0.1:{cluster.http.port}/query",
                                     data=json.dumps({"pql": pql}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            served = json.loads(r.read())
        assert served["aggregationResults"] == cluster.query(pql).to_json()["aggregationResults"]
        inst = cluster.controller.resources.instances[cluster.broker.name]
        assert inst.url == f"http://{cluster.http.host}:{cluster.http.port}"
    finally:
        cluster.stop()


def test_admin_quickstart_prints_the_samples(capsys):
    admin.main(["Quickstart", "-rows", "400", "-no-http", "-device", "cpu"])
    out = capsys.readouterr().out
    assert [ln[4:] for ln in out.splitlines() if ln.startswith(">>> ")] == OFFLINE_SAMPLE_QUERIES


def _readline(proc):
    line = proc.stdout.readline()
    assert line, proc.stderr.read()  # the process exited first
    return line


def test_start_cluster_serves_and_stops_on_sigterm(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-m", "pinot_tpu_torch.tools.admin", "StartCluster", "-servers", "1",
                             "-data-dir", str(tmp_path / "cluster"), "-broker-port", "0", "-controller-port", "0",
                             "-device", "cpu"], cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ctrl = _readline(proc).split()[1]
        broker = _readline(proc).split()[1]
        assert _readline(proc).strip() == "Ctrl-C to exit."
        schema = make_test_schema(with_mv=False)
        rows = ref_random_rows(schema, 90, seed=2)
        seg_dir = write_segment(build_segment(_port(schema), rows, "testTable_OFFLINE", "s0"), str(tmp_path / "s0"))
        admin.main(["AddSchema", "-controller", ctrl, "-schema-file", _dump(tmp_path, schema.to_json())])
        admin.main(["AddTable", "-controller", ctrl, "-config-file",
                    _dump(tmp_path, {"tableName": "testTable", "tableType": "OFFLINE"}, "table.json")])
        admin.main(["UploadSegment", "-controller", ctrl, "-table", "testTable_OFFLINE", "-segment-file", seg_dir])
        end = time.monotonic() + 60
        while True:
            req = urllib.request.Request(broker, data=json.dumps({"pql": "SELECT count(*) FROM testTable"}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                d = json.loads(r.read())
            if d.get("aggregationResults") and d["aggregationResults"][0]["value"] == "90":
                break
            assert time.monotonic() < end, d
            time.sleep(0.2)
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        proc.stdout.close()
        proc.stderr.close()


def _dump(tmp_path, obj, name="schema.json"):
    path = tmp_path / name
    path.write_text(json.dumps(obj))
    return str(path)


def test_converters_round_trip_and_equal_the_reference(tmp_path):
    """Export to CSV and JSONL, rebuild an identical segment from the
    export; each export's bytes equal the reference's."""
    ref_schema = make_test_schema(with_mv=True)
    schema = _port(ref_schema)
    rows = ref_random_rows(ref_schema, 150, seed=5)
    seg = build_segment(schema, rows, "t_OFFLINE", "conv")
    ref_seg = ref_build_segment(ref_schema, rows, "t_OFFLINE", "conv")
    for fmt, export, ref_export, read in (("jsonl", converters.segment_to_jsonl, ref_converters.segment_to_jsonl,
                                           read_jsonl),
                                          ("csv", converters.segment_to_csv, ref_converters.segment_to_csv, read_csv)):
        mine, theirs = str(tmp_path / f"port.{fmt}"), str(tmp_path / f"ref.{fmt}")
        assert export(seg, mine) == ref_export(ref_seg, theirs) == 150
        assert Path(mine).read_bytes() == Path(theirs).read_bytes(), fmt
        back = build_segment(schema, read(mine, schema), "t_OFFLINE", "conv2")
        assert back.rows() == seg.rows()


def test_exports_carry_injected_default_columns(tmp_path):
    """An evolved segment exports its default columns, as the reference's
    does: the exports iterate ``metadata.columns``."""
    ref_schema = make_test_schema(with_mv=False)
    rows = ref_random_rows(ref_schema, 40, seed=6)
    grown = RefSchema.from_json(dict(ref_schema.to_json(), dimensionFieldSpecs=ref_schema.to_json()[
        "dimensionFieldSpecs"] + [{"name": "newDim", "dataType": "STRING"}]))
    seg = build_segment(_port(ref_schema), rows, "t", "s")
    ref_seg = ref_build_segment(ref_schema, rows, "t", "s")
    assert inject_default_columns(seg, _port(grown)) == ref_inject(ref_seg, grown) == 1
    mine, theirs = str(tmp_path / "port.csv"), str(tmp_path / "ref.csv")
    converters.segment_to_csv(seg, mine)
    ref_converters.segment_to_csv(ref_seg, theirs)
    assert Path(mine).read_bytes() == Path(theirs).read_bytes()
    assert "newDim" in Path(mine).read_text().splitlines()[0].split(",")


def test_star_tree_summary_equals_the_reference():
    rows = baseball_rows(500, seed=9)
    seg = build_segment(_port(baseball_schema()), rows, "bb_OFFLINE", "st1",
                        startree_config=StarTreeBuilderConfig(max_leaf_records=50))
    ref_seg = ref_build_segment(baseball_schema(), rows, "bb_OFFLINE", "st1",
                                startree_config=RefStarTreeConfig(max_leaf_records=50))
    got = converters.star_tree_summary(seg, max_nodes=80)
    assert got == ref_converters.star_tree_summary(ref_seg, max_nodes=80)
    assert got["hasStarTree"] and got["numStarNodes"] > 0 and got["nodes"][0]["path"] == "(root)"
    plain = build_segment(_port(baseball_schema()), rows, "bb_OFFLINE", "plain1")
    assert converters.star_tree_summary(plain) == {"hasStarTree": False}


def test_random_rows_equal_the_reference():
    for schema in (make_test_schema(with_mv=True), baseball_schema()):
        assert random_rows(_port(schema), 120, seed=4, cardinality=7) == \
            ref_random_rows(schema, 120, seed=4, cardinality=7)


def _both(argv_for, capsys):
    """Run one admin command in each package; their printed outputs."""
    out = {}
    for label, mod in (("port", admin), ("ref", ref_admin)):
        mod.main(argv_for(label))
        out[label] = capsys.readouterr().out
    return out


def test_generate_convert_and_show_star_tree_commands_equal_the_reference(tmp_path, capsys):
    schema_file = _dump(tmp_path, baseball_schema().to_json())
    out = _both(lambda lab: ["GenerateData", "-schema-file", schema_file, "-num-rows", "300", "-seed", "3",
                             "-out-file", str(tmp_path / f"{lab}.jsonl")], capsys)
    assert out["port"] == out["ref"].replace("ref.jsonl", "port.jsonl")
    assert out["port"].startswith("generated 300 rows -> ")
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "ref.jsonl").read_bytes()

    # one segment file with a star-tree, written by the port and read by both
    data = str(tmp_path / "port.jsonl")
    admin.main(["CreateSegment", "-schema-file", schema_file, "-data-file", data, "-table", "baseballStats",
                "-segment-name", "g1", "-out-dir", str(tmp_path / "seg"), "-startree"])
    ref_admin.main(["CreateSegment", "-schema-file", schema_file, "-data-file", data, "-table", "baseballStats",
                    "-segment-name", "g1", "-out-dir", str(tmp_path / "refseg"), "-startree"])
    capsys.readouterr()
    for fmt in ("csv", "jsonl"):
        out = _both(lambda lab: ["ConvertSegment", "-segment-dir", str(tmp_path / ("seg" if lab == "port" else "refseg")),
                                 "-format", fmt, "-out-file", str(tmp_path / f"{lab}_export.{fmt}")], capsys)
        assert out["port"] == out["ref"].replace("ref_export", "port_export")
        assert (tmp_path / f"port_export.{fmt}").read_bytes() == (tmp_path / f"ref_export.{fmt}").read_bytes()
    out = _both(lambda lab: ["ShowStarTree", "-segment-dir", str(tmp_path / ("seg" if lab == "port" else "refseg")),
                             "-max-nodes", "20"], capsys)
    assert out["port"] == out["ref"] and json.loads(out["port"])["hasStarTree"]

