"""Schema evolution in the port (``segment/default_column.py``,
``ServerInstance.set_table_schema``, both starters, ``Controller.
add_schema``'s reload, ``RealtimeSegmentManager.update_schema``) against
the JAX package's, on the same rows.

The reference's five cases of ``tests/test_default_columns.py`` as
differentials: the synthesized columns equal the reference's, injection
skips present columns and the time column, a server retro-patches its
loaded segments, and a mixed-age cluster (a segment built before a
column was added and one built after) answers as the reference's:
``null`` 60 and ``fresh`` 60 over 120 docs, ``count(*) WHERE newDim =
'null'`` 60; without its default columns the old segment would be pruned
("missing columns") and that count would be 0. Beside them: the realtime
rollover with an evolved schema, and a schema posted over HTTP reaching
a server process (``-device cpu``) whose loaded segment is patched
without being read again.
"""
import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from pinot_tpu.common.schema import DataType as RefDataType
from pinot_tpu.common.schema import FieldSpec as RefFieldSpec
from pinot_tpu.common.schema import FieldType as RefFieldType
from pinot_tpu.common.schema import Schema as RefSchema
from pinot_tpu.common.schema import TimeFieldSpec as RefTimeFieldSpec
from pinot_tpu.realtime.llc import make_segment_name as ref_make_segment_name
from pinot_tpu.realtime.stream import MemoryStreamProvider as RefStream
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.segment.default_column import inject_default_columns as ref_inject
from pinot_tpu.segment.default_column import make_default_column as ref_make_default_column
from pinot_tpu.tools.cluster_harness import InProcessCluster as RefCluster
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.utils.audit import payloads_equivalent, strip_accounting

from pinot_tpu_torch.broker.network_starter import NetworkedBrokerStarter
from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType, Schema, TimeFieldSpec
from pinot_tpu_torch.common.tableconfig import TableConfig
from pinot_tpu_torch.controller.controller import Controller, ControllerHttpServer
from pinot_tpu_torch.engine.explain import build_explain_node
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.realtime.llc import RESP_KEEP, make_segment_name
from pinot_tpu_torch.realtime.stream import MemoryStreamProvider
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.segment.default_column import inject_default_columns, make_default_column
from pinot_tpu_torch.segment.format import write_segment
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.tools import admin
from pinot_tpu_torch.tools.cluster_harness import InProcessCluster

REPO = Path(__file__).resolve().parents[1]
REF_BASE = make_test_schema(with_mv=False)


def _port(schema):
    return Schema.from_json(schema.to_json())


def _grown(base: RefSchema) -> RefSchema:
    """base + a new string dimension, an MV int dimension and a metric."""
    return RefSchema(
        base.schema_name,
        dimensions=list(base.dimensions) + [
            RefFieldSpec("newDim", RefDataType.STRING, RefFieldType.DIMENSION),
            RefFieldSpec("newMV", RefDataType.INT_ARRAY, RefFieldType.DIMENSION, single_value=False),
        ],
        metrics=list(base.metrics) + [RefFieldSpec("newMet", RefDataType.DOUBLE, RefFieldType.METRIC)],
        time_field=base.time_field,
    )


def _assert_columns_equal(got, want):
    assert got.metadata.to_json() == want.metadata.to_json()
    assert list(got.dictionary.values) == list(want.dictionary.values)
    for arr in ("fwd", "mv_values", "mv_offsets"):
        a, b = getattr(got, arr), getattr(want, arr)
        assert (a is None) == (b is None), arr
        if b is not None:
            assert a.dtype == b.dtype, arr
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- unit
@pytest.mark.parametrize("name,dtype,ftype,sv", [
    ("d", "STRING", "DIMENSION", True),
    ("m", "DOUBLE", "METRIC", True),
    ("i", "INT", "DIMENSION", True),
    ("l", "LONG", "METRIC", True),
    ("mv", "INT_ARRAY", "DIMENSION", False),
    ("smv", "STRING_ARRAY", "DIMENSION", False),
])
def test_make_default_column_equals_the_reference(name, dtype, ftype, sv):
    got = make_default_column(FieldSpec(name, DataType(dtype), FieldType(ftype), single_value=sv), 7)
    want = ref_make_default_column(RefFieldSpec(name, RefDataType(dtype), RefFieldType(ftype), single_value=sv), 7)
    _assert_columns_equal(got, want)
    assert got.metadata.cardinality == 1 and got.metadata.is_sorted
    assert [got.values_for_doc(i) for i in range(7)] == [want.values_for_doc(i) for i in range(7)]
    if sv:
        np.testing.assert_array_equal(got.fwd, np.zeros(7, dtype=np.int32))
    else:  # one default entry a doc
        assert got.values_for_doc(2) == [want.values_for_doc(2)[0]] and len(got.mv_values) == 7


def test_inject_skips_existing_and_time_as_the_reference():
    rows = random_rows(REF_BASE, 20, seed=5)
    seg = build_segment(_port(REF_BASE), rows, "t", "s0")
    ref_seg = ref_build_segment(REF_BASE, rows, "t", "s0")
    grown = _grown(REF_BASE)
    columns_before, meta_before = seg.columns, seg.metadata.columns
    assert inject_default_columns(seg, _port(grown)) == ref_inject(ref_seg, grown) == 3
    # copies swapped in: a query iterating the old dicts never sees them change
    assert seg.columns is not columns_before and "newDim" not in columns_before
    assert seg.metadata.columns is not meta_before and "newDim" not in meta_before
    assert sorted(seg.columns) == sorted(ref_seg.columns) == sorted(seg.metadata.columns)
    for name in ("newDim", "newMV", "newMet"):
        _assert_columns_equal(seg.column(name), ref_seg.column(name))
    assert seg.compute_crc() == ref_seg.compute_crc()
    assert inject_default_columns(seg, _port(grown)) == ref_inject(ref_seg, grown) == 0  # idempotent
    other = Schema("t2", dimensions=[FieldSpec("dimStr", DataType.STRING, FieldType.DIMENSION)],
                   time_field=TimeFieldSpec("otherTime", DataType.INT, time_unit="DAYS"))
    seg2 = build_segment(_port(REF_BASE), rows, "t", "s1")
    assert inject_default_columns(seg2, other) == 0 and not seg2.has_column("otherTime")
    assert inject_default_columns(seg2, None) == 0


# ------------------------------------------------------ server instance
def test_server_retro_patches_loaded_segments():
    rows = random_rows(REF_BASE, 50, seed=7)
    old_seg = build_segment(_port(REF_BASE), rows, "testTable_OFFLINE", "old")
    server = ServerInstance("s0", device="cpu")
    try:
        server.add_segment("testTable_OFFLINE", old_seg)  # loaded before the evolution
        grown = _port(_grown(REF_BASE))
        server.set_table_schema("testTable_OFFLINE", grown)  # evolve: retro-patch
        assert old_seg.has_column("newDim") and old_seg.has_column("newMV")
        patched = old_seg.columns
        server.set_table_schema("testTable", grown)  # the raw name, unchanged: no second pass
        assert old_seg.columns is patched
        new_rows = [dict(r, newDim="x", newMV=[1, 2], newMet=2.5) for r in rows]
        new_seg = build_segment(_port(_grown(REF_BASE)), new_rows, "testTable_OFFLINE", "new")
        server.add_segment("testTable_OFFLINE", new_seg)
        bare = build_segment(_port(REF_BASE), rows, "testTable_OFFLINE", "later")
        server.add_segment("testTable_OFFLINE", bare)  # later loads are patched too
        assert bare.has_column("newMet")
        # the phantom plan of EXPLAIN sees the injected column
        req = optimize_request(parse_pql("SELECT count(*) FROM testTable GROUP BY newDim TOP 10"))
        node = build_explain_node(server.executor, [old_seg, new_seg, bare], req, "testTable_OFFLINE", "s0")
        assert node["numSegments"] == 3 and node["totalDocs"] == 150, node
        assert node["tierCounts"] == {"segmentsFullScan": 3} and "segmentsPruned" not in node["tierCounts"]
    finally:
        server.shutdown()


# --------------------------------------------------------- end-to-end
MIXED_QUERIES = (
    "SELECT count(*) FROM testTable GROUP BY newDim TOP 10",
    "SELECT sum(newMet) FROM testTable",
    "SELECT count(*) FROM testTable WHERE newDim = 'null'",
    "SELECT distinctcount(newDim) FROM testTable",
    "SELECT count(*) FROM testTable GROUP BY newMV TOP 10",
    "SELECT sum(metInt), count(*) FROM testTable GROUP BY newDim, dimStr TOP 100",
)


def _mixed_age(cluster, schema_of, build):
    base = schema_of(REF_BASE)
    physical = cluster.add_offline_table(base)
    rows = random_rows(REF_BASE, 120, seed=9)
    cluster.upload(physical, build(base, rows[:60], physical, "oldSeg"))
    grown = schema_of(_grown(REF_BASE))
    cluster.controller.add_schema(grown)
    new_rows = [dict(r, newDim="fresh", newMV=[3], newMet=1.0) for r in rows[60:]]
    cluster.upload(physical, build(grown, new_rows, physical, "newSeg"))
    return {pql: cluster.query(pql) for pql in MIXED_QUERIES}


def test_mixed_age_segments_answer_with_defaults_as_the_reference(tmp_path):
    port = InProcessCluster(num_servers=2, data_dir=str(tmp_path / "port"), device="cpu")
    ref = RefCluster(num_servers=2, data_dir=str(tmp_path / "ref"))
    try:
        got = _mixed_age(port, _port, build_segment)
        want = _mixed_age(ref, lambda s: s, ref_build_segment)
    finally:
        port.stop()
        ref.stop()
    for pql in MIXED_QUERIES:
        a, b = strip_accounting(got[pql].to_json()), strip_accounting(want[pql].to_json())
        assert payloads_equivalent(a, b), (pql, a, b)
    groups = {tuple(g.group): g.value for g in got[MIXED_QUERIES[0]].aggregation_results[0].group_by_result}
    assert groups == {("fresh",): 60, ("null",): 60}
    assert got[MIXED_QUERIES[0]].num_docs_scanned == 120 and got[MIXED_QUERIES[0]].num_segments_queried == 2
    assert got[MIXED_QUERIES[1]].num_docs_scanned == 120
    assert got[MIXED_QUERIES[1]].aggregation_results[0].value == 60.0
    assert got[MIXED_QUERIES[2]].aggregation_results[0].value == 60  # 0 if the old segment were pruned


def _rsvp_schemas(mod):
    base = mod["Schema"](
        "meetupRsvp",
        dimensions=[mod["FieldSpec"]("venue_name", mod["DataType"].STRING)],
        metrics=[mod["FieldSpec"]("rsvp_count", mod["DataType"].INT, mod["FieldType"].METRIC)],
        time_field=mod["TimeFieldSpec"]("mtime", mod["DataType"].LONG, time_unit="MILLISECONDS"),
    )
    grown = mod["Schema"](base.schema_name, dimensions=list(base.dimensions),
                          metrics=list(base.metrics) + [mod["FieldSpec"]("guests", mod["DataType"].INT,
                                                                         mod["FieldType"].METRIC)],
                          time_field=base.time_field)
    return base, grown


def _rollover(cluster, mod, stream, segment_name):
    base, grown = _rsvp_schemas(mod)
    physical = cluster.add_realtime_table(base, stream, rows_per_segment=50)
    for i in range(50):
        stream.produce({"venue_name": f"v{i % 3}", "rsvp_count": 1, "mtime": 1000 + i})
    dm0 = cluster.controller.realtime_manager.consumers_of(segment_name(physical, 0, 0))[0]
    dm0.consume_step(max_rows=1000)  # segment 0 fills with the old schema's rows
    # evolve while segment 0 still consumes: the evolution applies to the
    # segments created from here on; the consuming one keeps its schema
    cluster.controller.add_schema(grown)
    assert dm0.try_commit() == "KEEP"  # seals; the rollover creates segment 1 after the evolution
    for i in range(50):
        stream.produce({"venue_name": "v9", "rsvp_count": 1, "guests": 2, "mtime": 2000 + i})
    dm1 = cluster.controller.realtime_manager.consumers_of(segment_name(physical, 0, 1))[0]
    dm1.consume_step(max_rows=1000)
    assert dm1.try_commit() == "KEEP"
    return {pql: cluster.query(pql) for pql in ("SELECT sum(guests) FROM meetupRsvp",
                                                "SELECT count(*) FROM meetupRsvp GROUP BY guests TOP 10")}


def test_realtime_rollover_picks_up_the_evolved_schema(tmp_path):
    """Old rows answer guests = 0 (the metric default), rows after the
    rollover their streamed value 2, as in the reference."""
    port_mod = dict(Schema=Schema, FieldSpec=FieldSpec, DataType=DataType, FieldType=FieldType,
                    TimeFieldSpec=TimeFieldSpec)
    ref_mod = dict(Schema=RefSchema, FieldSpec=RefFieldSpec, DataType=RefDataType, FieldType=RefFieldType,
                   TimeFieldSpec=RefTimeFieldSpec)
    port = InProcessCluster(num_servers=1, data_dir=str(tmp_path / "port"), device="cpu")
    ref = RefCluster(num_servers=1, data_dir=str(tmp_path / "ref"))
    try:
        got = _rollover(port, port_mod, MemoryStreamProvider(num_partitions=1), make_segment_name)
        want = _rollover(ref, ref_mod, RefStream(num_partitions=1), ref_make_segment_name)
        assert RESP_KEEP == "KEEP"
    finally:
        port.stop()
        ref.stop()
    for pql in got:
        a, b = strip_accounting(got[pql].to_json()), strip_accounting(want[pql].to_json())
        assert payloads_equivalent(a, b), (pql, a, b)
    total = got["SELECT sum(guests) FROM meetupRsvp"]
    assert total.num_docs_scanned == 100 and total.aggregation_results[0].value == 100.0


# ---------------------------------------------------- over the network
def _post(url, data, ctype="application/json"):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _wait(cond, what, deadline_s=90.0):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out after {deadline_s} s waiting for {what}")


def test_a_schema_posted_over_http_patches_a_server_process(tmp_path):
    """``AddSchema`` of a grown schema reloads the table: the server
    process applies the ONLINE message's schemaJson on its CRC-skip path,
    so its loaded segment answers the new column without being loaded
    again (its segmentLoad count stays 1)."""
    ctrl = Controller(str(tmp_path / "controller"))
    http = ControllerHttpServer(ctrl)
    http.start()
    log = open(tmp_path / "server.log", "w+")
    proc = subprocess.Popen([sys.executable, "-m", "pinot_tpu_torch.tools.admin", "StartServer", "-controller",
                             http.url, "-name", "server0", "-port", "0", "-device", "cpu", "-precision", "x64"],
                            cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=log,
                            stderr=subprocess.STDOUT, text=True)
    broker = None
    try:
        def ready():
            assert proc.poll() is None, log.read()
            log.seek(0)
            return next((ln for ln in log.read().splitlines() if ln.startswith("READY server")), None)

        admin_url = _wait(ready, "READY server").split()[-1]
        broker = NetworkedBrokerStarter(http.url, "broker0")
        broker.start()
        schema_file = tmp_path / "schema.json"
        schema_file.write_text(json.dumps(REF_BASE.to_json()))
        admin.main(["AddSchema", "-controller", http.url, "-schema-file", str(schema_file)])
        _post(http.url + "/tables", json.dumps(TableConfig("testTable").to_json()).encode())
        rows = random_rows(REF_BASE, 60, seed=9)
        path = write_segment(build_segment(_port(REF_BASE), rows, "testTable_OFFLINE", "oldSeg"),
                             str(tmp_path / "oldSeg"))
        with open(path, "rb") as f:
            _post(http.url + "/segments/testTable_OFFLINE", f.read(), "application/octet-stream")

        def answer(pql):
            d = _post(broker.http.url + "/query", json.dumps({"pql": pql}).encode())
            return d if not d["exceptions"] and d.get("numDocsScanned") == 60 else None

        _wait(lambda: answer("SELECT count(*) FROM testTable"), "the old segment served")
        schema_file.write_text(json.dumps(_grown(REF_BASE).to_json()))
        admin.main(["AddSchema", "-controller", http.url, "-schema-file", str(schema_file)])
        d = _wait(lambda: answer("SELECT count(*) FROM testTable GROUP BY newDim TOP 10"), "the default column")
        assert d["aggregationResults"][0]["groupByResult"] == [{"value": "60", "group": ["null"]}]
        d = answer("SELECT count(*) FROM testTable WHERE newDim = 'null'")
        assert d["aggregationResults"][0]["value"] == "60"
        with urllib.request.urlopen(admin_url + "/debug/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
        assert metrics["metrics"]["timers"]["segmentLoad"]["count"] == 1  # patched, not loaded again
    finally:
        if broker is not None:
            broker.stop()
        if proc.poll() is None:
            proc.terminate()
            assert proc.wait(timeout=60) == 0
        log.close()
        http.stop()
