"""The port's offline segment build (``segment/builder.py``,
``segment/readers.py``, ``tools/admin.py`` ``CreateSegment`` /
``ShowSegment``) against the JAX package's, on the same rows.

A segment built by each package from the same rows (baseball rows, and
``make_test_schema()`` rows with their two multi-value columns) has equal
dictionaries, forward indexes (SV and CSR), column metadata, time range
and data CRC.  The creation time is the wall clock of each build, so it
may differ and is not compared.  ``read_csv`` / ``read_jsonl`` give the
reference's rows, and ``CreateSegment -startree`` writes a file whose
columns and star-tree equal the reference's build of the rows it read.
"""
import csv
import json
import os

import numpy as np
import pytest

from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.segment.format import read_segment as ref_read
from pinot_tpu.segment.readers import read_csv as ref_read_csv
from pinot_tpu.segment.readers import read_jsonl as ref_read_jsonl
from pinot_tpu.startree import StarTreeBuilderConfig as RefConfig
from pinot_tpu.tools import admin as ref_admin
from pinot_tpu.tools.datagen import baseball_schema, make_test_schema, random_rows

from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.segment.builder import SegmentGeneratorConfig, build_segment
from pinot_tpu_torch.segment.format import SEGMENT_FILE_NAME, read_segment, verify_segment_crc
from pinot_tpu_torch.segment.readers import MV_DELIMITER, read_csv, read_for_path, read_jsonl
from pinot_tpu_torch.startree import StarTreeBuilderConfig
from pinot_tpu_torch.tools import admin
from pinot_tpu_torch.tools.datagen import baseball_rows

MV_SCHEMA = make_test_schema()
TABLES = {
    "baseball": (baseball_schema(), lambda: baseball_rows(1500, seed=12), "baseballStats"),
    "mvtest": (MV_SCHEMA, lambda: random_rows(MV_SCHEMA, 600, seed=3, cardinality=15), "testTable"),
}


def _assert_segments_equal(got, want):
    assert got.num_docs == want.num_docs and sorted(got.columns) == sorted(want.columns)
    for name, wc in want.columns.items():
        gc = got.column(name)
        assert list(gc.dictionary.values) == list(wc.dictionary.values), name
        for arr in ("fwd", "mv_values", "mv_offsets"):
            a, b = getattr(gc, arr), getattr(wc, arr)
            assert (a is None) == (b is None), (name, arr)
            if b is not None:
                assert a.dtype == b.dtype, (name, arr)
                np.testing.assert_array_equal(a, b)
        assert gc.metadata.to_json() == wc.metadata.to_json(), name
    gm, wm = got.metadata.to_json(), want.metadata.to_json()
    gm.pop("creationTimeMs")
    wm.pop("creationTimeMs")
    assert gm == wm
    assert got.compute_crc() == got.metadata.crc == want.metadata.crc


@pytest.mark.parametrize("table", sorted(TABLES))
def test_a_segment_built_from_the_same_rows_equals_the_reference(table):
    ref_schema, rows_fn, name = TABLES[table]
    rows = rows_fn()
    want = ref_build_segment(ref_schema, rows, name, f"{table}_0")
    got = build_segment(Schema.from_json(ref_schema.to_json()), rows, name, f"{table}_0")
    _assert_segments_equal(got, want)
    assert got.metadata.custom == want.metadata.custom == {"dataCrc": True}
    verify_segment_crc(got)


def test_the_builder_builds_the_reference_star_tree():
    ref_schema, rows_fn, name = TABLES["baseball"]
    rows = rows_fn()
    want = ref_build_segment(ref_schema, rows, name, "st0", startree_config=RefConfig(max_leaf_records=40))
    got = build_segment(Schema.from_json(ref_schema.to_json()), rows, name, "st0",
                        startree_config=StarTreeBuilderConfig(max_leaf_records=40))
    _assert_segments_equal(got, want)
    for arr in ("dims", "sums", "counts"):
        np.testing.assert_array_equal(getattr(got.star_tree, arr), getattr(want.star_tree, arr))
    assert got.star_tree.root.to_json() == want.star_tree.root.to_json()
    assert got.metadata.custom["starTree"] == want.metadata.custom["starTree"]


def test_generator_config_keeps_the_reference_fields():
    cfg = SegmentGeneratorConfig(table_name="t")
    assert (cfg.segment_name, cfg.startree_config, tuple(cfg.hll_columns), cfg.hll_suffix) == \
        (None, None, (), "_hll")
    seg = build_segment(Schema.from_json(baseball_schema().to_json()), baseball_rows(10, seed=1), "t")
    assert seg.segment_name.startswith("t_10_")


def _write_csv(path, schema, rows):
    names = [s.name for s in schema.all_fields()]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=names)
        w.writeheader()
        for r in rows:
            w.writerow({k: MV_DELIMITER.join(str(x) for x in v) if isinstance(v, list) else v
                        for k, v in r.items()})


def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


@pytest.mark.parametrize("table", sorted(TABLES))
def test_readers_give_the_reference_rows(table, tmp_path):
    ref_schema, rows_fn, _ = TABLES[table]
    rows = rows_fn()[:200]
    rows[3] = {k: v for k, v in rows[3].items() if k not in ("runs", "metInt", "dimStrMV")}  # missing fields
    schema = Schema.from_json(ref_schema.to_json())
    _write_csv(tmp_path / "rows.csv", ref_schema, rows)
    _write_jsonl(tmp_path / "rows.jsonl", rows)
    assert read_csv(str(tmp_path / "rows.csv"), schema) == ref_read_csv(str(tmp_path / "rows.csv"), ref_schema)
    assert read_jsonl(str(tmp_path / "rows.jsonl"), schema) == \
        ref_read_jsonl(str(tmp_path / "rows.jsonl"), ref_schema)
    assert read_for_path(str(tmp_path / "rows.jsonl"), schema) == read_jsonl(str(tmp_path / "rows.jsonl"), schema)
    with pytest.raises(NotImplementedError, match="item 31"):
        read_for_path(str(tmp_path / "rows.avro"), schema)


@pytest.mark.parametrize("fmt", ["csv", "jsonl"])
def test_create_segment_startree_and_show_segment(fmt, tmp_path, capsys):
    ref_schema = baseball_schema()
    rows = baseball_rows(1200, seed=21)
    data = str(tmp_path / f"rows.{fmt}")
    if fmt == "csv":
        _write_csv(data, ref_schema, rows)
    else:
        _write_jsonl(data, rows)
    schema_file = tmp_path / "schema.json"
    schema_file.write_text(json.dumps(ref_schema.to_json()))
    out = str(tmp_path / "out")
    admin.main(["CreateSegment", "-schema-file", str(schema_file), "-data-file", data,
                "-table", "baseballStats", "-segment-name", "bb_cli", "-out-dir", out, "-startree"])
    assert "built segment bb_cli: 1200 docs" in capsys.readouterr().out
    got = read_segment(out)
    reader = ref_read_csv if fmt == "csv" else ref_read_jsonl
    want = ref_build_segment(ref_schema, reader(data, ref_schema), "baseballStats", "bb_cli",
                             startree_config=RefConfig())
    _assert_segments_equal(got, want)
    for arr in ("dims", "sums", "counts"):
        np.testing.assert_array_equal(getattr(got.star_tree, arr), getattr(want.star_tree, arr))
    assert got.star_tree.root.to_json() == want.star_tree.root.to_json()
    verify_segment_crc(got)
    # the reference reads the port's file
    ref_got = ref_read(os.path.join(out, SEGMENT_FILE_NAME))
    np.testing.assert_array_equal(ref_got.star_tree.dims, want.star_tree.dims)

    admin.main(["ShowSegment", "-segment-dir", out])
    shown = json.loads(capsys.readouterr().out)
    assert shown == got.metadata.to_json()
    assert shown["custom"]["starTree"]["numRecords"] == got.star_tree.num_records
    if fmt == "jsonl":
        # the reference's own CreateSegment (its row path for JSONL) builds the same columns
        ref_out = str(tmp_path / "ref_out")
        ref_admin.main(["CreateSegment", "-schema-file", str(schema_file), "-data-file", data,
                        "-table", "baseballStats", "-segment-name", "bb_cli", "-out-dir", ref_out,
                        "-startree"])
        capsys.readouterr()
        _assert_segments_equal(got, ref_read(ref_out))
