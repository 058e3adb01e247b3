"""The port's columnar build path (``segment/columnar.py``) and its native
CSV parser (``segment/native.py``, ``csrc/csvread.cpp``) against the JAX
package's, on the same files.

A segment the port builds from a CSV file through the columnar path
equals the reference's columnar build of the same file and the port's
row build of the rows read from it: the same dictionaries, forward
indexes (SV and CSR), column metadata and data CRC.  The creation time
is each build's wall clock and is not compared.  The reference's edge
cases of ``tests/test_native.py`` are one parametrised test: missing
cells, blank lines, quoted cells, NaN, integer overflow, extra columns
and a lone CR.  A failed build of the parser raises and names the
compiler's output.
"""
import json
import os

import numpy as np
import pytest

from pinot_tpu.segment.columnar import build_segment_from_columns as ref_build_from_columns
from pinot_tpu.segment.columnar import build_segment_from_csv as ref_build_from_csv
from pinot_tpu.segment.columnar import read_csv_columnar as ref_read_csv_columnar
from pinot_tpu.tools import admin as ref_admin
from pinot_tpu.tools.datagen import baseball_schema, make_test_schema, random_rows

from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.segment import native
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.segment.columnar import build_segment_from_columns, build_segment_from_csv, read_csv_columnar
from pinot_tpu_torch.segment.format import read_segment
from pinot_tpu_torch.segment.readers import MV_DELIMITER, read_csv
from pinot_tpu_torch.tools import admin
from pinot_tpu_torch.tools.datagen import baseball_rows, lineitem_schema, synthetic_lineitem_segment

MV_SCHEMA = make_test_schema()
SV_SCHEMA = make_test_schema(with_mv=False)


def _port(schema):
    return Schema.from_json(schema.to_json())


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


def _write_csv(path, schema, rows):
    names = [s.name for s in schema.all_fields()]
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for row in rows:
            f.write(",".join(MV_DELIMITER.join(str(x) for x in row[n]) if isinstance(row[n], list)
                             else str(row[n]) for n in names) + "\n")


TABLES = {
    "baseball": (baseball_schema(), lambda: baseball_rows(900, seed=5)),
    "mvtest": (MV_SCHEMA, lambda: random_rows(MV_SCHEMA, 500, seed=13)),
}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_csv_build_equals_the_reference_and_the_row_build(table, tmp_path):
    ref_schema, rows_fn = TABLES[table]
    schema = _port(ref_schema)
    path = str(tmp_path / "data.csv")
    _write_csv(path, ref_schema, rows_fn())
    cols, n = read_csv_columnar(path, schema)
    assert cols is not None and n == len(rows_fn()), "the native parse takes a plain CSV"
    got = build_segment_from_csv(schema, path, "t", "seg")
    _assert_segments_equal(got, ref_build_from_csv(ref_schema, path, "t", "seg"))
    _assert_segments_equal(got, build_segment(schema, read_csv(path, schema), "t", "seg"))


def test_build_from_columns_equals_the_reference_on_lineitem_arrays():
    """lineitem's nine columns as typed arrays (object strings, int and
    float numbers): the port's and the reference's columnar builds are
    bit-identical, and decode to the arrays they were built from."""
    src = synthetic_lineitem_segment(3000, seed=4, name="li")
    arrays = {name: np.asarray(col.dictionary.values, dtype=object if col.dictionary.is_string else None)[col.fwd]
              for name, col in src.columns.items()}
    from pinot_tpu.tools.datagen import lineitem_schema as ref_lineitem_schema

    got = build_segment_from_columns(lineitem_schema(), arrays, 3000, "lineitem", "li")
    want = ref_build_from_columns(ref_lineitem_schema(), arrays, 3000, "lineitem", "li")
    _assert_segments_equal(got, want)
    for name, values in arrays.items():  # the same values back, in row order
        col = got.column(name)
        assert list(np.asarray(col.dictionary.values, dtype=object)[col.fwd]) == list(values), name


def _names(schema):
    return ",".join(s.name for s in schema.all_fields())


# the reference's edge cases (tests/test_native.py): (file bytes, whether
# the native parse takes the file, whether the build raises OverflowError)
EDGE_CASES = {
    "missing_cells_and_blank_lines": (
        f"{_names(SV_SCHEMA)}\nalpha,1,2,3.5,4.5,100\n\nbeta,7\ngamma,,,,,200\n", True, False),
    "quoted": (f'{_names(SV_SCHEMA)}\n"hello, world",1,2,3.5,4.5,100\n', False, False),
    "nan": (f"{_names(SV_SCHEMA)}\na,1,2,3,nan,nan,100\nb,3,4,5,1.5,2.5,200\n", True, False),
    "int_overflow": (f"{_names(SV_SCHEMA)}\na,3000000000,2,1.0,1.0,100\n", True, True),
    "extra_columns": (f"junk1,{_names(SV_SCHEMA)},junk2\nx,a,1,2,3,1.5,2.5,100,y\nx,b,4,5,6,3.5,4.5,200,y\n",
                      True, False),
    "lone_cr": (f"{_names(SV_SCHEMA)}\na\rb,1,2,3,1.0,1.0,100\n", False, False),
    "crlf": (f"{_names(SV_SCHEMA)}\r\na,1,2,3,1.0,1.0,100\r\nb,4,5,6,2.0,2.0,200\r\n", True, False),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_csv_edge_cases_equal_the_reference(case, tmp_path):
    text, native_path, overflow = EDGE_CASES[case]
    path = str(tmp_path / f"{case}.csv")
    with open(path, "wb") as f:
        f.write(text.encode())
    schema = _port(SV_SCHEMA)
    if overflow:
        # out-of-range INT cells raise on both packages, no wraparound
        with pytest.raises(OverflowError):
            ref_build_from_csv(SV_SCHEMA, path, "t", "e")
        with pytest.raises(OverflowError):
            build_segment_from_csv(schema, path, "t", "e")
        return
    cols, _ = read_csv_columnar(path, schema)
    ref_cols, _ = ref_read_csv_columnar(path, SV_SCHEMA)
    assert (cols is not None) == (ref_cols is not None) == native_path
    if cols is not None:
        assert sorted(cols) == sorted(ref_cols)
        for name in cols:
            assert cols[name].dtype == ref_cols[name].dtype, name
            assert list(cols[name]) == list(ref_cols[name]), name
    got = build_segment_from_csv(schema, path, "t", "e")
    _assert_segments_equal(got, ref_build_from_csv(SV_SCHEMA, path, "t", "e"))
    _assert_segments_equal(got, build_segment(schema, read_csv(path, schema), "t", "e"))
    if case == "quoted":
        assert got.column("dimStr").dictionary.values[0] == "hello, world"


def test_a_failed_parser_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No quiet switch to the row path: a source that does not compile
    raises, naming g++'s output, and leaves no library behind."""
    bad = tmp_path / "csvread.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build()
    assert "error" in str(err.value)
    assert not any((tmp_path / "build").glob("*.so"))


def test_the_parser_builds_into_build_and_parses():
    lib = native.library_path()
    assert lib.parent.name == "build" and lib.name.startswith("libcsvread-")
    assert native.csv_available() and lib.exists()
    body = b"a,b\n1,x\n-2,yy\n"
    n, i64, _, offs = native.csv_parse(body, 4, ",", [0, 2], [0, 0], [0.0, 0.0])
    assert n == 2 and list(i64[0]) == [1, -2] and list(offs[1]) == [6, 1, 11, 2]


def test_create_segment_csv_takes_the_columnar_path_as_the_reference(tmp_path, capsys):
    rows = random_rows(MV_SCHEMA, 400, seed=8)
    data = str(tmp_path / "rows.csv")
    _write_csv(data, MV_SCHEMA, rows)
    schema_file = tmp_path / "schema.json"
    schema_file.write_text(json.dumps(MV_SCHEMA.to_json()))
    outs = {}
    for label, mod in (("port", admin), ("ref", ref_admin)):
        out_dir = str(tmp_path / label)
        mod.main(["CreateSegment", "-schema-file", str(schema_file), "-data-file", data, "-table", "testTable",
                  "-segment-name", "s0", "-out-dir", out_dir])
        outs[label] = out_dir
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("built segment s0: 400 docs -> ")
    assert [p.split(" -> ")[0] for p in printed] == ["built segment s0: 400 docs"] * 2
    from pinot_tpu.segment.format import read_segment as ref_read

    _assert_segments_equal(read_segment(outs["port"]), ref_read(outs["ref"]))
    assert os.path.exists(outs["port"])
