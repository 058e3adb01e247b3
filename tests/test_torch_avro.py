"""The port's Avro Object Container codec (``segment/avro.py``) against the
JAX package's.

Round trips with both codecs and a ``.gz``-wrapped file, named types
(records, enums, fixed), unions, arrays and maps; each package reads the
other's file; the Pinot schema derived from a file equals the
reference's; a segment built from Avro rows equals the reference's (CRC
included) and answers as the reference's does; and the segment -> Avro
export decodes to the reference's rows.  The sync marker is random in
both writers, so files are compared by their decoded records, never by
their bytes.
"""
import gzip

import numpy as np
import pytest

from pinot_tpu.common.schema import Schema as RefSchema
from pinot_tpu.engine.executor import QueryExecutor as RefExecutor
from pinot_tpu.pql import optimize_request as ref_optimize
from pinot_tpu.pql import parse_pql as ref_parse
from pinot_tpu.segment import avro as ref_avro
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.tools.converters import segment_to_avro as ref_segment_to_avro
from pinot_tpu.utils.audit import canonical_payload, payloads_equivalent, strip_accounting

from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType, Schema
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.segment import avro
from pinot_tpu_torch.segment.builder import build_segment
from pinot_tpu_torch.segment.readers import read_for_path
from pinot_tpu_torch.tools.converters import segment_to_avro

AVRO_SCHEMA = {
    "type": "record",
    "name": "LineItem",
    "fields": [
        {"name": "flag", "type": "string"},
        {"name": "qty", "type": "int"},
        {"name": "price", "type": ["null", "double"]},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "big", "type": "long"},
        {"name": "ratio", "type": "float"},
        {"name": "ok", "type": "boolean"},
        {"name": "mode", "type": {"type": "enum", "name": "Mode", "symbols": ["AIR", "RAIL", "SHIP"]}},
        {"name": "mode2", "type": ["null", "Mode"]},
        {"name": "key", "type": {"type": "fixed", "name": "Key", "size": 4}},
        {"name": "attrs", "type": {"type": "map", "values": "long"}},
        {"name": "addr", "type": ["null", {"type": "record", "name": "Addr",
                                           "fields": [{"name": "city", "type": "string"}]}]},
        {"name": "qtys", "type": {"type": "array", "items": "int"}},
    ],
}


def _records(n: int, seed: int):
    rng = np.random.default_rng(seed)
    modes = ["AIR", "RAIL", "SHIP"]
    out = []
    for i in range(n):
        out.append({
            "flag": "RNA"[int(rng.integers(3))],
            "qty": int(rng.integers(-50, 50)),
            "price": None if rng.random() < 0.2 else round(float(rng.uniform(0, 1000)), 2),
            "tags": [f"t{int(t)}" for t in rng.integers(0, 5, size=int(rng.integers(0, 3)))],
            "big": int(rng.integers(-(1 << 40), 1 << 40)),
            "ratio": float(np.float32(rng.uniform(-2, 2))),
            "ok": bool(rng.random() < 0.5),
            "mode": modes[int(rng.integers(3))],
            "mode2": None if i % 3 == 0 else modes[i % 3],
            "key": bytes(rng.integers(0, 256, size=4, dtype=np.uint8)),
            "attrs": {f"k{j}": int(rng.integers(0, 99)) for j in range(int(rng.integers(0, 3)))},
            "addr": None if i % 4 == 0 else {"city": f"c{i % 5}"},
            "qtys": [int(q) for q in rng.integers(1, 9, size=int(rng.integers(1, 4)))],
        })
    return out


RECORDS = _records(300, seed=3)


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_round_trip_and_cross_reads(codec, tmp_path):
    mine, theirs = str(tmp_path / "port.avro"), str(tmp_path / "ref.avro")
    avro.write_avro(mine, AVRO_SCHEMA, RECORDS, codec=codec, records_per_block=64)
    ref_avro.write_avro(theirs, AVRO_SCHEMA, RECORDS, codec=codec, records_per_block=64)
    for path in (mine, theirs):
        reader = avro.AvroContainerReader(path)
        assert reader.codec == codec and reader.schema == AVRO_SCHEMA
        assert list(reader) == RECORDS
        assert list(reader) == RECORDS  # re-iterable
        assert list(ref_avro.AvroContainerReader(path)) == RECORDS


def test_gzip_wrapped_container(tmp_path):
    plain = str(tmp_path / "d.avro")
    avro.write_avro(plain, AVRO_SCHEMA, RECORDS[:40], codec="deflate")
    gz = str(tmp_path / "d.avro.gz")
    with open(plain, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    assert list(avro.AvroContainerReader(gz)) == list(ref_avro.AvroContainerReader(gz)) == RECORDS[:40]


def test_unsupported_codec_and_bad_magic_raise(tmp_path):
    with pytest.raises(ValueError, match="codec"):
        avro.write_avro(str(tmp_path / "x.avro"), AVRO_SCHEMA, [], codec="snappy")
    bad = tmp_path / "bad.avro"
    bad.write_bytes(b"NOPE")
    with pytest.raises(ValueError, match="not an Avro"):
        avro.AvroContainerReader(str(bad))


@pytest.mark.parametrize("metrics,time_field", [((), None), (("qty", "price"), None), (("qty",), "big")])
def test_derived_schema_equals_the_reference(metrics, time_field, tmp_path):
    path = str(tmp_path / "d.avro")
    avro.write_avro(path, AVRO_SCHEMA, RECORDS[:5])
    got = avro.avro_to_pinot_schema(path, "lineitem", metrics=metrics, time_field=time_field)
    want = ref_avro.avro_to_pinot_schema(path, "lineitem", metrics=metrics, time_field=time_field)
    assert got.to_json() == want.to_json()
    assert avro.pinot_to_avro_schema(got) == ref_avro.pinot_to_avro_schema(want)
    f = {s.name: s for s in got.all_fields()}
    assert f["tags"].data_type == DataType.STRING_ARRAY and not f["tags"].single_value
    assert f["price"].data_type == DataType.DOUBLE  # the union [null, double]


QUERIES = (
    "SELECT sum(qty), count(*) FROM lineitem GROUP BY flag TOP 10",
    "SELECT sum(price) FROM lineitem WHERE mode = 'AIR'",
    "SELECT count(*) FROM lineitem GROUP BY tags TOP 10",
    "SELECT distinctcount(key) FROM lineitem",
)


def test_an_avro_built_segment_equals_the_reference_and_answers_alike(tmp_path):
    path = str(tmp_path / "d.avro")
    avro.write_avro(path, AVRO_SCHEMA, RECORDS, codec="deflate")
    schema = avro.avro_to_pinot_schema(path, "lineitem", metrics=("qty", "price"))
    ref_schema = RefSchema.from_json(schema.to_json())
    rows = read_for_path(path, schema)
    assert rows == ref_avro.read_avro(path, ref_schema)
    seg = build_segment(schema, rows, "lineitem", "avroseg")
    want = ref_build_segment(ref_schema, ref_avro.read_avro(path, ref_schema), "lineitem", "avroseg")
    assert seg.compute_crc() == seg.metadata.crc == want.metadata.crc
    for name, wc in want.columns.items():
        assert list(seg.column(name).dictionary.values) == list(wc.dictionary.values), name
    for pql in QUERIES:
        req = optimize_request(parse_pql(pql))
        got = strip_accounting(reduce_to_response(req, [QueryExecutor(device="cpu").execute([seg], req)]).to_json())
        ref_req = ref_optimize(ref_parse(pql))
        want_payload = canonical_payload(ref_req, RefExecutor().execute([want], ref_req))
        assert payloads_equivalent(got, want_payload), (pql, got, want_payload)


def test_segment_to_avro_export_equals_the_reference(tmp_path):
    schema = Schema(
        "t",
        dimensions=[FieldSpec("d", DataType.STRING), FieldSpec("mv", DataType.INT_ARRAY, single_value=False)],
        metrics=[FieldSpec("m", DataType.DOUBLE, FieldType.METRIC), FieldSpec("f", DataType.FLOAT, FieldType.METRIC)],
    )
    rng = np.random.default_rng(9)
    rows = [{"d": f"v{int(rng.integers(5))}", "mv": [int(x) for x in rng.integers(0, 9, size=2)],
             "m": float(rng.normal()), "f": float(np.float32(rng.normal()))} for _ in range(50)]
    seg = build_segment(schema, rows, "t", "s0")
    ref_seg = ref_build_segment(RefSchema.from_json(schema.to_json()), rows, "t", "s0")
    mine, theirs = str(tmp_path / "port.avro"), str(tmp_path / "ref.avro")
    assert segment_to_avro(seg, mine) == ref_segment_to_avro(ref_seg, theirs) == 50
    assert avro.AvroContainerReader(mine).schema == ref_avro.AvroContainerReader(theirs).schema
    assert list(ref_avro.AvroContainerReader(mine)) == list(avro.AvroContainerReader(theirs))


def test_bytes_decode_to_their_content(tmp_path):
    schema_avro = {"type": "record", "name": "B",
                   "fields": [{"name": "raw", "type": "bytes"}, {"name": "k", "type": "string"}]}
    path = str(tmp_path / "b.avro")
    avro.write_avro(path, schema_avro, [{"raw": b"abc", "k": "x"}])
    schema = Schema("b", dimensions=[FieldSpec("raw", DataType.STRING), FieldSpec("k", DataType.STRING)])
    assert avro.read_avro(path, schema) == ref_avro.read_avro(path, RefSchema.from_json(schema.to_json())) == \
        [{"raw": "abc", "k": "x"}]
