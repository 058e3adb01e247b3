"""The port's segment files (``segment/format.py``, ``segment/bitpack.py``,
the zone maps of ``engine/zonemap.py``) against the JAX package's: the
port writes the reference's bytes, each package reads the other's file
to equal columns and zones, a flipped byte fails the CRC check in both,
zones re-blocked from a file's persisted ones equal the reference's, and a
star-tree segment's cube buffers round-trip beside its zones.

Segments: a seeded synthetic lineitem segment from each package's
``datagen`` (the same numpy draws), and a ``make_test_schema()`` segment
with its two multi-value columns, built by the reference's builder (which
stamps a verifiable column-data CRC) and carried to the port with
``segment/convert.py``.  Zone blocks: the default 65,536 rows, and 1,024
for the small segments.  Everything compares exactly.
"""
import json
import os

import numpy as np
import pytest

from pinot_tpu.engine import zonemap as ref_zonemap
from pinot_tpu.segment.bitpack import pack_bits as ref_pack_bits
from pinot_tpu.segment.bitpack import unpack_bits as ref_unpack_bits
from pinot_tpu.segment.builder import build_segment as ref_build_segment
from pinot_tpu.segment.format import SegmentIntegrityError as RefIntegrityError
from pinot_tpu.segment.format import read_segment as ref_read
from pinot_tpu.segment.format import verify_segment_crc as ref_verify
from pinot_tpu.segment.format import write_segment as ref_write
from pinot_tpu.startree import StarTreeBuilderConfig as RefStarTreeConfig
from pinot_tpu.startree import build_star_tree as ref_build_star_tree
from pinot_tpu.tools.datagen import lineitem_schema as ref_lineitem_schema
from pinot_tpu.tools.datagen import make_test_schema, random_rows
from pinot_tpu.tools.datagen import synthetic_lineitem_segment as ref_synthetic

from pinot_tpu_torch.engine import config, zonemap
from pinot_tpu_torch.segment.bitpack import pack_bits, unpack_bits
from pinot_tpu_torch.segment.convert import segment_arrays_of, segment_from_arrays
from pinot_tpu_torch.segment.format import SEGMENT_FILE_NAME, SegmentIntegrityError
from pinot_tpu_torch.segment.format import read_segment, read_segment_metadata, verify_segment_crc, write_segment
from pinot_tpu_torch.startree import StarTreeBuilderConfig, build_star_tree
from pinot_tpu_torch.tools.datagen import lineitem_schema, synthetic_lineitem_segment

SMALL_BLOCK = 1024


def _lineitem(rows, seed):
    return ref_synthetic(rows, seed=seed, name="li_fmt"), synthetic_lineitem_segment(rows, seed=seed, name="li_fmt")


def _mvtest():
    ref = ref_build_segment(make_test_schema(), random_rows(make_test_schema(), 3000, seed=5, cardinality=40),
                            "testTable", "mv_fmt")
    return ref, segment_from_arrays(**segment_arrays_of(ref))


CASES = {
    "lineitem_default_block": (lambda: _lineitem(140_000, 3), None),
    "lineitem_small_block": (lambda: _lineitem(6000, 4), SMALL_BLOCK),
    "mvtest_small_block": (_mvtest, SMALL_BLOCK),
}


@pytest.fixture
def zone_block(monkeypatch):
    def set_block(block):
        if block is not None:
            monkeypatch.setenv("PINOT_TPU_ZONE_BLOCK", str(block))
            monkeypatch.setattr(config, "ZONE_BLOCK", block)
    return set_block


def _file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_writes_the_reference_bytes(case, zone_block, tmp_path):
    make, block = CASES[case]
    zone_block(block)
    ref, port = make()
    want = _file_bytes(ref_write(ref, str(tmp_path / "ref")))
    got = _file_bytes(write_segment(port, str(tmp_path / "port")))
    assert got == want
    header = json.loads(got[16 : 16 + int.from_bytes(got[8:16], "little")])
    assert header["zoneBlock"] == (block or 65536)
    assert any(k.endswith(".zmin") for k in header["indexMap"])  # zones persisted


def _columns_equal(a, b):
    assert a.metadata.to_json() == b.metadata.to_json()
    assert sorted(a.columns) == sorted(b.columns)
    for name in a.columns:
        ca, cb = a.columns[name], b.columns[name]
        assert list(ca.dictionary.values) == list(cb.dictionary.values), name
        for attr in ("fwd", "mv_values", "mv_offsets"):
            x, y = getattr(ca, attr), getattr(cb, attr)
            assert (x is None) == (y is None), (name, attr)
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f"{name}.{attr}")


def _zones_equal(a, b):
    za, zb = a._zone_cache, b._zone_cache
    assert sorted(za) == sorted(zb)
    for key in za:
        np.testing.assert_array_equal(za[key][0], zb[key][0], err_msg=str(key))
        np.testing.assert_array_equal(za[key][1], zb[key][1], err_msg=str(key))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_reads_the_others_file(case, writer, zone_block, tmp_path):
    make, block = CASES[case]
    zone_block(block)
    ref, port = make()
    d = str(tmp_path / "seg")
    if writer == "reference":
        ref_write(ref, d)
    else:
        write_segment(port, d)
    from_ref, from_port = ref_read(d), read_segment(d)
    _columns_equal(from_ref, from_port)
    _columns_equal(from_port, ref)
    _zones_equal(from_ref, from_port)
    assert read_segment_metadata(_file_bytes(os.path.join(d, SEGMENT_FILE_NAME))).to_json() == \
        ref.metadata.to_json()


def _flip_fwd_byte(path, column):
    data = bytearray(_file_bytes(path))
    hlen = int.from_bytes(data[8:16], "little")
    entry = json.loads(data[16 : 16 + hlen])["indexMap"][f"{column}.fwd"]
    data[16 + hlen + entry["offset"] + entry["length"] // 2] ^= 0x5A
    with open(path, "wb") as f:
        f.write(bytes(data))


@pytest.mark.parametrize("reader", ["reference", "port"])
def test_a_flipped_byte_fails_the_crc_check(reader, zone_block, tmp_path):
    zone_block(SMALL_BLOCK)
    ref, port = _mvtest()
    assert port.metadata.custom.get("dataCrc") and port.metadata.crc == port.compute_crc()
    d = str(tmp_path / "seg")
    path = write_segment(port, d)
    verify_segment_crc(read_segment(d))  # intact: passes
    ref_verify(ref_read(d))
    _flip_fwd_byte(path, "dimInt")
    if reader == "reference":
        with pytest.raises(RefIntegrityError):
            ref_verify(ref_read(d))
    else:
        with pytest.raises(SegmentIntegrityError):
            verify_segment_crc(read_segment(d))


@pytest.mark.parametrize("coarse", [2 * SMALL_BLOCK, 4 * SMALL_BLOCK, 16 * SMALL_BLOCK])
def test_reblocked_persisted_zones_equal_the_reference(coarse, zone_block, tmp_path):
    zone_block(SMALL_BLOCK)
    ref, _ = _lineitem(6000, 4)
    d = str(tmp_path / "seg")
    ref_write(ref, d)
    from_ref, from_port = ref_read(d), read_segment(d)
    for column in ("l_shipdate", "l_quantity", "l_returnflag"):
        want = ref_zonemap.column_zones(from_ref, column, coarse)
        got = zonemap.column_zones(from_port, column, coarse)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        # derived from the persisted zones, equal to a rescan of the rows
        fresh = zonemap.column_zones(segment_from_arrays(**segment_arrays_of(from_port)), column, coarse)
        np.testing.assert_array_equal(got[0], fresh[0])


@pytest.mark.parametrize("n", [4000, 5000])  # the reference's numpy branch, then its codec
@pytest.mark.parametrize("nbits", [1, 3, 8, 12, 17, 31])
def test_bitpack_writes_the_reference_bytes(nbits, n):
    v = np.random.default_rng(nbits).integers(0, 1 << nbits, n)
    want = ref_pack_bits(v, nbits)
    got = pack_bits(v, nbits)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(unpack_bits(got, nbits, n), v)
    np.testing.assert_array_equal(ref_unpack_bits(got, nbits, n), v)


@pytest.mark.parametrize("nbits,n", [(b, 4099) for b in range(1, 33)] + [(5, (1 << 20) + 3), (27, (1 << 20) + 3)])
def test_bitpack_unpacks_every_width_as_the_reference(nbits, n):
    """Every width, a count that ends mid-byte, and counts past one
    unpacking chunk, with the top bit set at 32 bits."""
    v = np.random.default_rng(nbits).integers(0, 1 << nbits, n, dtype=np.int64)
    v[-1] = (1 << nbits) - 1
    packed = pack_bits(v, nbits)
    got = unpack_bits(packed, nbits, n)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref_unpack_bits(packed, nbits, n))
    np.testing.assert_array_equal(got.astype(np.int64) & ((1 << nbits) - 1), v)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_star_tree_segments_round_trip_with_their_zones(writer, zone_block, tmp_path):
    """A star-tree segment file beside its zone maps: each package's
    tree (built by its own builder) is written as the same bytes and read
    back by the other with an equal cube, node tree and zones."""
    zone_block(SMALL_BLOCK)
    ref, port = _lineitem(6000, 5)
    cfg = dict(split_order=["l_returnflag", "l_linestatus", "l_shipmode"], max_leaf_records=8)
    ref_build_star_tree(ref, ref_lineitem_schema(), RefStarTreeConfig(**cfg))
    build_star_tree(port, lineitem_schema(), StarTreeBuilderConfig(**cfg))
    want = _file_bytes(ref_write(ref, str(tmp_path / "ref")))
    assert _file_bytes(write_segment(port, str(tmp_path / "port"))) == want
    src, read = (ref_write, read_segment) if writer == "reference" else (write_segment, ref_read)
    back = read(src(ref if writer == "reference" else port, str(tmp_path / "x")))
    for arr in ("dims", "sums", "counts"):
        np.testing.assert_array_equal(getattr(back.star_tree, arr), getattr(ref.star_tree, arr))
    assert back.star_tree.root.to_json() == ref.star_tree.root.to_json()
    assert back.metadata.custom["starTree"] == ref.metadata.custom["starTree"]
    assert any(key[0] == "l_shipdate" for key in back._zone_cache)
