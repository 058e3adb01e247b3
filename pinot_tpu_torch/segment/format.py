"""On-disk segment format: one file with an index map (port of
``pinot_tpu.segment.format``; it reads and writes the reference's bytes).

    [0:8]    magic  b"PNTPUSEG"
    [8:16]   uint64 little-endian header JSON length H
    [16:16+H] header JSON: segment metadata, index map (per buffer:
              offset, length, codec, dtype, count), zone block
    [16+H:]  concatenated buffers

Buffer codecs:
  raw      — dtype bytes as-is
  bitpack  — fixed-bit packed dictIds (``bitpack.py``)
  strings  — utf-8, '\\x00'-separated sorted dictionary entries

Per SV column longer than one zone block the file holds its per-block
dictId min / max (``<column>.zmin`` / ``.zmax``, int32); ``read_segment``
preloads them into the segment's zone cache (``engine/zonemap.py``).
A segment with a star-tree (``startree/index.py``) adds its cube as raw
buffers ``__startree__.dims`` / ``.sums`` / ``.counts`` / ``.hll.<col>``
and the header a ``starTree`` object (split order, metric and HLL
columns, leaf cap, record count, the node tree as JSON).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np

from pinot_tpu_torch.engine.zonemap import column_zones, zone_block_rows
from pinot_tpu_torch.segment.bitpack import bits_required, pack_bits, unpack_bits
from pinot_tpu_torch.segment.convert import star_tree_from_arrays
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.immutable import ColumnData, ImmutableSegment, SegmentMetadata

MAGIC = b"PNTPUSEG"

SEGMENT_FILE_NAME = "columns.pnt"  # analog of v3's columns.psf


class SegmentIntegrityError(RuntimeError):
    """A segment's bytes do not match their metadata CRC claim: a corrupt
    download or a bit-rotted disk copy.  Loaders quarantine the copy and
    never serve it."""


class SegmentStaleError(SegmentIntegrityError):
    """An internally consistent copy whose CRC is another version than
    the one asked for (replication lag): not corruption, no quarantine."""


def verify_segment_crc(segment: ImmutableSegment, source: str = "") -> None:
    """Recompute the column-data CRC and compare it with the metadata
    claim.  Only a claim marked verifiable (``custom["dataCrc"]``) is
    held; a synthetic segment's crc is an identity token and passes."""
    claimed = segment.metadata.crc
    if not claimed or not segment.metadata.custom.get("dataCrc"):
        return
    actual = segment.compute_crc()
    if actual != claimed:
        where = f" ({source})" if source else ""
        raise SegmentIntegrityError(
            f"segment {segment.segment_name!r}{where}: computed CRC {actual} != "
            f"metadata CRC {claimed} — corrupt copy"
        )


def write_segment(segment: ImmutableSegment, directory: str) -> str:
    """Write a segment directory: one data file, index map inside."""
    os.makedirs(directory, exist_ok=True)
    buffers: List[bytes] = []
    index_map: Dict[str, Dict[str, Any]] = {}
    offset = 0

    def add(key: str, data: bytes, codec: str, **extra: Any) -> None:
        nonlocal offset
        index_map[key] = {"offset": offset, "length": len(data), "codec": codec, **extra}
        buffers.append(data)
        offset += len(data)

    for name, col in segment.columns.items():
        d = col.dictionary
        if d.is_string:
            add(f"{name}.dict", "\x00".join(d.values).encode("utf-8"), "strings", count=len(d))
        else:
            arr = np.ascontiguousarray(d.values)
            add(f"{name}.dict", arr.tobytes(), "raw", dtype=str(arr.dtype), count=len(d))
        nbits = bits_required(max(d.cardinality, 1))
        if col.fwd is not None:
            add(f"{name}.fwd", pack_bits(col.fwd, nbits).tobytes(), "bitpack",
                nbits=nbits, count=int(col.fwd.size))
        if col.mv_values is not None:
            add(f"{name}.mv", pack_bits(col.mv_values, nbits).tobytes(), "bitpack",
                nbits=nbits, count=int(col.mv_values.size))
            off = np.ascontiguousarray(col.mv_offsets, dtype=np.int32)
            add(f"{name}.mvoff", off.tobytes(), "raw", dtype="int32", count=int(off.size))

    # zone maps: per-block dictId min / max per SV column, persisted so
    # selective queries prune blocks without a first-query scan
    zblock = zone_block_rows()
    for name, col in segment.columns.items():
        if col.fwd is None or col.fwd.size <= zblock:
            continue
        z = column_zones(segment, name, zblock)
        if z is None:
            continue
        zmin, zmax = (a.astype(np.int32) for a in z)
        add(f"{name}.zmin", zmin.tobytes(), "raw", dtype="int32", count=int(zmin.size))
        add(f"{name}.zmax", zmax.tobytes(), "raw", dtype="int32", count=int(zmax.size))

    header = {"metadata": segment.metadata.to_json(), "indexMap": index_map, "zoneBlock": zblock}
    star_tree = getattr(segment, "star_tree", None)
    if star_tree is not None:
        cube = {"dims": star_tree.dims, "sums": star_tree.sums, "counts": star_tree.counts}
        cube.update({f"hll.{c}": r for c, r in star_tree.hll_registers.items()})
        for key, arr in cube.items():
            arr = np.ascontiguousarray(arr)
            add(f"__startree__.{key}", arr.tobytes(), "raw", dtype=str(arr.dtype), count=int(arr.size))
        header["starTree"] = {
            "splitOrder": star_tree.split_order,
            "metricColumns": star_tree.metric_columns,
            "maxLeafRecords": star_tree.max_leaf_records,
            "numRecords": star_tree.num_records,
            "hllColumns": list(star_tree.hll_columns),
            "root": star_tree.root.to_json(),
        }
    hdr = json.dumps(header).encode("utf-8")
    path = os.path.join(directory, SEGMENT_FILE_NAME)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(hdr).to_bytes(8, "little"))
        f.write(hdr)
        for b in buffers:
            f.write(b)
    return path


def _decode(entry: Dict[str, Any], blob: bytes) -> Any:
    codec = entry["codec"]
    if codec == "raw":
        return np.frombuffer(blob, dtype=np.dtype(entry["dtype"]), count=entry["count"]).copy()
    if codec == "bitpack":
        return unpack_bits(np.frombuffer(blob, dtype=np.uint8), entry["nbits"], entry["count"])
    if codec == "strings":
        if entry["count"] == 0:
            return []
        return blob.decode("utf-8").split("\x00")
    raise ValueError(f"unknown codec {codec}")


def _read_header(data: bytes, path: str) -> Dict[str, Any]:
    if data[:8] != MAGIC:
        raise ValueError(f"{path}: not a pinot_tpu segment file")
    hlen = int.from_bytes(data[8:16], "little")
    return json.loads(data[16 : 16 + hlen].decode("utf-8"))


def read_segment_metadata(data: bytes, path: str = "<bytes>") -> SegmentMetadata:
    """A segment file's metadata from its header alone (the controller's
    upload path needs no column)."""
    return SegmentMetadata.from_json(_read_header(data, path)["metadata"])


def read_segment(directory: str) -> ImmutableSegment:
    """Read a segment file (or the directory that holds it)."""
    path = os.path.join(directory, SEGMENT_FILE_NAME) if os.path.isdir(directory) else directory
    with open(path, "rb") as f:
        data = f.read()
    header = _read_header(data, path)
    base = 16 + int.from_bytes(data[8:16], "little")
    index_map = header["indexMap"]
    metadata = SegmentMetadata.from_json(header["metadata"])

    def load(key: str) -> Any:
        e = index_map[key]
        return _decode(e, data[base + e["offset"] : base + e["offset"] + e["length"]])

    columns: Dict[str, ColumnData] = {}
    for name, cmeta in metadata.columns.items():
        col = ColumnData(metadata=cmeta, dictionary=Dictionary(cmeta.data_type.stored_type, load(f"{name}.dict")))
        if f"{name}.fwd" in index_map:
            col.fwd = load(f"{name}.fwd")
        if f"{name}.mv" in index_map:
            col.mv_values = load(f"{name}.mv")
            col.mv_offsets = load(f"{name}.mvoff")
        columns[name] = col
    segment = ImmutableSegment(metadata=metadata, columns=columns)

    zblock = header.get("zoneBlock")
    if zblock:
        cache = {
            (name, int(zblock)): (load(f"{name}.zmin").astype(np.int64), load(f"{name}.zmax").astype(np.int64))
            for name in metadata.columns
            if f"{name}.zmin" in index_map
        }
        if cache:
            object.__setattr__(segment, "_zone_cache", cache)

    st = header.get("starTree")
    if st is not None:
        n_rec = st["numRecords"]
        hll_cols = list(st.get("hllColumns", []))
        segment.star_tree = star_tree_from_arrays({
            "split_order": st["splitOrder"],
            "metric_columns": st["metricColumns"],
            "dims": load("__startree__.dims").reshape(n_rec, len(st["splitOrder"])),
            "sums": load("__startree__.sums").reshape(n_rec, len(st["metricColumns"])),
            "counts": load("__startree__.counts"),
            "root": st["root"],
            "max_leaf_records": st["maxLeafRecords"],
            "hll_columns": hll_cols,
            "hll_registers": {c: load(f"__startree__.hll.{c}").reshape(n_rec, -1) for c in hll_cols},
        })
    return segment
