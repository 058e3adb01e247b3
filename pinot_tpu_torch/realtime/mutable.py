"""Mutable (consuming) segment: append rows, query at a row watermark
(port of ``pinot_tpu.realtime.mutable``).

The reference's ``RealtimeSegmentImpl.java:62`` keeps mutable
dictionaries (arrival-order ids) and growable forward indexes, and at
commit a converter builds the immutable segment
(``RealtimeSegmentConverter.java``).  Here ingestion appends into
growable host numpy arrays with arrival-order dictIds; a query takes a
snapshot at the current row watermark, converted to a sorted-dictionary
``ImmutableSegment`` (a vectorized O(n) remap) and cached until the
watermark moves.  The snapshot then goes through the normal staging
path, so K1 and K2 never special-case realtime data.  Appends and
snapshots hold one lock, so a snapshot sees whole batches: never a torn
row, never a later row in one column than in another.
"""
from __future__ import annotations

import threading
import time
from operator import itemgetter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.common.schema import DataType, FieldSpec, Schema
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.invindex import release_postings
from pinot_tpu_torch.segment.immutable import (
    ColumnData,
    ColumnMetadata,
    ImmutableSegment,
    SegmentMetadata,
)

Row = Dict[str, Any]


class _MutableColumn:
    """Arrival-order dictionary + growable dictId arrays
    (core/realtime/impl/dictionary + fwdindex analogs)."""

    def __init__(self, spec: FieldSpec) -> None:
        self.spec = spec
        self.value_to_id: Dict[Any, int] = {}
        self.id_to_value: List[Any] = []
        self.single = spec.single_value
        if self.single:
            self.ids = np.zeros(1024, dtype=np.int32)
        else:
            self.flat_ids: List[int] = []
            self.offsets: List[int] = [0]
        self.max_mv = 0
        # numeric SV columns keep a SORTED (values, arrival ids) index
        # so whole batches dictionary-encode with searchsorted — no
        # per-value (or per-unique) Python in the steady state
        self._sorted_vals: Optional[np.ndarray] = None
        self._sorted_ids: Optional[np.ndarray] = None
        # capacity-doubled backing for the append-at-end dictionary
        # growth path (monotone columns): _sorted_vals/_sorted_ids are
        # VIEWS of these while appending, so tail growth is amortized
        # O(new) instead of an O(dict) copy per ingest block
        self._cap_vals: Optional[np.ndarray] = None
        self._cap_ids: Optional[np.ndarray] = None
        self._v2i_stale = False  # value_to_id rebuilt on demand (_id_of)

    def _id_of(self, value: Any) -> int:
        if self._v2i_stale:
            self.value_to_id = {v: i for i, v in enumerate(self.id_to_value)}
            self._v2i_stale = False
        i = self.value_to_id.get(value)
        if i is None:
            i = len(self.id_to_value)
            self.value_to_id[value] = i
            self.id_to_value.append(value)
            self._sorted_vals = None  # scalar path invalidates the index
        return i

    def encode_array(self, arr: np.ndarray) -> np.ndarray:
        """Vectorized dictionary encode of a numeric SV batch: one
        np.unique + searchsorted against the sorted known-values index;
        Python work only to record NEVER-SEEN uniques (amortizes to
        zero once the dictionary saturates).  The value_to_id hash map
        is left stale (rebuilt on demand by the scalar path): at high
        cardinality its per-unique inserts would dominate ingest."""
        if arr.size > 1 and bool((arr[1:] >= arr[:-1]).all()):
            # sorted-block fast path (monotone time/offset-like
            # columns, and blocks that happen to arrive ordered): the
            # uniques are the change points — no argsort, no gather
            flags = np.empty(arr.size, dtype=bool)
            flags[0] = True
            np.not_equal(arr[1:], arr[:-1], out=flags[1:])
            uniq = arr[flags]
            inverse = np.cumsum(flags) - 1
        else:
            uniq, inverse = np.unique(arr, return_inverse=True)
        if self._sorted_vals is None or self._sorted_vals.dtype != arr.dtype:
            known = np.asarray(self.id_to_value, dtype=arr.dtype)
            order = np.argsort(known, kind="stable")
            self._sorted_vals = known[order]
            self._sorted_ids = order.astype(np.int32)
            self._cap_vals = self._cap_ids = None
        pos = np.searchsorted(self._sorted_vals, uniq)
        if self._sorted_vals.size:
            pc = np.minimum(pos, self._sorted_vals.size - 1)
            hit = self._sorted_vals[pc] == uniq
        else:
            hit = np.zeros(uniq.size, dtype=bool)
        new_vals = uniq[~hit]
        if new_vals.size:
            base = len(self.id_to_value)
            self.id_to_value.extend(new_vals.tolist())
            self._v2i_stale = True
            new_ids = np.arange(base, base + new_vals.size, dtype=np.int32)
            n_old = self._sorted_vals.size
            if n_old == 0 or new_vals[0] > self._sorted_vals[-1]:
                # append-at-end growth (monotone columns: every new
                # value sorts after the whole dictionary): write into
                # the capacity-doubled backing — amortized O(new),
                # where np.insert would copy the full dictionary per
                # ingest block
                need = n_old + new_vals.size
                if (
                    self._cap_vals is None
                    or self._cap_vals.size < need
                    or self._cap_vals.dtype != arr.dtype
                    or self._sorted_vals.base is not self._cap_vals
                ):
                    cap = max(need * 2, 1024)
                    grown_v = np.empty(cap, dtype=arr.dtype)
                    grown_v[:n_old] = self._sorted_vals
                    grown_i = np.empty(cap, dtype=np.int32)
                    grown_i[:n_old] = self._sorted_ids
                    self._cap_vals, self._cap_ids = grown_v, grown_i
                self._cap_vals[n_old:need] = new_vals
                self._cap_ids[n_old:need] = new_ids
                self._sorted_vals = self._cap_vals[:need]
                self._sorted_ids = self._cap_ids[:need]
            else:
                ins = np.searchsorted(self._sorted_vals, new_vals)
                self._sorted_vals = np.insert(self._sorted_vals, ins, new_vals)
                self._sorted_ids = np.insert(self._sorted_ids, ins, new_ids)
                self._cap_vals = self._cap_ids = None
            pos = np.searchsorted(self._sorted_vals, uniq)
        lut = self._sorted_ids[pos]
        return lut[inverse].astype(np.int32)

    # Batch ingestion is two-phase so a dirty value mid-batch (convert
    # raises on producer garbage) can never leave columns misaligned:
    # encode_batch only touches the dictionary (unreferenced entries are
    # harmless), commit_batch cannot raise.
    def encode_batch(self, vals):
        """The column's values of a batch (None where a row lacks it) ->
        int32[m] dictIds (SV) or per-row id lists (MV); raises on
        unconvertible values BEFORE any row arrays mutate."""
        st = self.spec.stored_type
        conv = st.convert
        id_of = self._id_of
        default_id = None
        if self.single:
            if st.is_numeric and None not in vals:
                # Vectorized fast path (the ingest hot loop): one numpy
                # conversion + unique, then one id_of per UNIQUE value.
                # np.asarray enforces the same semantics as convert()
                # (int truncation, float32 rounding for FLOAT) and
                # raises on junk BEFORE any dictionary mutation; mixed/
                # stringy payloads fall back to the per-value loop.
                try:
                    arr = np.asarray(vals, dtype=st.to_numpy())
                except (TypeError, ValueError, OverflowError):
                    arr = None
                if arr is not None and arr.ndim != 1:
                    # nested-list values build a 2-D array that would
                    # pass encode and blow up in commit_batch AFTER
                    # other columns committed — the per-value loop
                    # raises in the safe encode phase instead
                    arr = None
                if arr is not None and arr.dtype.kind == "f" and np.isnan(arr).any():
                    # np.unique collapses NaNs to one dictId while the
                    # fallback's dict keying gives each NaN its own —
                    # keep one (the historical) behavior regardless of
                    # which path a batch happens to take
                    arr = None
                if arr is not None:
                    return self.encode_array(arr)
            elif set(map(type, vals)) == {str}:
                # STRING columns from JSON payloads arrive as str:
                # convert() would be an identity per value — skip it.
                # id_of once a distinct value, in the order of first
                # appearance (the ids a per-value loop would give)
                ids = {v: id_of(v) for v in dict.fromkeys(vals)}
                return np.fromiter(map(ids.__getitem__, vals), dtype=np.int32, count=len(vals))
            out = np.empty(len(vals), dtype=np.int32)
            for j, v in enumerate(vals):
                if v is None:
                    if default_id is None:
                        default_id = id_of(conv(self.spec.get_default_null_value()))
                    out[j] = default_id
                else:
                    out[j] = id_of(conv(v))
            return out
        outs = []
        default_ids = None
        for v in vals:
            vs = v if isinstance(v, (list, tuple)) else [v] if v is not None else []
            if not vs:
                if default_ids is None:
                    default_ids = [id_of(conv(self.spec.get_default_null_value()))]
                outs.append(default_ids)
            else:
                outs.append([id_of(conv(x)) for x in vs])
        return outs

    def commit_batch(self, encoded, start: int) -> None:
        if self.single:
            need = start + encoded.shape[0]
            while self.ids.size < need:
                self.ids = np.concatenate(
                    [self.ids, np.zeros(self.ids.size, dtype=np.int32)]
                )
            self.ids[start:need] = encoded
            return
        for id_list in encoded:
            self.flat_ids.extend(id_list)
            self.offsets.append(len(self.flat_ids))
            self.max_mv = max(self.max_mv, len(id_list))


class MutableSegment:
    def __init__(self, schema: Schema, segment_name: str, table_name: str) -> None:
        self.schema = schema
        self.segment_name = segment_name
        self.table_name = table_name
        self._columns = {spec.name: _MutableColumn(spec) for spec in schema.all_fields()}
        self._num_docs = 0
        self._lock = threading.Lock()
        self._snapshot: Optional[ImmutableSegment] = None
        self._snapshot_watermark = -1
        self.start_offset: int = 0
        self.end_offset: int = 0

    @property
    def num_docs(self) -> int:
        return self._num_docs

    def approx_bytes(self) -> int:
        """Rough host-memory footprint of the consuming state (growable
        dictId arrays + dictionaries + encode indexes) — the ingest
        backpressure watermark input.  Conservative rather than exact:
        the cached query snapshot (rebuilt per watermark) is not
        counted, so set watermarks with ~2x headroom."""
        with self._lock:
            total = 0
            for mc in self._columns.values():
                if mc.single:
                    total += mc.ids.nbytes
                else:
                    total += 4 * len(mc.flat_ids) + 8 * len(mc.offsets)
                total += 64 * len(mc.id_to_value)  # dict entries (rough)
                if mc._sorted_vals is not None:
                    total += mc._sorted_vals.nbytes + mc._sorted_ids.nbytes
            return total

    def index(self, row: Row) -> None:
        """Append one row (RealtimeSegmentImpl.index :185); visible to
        queries at the next snapshot."""
        self.index_batch((row,))

    def index_batch(self, rows) -> None:
        """Append many rows under ONE lock with per-column tight loops —
        the stream consumers fetch in batches, and batching the encode
        side makes ingestion ~3x faster than per-row calls (the hot
        loop of the 1-row reference path, ``RealtimeSegmentImpl.index``,
        amortized).  Encode-then-commit: a dirty value anywhere in the
        batch raises before ANY column's row arrays change."""
        if not rows:
            return
        with self._lock:
            start = self._num_docs
            specs = self.schema.all_fields()
            names = [spec.name for spec in specs]
            # the batch transposed into columns: one pass when every row
            # carries every field (the first name asked twice, so a getter
            # of one field also returns tuples), else None where a row
            # lacks one
            try:
                cols = list(zip(*map(itemgetter(*names, *names[:1]), rows)))
            except KeyError:
                cols = [[row.get(name) for row in rows] for name in names]
            encoded = [self._columns[name].encode_batch(col) for name, col in zip(names, cols)]
            for spec, enc in zip(specs, encoded):
                self._columns[spec.name].commit_batch(enc, start)
            self._num_docs = start + len(rows)

    def index_columns(self, cols: Dict[str, np.ndarray]) -> int:
        """Columnar append — the high-throughput ingest path: one
        numpy array per column, vectorized dictionary encode per column
        (``_MutableColumn.encode_array``), no per-row dicts anywhere.
        All schema columns must be single-value and present; numeric
        columns must be NaN-free (callers fall back to ``index_batch``
        rows otherwise).  Returns the number of rows appended."""
        specs = self.schema.all_fields()
        n = -1
        for spec in specs:
            if not spec.single_value:
                raise ValueError(f"columnar ingest requires SV columns: {spec.name}")
            arr = cols.get(spec.name)
            if arr is None:
                raise ValueError(f"columnar batch missing column {spec.name}")
            if n < 0:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError("columnar batch length mismatch")
        if n <= 0:
            return 0
        with self._lock:
            start = self._num_docs
            encoded = []
            for spec in specs:
                st = spec.stored_type
                mc = self._columns[spec.name]
                if st.is_numeric:
                    arr = np.asarray(cols[spec.name], dtype=st.to_numpy())
                    if arr.dtype.kind == "f" and np.isnan(arr).any():
                        raise ValueError(f"NaN in columnar batch: {spec.name}")
                    encoded.append(mc.encode_array(arr))
                else:
                    # STRING: per-unique id_of (vectorized unique first; a
                    # fixed-width str / bytes block sorts in its own dtype,
                    # in the order of the same values as objects)
                    vals = cols[spec.name]
                    if getattr(vals, "dtype", None) is None or vals.dtype.kind not in "US":
                        vals = np.asarray(vals, dtype=object)
                    uniq, inverse = np.unique(vals, return_inverse=True)
                    lut = np.empty(uniq.size, dtype=np.int32)
                    for ui, value in enumerate(uniq.tolist()):
                        lut[ui] = mc._id_of(value)
                    encoded.append(lut[inverse].astype(np.int32))
            for spec, enc in zip(specs, encoded):
                self._columns[spec.name].commit_batch(enc, start)
            self._num_docs = start + n
        return n

    # ------------------------------------------------------------------
    def snapshot(self) -> ImmutableSegment:
        """Immutable view at the current watermark; cached until more
        rows arrive (chunk-watermark consistency).  A superseded
        snapshot's host postings go back to the process budget."""
        with self._lock:
            n = self._num_docs
            if self._snapshot is not None and self._snapshot_watermark == n:
                return self._snapshot
            snap = self._convert(n)
            if self._snapshot is not None:
                release_postings(self._snapshot)
            self._snapshot = snap
            self._snapshot_watermark = n
            return snap

    def _convert(self, n: int) -> ImmutableSegment:
        columns: Dict[str, ColumnData] = {}
        for spec in self.schema.all_fields():
            mc = self._columns[spec.name]
            st = spec.stored_type
            if st == DataType.STRING:
                order = np.argsort(np.asarray(mc.id_to_value, dtype=object)) if mc.id_to_value else np.zeros(0, np.int64)
                sorted_vals = [mc.id_to_value[i] for i in order]
                d = Dictionary(st, sorted_vals)
            else:
                arr = np.asarray(mc.id_to_value, dtype=st.to_numpy()) if mc.id_to_value else np.zeros(0, st.to_numpy())
                order = np.argsort(arr, kind="stable")
                d = Dictionary(st, arr[order])
            # remap arrival-order ids -> sorted dictIds
            remap = np.empty(max(len(mc.id_to_value), 1), dtype=np.int32)
            remap[order] = np.arange(order.size, dtype=np.int32)

            fwd = remap[mc.ids[:n]] if spec.single_value else None
            meta = ColumnMetadata(
                name=spec.name,
                data_type=spec.data_type,
                field_type=spec.field_type,
                single_value=spec.single_value,
                cardinality=d.cardinality,
                total_docs=n,
                # time-ordered streams produce sorted time columns: the
                # committed segment records it so the docrange fast
                # path (engine/plan.py) applies to realtime data too
                is_sorted=bool(
                    spec.single_value
                    and (fwd is None or fwd.size == 0 or np.all(fwd[1:] >= fwd[:-1]))
                ),
                max_num_multi_values=mc.max_mv,
                total_number_of_entries=n if spec.single_value else len(mc.flat_ids),
                min_value=d.min_value if len(d) else None,
                max_value=d.max_value if len(d) else None,
            )
            if spec.single_value:
                columns[spec.name] = ColumnData(metadata=meta, dictionary=d, fwd=fwd)
            else:
                offsets = np.asarray(mc.offsets[: n + 1], dtype=np.int32)
                flat = np.asarray(mc.flat_ids[: offsets[-1]], dtype=np.int32)
                columns[spec.name] = ColumnData(
                    metadata=meta,
                    dictionary=d,
                    mv_values=remap[flat] if flat.size else flat,
                    mv_offsets=offsets,
                )

        smeta = SegmentMetadata(
            segment_name=self.segment_name,
            table_name=self.table_name,
            num_docs=n,
            columns={c.metadata.name: c.metadata for c in columns.values()},
            time_column=self.schema.time_column_name,
            time_unit=self.schema.time_field.time_unit if self.schema.time_field else "DAYS",
            creation_time_ms=int(time.time() * 1000),
            custom={"realtime": True, "startOffset": self.start_offset, "endOffset": self.end_offset},
        )
        tcol = self.schema.time_column_name
        if tcol and n > 0 and not columns[tcol].dictionary.is_string:
            smeta.start_time = int(columns[tcol].dictionary.min_value)
            smeta.end_time = int(columns[tcol].dictionary.max_value)
        seg = ImmutableSegment(metadata=smeta, columns=columns)
        # watermark-scoped identity so staging/context caches key correctly
        smeta.crc = (hash((self.segment_name, n)) & 0x7FFFFFFF) or 1
        return seg

    def to_committed_segment(self, final_name: Optional[str] = None) -> ImmutableSegment:
        """Final conversion at commit (RealtimeSegmentConverter analog):
        a full CRC'd immutable segment ready for the store."""
        snap = self.snapshot()
        if final_name and final_name != self.segment_name:
            snap.metadata.segment_name = final_name
        snap.metadata.custom.update(
            {"startOffset": self.start_offset, "endOffset": self.end_offset}
        )
        snap.metadata.crc = snap.compute_crc()
        snap.metadata.custom["dataCrc"] = True  # verifiable (format.verify_segment_crc)
        return snap
