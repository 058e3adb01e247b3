"""Table dictionary context: global (query-level) dictionaries + per-segment
remaps (copy of ``pinot_tpu.engine.context``).

A table-level global dictionary per column is the sorted union of the
segments' dictionaries, plus one ``remap: int32[segment_card]`` per
(segment, column) translating local dictIds to global ids.  Group keys
are then indexed in the global id space — identical across segments — so
the cross-segment merge is a plain elementwise reduction and group-key
materialization one host-side lookup.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, MutableMapping, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.common.schema import DataType
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.immutable import ImmutableSegment


@dataclass
class GlobalColumn:
    """Global dictionary + per-segment remap arrays for one column."""

    name: str
    stored_type: DataType
    global_dict: Dictionary
    remaps: List[np.ndarray]  # remaps[i][local_dict_id] -> global id (int32)

    @property
    def global_cardinality(self) -> int:
        return self.global_dict.cardinality


class TableContext:
    """Global dictionaries for one set of segments (one query's scope)."""

    def __init__(self, segments: Sequence[ImmutableSegment]):
        self.segments = list(segments)
        self._columns: Dict[str, GlobalColumn] = {}

    def column(self, name: str) -> GlobalColumn:
        gc = self._columns.get(name)
        if gc is None:
            gc = self._build(name)
            self._columns[name] = gc
        return gc

    def _build(self, name: str) -> GlobalColumn:
        dicts = [seg.column(name).dictionary for seg in self.segments]
        stored = dicts[0].stored_type
        if stored == DataType.STRING:
            union = sorted(set().union(*[set(d.values) for d in dicts]))
            gdict = Dictionary(stored, union)
            lookup = {v: i for i, v in enumerate(union)}
            remaps = [
                np.fromiter((lookup[v] for v in d.values), dtype=np.int32, count=len(d))
                for d in dicts
            ]
        else:
            union = np.unique(np.concatenate([np.asarray(d.values) for d in dicts]))
            gdict = Dictionary(stored, union)
            remaps = [
                np.searchsorted(union, np.asarray(d.values)).astype(np.int32) for d in dicts
            ]
        return GlobalColumn(name=name, stored_type=stored, global_dict=gdict, remaps=remaps)


def get_table_context(
    segments: Sequence[ImmutableSegment],
    cache: MutableMapping[Tuple, TableContext],
) -> TableContext:
    """Context for this segment set, cached in the caller's ``cache`` by
    (name, crc, instance token) per segment."""
    key = tuple((s.segment_name, s.metadata.crc, s.staging_token) for s in segments)
    ctx = cache.get(key)
    if ctx is None:
        ctx = TableContext(segments)
        if len(cache) > 64:
            cache.clear()
        cache[key] = ctx
    return ctx
