"""Segment export converters and star-tree inspection (copy of
``pinot_tpu.tools.converters``).

The reference ships segment converters (pinot-tools
``tools/segment/converter/`` — segment -> CSV/JSON/Avro) and a
``StarTreeIndexViewer``.  Same capabilities here: rows are rebuilt from
the columnar data (dictionary decode through the forward index) and
written back out as CSV, JSONL, or Avro object containers
(``pinot_tpu_torch.segment.avro``, the pure-Python container codec).
Injected default columns appear in every export: the exports iterate
``metadata.columns``, which schema evolution keeps in step with the
live columns.
"""
from __future__ import annotations

import csv
import json
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.segment.format import read_segment
from pinot_tpu_torch.segment.immutable import ImmutableSegment


def _load(segment_or_dir) -> ImmutableSegment:
    if isinstance(segment_or_dir, ImmutableSegment):
        return segment_or_dir
    return read_segment(segment_or_dir)


def segment_to_jsonl(segment_or_dir, out_path: str) -> int:
    """Export every row of a segment as JSON lines; returns row count."""
    seg = _load(segment_or_dir)
    n = 0
    with open(out_path, "w") as f:
        for row in seg.rows():
            f.write(json.dumps(row, default=_json_default) + "\n")
            n += 1
    return n


def segment_to_csv(segment_or_dir, out_path: str) -> int:
    """Export every row of a segment as CSV (MV cells join on ';', the
    reference CSV reader's default multi-value delimiter)."""
    seg = _load(segment_or_dir)
    cols = list(seg.metadata.columns)
    n = 0
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for row in seg.rows():
            w.writerow(
                [
                    ";".join(str(x) for x in row[c]) if isinstance(row[c], list) else row[c]
                    for c in cols
                ]
            )
            n += 1
    return n


def segment_to_avro(segment_or_dir, out_path: str, codec: str = "deflate") -> int:
    """Export every row of a segment as an Avro object container file
    (segment->Avro converter parity; schema derived from the segment)."""
    from pinot_tpu_torch.common.schema import FieldSpec, Schema
    from pinot_tpu_torch.segment.avro import pinot_to_avro_schema, write_avro

    seg = _load(segment_or_dir)
    specs = [
        FieldSpec(name, meta.data_type, meta.field_type, single_value=meta.single_value)
        for name, meta in seg.metadata.columns.items()
    ]
    schema = Schema(seg.metadata.table_name, dimensions=specs)
    avro_schema = pinot_to_avro_schema(schema)
    rows = [{k: _py(v) for k, v in row.items()} for row in seg.rows()]
    write_avro(out_path, avro_schema, rows, codec=codec)
    return len(rows)


def _np_scalar(v: Any) -> Optional[Any]:
    """numpy scalar -> plain Python, or None if not a numpy scalar."""
    import numpy as np

    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return None


def _py(v: Any):
    """Values (incl. lists) -> plain Python for the Avro encoder."""
    if isinstance(v, list):
        return [_py(x) for x in v]
    s = _np_scalar(v)
    return v if s is None else s


def _json_default(v: Any):
    s = _np_scalar(v)
    return str(v) if s is None else s


def star_tree_summary(segment_or_dir, max_nodes: int = 50) -> Dict[str, Any]:
    """StarTreeIndexViewer analog: tree shape + a bounded node dump +
    cube statistics, as a JSON-friendly dict."""
    seg = _load(segment_or_dir)
    st = getattr(seg, "star_tree", None)
    if st is None:
        return {"hasStarTree": False}

    nodes: List[Dict[str, Any]] = []
    depth_counts: Dict[int, int] = {}
    leaf_count = 0
    star_count = 0

    def walk(node, depth: int, path: List[str], is_star: bool) -> None:
        nonlocal leaf_count, star_count
        depth_counts[depth] = depth_counts.get(depth, 0) + 1
        if is_star:
            star_count += 1
        if node.is_leaf:
            leaf_count += 1
        if len(nodes) < max_nodes:
            nodes.append(
                {
                    "depth": depth,
                    "path": " / ".join(path) if path else "(root)",
                    "star": is_star,
                    "leaf": node.is_leaf,
                    "level": int(node.level),
                    "aggRange": [int(node.start), int(node.end)],
                }
            )
        for val, child in sorted(node.children.items()):
            walk(child, depth + 1, path + [str(val)], False)
        if node.star_child is not None:
            walk(node.star_child, depth + 1, path + ["*"], True)

    walk(st.root, 0, [], False)
    return {
        "hasStarTree": True,
        "splitOrder": list(st.split_order),
        "metricColumns": list(st.metric_columns),
        "hllColumns": list(st.hll_columns),
        "numAggRecords": st.num_records,
        "maxLeafRecords": st.max_leaf_records,
        "numLeaves": leaf_count,
        "numStarNodes": star_count,
        "nodesPerDepth": {str(k): v for k, v in sorted(depth_counts.items())},
        "nodes": nodes,
    }
