"""Controller segment store: the durable copy of every uploaded segment
(port of ``pinot_tpu.controller.store``, trimmed): one directory per
table, one segment file per segment, served to servers for download."""
from __future__ import annotations

import os
import shutil
from pinot_tpu_torch.segment.format import SEGMENT_FILE_NAME, write_segment
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.utils.fileio import atomic_write


class SegmentStore:
    def __init__(self, base_dir: str) -> None:
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)

    def segment_dir(self, table: str, segment_name: str) -> str:
        return os.path.join(self.base_dir, table, segment_name)

    def segment_file_path(self, table: str, segment_name: str) -> str:
        return os.path.join(self.segment_dir(table, segment_name), SEGMENT_FILE_NAME)

    def save(self, table: str, segment: ImmutableSegment) -> str:
        d = self.segment_dir(table, segment.segment_name)
        write_segment(segment, d)
        return d

    def save_bytes(self, table: str, segment_name: str, data: bytes) -> str:
        """Install segment-file bytes as the durable copy, atomically: a
        concurrent download never sees a partial file."""
        d = self.segment_dir(table, segment_name)
        os.makedirs(d, exist_ok=True)
        atomic_write(os.path.join(d, SEGMENT_FILE_NAME), data, binary=True)
        return d

    def exists(self, table: str, segment_name: str) -> bool:
        return os.path.exists(self.segment_file_path(table, segment_name))

    def delete(self, table: str, segment_name: str) -> None:
        d = self.segment_dir(table, segment_name)
        if os.path.exists(d):
            shutil.rmtree(d)
