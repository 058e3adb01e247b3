"""Controller segment store: the durable copy of every uploaded segment
(port of ``pinot_tpu.controller.store``, trimmed): one directory per
table, one segment file per segment, served to servers for download and
re-verified by the deep-store scrubber (``verify_copy``)."""
from __future__ import annotations

import os
import shutil
from typing import Optional

from pinot_tpu_torch.segment.format import (
    SEGMENT_FILE_NAME,
    SegmentIntegrityError,
    read_segment,
    verify_segment_crc,
    write_segment,
)
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

    @staticmethod
    def _dir_bytes(d: str) -> int:
        total = 0
        for root, _dirs, files in os.walk(d):
            for f in files:
                total += os.path.getsize(os.path.join(root, f))
        return total

    def segment_size_bytes(self, table: str, segment_name: str) -> int:
        return self._dir_bytes(self.segment_dir(table, segment_name))

    def table_size_bytes(self, table: str) -> int:
        """On-disk bytes of a table's durable copies (the storage quota's
        input)."""
        return self._dir_bytes(os.path.join(self.base_dir, table))

    def exists(self, table: str, segment_name: str) -> bool:
        return os.path.exists(self.segment_file_path(table, segment_name))

    def delete(self, table: str, segment_name: str) -> None:
        d = self.segment_dir(table, segment_name)
        if os.path.exists(d):
            shutil.rmtree(d)

    def verify_copy(self, table: str, segment_name: str, expected_crc: Optional[int] = None) -> ImmutableSegment:
        """Re-verify the durable copy (the deep-store scrub primitive).
        Raises ``FileNotFoundError`` for a lost copy and
        ``SegmentIntegrityError`` for an unreadable or CRC-failing one, or
        one whose verifiable CRC no longer matches the registered
        metadata (``expected_crc``)."""
        path = self.segment_file_path(table, segment_name)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        try:
            seg = read_segment(path)
        except SegmentIntegrityError:
            raise
        except Exception as e:
            raise SegmentIntegrityError(f"store copy {table}/{segment_name} unreadable: {e!r}") from e
        verify_segment_crc(seg, source=f"store:{table}/{segment_name}")
        if (expected_crc and seg.metadata.crc and seg.metadata.custom.get("dataCrc")
                and int(seg.metadata.crc) != int(expected_crc)):
            raise SegmentIntegrityError(
                f"store copy {table}/{segment_name}: CRC {seg.metadata.crc} != registered {expected_crc}")
        return seg
