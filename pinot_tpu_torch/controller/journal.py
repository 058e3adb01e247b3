"""Append-only, CRC-framed op journal with periodic full snapshots for
the controller property store (a copy of ``pinot_tpu.controller.journal``;
the same file format and environment names, so either package reads a
store the other wrote).

The reference's durable metadata plane is ZooKeeper: every znode write
lands in ZK's own transaction log + fuzzy snapshots, so a controller
can lose its local disk and recover the full cluster state from the
ensemble.  Our file-backed ``PropertyStore`` replaces ZK, so it needs
the same story locally: every mutation is framed into ``journal.log``
*before* the per-key JSON mirror file is rewritten, and a full-state
``snapshot.json`` is cut every N ops.  Recovery = snapshot +
journal-replay; a torn tail frame (crash mid-append) is truncated, not
fatal, and replay is idempotent because every op carries a
monotonically increasing ``seq`` that the snapshot also records.

Frame format (all integers big-endian)::

    u32 payload_length | u32 crc32(payload) | payload (UTF-8 JSON)

Payload::

    {"seq": N, "op": "put"|"delete"|"delete_ns", "ns": ..., "key": ...,
     "record": ...}

Epoch claims (the fencing epoch) are ordinary journaled puts of the
``cluster/epoch`` record, so a restore from snapshot+journal preserves
the fencing invariant: the restored controller re-claims past the
highest journaled epoch and stale pre-disaster writers stay rejected.

fsync behaviour is governed by ``PINOT_TPU_DURABLE_FSYNC`` (default
on).  With it off, appends still hit the page cache in order — crash
recovery of the *process* is unaffected; only power loss can lose the
un-synced tail.
"""
from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

from pinot_tpu_torch.utils.fileio import atomic_write, fsync_dir

_FRAME = struct.Struct(">II")
# A frame longer than this is assumed to be garbage (torn/overwritten
# length word), not a real op: the whole property store is far smaller.
_MAX_FRAME_BYTES = 64 * 1024 * 1024

JOURNAL_DIR_NAME = ".journal"
LOG_NAME = "journal.log"
SNAPSHOT_NAME = "snapshot.json"


def durable_fsync_enabled() -> bool:
    """``PINOT_TPU_DURABLE_FSYNC`` knob; default on (durable)."""
    return os.environ.get("PINOT_TPU_DURABLE_FSYNC", "1") not in ("0", "false", "no")


def snapshot_every_default() -> int:
    try:
        return max(1, int(os.environ.get("PINOT_TPU_JOURNAL_SNAPSHOT_EVERY", "256")))
    except ValueError:
        return 256


# State shape shared with the property store: ns -> key -> record.
State = Dict[str, Dict[str, Any]]


def apply_op(state: State, op: Dict[str, Any]) -> None:
    """Apply one journaled op to an in-memory state mirror."""
    kind = op.get("op")
    ns = op.get("ns", "")
    if kind == "put":
        state.setdefault(ns, {})[op["key"]] = op.get("record")
    elif kind == "delete":
        state.get(ns, {}).pop(op.get("key"), None)
    elif kind == "delete_ns":
        prefix = ns + "/"
        for existing in [n for n in state if n == ns or n.startswith(prefix)]:
            del state[existing]


class MetadataJournal:
    """Single-writer op journal + snapshot pair under ``dir_path``.

    Not internally locked: the property store serializes all mutations
    (and recovery) under its own epoch-fence flock, which is the
    correct scope — cross-process, not just cross-thread.
    """

    def __init__(
        self,
        dir_path: str,
        fsync: Optional[bool] = None,
        snapshot_every: Optional[int] = None,
        on_event: Optional[Callable[[str], None]] = None,
    ) -> None:
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self.log_path = os.path.join(dir_path, LOG_NAME)
        self.snapshot_path = os.path.join(dir_path, SNAPSHOT_NAME)
        self.fsync = durable_fsync_enabled() if fsync is None else fsync
        self.snapshot_every = snapshot_every or snapshot_every_default()
        # on_event(name) lets the owner meter journal internals
        # (torn-tail truncations, corrupt snapshots) without the
        # journal depending on the metrics registry.
        self._on_event = on_event or (lambda name: None)
        self._fd: Optional[int] = None
        self.seq = 0  # last appended/recovered op seq
        self.ops_since_snapshot = 0
        self.torn_tail_truncations = 0

    # -- recovery ----------------------------------------------------

    def recover(self, fallback_state_fn: Optional[Callable[[], State]] = None) -> State:
        """Rebuild state from snapshot + journal replay.

        When no (valid) snapshot exists, ``fallback_state_fn()`` seeds
        the base state — the property store passes its on-disk record
        scan here so legacy/pre-journal stores are absorbed, with the
        journal's ops replayed on top in order (so journaled deletes
        still win over a stale mirror file).

        Torn tail frames are truncated off the log (counted via the
        ``journalTornTail`` event); a corrupt snapshot is quarantined
        aside and recovery proceeds from the journal alone.  Never
        raises for damaged journal/snapshot content.
        """
        state, snap_seq = self._load_snapshot()
        if snap_seq == 0 and not state and fallback_state_fn is not None:
            state = fallback_state_fn()
        self.seq = snap_seq
        applied = 0
        last_good = 0
        if os.path.exists(self.log_path):
            with open(self.log_path, "rb") as f:
                data = f.read()
            offset = 0
            while True:
                frame = self._read_frame(data, offset)
                if frame is None:
                    break
                op, offset = frame
                last_good = offset
                seq = int(op.get("seq", 0))
                if seq <= snap_seq:
                    continue  # already folded into the snapshot
                apply_op(state, op)
                self.seq = max(self.seq, seq)
                applied += 1
            if last_good < len(data):
                # torn tail: truncate to the last whole frame
                self.torn_tail_truncations += 1
                self._on_event("journalTornTail")
                with open(self.log_path, "r+b") as f:
                    f.truncate(last_good)
                if self.fsync:
                    with open(self.log_path, "rb") as f:
                        os.fsync(f.fileno())
        self.ops_since_snapshot = applied
        return state

    def _load_snapshot(self) -> Tuple[State, int]:
        if not os.path.exists(self.snapshot_path):
            return {}, 0
        try:
            with open(self.snapshot_path) as f:
                doc = json.load(f)
            state = doc["state"]
            if not isinstance(state, dict):
                raise ValueError("snapshot state is not a mapping")
            return state, int(doc.get("seq", 0))
        except (ValueError, KeyError, OSError, UnicodeDecodeError):
            self._on_event("corruptSnapshot")
            try:
                os.replace(
                    self.snapshot_path,
                    self.snapshot_path + ".corrupt.%d" % int(time.time() * 1000),
                )
            except OSError:
                pass
            return {}, 0

    @staticmethod
    def _read_frame(data: bytes, offset: int):
        """One frame at ``offset`` -> (op, next_offset), or None if the
        remaining bytes are not a whole valid frame (torn tail)."""
        if offset + _FRAME.size > len(data):
            return None
        length, crc = _FRAME.unpack_from(data, offset)
        if length == 0 or length > _MAX_FRAME_BYTES:
            return None
        start = offset + _FRAME.size
        end = start + length
        if end > len(data):
            return None
        payload = data[start:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return None
        try:
            op = json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None
        if not isinstance(op, dict):
            return None
        return op, end

    # -- append ------------------------------------------------------

    def append(self, op: Dict[str, Any]) -> int:
        """Frame + append one op; returns its assigned seq."""
        self.seq += 1
        op = dict(op)
        op["seq"] = self.seq
        payload = json.dumps(op, separators=(",", ":")).encode("utf-8")
        frame = _FRAME.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload
        if self._fd is None:
            self._fd = os.open(self.log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        os.write(self._fd, frame)
        if self.fsync:
            os.fsync(self._fd)
        self.ops_since_snapshot += 1
        return self.seq

    def should_snapshot(self) -> bool:
        return self.ops_since_snapshot >= self.snapshot_every

    def write_snapshot(self, state: State) -> None:
        """Atomically persist a full-state snapshot at the current seq
        and reset the log: crash between the snapshot replace and the
        log truncate is safe, since replay skips ops with
        ``seq <= snapshot.seq``."""
        atomic_write(
            self.snapshot_path,
            json.dumps({"seq": self.seq, "state": state}, separators=(",", ":")),
            fsync=self.fsync,
        )
        self.close()
        with open(self.log_path, "wb") as f:
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        if self.fsync:
            fsync_dir(self.dir)
        self.ops_since_snapshot = 0

    def log_size_bytes(self) -> int:
        try:
            return os.path.getsize(self.log_path)
        except OSError:
            return 0

    def close(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            finally:
                self._fd = None
