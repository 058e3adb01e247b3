"""Durable controller property store (a copy of
``pinot_tpu.controller.property_store``: the same layout, namespaces and
environment names, so either package opens a store the other wrote).

The reference keeps all cluster metadata — schemas, table configs,
ideal states, per-segment ZK metadata (incl. LLC offset checkpoints) —
in the ZooKeeper property store
(``PinotHelixResourceManager.java:103``, ``pinot-common/.../metadata/``),
so a controller restart recovers the whole cluster from ZK.  This is
the single-controller analog: one JSON file per record under the
controller's data dir, written atomically (tmp + rename) so a crash
mid-write can never corrupt a record.

Durability (the ZK-transaction-log analog): every mutation is first
appended to a CRC-framed op journal (``.journal/journal.log``) and a
full-state snapshot is cut periodically (``.journal/snapshot.json``) —
see ``controller/journal.py``.  The per-key JSON files become a read
mirror: a missing or corrupted record file is healed from the
journal-recovered in-memory state instead of crashing the reader, and
a garbled record that has no journal backing surfaces as a typed
``CorruptRecordError`` with the damaged file quarantined aside
(``<name>.json.corrupt.<ms>`` — the segment-quarantine idiom).
fsync of the journal is governed by ``PINOT_TPU_DURABLE_FSYNC``
(default on); the mirror files skip fsync since the journal, not the
mirror, is the recovery source of truth.

Namespaces:
  schemas/<name>.json          Schema.to_json()
  tables/<physical>.json       TableConfig.to_json()
  idealstates/<physical>.json  {segment -> {server -> target state}}
  segments/<physical>/<segment>.json  segment record: metadata +
                               download dir + realtime partition/offset
  streams/<physical>.json      stream-provider descriptor for realtime
                               tables (so consumption resumes)
  cluster/epoch.json           the controller-incarnation fencing token

Epoch fencing (the ZK leader-generation analog): a controller claims
authority at construction by bumping ``cluster/epoch`` and becomes the
store's writer; every subsequent ``put``/``delete`` re-reads the stored
epoch and raises a typed ``StaleEpochError`` when a NEWER incarnation
has claimed the store since — so a partitioned-away or zombie
controller cannot clobber the live one's state (split-brain safety).
A store without a writer epoch (bare/test use) is unfenced.  Epoch
claims go through the journal like every other put, so a restore from
snapshot+journal preserves the fencing invariant.
"""
from __future__ import annotations

import fcntl
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.common.fencing import StaleEpochError
from pinot_tpu_torch.controller.journal import JOURNAL_DIR_NAME, MetadataJournal
from pinot_tpu_torch.utils.fileio import atomic_write
from pinot_tpu_torch.utils.metrics import ControllerMetrics

CLUSTER_NS = "cluster"
EPOCH_KEY = "epoch"
_FENCE_LOCK_FILE = ".fence.lock"  # never matches an encoded record name

_SAFE = "-_"  # NOT '.', or a '..' component would survive encoding


class CorruptRecordError(Exception):
    """A property-store record file is unreadable/garbled and has no
    journal backing to heal from.  The damaged file has been
    quarantined aside (``<path>.corrupt.<ms>``)."""

    def __init__(self, namespace: str, key: str, path: str, cause: Exception) -> None:
        super().__init__(
            f"corrupt property-store record {namespace}/{key} at {path}: {cause!r}"
        )
        self.namespace = namespace
        self.key = key
        self.path = path
        self.cause = cause


def _encode_key(key: str) -> str:
    """Filesystem-safe record name (segment names contain '__', table
    names are alnum+underscore; escape anything else)."""
    out = []
    for ch in key:
        if ch.isalnum() or ch in _SAFE or ch == "_":
            out.append(ch)
        else:
            out.append(f"%{ord(ch):02x}")
    return "".join(out) + ".json"


def _decode_name(raw: str) -> str:
    """Reverse of ``_encode_key`` (without the .json suffix)."""
    parts = []
    i = 0
    while i < len(raw):
        if raw[i] == "%" and i + 2 < len(raw) + 1:
            try:
                parts.append(chr(int(raw[i + 1 : i + 3], 16)))
                i += 3
                continue
            except ValueError:
                pass
        parts.append(raw[i])
        i += 1
    return "".join(parts)


class PropertyStore:
    def __init__(self, base_dir: str) -> None:
        self.base_dir = base_dir
        self._lock = threading.Lock()
        # None = unfenced (bare/test stores); set via claim_epoch()
        self._writer_epoch: Optional[int] = None
        # persistent fence-lock fd (opened on first fenced use): flock
        # is per open-file-description, so one long-lived fd gives
        # cross-PROCESS exclusion without 3 syscalls per write; the
        # thread lock above covers threads sharing this fd
        self._fence_fd = None
        os.makedirs(base_dir, exist_ok=True)
        self.metrics = ControllerMetrics("durability")
        for m in (
            "durability.journalAppends",
            "durability.snapshots",
            "durability.corruptRecords",
            "durability.recordsHealed",
            "durability.journalTornTailTruncations",
            "durability.corruptSnapshots",
        ):
            self.metrics.meter(m)
        self._journal = MetadataJournal(
            os.path.join(base_dir, JOURNAL_DIR_NAME), on_event=self._journal_event
        )
        # journal-recovered state mirror: ns -> key -> record.  Guarded
        # by its own lock (NOT self._lock): get() must stay callable
        # from inside _exclusive (claim_epoch -> stored_epoch -> get).
        self._mem_lock = threading.Lock()
        # recovery runs under the cross-process fence lock so a live
        # writer's in-flight append cannot interleave with our replay
        with self._exclusive(force_flock=True):
            self._mem: Dict[str, Dict[str, Any]] = self._journal.recover(
                fallback_state_fn=self._scan_disk_state
            )

    def _journal_event(self, name: str) -> None:
        if name == "journalTornTail":
            self.metrics.meter("durability.journalTornTailTruncations").mark()
        elif name == "corruptSnapshot":
            self.metrics.meter("durability.corruptSnapshots").mark()

    def _ns_dir(self, namespace: str) -> str:
        # encode each namespace component too: namespaces embed table
        # names, and a hostile name must not escape the store dir
        parts = [_encode_key(p)[: -len(".json")] for p in namespace.split("/") if p]
        return os.path.join(self.base_dir, *parts)

    def _path(self, namespace: str, key: str) -> str:
        return os.path.join(self._ns_dir(namespace), _encode_key(key))

    # -- epoch fencing -------------------------------------------------
    @contextmanager
    def _exclusive(self, force_flock: bool = False):
        """Thread lock + cross-PROCESS file lock over the store: the
        fence check and the write it guards must be one atomic unit, or
        a zombie's in-flight write could land just after a newer
        incarnation claims the store (check-then-act race).  Unfenced
        stores (no claimed epoch — bare/test use) skip the file lock:
        their fence check is a no-op, so the thread lock alone is the
        pre-fencing behavior."""
        with self._lock:
            if self._writer_epoch is None and not force_flock:
                yield
                return
            if self._fence_fd is None:
                self._fence_fd = open(
                    os.path.join(self.base_dir, _FENCE_LOCK_FILE), "a+b"
                )
            fcntl.flock(self._fence_fd, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(self._fence_fd, fcntl.LOCK_UN)

    def stored_epoch(self) -> int:
        """The incarnation currently holding the store (0 = unclaimed).
        Read from disk every time: the whole point is seeing a NEWER
        claimant that may live in another process.  Routed through
        ``get`` so a damaged epoch record heals from the journal."""
        try:
            rec = self.get(CLUSTER_NS, EPOCH_KEY)
        except CorruptRecordError:
            return 0
        if not rec:
            return 0
        try:
            return int(rec.get("epoch", 0))
        except (TypeError, ValueError):
            return 0

    @property
    def writer_epoch(self) -> Optional[int]:
        return self._writer_epoch

    def claim_epoch(self) -> int:
        """Claim write authority: bump ``cluster/epoch`` and become the
        store's writer.  Every OLDER incarnation's writes are rejected
        from this moment (their next ``put``/``delete`` raises
        ``StaleEpochError``)."""
        with self._exclusive(force_flock=True):
            epoch = self.stored_epoch() + 1
            record = {"epoch": epoch}
            path = self._path(CLUSTER_NS, EPOCH_KEY)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._append_and_mirror(CLUSTER_NS, EPOCH_KEY, record, path)
            self._writer_epoch = epoch
        return epoch

    def _check_fence(self) -> None:
        if self._writer_epoch is None:
            return
        stored = self.stored_epoch()
        if stored > self._writer_epoch:
            raise StaleEpochError(
                f"property store claimed by epoch {stored}; this writer "
                f"holds stale epoch {self._writer_epoch}",
                stale=self._writer_epoch,
                current=stored,
            )

    # -- journaled mutation helpers ------------------------------------

    def _append_and_mirror(
        self, namespace: str, key: str, record: Dict[str, Any], path: str
    ) -> None:
        """WAL order, caller holds _exclusive: journal first, then the
        per-key mirror file (un-fsynced — the journal is the recovery
        source), then the in-memory state, then maybe snapshot."""
        self._journal.append(
            {"op": "put", "ns": namespace, "key": key, "record": record}
        )
        self.metrics.meter("durability.journalAppends").mark()
        atomic_write(path, json.dumps(record), fsync=False)
        with self._mem_lock:
            self._mem.setdefault(namespace, {})[key] = record
        self._maybe_snapshot()

    def _maybe_snapshot(self) -> None:
        if self._journal.should_snapshot():
            self._journal.write_snapshot(self._full_state())
            self.metrics.meter("durability.snapshots").mark()

    def snapshot_now(self) -> None:
        """Force a full-state snapshot + journal reset (backup prep)."""
        with self._exclusive():
            self._journal.write_snapshot(self._full_state())
            self.metrics.meter("durability.snapshots").mark()

    def _full_state(self) -> Dict[str, Dict[str, Any]]:
        """Disk mirror overlaid with journal state (journal wins): the
        scan picks up pre-journal legacy records, the overlay carries
        anything whose mirror write hasn't landed."""
        state = self._scan_disk_state()
        with self._mem_lock:
            for ns, records in self._mem.items():
                state.setdefault(ns, {}).update(records)
        return state

    def _scan_disk_state(self) -> Dict[str, Dict[str, Any]]:
        """Read every record file under the store into state shape.
        Unreadable records are quarantined aside and skipped (they can
        still heal later if the journal knows them)."""
        state: Dict[str, Dict[str, Any]] = {}
        for dirpath, dirnames, filenames in os.walk(self.base_dir):
            dirnames[:] = [d for d in dirnames if d != JOURNAL_DIR_NAME]
            rel = os.path.relpath(dirpath, self.base_dir)
            if rel == ".":
                continue  # records always live inside a namespace dir
            namespace = "/".join(_decode_name(p) for p in rel.split(os.sep))
            for fn in filenames:
                if not fn.endswith(".json") or ".corrupt." in fn:
                    continue
                path = os.path.join(dirpath, fn)
                try:
                    with open(path) as f:
                        record = json.load(f)
                except (ValueError, UnicodeDecodeError, OSError):
                    self._quarantine_file(path)
                    continue
                state.setdefault(namespace, {})[_decode_name(fn[: -len(".json")])] = record
        return state

    def _quarantine_file(self, path: str) -> None:
        self.metrics.meter("durability.corruptRecords").mark()
        try:
            os.replace(path, path + ".corrupt.%d" % int(time.time() * 1000))
        except OSError:
            pass

    # -- record API ----------------------------------------------------

    def put(self, namespace: str, key: str, record: Dict[str, Any]) -> None:
        path = self._path(namespace, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._exclusive():
            self._check_fence()
            self._append_and_mirror(namespace, key, record, path)

    def get(self, namespace: str, key: str) -> Optional[Dict[str, Any]]:
        path = self._path(namespace, key)
        if not os.path.exists(path):
            return self._heal_from_mem(namespace, key, path)
        try:
            with open(path) as f:
                return json.load(f)
        except (ValueError, UnicodeDecodeError, OSError) as e:
            # truncated/garbled record: quarantine the damaged file and
            # heal from the journal state if it knows this record
            self._quarantine_file(path)
            healed = self._heal_from_mem(namespace, key, path)
            if healed is not None:
                return healed
            raise CorruptRecordError(namespace, key, path, e) from e

    def _heal_from_mem(
        self, namespace: str, key: str, path: str
    ) -> Optional[Dict[str, Any]]:
        with self._mem_lock:
            rec = self._mem.get(namespace, {}).get(key)
            if rec is None:
                return None
            os.makedirs(os.path.dirname(path), exist_ok=True)
            atomic_write(path, json.dumps(rec), fsync=False)
            self.metrics.meter("durability.recordsHealed").mark()
            # round-trip so callers can't mutate the journal state
            return json.loads(json.dumps(rec))

    def delete(self, namespace: str, key: str) -> None:
        path = self._path(namespace, key)
        with self._exclusive():
            self._check_fence()
            self._journal.append({"op": "delete", "ns": namespace, "key": key})
            self.metrics.meter("durability.journalAppends").mark()
            if os.path.exists(path):
                os.unlink(path)
            with self._mem_lock:
                self._mem.get(namespace, {}).pop(key, None)
            self._maybe_snapshot()

    def list_keys(self, namespace: str) -> List[str]:
        d = self._ns_dir(namespace)
        out = set()
        if os.path.isdir(d):
            for fn in os.listdir(d):
                if not fn.endswith(".json") or ".corrupt." in fn:
                    continue
                out.add(_decode_name(fn[: -len(".json")]))
        with self._mem_lock:
            out.update(self._mem.get(namespace, {}).keys())
        return sorted(out)

    def delete_namespace(self, namespace: str) -> None:
        import shutil

        d = self._ns_dir(namespace)
        with self._exclusive():
            self._check_fence()
            self._journal.append({"op": "delete_ns", "ns": namespace})
            self.metrics.meter("durability.journalAppends").mark()
            if os.path.isdir(d):
                shutil.rmtree(d)
            prefix = namespace + "/"
            with self._mem_lock:
                for ns in [
                    n for n in self._mem if n == namespace or n.startswith(prefix)
                ]:
                    del self._mem[ns]
            self._maybe_snapshot()

    def close(self) -> None:
        self._journal.close()
