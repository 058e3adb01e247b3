"""Cluster backup and disaster restore (``python -m
pinot_tpu_torch.tools.backup``; port of ``pinot_tpu.tools.backup``).

The reference survives the loss of a controller host because its durable
state lives elsewhere: the cluster metadata in the ZooKeeper ensemble, the
segment bytes in the deep store.  Here both sit under the controller's
data directory, so this tool is the missing leg: a consistent online
backup of the metadata plane (the property store's record mirror, its
journal and snapshot) with a manifest of the deep store's segments and
their byte-level CRCs, and a restore that rebuilds a new controller from
the archive and the deep store alone.

Consistency while the cluster serves: every property-store mutation runs
under the store's cross-process fence flock (``.fence.lock``), so holding
that flock while the metadata is copied gives a point-in-time image.
Segment files are immutable once written (a temporary file, then a
rename), so the manifest pass takes no lock.

A restore puts the archive's metadata into the data directory and checks
the deep store against the manifest: a missing or rotted copy is
reported, and the ``DeepStoreScrubber`` heals it later from a live
server.  A new ``Controller`` over the restored directory claims the epoch
after the journaled one, so a controller from before the disaster is
still fenced off.  The archive's layout is the reference's: an archive
written by either package restores in the other.
"""
from __future__ import annotations

import argparse
import fcntl
import json
import os
import shutil
import sys
import tarfile
import tempfile
import time
import zlib
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.controller.journal import JOURNAL_DIR_NAME, LOG_NAME, SNAPSHOT_NAME
from pinot_tpu_torch.controller.store import SegmentStore

MANIFEST_NAME = "MANIFEST.json"
METADATA_PREFIX = "metadata"
_FENCE_LOCK_FILE = ".fence.lock"


def _copy_metadata_consistent(ps_dir: str, staging: str) -> None:
    """Copy the property-store tree under its own fence flock: writers take
    the same lock for each mutation, so the image is point-in-time."""
    lock_path = os.path.join(ps_dir, _FENCE_LOCK_FILE)
    with open(lock_path, "a+b") as lock_fd:
        fcntl.flock(lock_fd, fcntl.LOCK_EX)
        try:
            shutil.copytree(ps_dir, staging, ignore=shutil.ignore_patterns(_FENCE_LOCK_FILE, "*.tmp"))
        finally:
            fcntl.flock(lock_fd, fcntl.LOCK_UN)


def _staged_journal_info(staging: str) -> Dict[str, Any]:
    jdir = os.path.join(staging, JOURNAL_DIR_NAME)
    log = os.path.join(jdir, LOG_NAME)
    snap = os.path.join(jdir, SNAPSHOT_NAME)
    info: Dict[str, Any] = {"journalBytes": 0, "snapshotSeq": 0}
    if os.path.exists(log):
        info["journalBytes"] = os.path.getsize(log)
    if os.path.exists(snap):
        try:
            with open(snap) as f:
                info["snapshotSeq"] = int(json.load(f).get("seq", 0))
        except (ValueError, OSError):
            pass
    return info


def _staged_epoch(staging: str) -> int:
    try:
        with open(os.path.join(staging, "cluster", "epoch.json")) as f:
            return int(json.load(f).get("epoch", 0))
    except (ValueError, OSError):
        return 0


def create_backup(data_dir: str, out_path: str) -> Dict[str, Any]:
    """Write a consistent ``.tar.gz`` archive of the metadata plane and a
    CRC'd manifest of the deep store, while the cluster serves."""
    t0 = time.monotonic()
    ps_dir = os.path.join(data_dir, "property_store")
    if not os.path.isdir(ps_dir):
        raise FileNotFoundError(f"no property store at {ps_dir}")
    staging = tempfile.mkdtemp(prefix="pinot_backup_")
    staged_meta = os.path.join(staging, METADATA_PREFIX)
    try:
        _copy_metadata_consistent(ps_dir, staged_meta)
        manifest: Dict[str, Any] = {
            "version": 1,
            "createdAtMs": int(time.time() * 1000),
            "epoch": _staged_epoch(staged_meta),
            "segments": SegmentStore(os.path.join(data_dir, "segments")).manifest(),
        }
        manifest.update(_staged_journal_info(staged_meta))
        manifest_path = os.path.join(staging, MANIFEST_NAME)
        with open(manifest_path, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        tmp_out = out_path + ".tmp"
        with tarfile.open(tmp_out, "w:gz") as tar:
            tar.add(manifest_path, arcname=MANIFEST_NAME)
            tar.add(staged_meta, arcname=METADATA_PREFIX)
        os.replace(tmp_out, out_path)
    finally:
        shutil.rmtree(staging, ignore_errors=True)
    return {
        "archive": out_path,
        "archiveBytes": os.path.getsize(out_path),
        "journalBytes": manifest["journalBytes"],
        "snapshotSeq": manifest["snapshotSeq"],
        "epoch": manifest["epoch"],
        "segments": sum(len(v) for v in manifest["segments"].values()),
        "backupSeconds": time.monotonic() - t0,
    }


def _safe_members(tar: tarfile.TarFile) -> List[tarfile.TarInfo]:
    """The archive's members, refusing path traversal (absolute paths,
    ``..`` components, links) before anything is extracted."""
    out = []
    for m in tar.getmembers():
        name = m.name
        if name.startswith("/") or os.path.isabs(name):
            raise ValueError(f"unsafe archive member (absolute): {name}")
        if any(part == ".." for part in name.split("/")):
            raise ValueError(f"unsafe archive member (traversal): {name}")
        if m.issym() or m.islnk():
            raise ValueError(f"unsafe archive member (link): {name}")
        out.append(m)
    return out


def restore_backup(archive_path: str, data_dir: str, overwrite: bool = False) -> Dict[str, Any]:
    """Rebuild the metadata plane from an archive and check the deep store
    against the manifest.

    Builds no controller: the caller starts a new ``Controller(data_dir)``
    afterwards, which replays the restored snapshot and journal, claims
    the next epoch and recovers the tables, ideal states, drain flags and
    realtime offsets."""
    t0 = time.monotonic()
    ps_dir = os.path.join(data_dir, "property_store")
    if os.path.isdir(ps_dir) and os.listdir(ps_dir) and not overwrite:
        raise FileExistsError(f"refusing to restore over non-empty {ps_dir} (pass overwrite)")
    with tarfile.open(archive_path, "r:gz") as tar:
        members = _safe_members(tar)
        with tempfile.TemporaryDirectory(prefix="pinot_restore_") as td:
            tar.extractall(td, members=members)
            with open(os.path.join(td, MANIFEST_NAME)) as f:
                manifest = json.load(f)
            extracted_meta = os.path.join(td, METADATA_PREFIX)
            if not os.path.isdir(extracted_meta):
                raise ValueError(f"archive {archive_path} has no metadata tree")
            if os.path.isdir(ps_dir):
                shutil.rmtree(ps_dir)
            os.makedirs(os.path.dirname(os.path.abspath(ps_dir)), exist_ok=True)
            shutil.copytree(extracted_meta, ps_dir)

    # the deep store against the manifest's byte-level CRCs: damage is
    # reported (the scrubber heals it later), never fatal
    store = SegmentStore(os.path.join(data_dir, "segments"))
    verified = 0
    missing: List[str] = []
    corrupt: List[str] = []
    for table, segs in (manifest.get("segments") or {}).items():
        for seg, entry in segs.items():
            path = store.segment_file_path(table, seg)
            if not os.path.exists(path):
                missing.append(f"{table}/{seg}")
                continue
            with open(path, "rb") as f:
                crc = zlib.crc32(f.read()) & 0xFFFFFFFF
            if int(entry.get("crc32", 0)) not in (0, crc):
                corrupt.append(f"{table}/{seg}")
                continue
            verified += 1
    return {
        "restored": True,
        "archive": archive_path,
        "epoch": manifest.get("epoch", 0),
        "snapshotSeq": manifest.get("snapshotSeq", 0),
        "journalBytes": manifest.get("journalBytes", 0),
        "segmentsVerified": verified,
        "segmentsMissing": missing,
        "segmentsCorrupt": corrupt,
        "restoreSeconds": time.monotonic() - t0,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("backup", help="write a consistent archive of a live cluster")
    b.add_argument("--data-dir", required=True)
    b.add_argument("--out", required=True, help="archive path (.tar.gz)")
    r = sub.add_parser("restore", help="rebuild a data dir's metadata from an archive")
    r.add_argument("--archive", required=True)
    r.add_argument("--data-dir", required=True)
    r.add_argument("--overwrite", action="store_true")
    args = ap.parse_args(argv)
    if args.cmd == "backup":
        out = create_backup(args.data_dir, args.out)
    else:
        out = restore_backup(args.archive, args.data_dir, overwrite=args.overwrite)
    json.dump(out, sys.stdout, indent=2, sort_keys=True)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
