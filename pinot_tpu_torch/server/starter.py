"""Server starter: a ``ServerInstance`` joined to an in-process controller
as a participant (port of ``pinot_tpu.server.starter``, trimmed).

An ONLINE transition loads the segment file from the controller's store
(``dir``, or ``downloadUri`` through ``segment/fetcher.py``) and verifies
its column-data CRC; a matching CRC already loaded is skipped
(``SegmentFetcherAndLoader.java:84``).  With a server-local ``data_dir``
the starter keeps its own copy per segment; a copy that fails its CRC is
quarantined (moved aside, pulled from serving) and fetched again from the
controller's copy, so a bad local copy costs a download, never a wrong
answer.  CONSUMING starts the segment's consumer through the realtime
manager's ``consuming_starter`` (``realtime/llc.py``); the ONLINE
transition that follows a commit takes the committed segment in memory
(``info["segment"]``, built and CRC'd in this process).  OFFLINE and
DROPPED unload.  The table's schema (``info["schema"]``) is applied first
on every ONLINE transition, so a reload broadcast after schema evolution
patches segments already loaded with default columns
(``ServerInstance.set_table_schema``).

``residency_options`` reads the residency caps a server is started with
from the reference's environment names (``PINOT_TPU_HBM_CAP_BYTES``,
``PINOT_TPU_HOST_CAP_BYTES``, ``PINOT_TPU_STAGE_CACHE_ENTRIES``,
``PINOT_TPU_RESIDENCY_DIR``), with ``engine/config.py``'s defaults.
"""
from __future__ import annotations

import logging
import os
import tempfile
import time
from typing import Any, Dict, Optional

from pinot_tpu_torch.controller.resource_manager import (
    CONSUMING,
    DROPPED,
    OFFLINE,
    ONLINE,
    ClusterResourceManager,
    InstanceState,
    Participant,
)
from pinot_tpu_torch.engine import config
from pinot_tpu_torch.segment.fetcher import DEFAULT_FACTORY
from pinot_tpu_torch.segment.format import (
    SEGMENT_FILE_NAME,
    SegmentIntegrityError,
    SegmentStaleError,
    read_segment,
    verify_segment_crc,
)
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.segment.invindex import warm_inverted_indexes
from pinot_tpu_torch.server.instance import ServerInstance

logger = logging.getLogger(__name__)


def _int_env(name: str, default: int) -> int:
    """An integer knob from the environment; unset or junk is the default."""
    raw = os.environ.get(name)
    if raw:
        try:
            return int(float(raw))
        except ValueError:
            pass
    return default


def residency_options() -> Dict[str, Any]:
    """``ServerInstance`` keyword arguments for the residency caps, from
    the environment (module docstring)."""
    return {
        "hbm_cap_bytes": _int_env("PINOT_TPU_HBM_CAP_BYTES", config.HBM_CAP_BYTES),
        "host_cap_bytes": _int_env("PINOT_TPU_HOST_CAP_BYTES", config.HOST_CAP_BYTES),
        "stage_cache_entries": _int_env("PINOT_TPU_STAGE_CACHE_ENTRIES", config.STAGE_CACHE_ENTRIES),
        "residency_dir": os.environ.get("PINOT_TPU_RESIDENCY_DIR") or None,
    }


class ServerStarter:
    """``workload_source(tables, n)``: the prewarm worker's fleet
    workload feed (``server/prewarm.py``); an in-process harness passes a
    closure over a broker's plan statistics, and segment loads then
    trigger prewarm passes."""

    def __init__(self, server: ServerInstance, resources: ClusterResourceManager,
                 data_dir: Optional[str] = None, workload_source=None) -> None:
        self.server = server
        self.resources = resources
        # server-local segment copies; None reads the store's path directly
        # (then a quarantine only pulls the segment from serving)
        self.data_dir = data_dir
        self._local_crcs: Dict[str, int] = {}  # segment -> crc loaded
        if workload_source is not None:
            server.prewarm.workload_source = workload_source

    def start(self) -> None:
        self.resources.register_instance(
            InstanceState(self.server.name, role="server"),
            Participant(self.server.name, self.on_transition),
        )
        # replay the ideal-state transitions already targeting this server
        self.resources.reconcile_instance(self.server.name)

    def on_transition(self, table: str, segment: str, target: str, info: Dict[str, Any]) -> bool:
        if target == ONLINE:
            return self._load(table, segment, info)
        if target == CONSUMING:
            starter = info.get("consuming_starter")
            return starter is not None and bool(starter(self.server, table, segment, info))
        if target in (OFFLINE, DROPPED):
            self.server.remove_segment(table, segment)
            self._local_crcs.pop(segment, None)
            return True
        return False

    def _load(self, table: str, segment: str, info: Dict[str, Any]) -> bool:
        meta = info.get("metadata")
        crc = meta.crc if meta is not None else None
        # the schema applies on the CRC-skip path too: a reload after schema
        # evolution patches the loaded segments without reading any bytes
        schema = info.get("schema")
        if schema is not None:
            self.server.set_table_schema(table, schema)
        tdm = self.server.data_manager.table(table)
        if tdm is not None and segment in tdm.segment_names() and crc is not None \
                and self._local_crcs.get(segment) == crc:
            return True  # this CRC is already loaded
        t0 = time.perf_counter()
        seg_obj = info.get("segment")  # a realtime commit, handed over in memory
        if seg_obj is None:
            seg_obj = self._load_from_store(table, segment, info, crc)
            if seg_obj is None:
                return False
        self.server.add_segment(table, seg_obj)
        # the table config's invertedIndexColumns: postings built at load
        warm_inverted_indexes(seg_obj, info.get("invertedIndexColumns"))
        self.server.metrics.timer("segmentLoad").update((time.perf_counter() - t0) * 1000)
        if crc is not None:
            self._local_crcs[segment] = crc
        return True

    def _load_from_store(self, table: str, segment: str, info: Dict[str, Any],
                         crc: Optional[int]) -> Optional[ImmutableSegment]:
        path = info.get("dir")
        uri = info.get("downloadUri")
        if path is None and uri is None:
            logger.error("segment %s/%s has no download info", table, segment)
            return None
        if self.data_dir is not None and uri is not None:
            return self._load_via_local_copy(table, segment, uri, crc)
        try:
            if path is not None:
                seg_obj = read_segment(path)
                verify_segment_crc(seg_obj, source=path)
                return seg_obj
            with tempfile.TemporaryDirectory() as td:
                seg_obj = DEFAULT_FACTORY.fetch(uri, os.path.join(td, SEGMENT_FILE_NAME), expected_crc=crc)
                if seg_obj is None:  # no crc to expect: hold the copy to its own claim
                    seg_obj = read_segment(td)
                    verify_segment_crc(seg_obj, source=uri)
            return seg_obj
        except SegmentIntegrityError:
            # a corrupt shared copy is the controller's to repair: pull the
            # segment from serving, never rename a directory not ours
            self.server.record_crc_failure(table, segment)
            self.server.quarantine_segment(table, segment)
            logger.exception("segment %s/%s failed integrity verification at %s",
                             table, segment, path or uri)
            return None
        except Exception:
            logger.exception("failed to load %s/%s from %s", table, segment, path or uri)
            return None

    def _load_via_local_copy(self, table: str, segment: str, uri: str,
                             crc: Optional[int]) -> Optional[ImmutableSegment]:
        """Load the server-local copy, fetching it from the controller's copy
        as needed.  One quarantine and re-fetch heals a bad local copy; a
        second failure means the source is bad, and the segment stays out
        of serving."""
        d = os.path.join(self.data_dir, table, segment)
        fpath = os.path.join(d, SEGMENT_FILE_NAME)
        for attempt in (0, 1):
            try:
                if not os.path.exists(fpath):
                    os.makedirs(d, exist_ok=True)
                    fetched = DEFAULT_FACTORY.fetch(uri, fpath, expected_crc=crc)
                    if fetched is not None:
                        return fetched
                seg_obj = read_segment(d)
                if crc is not None and seg_obj.metadata.crc and seg_obj.metadata.crc != crc:
                    # another version, not corruption: replace it quietly
                    os.remove(fpath)
                    if attempt:
                        return None
                    continue
                verify_segment_crc(seg_obj, source=fpath)
                return seg_obj
            except SegmentStaleError:
                logger.warning("segment %s/%s: the controller's copy at %s is another version",
                               table, segment, uri)
                return None
            except SegmentIntegrityError:
                self.server.record_crc_failure(table, segment)
                quarantine_local_copy(self.server, table, segment, d)
                if attempt:
                    logger.exception("segment %s/%s corrupt after re-fetch from %s", table, segment, uri)
                    return None
                logger.warning("segment %s/%s: local copy corrupt; quarantined, re-fetching from %s",
                               table, segment, uri)
            except Exception:
                logger.exception("failed to load %s/%s from %s", table, segment, uri)
                return None
        return None


def quarantine_local_copy(server: ServerInstance, table: str, segment: str, d: str) -> None:
    """Move a corrupt server-local copy aside (out of every load path,
    kept for inspection) and pull the segment from serving; with no copy
    on disk, only pull it."""
    if os.path.exists(os.path.join(d, SEGMENT_FILE_NAME)):
        server.quarantine_segment(table, segment)
        try:
            os.rename(d, f"{d}.quarantined.{int(time.time() * 1000)}")
        except OSError:
            logger.exception("could not quarantine %s", d)
    else:
        server.remove_segment(table, segment)
