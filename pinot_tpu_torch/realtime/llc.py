"""LLC (low-level consumer) realtime coordination (port of
``pinot_tpu.realtime.llc``, without the high-level consumer groups).

The reference's three-way exchange:

- server: ``LLRealtimeSegmentDataManager.java:68``, one consumer a
  stream partition, appends into a mutable segment up to a row
  threshold, then reports ``segmentConsumed(offset)`` to the controller;
- controller: ``SegmentCompletionManager.java:45-54``, one FSM a
  consuming segment (HOLDING -> COMMITTER_DECIDED -> COMMITTER_UPLOADING
  -> COMMITTED), picks the replica at the largest offset as committer and
  answers each replica HOLD / CATCH_UP / COMMIT / KEEP / DISCARD /
  NOT_LEADER (``SegmentCompletionProtocol.java:63-105``);
- commit: the committer converts its mutable segment to an immutable one
  and uploads it; the controller stores it with its exact start and end
  offsets (the checkpoint), turns the replicas ONLINE (laggards load the
  committed copy) and opens the next CONSUMING segment at the end offset.
  ``ensure_consuming_segments`` recreates a missing CONSUMING segment at
  the last committed end offset (the ValidationManager's repair).

Segment names are ``{table}__{partition}__{seq}`` (LLCSegmentName).
Left out, ROADMAP queue 1 item 29: the high-level consumer groups, the
freshness watermarks; item 30: the property store, so a restarted
controller does not recover a table's consumption.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from pinot_tpu_torch.common.fencing import StaleEpochError, epoch_int
from pinot_tpu_torch.broker.freshness import WATERMARKS, batch_max_event_ms, now_ms
from pinot_tpu_torch.common.schema import Schema, time_unit_to_millis
from pinot_tpu_torch.common.tableconfig import TableConfig
from pinot_tpu_torch.controller.resource_manager import CONSUMING, ONLINE, ClusterResourceManager
from pinot_tpu_torch.realtime.mutable import MutableSegment
from pinot_tpu_torch.realtime.stream import LagProbe, StreamProvider, describe_stream
from pinot_tpu_torch.segment.immutable import SegmentMetadata

logger = logging.getLogger(__name__)

MAX_HOLD_TIME_MS = 3000  # SegmentCompletionProtocol.java:50


def _commit_stall_ms() -> float:
    """How long an elected committer may go protocol-silent (no
    segmentConsumed/segmentCommit calls) before the FSM re-elects a
    caught-up replica (the reference's max-segment-commit-time,
    ``controller.realtime.segment.commit.timeoutSeconds``).  Lease
    validity alone cannot catch this: under a ONE-WAY partition the
    victim's heartbeats keep renewing its controller-side lease while
    its self-fenced commit plane is frozen."""
    return float(os.environ.get("PINOT_TPU_COMMIT_STALL_S", "120")) * 1000.0

# FSM states (SegmentCompletionManager.java:48-54)
HOLDING = "HOLDING"
COMMITTER_DECIDED = "COMMITTER_DECIDED"
COMMITTER_UPLOADING = "COMMITTER_UPLOADING"
COMMITTED = "COMMITTED"

# responses (SegmentCompletionProtocol.java:63-105)
RESP_HOLD = "HOLD"
RESP_CATCH_UP = "CATCH_UP"
RESP_DISCARD = "DISCARD"
RESP_KEEP = "KEEP"
RESP_COMMIT = "COMMIT"
RESP_NOT_LEADER = "NOT_LEADER"


def make_segment_name(table: str, partition: int, seq: int) -> str:
    return f"{table}__{partition}__{seq}"


def parse_segment_name(name: str) -> Tuple[str, int, int]:
    table, partition, seq = name.rsplit("__", 2)
    return table, int(partition), int(seq)


class _SegmentFsm:
    def __init__(self, num_replicas: int) -> None:
        self.state = HOLDING
        self.num_replicas = num_replicas
        self.offsets: Dict[str, int] = {}
        self.committer: Optional[str] = None
        self.target_offset: Optional[int] = None
        self.final_offset: Optional[int] = None
        self.first_report_ms: Optional[float] = None
        self.commit_inflight = False  # an upload is being persisted
        # last protocol call from the elected committer (stall detector)
        self.committer_activity_ms: Optional[float] = None


class SegmentCompletionManager:
    """Controller-side commit FSM (SegmentCompletionManager.java:45).

    Partition fencing: every protocol call may carry the caller's
    serving-lease ``epoch`` (the controller incarnation that granted
    it); a mismatch against this controller's epoch raises a typed
    ``StaleEpochError`` — a committer leased by a dead controller
    cannot commit into a live one, and a zombie controller cannot
    accept commits leased by its successor.  ``lease_checker`` (wired
    by the Controller to ``ParticipantGateway.server_lease_valid``)
    lets the FSM re-elect when the chosen committer's lease expires
    mid-protocol (partitioned away mid-upload) instead of holding the
    partition's commit hostage forever; the commit-stall window
    (``PINOT_TPU_COMMIT_STALL_S``) re-elects a committer whose lease
    stays controller-side valid but whose commit plane went silent
    (one-way partition: heartbeats arrive, replies are lost)."""

    def __init__(self, realtime_manager: "RealtimeSegmentManager") -> None:
        self.rm = realtime_manager
        self._fsm: Dict[str, _SegmentFsm] = {}
        self._lock = threading.Lock()
        # (server) -> bool: does this replica still hold a valid
        # serving lease?  None = no lease plane (in-process harness).
        self.lease_checker = None
        self.commit_stall_ms = _commit_stall_ms()
        self.clock = time.time  # injectable for stall/hold tests

    def _get(self, segment: str) -> _SegmentFsm:
        fsm = self._fsm.get(segment)
        if fsm is None:
            replicas = self.rm.resources.get_ideal_state(
                self.rm.physical_table_of(segment)
            ).get(segment, {})
            fsm = _SegmentFsm(max(len(replicas), 1))
            self._fsm[segment] = fsm
        return fsm

    def _mark(self, name: str) -> None:
        metrics = getattr(self.rm, "metrics", None)
        if metrics is not None:
            metrics.meter(name).mark()

    def _check_epoch(self, epoch) -> None:
        """Reject a protocol call fenced off by controller failover.
        Unarmed when either side has no epoch (legacy / in-process)."""
        current = getattr(self.rm, "epoch", None)
        if current is None or epoch is None:
            return
        e = epoch_int(epoch)
        if e == -1:
            return
        if e != int(current):
            self._mark("fence.staleEpochRejections")
            # direction-aware message (fields keep their wire meaning:
            # staleEpoch = caller's, currentEpoch = this controller's):
            # an operator debugging the 409 must be pointed at the side
            # that is actually fenced off
            if e < int(current):
                msg = (
                    f"commit-plane call under stale lease epoch {e}; "
                    f"controller epoch is {current}"
                )
            else:
                msg = (
                    f"commit-plane call under lease epoch {e} from a "
                    f"newer controller incarnation; this controller "
                    f"(epoch {current}) is the fenced-off zombie"
                )
            raise StaleEpochError(msg, stale=e, current=int(current))

    def _committer_leased(self, fsm: _SegmentFsm) -> bool:
        if self.lease_checker is None or fsm.committer is None:
            return True
        try:
            return bool(self.lease_checker(fsm.committer))
        except Exception:  # a broken probe must not wedge the protocol
            return True

    def segment_consumed(
        self, segment: str, server: str, offset: int, epoch=None
    ) -> Tuple[str, Optional[int]]:
        """A replica hit its threshold at ``offset``. Returns
        (response, target_offset)."""
        self._check_epoch(epoch)
        with self._lock:
            fsm = self._get(segment)
            now = self.clock() * 1000

            if fsm.state == COMMITTED:
                if offset == fsm.final_offset:
                    return RESP_KEEP, fsm.final_offset
                return RESP_DISCARD, fsm.final_offset

            fsm.offsets[server] = offset
            if fsm.first_report_ms is None:
                fsm.first_report_ms = now

            if fsm.state == HOLDING:
                all_reported = len(fsm.offsets) >= fsm.num_replicas
                hold_expired = now - fsm.first_report_ms > MAX_HOLD_TIME_MS
                if not (all_reported or hold_expired):
                    return RESP_HOLD, None
                # decide committer: max offset wins (ties -> name order)
                fsm.committer = max(fsm.offsets, key=lambda s: (fsm.offsets[s], s))
                fsm.target_offset = fsm.offsets[fsm.committer]
                fsm.committer_activity_ms = now
                fsm.state = COMMITTER_DECIDED

            if fsm.state in (COMMITTER_DECIDED, COMMITTER_UPLOADING):
                assert fsm.target_offset is not None
                if server == fsm.committer:
                    fsm.committer_activity_ms = now
                if offset < fsm.target_offset:
                    return RESP_CATCH_UP, fsm.target_offset
                stalled = (
                    fsm.committer_activity_ms is not None
                    and now - fsm.committer_activity_ms > self.commit_stall_ms
                )
                if (
                    server != fsm.committer
                    and not fsm.commit_inflight
                    and (stalled or not self._committer_leased(fsm))
                ):
                    # committer failover: the elected committer's
                    # serving lease expired (partitioned away / died
                    # mid-upload), OR it went protocol-silent past the
                    # commit-stall window — under a ONE-WAY partition
                    # its heartbeats keep the controller-side lease
                    # alive while its self-fenced commit plane freezes,
                    # so lease validity alone cannot detect it.  No
                    # upload is being persisted — re-elect this
                    # caught-up replica.  The old committer's late
                    # segmentCommit lands on ``committer != server``
                    # below: NOT_LEADER, no double commit.
                    logger.warning(
                        "committer %s for %s %s; re-electing %s",
                        fsm.committer, segment,
                        "stalled past the commit window" if stalled
                        else "lost its lease",
                        server,
                    )
                    self._mark("fence.committerReElections")
                    fsm.committer = server
                    fsm.committer_activity_ms = now
                    fsm.state = COMMITTER_DECIDED
                if server == fsm.committer and not fsm.commit_inflight:
                    # COMMITTER_UPLOADING here (not inflight) means a
                    # previous commit attempt FAILED (e.g. the
                    # controller had just restarted): re-issue COMMIT so
                    # the committer retries instead of holding forever.
                    # While an upload is actually being persisted the
                    # committer holds — no duplicate commit.
                    fsm.state = COMMITTER_UPLOADING
                    return RESP_COMMIT, fsm.target_offset
                return RESP_HOLD, fsm.target_offset
        return RESP_HOLD, None

    def commit_fence_check(self, segment: str, server: str, epoch=None):
        """Cheap pre-upload fence: raises the typed ``StaleEpochError``
        or returns ``NOT_LEADER`` for a caller with no write authority,
        so the HTTP surface can reject a fenced upload before buffering
        and parsing megabytes of segment body.  Advisory only — the
        authoritative fences re-run under the lock in
        ``segment_commit`` (a lease can expire between the two)."""
        self._check_epoch(epoch)
        with self._lock:
            fsm = self._fsm.get(segment)
            if fsm is not None and fsm.committer == server:
                # upload starting: the body transfer that follows can
                # legitimately outlast the commit-stall window — stamp
                # activity NOW so a slow upload isn't mistaken for a
                # silent (partitioned) committer and re-elected away
                fsm.committer_activity_ms = self.clock() * 1000
        if self.lease_checker is not None:
            try:
                leased = bool(self.lease_checker(server))
            except Exception:
                leased = True
            if not leased:
                self._mark("fence.leaseRejections")
                return RESP_NOT_LEADER
        return None

    def segment_commit(self, segment: str, server: str, committed, epoch=None) -> str:
        """Committer uploads its converted segment (segmentCommit).

        The FSM flips to COMMITTED only AFTER the metadata/ideal-state
        persistence succeeds — a failure (controller freshly restarted,
        replica not re-registered yet) leaves the FSM in
        COMMITTER_UPLOADING so the committer's next segmentConsumed
        retries the commit rather than wedging on KEEP/HOLD.

        Fencing order: stale epoch raises (typed), an expired lease is
        NOT_LEADER (the replica may retry after renewing), and a
        non-committer is NOT_LEADER — so a committer partitioned away
        mid-upload can never land a second copy after re-election.
        """
        self._check_epoch(epoch)
        with self._lock:
            fsm = self._get(segment)
            if server == fsm.committer:
                fsm.committer_activity_ms = self.clock() * 1000
            if self.lease_checker is not None:
                try:
                    leased = bool(self.lease_checker(server))
                except Exception:
                    leased = True
                if not leased:
                    # lease fence FIRST (even over the COMMITTED
                    # short-circuit): an upload arriving without write
                    # authority is always rejected — the replica must
                    # renew its lease and learn the final verdict via
                    # segmentConsumed (KEEP/DISCARD) instead
                    self._mark("fence.leaseRejections")
                    return RESP_NOT_LEADER
            if fsm.state == COMMITTED:
                return RESP_KEEP  # duplicate upload after a lost reply
            if fsm.committer != server or fsm.state != COMMITTER_UPLOADING:
                return RESP_NOT_LEADER
            if fsm.commit_inflight:
                # a previous upload of this segment is still being
                # persisted (slow request + client retry): hold rather
                # than run on_segment_committed twice concurrently
                return RESP_HOLD
            fsm.commit_inflight = True
        try:
            self.rm.on_segment_committed(segment, committed)
        except Exception:
            with self._lock:
                fsm.commit_inflight = False
            raise
        with self._lock:
            fsm.commit_inflight = False
            fsm.state = COMMITTED
            fsm.final_offset = fsm.target_offset
        return RESP_KEEP


class RealtimeSegmentManager:
    """Controller-side realtime coordinator (PinotLLCRealtimeSegmentManager):
    creates CONSUMING segments, stores commits, opens the next sequence."""

    def __init__(self, resources: ClusterResourceManager, store, metrics=None) -> None:
        self.resources = resources
        self.store = store
        # optional ControllerMetrics: segmentCommits and segmentCommitMs
        self.metrics = metrics
        # optional IngestConsumerPool (realtime/pool.py): when set, every
        # in-process consumer made here is driven by the pool's workers
        # instead of waiting for consume_step calls
        self.ingest_pool = None
        # the controller's fencing incarnation: arms the epoch fence of
        # SegmentCompletionManager
        self.epoch: Optional[int] = None
        if metrics is not None:
            metrics.meter("segmentCommits")
            metrics.timer("segmentCommitMs")
        self.completion = SegmentCompletionManager(self)
        self._tables: Dict[str, Dict[str, Any]] = {}  # physical -> {schema, stream, config}
        self._consumers: Dict[Tuple[str, str], "RealtimeSegmentDataManager"] = {}
        self._lock = threading.Lock()
        # serializes consuming-segment creation: a commit's rollover and
        # the validation repair race the check-then-create otherwise
        self._create_lock = threading.Lock()
        # a deleted segment's in-process consumers stop with it, so a later
        # CONSUMING transition of the same name consumes afresh from its
        # start offset instead of resuming a mutable no server hosts
        resources.segment_deleted_listeners.append(self.release_segment_consumers)

    # -- setup ---------------------------------------------------------
    def setup_table(self, config: TableConfig, schema: Schema, stream: StreamProvider) -> str:
        physical = self.resources.add_table(config)
        with self._lock:
            self._tables[physical] = {"schema": schema, "stream": stream, "config": config}
        for partition in range(stream.partition_count()):
            self._create_consuming_segment(physical, partition, seq=0, start_offset=0)
        return physical

    def update_schema(self, raw_name: str, schema: Schema) -> List[str]:
        """Schema evolution of the realtime tables on ``raw_name``: the
        stored schema is swapped, so the NEXT segment's rollover consumes
        with the grown schema (CONSUMING transitions carry it as
        schemaJson).  The consuming segment keeps its frozen schema; its
        rows get default columns when it seals, as in the reference."""
        updated = []
        with self._lock:
            for physical, tinfo in self._tables.items():
                if tinfo["config"].raw_name == raw_name:
                    tinfo["schema"] = schema
                    updated.append(physical)
        return updated

    def physical_table_of(self, segment: str) -> str:
        return parse_segment_name(segment)[0]

    def _rows_per_segment(self, tinfo: Dict[str, Any]) -> int:
        stream = tinfo["config"].stream
        return stream.rows_per_segment if stream else 100_000

    def _create_consuming_segment(self, physical: str, partition: int, seq: int, start_offset: int) -> str:
        name = make_segment_name(physical, partition, seq)
        with self._create_lock:
            if name in self.resources.get_ideal_state(physical):
                return name  # idempotent: a concurrent path created it
            return self._create_consuming_segment_locked(physical, partition, seq, start_offset, name)

    def _create_consuming_segment_locked(self, physical: str, partition: int, seq: int, start_offset: int,
                                         name: str) -> str:
        meta = SegmentMetadata(
            segment_name=name,
            table_name=physical,
            num_docs=0,
            custom={"partition": partition, "seq": seq, "startOffset": start_offset, "status": "IN_PROGRESS"},
        )
        info: Dict[str, Any] = {
            "consuming_starter": self._start_consumer,
            "partition": partition,
            "startOffset": start_offset,
        }
        # the consume spec, serializable: a server process starts its
        # consumer from the transition message alone
        with self._lock:
            tinfo = self._tables.get(physical)
        if tinfo is not None:
            desc = describe_stream(tinfo["stream"])
            if desc is not None:
                info["streamDescriptor"] = desc
            info["rowsPerSegment"] = self._rows_per_segment(tinfo)
            info["schemaJson"] = tinfo["schema"].to_json()
        self.resources.add_segment(physical, meta, info, target_state=CONSUMING)
        return name

    # -- server-side consumer creation (the in-process CONSUMING transition)
    def _start_consumer(self, server_instance, table: str, segment: str, info: Dict[str, Any]) -> bool:
        with self._lock:
            tinfo = self._tables.get(table)
            if (segment, server_instance.name) in self._consumers:
                return True  # already consuming; don't reset the offset
        if tinfo is None:
            return False
        dm = RealtimeSegmentDataManager(
            server=server_instance,
            manager=self,
            table=table,
            segment_name=segment,
            schema=tinfo["schema"],
            stream=tinfo["stream"],
            partition=int(info["partition"]),
            start_offset=int(info["startOffset"]),
            rows_per_segment=self._rows_per_segment(tinfo),
        )
        with self._lock:
            self._consumers[(segment, server_instance.name)] = dm
        server_instance.add_segment(table, dm.mutable)
        pool = self.ingest_pool
        if pool is not None:
            pool.add(dm, key=(segment, server_instance.name))
        return True

    def consumers_of(self, segment: str) -> List["RealtimeSegmentDataManager"]:
        with self._lock:
            return [dm for (seg, _), dm in self._consumers.items() if seg == segment]

    def release_segment_consumers(self, segment: str, server: Optional[str] = None) -> None:
        """Stop and forget the in-process consumers of ``segment``: all, or
        only ``server``'s."""
        with self._lock:
            for key in [k for k in self._consumers if k[0] == segment and (server is None or k[1] == server)]:
                self._consumers[key].stop()
                del self._consumers[key]
                if self.ingest_pool is not None:
                    self.ingest_pool.remove(key)

    # -- commit --------------------------------------------------------
    def on_segment_committed(self, segment: str, committed) -> None:
        t0 = time.perf_counter()
        physical, partition, seq = parse_segment_name(segment)
        path = self.store.save(physical, committed)
        end_offset = committed.metadata.custom.get("endOffset", 0)
        # the offset checkpoint, then every replica ONLINE
        with self.resources._lock:
            self.resources.segment_metadata[(physical, segment)] = {
                "metadata": committed.metadata,
                "dir": path,
                "segment": committed,
            }
            replicas = self.resources.ideal_states[physical].get(segment, {})
            for server in replicas:
                replicas[server] = ONLINE
        for server in list(replicas):
            self.resources._execute_transition(physical, segment, server, ONLINE)
        self.resources._notify_view(physical)
        self.release_segment_consumers(segment)
        if self.metrics is not None:
            self.metrics.meter("segmentCommits").mark()
            self.metrics.timer("segmentCommitMs").update((time.perf_counter() - t0) * 1000)
        # the next consuming segment at the committed end offset; a failure
        # (no live replica) must not fail the commit: the validation repair
        # (ensure_consuming_segments) recreates it
        try:
            self._create_consuming_segment(physical, partition, seq + 1, int(end_offset))
        except Exception as e:
            logger.warning("could not open next consuming segment for %s partition %d "
                           "(validation repair will retry): %s", physical, partition, e)

    # -- validation hook ----------------------------------------------
    def ensure_consuming_segments(self) -> None:
        """Recreate missing CONSUMING segments (ValidationManager.java:64's
        LLC repair) at the next sequence after the last stored one, from
        its end offset."""
        with self._lock:
            tables = list(self._tables.keys())
        for physical in tables:
            ideal = self.resources.get_ideal_state(physical)
            with self._lock:
                stream = self._tables[physical]["stream"]
            for partition in range(stream.partition_count()):
                has_consuming = False
                max_seq, max_end = -1, 0
                for seg, replicas in ideal.items():
                    try:
                        _, p, seq = parse_segment_name(seg)
                    except ValueError:
                        continue
                    if p != partition:
                        continue
                    if any(st == CONSUMING for st in replicas.values()):
                        has_consuming = True
                    info = self.resources.get_segment_metadata(physical, seg)
                    if info and info.get("metadata") is not None and seq > max_seq:
                        max_seq = seq
                        max_end = int(info["metadata"].custom.get("endOffset", 0))
                if not has_consuming:
                    logger.info("validation: recreating consuming segment %s p%d seq%d @%d",
                                physical, partition, max_seq + 1, max_end)
                    self._create_consuming_segment(physical, partition, max_seq + 1, max_end)


def attach_freshness(consumer, server, schema: Schema) -> None:
    """The event-time freshness and result-cache hooks of a consumer (a
    ``RealtimeSegmentDataManager`` or a networked ``RemoteConsumer``, with
    its ``table`` and ``partition`` set): every indexed batch advances the
    process-wide (table, partition) watermark (``broker/freshness.py``) to
    its time column's maximum, and every offset advance drops the table's
    cached answers (``engine/rescache.py``).  The per-partition gauge
    ``freshness.lag.<table>.p<n>`` (now minus the watermark, ms) is
    registered again at a rollover, so its series is continuous."""
    consumer._result_cache = getattr(server, "result_cache", None)
    consumer._time_col = schema.time_column_name
    consumer._time_unit_ms = (
        time_unit_to_millis(schema.time_field.time_unit) if schema.time_field is not None else None
    )
    consumer._freshness_gauge_name = f"freshness.lag.{consumer.table}.p{consumer.partition}"

    def probe(_t=consumer.table, _p=consumer.partition):
        w = WATERMARKS.get(_t, _p)
        return round(max(0.0, now_ms() - w), 3) if w is not None else 0

    consumer._freshness_fn = probe
    metrics = getattr(server, "metrics", None)
    if metrics is not None and consumer._time_col is not None:
        metrics.gauge(consumer._freshness_gauge_name).set_fn(probe)


def detach_freshness(consumer, metrics) -> None:
    """A stopped consumer's watermark gauge leaves its registry (the
    equality guard of ``clear_fn`` keeps a successor's series)."""
    if metrics is not None:
        metrics.gauge(consumer._freshness_gauge_name).clear_fn(consumer._freshness_fn)


def _advance_watermark(consumer, time_values) -> None:
    """One indexed batch's event-time watermark advance (monotone: a
    replay never moves it back)."""
    if consumer._time_unit_ms is None:
        return
    event_ms = batch_max_event_ms(time_values, consumer._time_unit_ms)
    if event_ms is not None:
        WATERMARKS.advance(consumer.table, consumer.partition, event_ms)


def _notify_offset_advance(consumer) -> None:
    """The consume offset moved: every answer cached over the table's
    previous watermark is superseded (the staging-token key already made
    those entries unreachable; this drops them at once)."""
    cache = consumer._result_cache
    if cache is not None and cache.enabled:
        cache.on_offset_advance(consumer.table, consumer.partition, consumer.offset)


def fetch_and_index(consumer, limit: int) -> int:
    """One fetch and index of ``consumer`` (a ``RealtimeSegmentDataManager``
    or a networked ``RemoteConsumer``: its ``stream``, ``partition``,
    ``offset``, ``mutable`` and ``_columnar``), preferring the columnar
    block path where the stream and partition have it (netstream's
    producec topics: np.frombuffer and a vectorized dictionary encode).
    Returns the rows consumed and advances the offset, the watermark and
    the result cache's offset fence (``attach_freshness``)."""
    fetch_cols = getattr(consumer.stream, "fetch_columns", None)
    if consumer._columnar is not False and fetch_cols is not None:
        try:
            cols, n, next_offset = fetch_cols(consumer.partition, consumer.offset)
        except RuntimeError as e:
            # only the broker's definitive verdict latches row mode: its
            # typed row-mode rejection, or a broker without the fetchc op;
            # any other error (a transport hiccup, a bad reply) re-raises,
            # and the consume loop retries it
            msg = str(e)
            if "row-mode" in msg or "unknown op" in msg:
                consumer._columnar = False
            else:
                raise
        else:
            consumer._columnar = True
            if n <= 0:
                return 0
            if n > limit:
                # blocks serve whole: keep to the budget and resume mid-block
                cols = {c: a[:limit] for c, a in cols.items()}
                next_offset -= n - limit
                n = limit
            try:
                consumer.mutable.index_columns(cols)
            except ValueError:
                # MV schema or NaN payloads: this batch takes the row path
                names = list(cols)
                consumer.mutable.index_batch([{c: cols[c][i].item() for c in names} for i in range(n)])
            consumer.offset = next_offset
            consumer.mutable.end_offset = next_offset
            consumer._mark_rows(n)
            if consumer._time_col is not None:
                _advance_watermark(consumer, cols.get(consumer._time_col))
            _notify_offset_advance(consumer)
            return n
    rows, next_offset = consumer.stream.fetch(consumer.partition, consumer.offset, limit)
    consumer.mutable.index_batch(rows)
    advanced = next_offset != consumer.offset
    consumer.offset = next_offset
    consumer.mutable.end_offset = next_offset
    consumer._mark_rows(len(rows))
    if rows and consumer._time_col is not None:
        _advance_watermark(consumer, [r.get(consumer._time_col) for r in rows if consumer._time_col in r])
    if advanced:
        _notify_offset_advance(consumer)
    return len(rows)


class RealtimeSegmentDataManager:
    """Server-side consumer of one stream partition
    (LLRealtimeSegmentDataManager.java:68)."""

    def __init__(
        self,
        server,
        manager: RealtimeSegmentManager,
        table: str,
        segment_name: str,
        schema: Schema,
        stream: StreamProvider,
        partition: int,
        start_offset: int,
        rows_per_segment: int,
    ) -> None:
        self.server = server
        self.manager = manager
        self.table = table
        self.segment_name = segment_name
        self.stream = stream
        self.partition = partition
        self.offset = start_offset
        self.rows_per_segment = rows_per_segment
        # the pool's idle cadence (realtime/pool.py): how long a paused,
        # empty or HOLDing consumer stays off its worker
        self.poll_interval_s = 0.05
        # rows one pool step may consume
        self.step_rows = 1000
        self.mutable = MutableSegment(schema, segment_name, table)
        self.mutable.start_offset = start_offset
        self._stopped = False
        # None = untried; True / False once the stream's columnar support
        # for this partition is known
        self._columnar: Optional[bool] = None
        # the per-partition lag and paused gauges and the rows meter on the
        # hosting server's registry; a rollover re-registers the same
        # names, so each series is continuous per (table, partition)
        self._metrics = getattr(server, "metrics", None)
        self._lag_probe = LagProbe(stream, partition, lambda: self.offset)
        self._lag_gauge_name = f"ingest.lag.{table}.p{partition}"
        # the hosting server's backpressure governor
        self._governor = getattr(server, "ingest_backpressure", None)
        self._paused = False
        self._paused_gauge_name = f"ingest.paused.{table}.p{partition}"
        self._paused_fn = lambda: 1 if self._paused else 0
        if self._metrics is not None:
            self._metrics.gauge(self._lag_gauge_name).set_fn(self._lag_probe)
            self._metrics.gauge(self._paused_gauge_name).set_fn(self._paused_fn)
        attach_freshness(self, server, schema)

    def lag(self) -> Optional[int]:
        """Rows the partition holds past the consumed offset (TTL-cached)."""
        return self._lag_probe()

    def stop(self) -> None:
        self._stopped = True
        # a stopped consumer's frozen offset must not report lag; the
        # equality guard of clear_fn keeps a successor's series
        if self._metrics is not None:
            self._metrics.gauge(self._lag_gauge_name).clear_fn(self._lag_probe)
            self._metrics.gauge(self._paused_gauge_name).clear_fn(self._paused_fn)
        detach_freshness(self, self._metrics)

    def _mark_rows(self, n: int) -> None:
        if n and self._metrics is not None:
            self._metrics.meter("ingest.rowsConsumed").mark(int(n))

    # -- consumption ---------------------------------------------------
    def _fetch_and_index(self, limit: int) -> int:
        return fetch_and_index(self, limit)

    def consume_step(self, max_rows: int = 1000) -> int:
        """Fetch and index one bounded batch; returns rows consumed.  While
        the server's governor holds ingest above a watermark it returns 0
        without touching the stream: the offset freezes, lag grows,
        nothing is dropped or skipped."""
        if self._stopped:
            return 0
        if self._governor is not None:
            allowed = self._governor.consume_allowed()
            self._paused = not allowed
            if not allowed:
                return 0
            max_rows = self._governor.clamp_batch(max_rows)
        budget = self.rows_per_segment - self.mutable.num_docs
        if budget <= 0:
            return 0
        return self._fetch_and_index(min(max_rows, budget))

    @property
    def threshold_reached(self) -> bool:
        return self.mutable.num_docs >= self.rows_per_segment

    def step(self) -> Optional[float]:
        """One cooperative pool unit: a bounded consume batch, and one
        completion round at the row threshold.  Returns the seconds until
        this consumer is eligible again, or None when it is finished.
        Never blocks: a pause, an empty stream or a HOLD is an idle delay."""
        if self._stopped:
            return None
        got = self.consume_step(self.step_rows)
        if self.threshold_reached:
            resp = self.try_commit()
            if self._stopped or resp in (RESP_KEEP, RESP_DISCARD):
                return None
            return self.poll_interval_s
        if self._paused or got == 0:
            return self.poll_interval_s
        return 0.0

    def try_commit(self) -> str:
        """One round of the completion protocol (segmentConsumed, then maybe
        segmentCommit)."""
        if self._stopped:
            return RESP_DISCARD
        completion = self.manager.completion
        resp, target = completion.segment_consumed(self.segment_name, self.server.name, self.offset)
        if resp == RESP_CATCH_UP and target is not None:
            while self.offset < target and not self._stopped:
                if self._fetch_and_index(target - self.offset) == 0:
                    break
            return resp
        if resp == RESP_COMMIT:
            t0 = time.perf_counter()
            committed = self.mutable.to_committed_segment()
            out = completion.segment_commit(self.segment_name, self.server.name, committed)
            # the conversion and the controller's persistence: the ingest stall
            if self._metrics is not None:
                self._metrics.timer("ingest.commitMs").update((time.perf_counter() - t0) * 1000)
            return out
        return resp
