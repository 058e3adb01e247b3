"""Kafka consumer-group wire protocol, the 0.9+ group coordinator APIs
(copy of ``pinot_tpu.realtime.kafka_group``).

The reference's HLC rode Kafka 0.8's ZooKeeper-based high-level
consumer; modern Kafka moved group coordination into the broker behind
these APIs, which this module implements from spec — both sides:

  FindCoordinator (10, v0)   group -> coordinator broker
  JoinGroup       (11, v0)   member admission, generation bump,
                             leader election, member list to the leader
  SyncGroup       (14, v0)   leader distributes assignments
  Heartbeat       (12, v0)   liveness; REBALANCE_IN_PROGRESS on change
  LeaveGroup      (13, v0)   eager departure
  OffsetCommit    (8,  v0)   durable group offsets
  OffsetFetch     (9,  v0)   committed group offsets

plus the embedded "consumer" protocol payloads (Subscription /
Assignment encodings) and range assignment computed CLIENT-side by the
group leader, exactly as the real protocol does.

``KafkaGroupConsumer`` exposes the same surface as the native
``netstream.HLConsumer`` (join / poll / commit / reset_to_committed /
on_revoke), so the HLC ingestion machinery can ride either transport.
``GroupCoordinator`` adds these APIs to ``KafkaProtocolShim`` for
integration tests over real sockets: full join barrier, sync
distribution, heartbeat expiry, and rebalance-in-progress signalling
with condition variables — the broker-side state machine
(Stable -> PreparingRebalance -> AwaitingSync -> Stable).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from pinot_tpu_torch.realtime.kafka import (
    KafkaWireClient,
    _Reader,
    _bytes,
    _i16,
    _i32,
    _i64,
    _string,
)
from pinot_tpu_torch.realtime.stream import Row

API_OFFSET_COMMIT = 8
API_OFFSET_FETCH = 9
API_FIND_COORDINATOR = 10
API_JOIN_GROUP = 11
API_HEARTBEAT = 12
API_LEAVE_GROUP = 13
API_SYNC_GROUP = 14

ERR_NONE = 0
ERR_NOT_COORDINATOR = 16
ERR_ILLEGAL_GENERATION = 22
ERR_UNKNOWN_MEMBER = 25
ERR_REBALANCE_IN_PROGRESS = 27

PROTOCOL_TYPE = "consumer"
ASSIGN_STRATEGY = "range"


# -- embedded consumer-protocol payloads -------------------------------


def encode_subscription(topics: List[str]) -> bytes:
    return (
        _i16(0)
        + _i32(len(topics))
        + b"".join(_string(t) for t in topics)
        + _bytes(b"")
    )


def decode_subscription(data: bytes) -> List[str]:
    r = _Reader(data)
    r.i16()  # version
    return [r.string() for _ in range(r.i32())]


def encode_assignment(parts_by_topic: Dict[str, List[int]]) -> bytes:
    body = _i16(0) + _i32(len(parts_by_topic))
    for t, ps in sorted(parts_by_topic.items()):
        body += _string(t) + _i32(len(ps)) + b"".join(_i32(p) for p in ps)
    return body + _bytes(b"")


def decode_assignment(data: bytes) -> Dict[str, List[int]]:
    if not data:
        return {}
    r = _Reader(data)
    r.i16()  # version
    out: Dict[str, List[int]] = {}
    for _ in range(r.i32()):
        t = r.string()
        out[t] = [r.i32() for _ in range(r.i32())]
    return out


def range_assign(
    members: List[Tuple[str, List[str]]], partitions: Dict[str, int]
) -> Dict[str, Dict[str, List[int]]]:
    """The client-side 'range' strategy the leader runs: per topic,
    contiguous partition spans to subscribed members in member order."""
    out: Dict[str, Dict[str, List[int]]] = {m: {} for m, _ in members}
    topics = sorted({t for _, subs in members for t in subs})
    for topic in topics:
        subs = sorted(m for m, s in members if topic in s)
        n = partitions.get(topic, 0)
        if not subs or n == 0:
            continue
        per, extra = divmod(n, len(subs))
        start = 0
        for i, m in enumerate(subs):
            take = per + (1 if i < extra else 0)
            if take:
                out[m][topic] = list(range(start, start + take))
            start += take
    return out


# -- client ------------------------------------------------------------


class KafkaGroupConsumer:
    """HLConsumer-compatible consumer over the Kafka group protocol."""

    def __init__(
        self,
        host: str,
        port: int,
        topic: str,
        group: str,
        consumer_id: str = "",
        session_timeout: float = 10.0,
    ) -> None:
        self.topic = topic
        self.group = group
        self.session_timeout = session_timeout
        self.client = KafkaWireClient(host, port, client_id=consumer_id or "pinot-tpu")
        self.on_revoke = None
        self.member_id = ""
        self.generation = -1
        self.assignment: List[int] = []
        self.positions: Dict[int, int] = {}

    # -- raw api calls -------------------------------------------------
    def _find_coordinator(self) -> None:
        r = self.client._roundtrip(API_FIND_COORDINATOR, _string(self.group))
        err = r.i16()
        r.i32()  # node
        r.string()  # host
        r.i32()  # port
        if err != ERR_NONE:
            raise IOError(f"FindCoordinator error {err}")
        # single-broker deployments (the shim, quickstarts): the
        # coordinator is the connected broker, no re-dial needed

    def _join_group(self):
        body = (
            _string(self.group)
            + _i32(int(self.session_timeout * 1000))
            + _string(self.member_id)
            + _string(PROTOCOL_TYPE)
            + _i32(1)
            + _string(ASSIGN_STRATEGY)
            + _bytes(encode_subscription([self.topic]))
        )
        r = self.client._roundtrip(API_JOIN_GROUP, body)
        err = r.i16()
        generation = r.i32()
        r.string()  # protocol
        leader = r.string()
        member_id = r.string()
        members = []
        for _ in range(r.i32()):
            mid = r.string()
            meta = r.bytes() or b""
            members.append((mid, decode_subscription(meta)))
        if err == ERR_UNKNOWN_MEMBER:
            self.member_id = ""
            raise _Rejoin()
        if err != ERR_NONE:
            raise IOError(f"JoinGroup error {err}")
        self.member_id = member_id
        self.generation = generation
        return leader, members

    def _sync_group(self, assignments: Dict[str, bytes]) -> Dict[str, List[int]]:
        body = (
            _string(self.group)
            + _i32(self.generation)
            + _string(self.member_id)
            + _i32(len(assignments))
        )
        for mid, a in assignments.items():
            body += _string(mid) + _bytes(a)
        r = self.client._roundtrip(API_SYNC_GROUP, body)
        err = r.i16()
        blob = r.bytes() or b""
        if err in (ERR_REBALANCE_IN_PROGRESS, ERR_ILLEGAL_GENERATION, ERR_UNKNOWN_MEMBER):
            raise _Rejoin()
        if err != ERR_NONE:
            raise IOError(f"SyncGroup error {err}")
        return decode_assignment(blob)

    def _heartbeat(self) -> int:
        body = _string(self.group) + _i32(self.generation) + _string(self.member_id)
        r = self.client._roundtrip(API_HEARTBEAT, body)
        return r.i16()

    # -- HLConsumer surface --------------------------------------------
    def join(self) -> List[int]:
        self._find_coordinator()
        while True:
            try:
                leader, members = self._join_group()
                if leader == self.member_id:
                    parts = {self.topic: self._partition_count()}
                    plan = range_assign(members, parts)
                    blobs = {m: encode_assignment(a) for m, a in plan.items()}
                else:
                    blobs = {}
                mine = self._sync_group(blobs)
                break
            except _Rejoin:
                time.sleep(0.05)
        new_assignment = sorted(mine.get(self.topic, []))
        # fetch committed offsets BEFORE adopting the assignment: if
        # this call fails mid-join, the old assignment/positions stand
        # and the retry re-floors — never a new partition at offset 0
        committed = self.committed_offsets()
        self.assignment = new_assignment
        # kept partitions resume from the local (possibly further)
        # position — their rows are already in the local segment
        self.positions = {
            p: max(committed.get(p, 0), self.positions.get(p, 0))
            for p in self.assignment
        }
        return self.assignment

    def _partition_count(self) -> int:
        meta = self.client.metadata([self.topic])
        return len(meta["topics"][self.topic]["partitions"])

    def poll(self, max_rows_per_partition: int = 500) -> List[Tuple[int, Row]]:
        import json

        err = self._heartbeat()
        if err in (ERR_REBALANCE_IN_PROGRESS, ERR_ILLEGAL_GENERATION, ERR_UNKNOWN_MEMBER):
            try:
                if self.on_revoke is not None:
                    self.on_revoke()
                else:
                    self.commit()
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "on_revoke failed for %s/%s", self.group, self.member_id
                )
            if err == ERR_UNKNOWN_MEMBER:
                self.member_id = ""
            self.join()
        out: List[Tuple[int, Row]] = []
        for p in self.assignment:
            msgs = self.client.fetch(self.topic, p, self.positions.get(p, 0))
            for moff, _k, value in msgs[:max_rows_per_partition]:
                out.append((p, json.loads(value.decode())))
                self.positions[p] = moff + 1
        return out

    def commit(self) -> bool:
        body = (
            _string(self.group)
            + _i32(1)
            + _string(self.topic)
            + _i32(len(self.assignment))
        )
        for p in self.assignment:
            body += _i32(p) + _i64(self.positions.get(p, 0)) + _string("")
        r = self.client._roundtrip(API_OFFSET_COMMIT, body)
        ok = True
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                if r.i16() != ERR_NONE:
                    ok = False
        return ok

    def committed_offsets(self) -> Dict[int, int]:
        nparts = self._partition_count()
        body = (
            _string(self.group)
            + _i32(1)
            + _string(self.topic)
            + _i32(nparts)
            + b"".join(_i32(p) for p in range(nparts))
        )
        r = self.client._roundtrip(API_OFFSET_FETCH, body)
        out: Dict[int, int] = {}
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                p = r.i32()
                off = r.i64()
                r.string()  # metadata
                err = r.i16()
                if err == ERR_NONE and off >= 0:
                    out[p] = off
        return out

    def reset_to_committed(self) -> None:
        committed = self.committed_offsets()
        self.positions = {p: committed.get(p, 0) for p in self.assignment}

    def describe_group(self) -> Dict[str, Any]:
        return {"memberId": self.member_id, "generation": self.generation}

    def close(self) -> None:
        try:
            if self.member_id:
                body = _string(self.group) + _string(self.member_id)
                r = self.client._roundtrip(API_LEAVE_GROUP, body)
                r.i16()
        except Exception:
            pass
        self.client.close()


class _Rejoin(Exception):
    pass


# -- coordinator (shim side) -------------------------------------------


class _GroupState:
    EMPTY = "Empty"
    PREPARING = "PreparingRebalance"
    AWAITING_SYNC = "AwaitingSync"
    STABLE = "Stable"

    def __init__(self) -> None:
        self.state = self.EMPTY
        self.generation = 0
        self.members: Dict[str, bytes] = {}  # member_id -> subscription
        self.joined: Dict[str, bytes] = {}  # members of the forming generation
        self.leader: Optional[str] = None
        self.assignments: Dict[str, bytes] = {}
        self.last_seen: Dict[str, float] = {}
        self.session_timeout = 10.0
        self.offsets: Dict[Tuple[str, int], int] = {}
        self.cond = threading.Condition()
        self._next_member = 0


class GroupCoordinator:
    """Broker-side group state machine for the shim: join barrier,
    leader-distributed sync, heartbeat expiry, rebalance signalling."""

    REBALANCE_TIMEOUT_S = 5.0

    def __init__(self) -> None:
        self._groups: Dict[str, _GroupState] = {}
        self._lock = threading.Lock()

    def _group(self, name: str) -> _GroupState:
        with self._lock:
            g = self._groups.get(name)
            if g is None:
                g = _GroupState()
                self._groups[name] = g
            return g

    def _expire(self, g: _GroupState) -> None:
        now = time.monotonic()
        dead = [
            m for m, t in g.last_seen.items() if now - t > g.session_timeout
        ]
        for m in dead:
            g.members.pop(m, None)
            g.joined.pop(m, None)
            g.last_seen.pop(m, None)
        if dead and g.state in (_GroupState.STABLE, _GroupState.AWAITING_SYNC):
            g.state = _GroupState.PREPARING
            g.joined = {}
            g.cond.notify_all()

    # -- API handlers (called from the shim's dispatch) ----------------
    def find_coordinator(self, r: _Reader, address) -> bytes:
        r.string()  # group
        host, port = address
        return _i16(ERR_NONE) + _i32(0) + _string(host) + _i32(port)

    def join_group(self, r: _Reader) -> bytes:
        group = r.string()
        session_ms = r.i32()
        member_id = r.string() or ""
        r.string()  # protocol type
        nproto = r.i32()
        proto_name, sub = "", b""
        for i in range(nproto):
            name = r.string()
            meta = r.bytes() or b""
            if i == 0:
                proto_name, sub = name, meta
        g = self._group(group)
        with g.cond:
            g.session_timeout = max(1.0, session_ms / 1000.0)
            self._expire(g)
            if not member_id:
                g._next_member += 1
                member_id = f"member-{g._next_member}"
            elif member_id not in g.members and g.state != _GroupState.EMPTY:
                if member_id not in g.joined:
                    return (
                        _i16(ERR_UNKNOWN_MEMBER)
                        + _i32(-1)
                        + _string("")
                        + _string("")
                        + _string("")
                        + _i32(0)
                    )
            newly = member_id not in g.members
            g.members[member_id] = sub
            g.last_seen[member_id] = time.monotonic()
            if g.state in (_GroupState.EMPTY, _GroupState.STABLE, _GroupState.AWAITING_SYNC) or newly:
                if g.state != _GroupState.PREPARING:
                    g.state = _GroupState.PREPARING
                    g.joined = {}
                    g.cond.notify_all()
            g.joined[member_id] = sub
            # join barrier: wait until every known member has rejoined
            # (or stragglers expire / the rebalance times out)
            deadline = time.monotonic() + self.REBALANCE_TIMEOUT_S
            while (
                g.state == _GroupState.PREPARING
                and set(g.joined) != set(g.members)
                and time.monotonic() < deadline
            ):
                g.cond.wait(timeout=0.1)
                self._expire(g)
                g.last_seen[member_id] = time.monotonic()
            if g.state == _GroupState.PREPARING:
                # everyone (still alive) joined, or we timed out:
                # drop stragglers and form the new generation
                g.members = dict(g.joined)
                g.generation += 1
                g.leader = sorted(g.members)[0] if g.members else None
                g.assignments = {}
                g.state = _GroupState.AWAITING_SYNC
                g.cond.notify_all()
            body = (
                _i16(ERR_NONE)
                + _i32(g.generation)
                + _string(ASSIGN_STRATEGY)
                + _string(g.leader or "")
                + _string(member_id)
            )
            if member_id == g.leader:
                body += _i32(len(g.members))
                for mid, meta in sorted(g.members.items()):
                    body += _string(mid) + _bytes(meta)
            else:
                body += _i32(0)
            return body

    def sync_group(self, r: _Reader) -> bytes:
        group = r.string()
        generation = r.i32()
        member_id = r.string()
        n = r.i32()
        provided: Dict[str, bytes] = {}
        for _ in range(n):
            mid = r.string()
            provided[mid] = r.bytes() or b""
        g = self._group(group)
        with g.cond:
            if member_id not in g.members:
                return _i16(ERR_UNKNOWN_MEMBER) + _bytes(b"")
            if generation != g.generation or g.state == _GroupState.PREPARING:
                return _i16(ERR_REBALANCE_IN_PROGRESS) + _bytes(b"")
            g.last_seen[member_id] = time.monotonic()
            if member_id == g.leader and provided:
                g.assignments = provided
                g.state = _GroupState.STABLE
                g.cond.notify_all()
            deadline = time.monotonic() + self.REBALANCE_TIMEOUT_S
            while (
                g.state == _GroupState.AWAITING_SYNC
                and generation == g.generation
                and time.monotonic() < deadline
            ):
                g.cond.wait(timeout=0.1)
                g.last_seen[member_id] = time.monotonic()
            if generation != g.generation or g.state == _GroupState.PREPARING:
                return _i16(ERR_REBALANCE_IN_PROGRESS) + _bytes(b"")
            if g.state != _GroupState.STABLE:
                return _i16(ERR_REBALANCE_IN_PROGRESS) + _bytes(b"")
            return _i16(ERR_NONE) + _bytes(g.assignments.get(member_id, b""))

    def heartbeat(self, r: _Reader) -> bytes:
        group = r.string()
        generation = r.i32()
        member_id = r.string()
        g = self._group(group)
        with g.cond:
            self._expire(g)
            if member_id not in g.members:
                return _i16(ERR_UNKNOWN_MEMBER)
            g.last_seen[member_id] = time.monotonic()
            if g.state != _GroupState.STABLE:
                return _i16(ERR_REBALANCE_IN_PROGRESS)
            if generation != g.generation:
                return _i16(ERR_ILLEGAL_GENERATION)
            return _i16(ERR_NONE)

    def leave_group(self, r: _Reader) -> bytes:
        group = r.string()
        member_id = r.string()
        g = self._group(group)
        with g.cond:
            if member_id in g.members:
                was_preparing = g.state == _GroupState.PREPARING
                g.members.pop(member_id, None)
                g.joined.pop(member_id, None)
                g.last_seen.pop(member_id, None)
                if not g.members:
                    g.state = _GroupState.EMPTY
                    g.joined = {}
                else:
                    # members already waiting in the join barrier keep
                    # their registrations — wiping g.joined would stall
                    # them to the rebalance timeout and form an empty
                    # generation
                    if not was_preparing:
                        g.joined = {}
                    g.state = _GroupState.PREPARING
                g.cond.notify_all()
        return _i16(ERR_NONE)

    def offset_commit(self, r: _Reader) -> bytes:
        group = r.string()
        g = self._group(group)
        out = b""
        ntopics = r.i32()
        out += _i32(ntopics)
        with g.cond:
            for _ in range(ntopics):
                topic = r.string()
                nparts = r.i32()
                out += _string(topic) + _i32(nparts)
                for _ in range(nparts):
                    p = r.i32()
                    off = r.i64()
                    r.string()  # metadata
                    g.offsets[(topic, p)] = off
                    out += _i32(p) + _i16(ERR_NONE)
        return out

    def offset_fetch(self, r: _Reader) -> bytes:
        group = r.string()
        g = self._group(group)
        out = b""
        ntopics = r.i32()
        out += _i32(ntopics)
        with g.cond:
            for _ in range(ntopics):
                topic = r.string()
                nparts = r.i32()
                out += _string(topic) + _i32(nparts)
                for _ in range(nparts):
                    p = r.i32()
                    off = g.offsets.get((topic, p), -1)
                    out += _i32(p) + _i64(off) + _string("") + _i16(ERR_NONE)
        return out
