"""Broker routing: external view -> precomputed routing tables.

The reference listens to Helix ExternalView changes and precomputes N
routing tables per table — each a full ``{server -> segment set}``
cover with one random ONLINE replica chosen per segment — then picks a
random table per query (``HelixExternalViewBasedRouting.java:65``,
``BalancedRandomRoutingTableBuilder.java``).  Same design here, fed by
the controller's external view or a static map.

Resilience extensions: the provider keeps the raw external view, so it
can (a) consult a ``ServerHealthTracker`` in ``find_servers`` and
re-cover segments whose chosen replica sits in the penalty box, and
(b) answer ``alternates`` — "who else serves these segments?" — which
is what the broker's retry-with-failover and hedging paths use to
re-issue a straggler's segment set to a different replica.

A segment of the view that no replica serves is listed by ``unrouted``,
and the broker counts it unserved (the reference leaves it out of every
cover and answers over the other segments as if complete).

(Copy of ``pinot_tpu.broker.routing``.)
"""
from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Set, Tuple

# external view shape: {segment_name: {server_name: state}}; state in
# ONLINE | CONSUMING | OFFLINE | ERROR
ExternalView = Dict[str, Dict[str, str]]
RoutingTable = Dict[str, List[str]]  # server -> segments

ONLINE_STATES = ("ONLINE", "CONSUMING")


def balanced_random_routing_tables(
    external_view: ExternalView, num_tables: int = 10, seed: int = 0
) -> List[RoutingTable]:
    """Precompute N random replica-balanced covers of all segments."""
    rng = random.Random(seed)
    out: List[RoutingTable] = []
    for _ in range(max(1, num_tables)):
        table: RoutingTable = {}
        for segment, replicas in external_view.items():
            candidates = [s for s, st in replicas.items() if st in ONLINE_STATES]
            if not candidates:
                continue  # segment currently unserved -> partial results
            server = rng.choice(candidates)
            table.setdefault(server, []).append(segment)
        out.append(table)
    return out


class RoutingTableProvider:
    """Per-table routing state, rebuilt on external-view updates (the
    broker's ExternalView listener analog)."""

    def __init__(self, num_tables: int = 10) -> None:
        self._routing: Dict[str, List[RoutingTable]] = {}
        self._views: Dict[str, ExternalView] = {}
        self._unrouted: Dict[str, List[str]] = {}
        self._lock = threading.Lock()
        self._num_tables = num_tables
        self._rng = random.Random(7)

    def update(self, table_name: str, external_view: ExternalView) -> None:
        tables = balanced_random_routing_tables(
            external_view, self._num_tables, seed=self._rng.randrange(1 << 30)
        )
        view_copy = {seg: dict(replicas) for seg, replicas in external_view.items()}
        unrouted = sorted(seg for seg, replicas in view_copy.items()
                          if not any(st in ONLINE_STATES for st in replicas.values()))
        with self._lock:
            self._routing[table_name] = tables
            self._views[table_name] = view_copy
            self._unrouted[table_name] = unrouted

    def remove(self, table_name: str) -> None:
        with self._lock:
            self._routing.pop(table_name, None)
            self._views.pop(table_name, None)
            self._unrouted.pop(table_name, None)

    def unrouted(self, table_name: str) -> List[str]:
        """Segments of the view with no ONLINE or CONSUMING replica: no
        cover holds them, and an answer without them is partial."""
        with self._lock:
            return list(self._unrouted.get(table_name, ()))

    def find_servers(self, table_name: str, health=None) -> Optional[RoutingTable]:
        """Pick a precomputed cover; with a health tracker, re-route any
        segment whose chosen replica is unhealthy onto a healthy replica
        (falling back to the original pick when no replica is healthy —
        sending to a penalty-boxed server beats not sending at all).
        A still-warming replica (restart in prewarm) is deprioritized
        the same way but never excluded: healthy-and-ready replicas win,
        a warming replica still serves when it is all that is left."""
        with self._lock:
            tables = self._routing.get(table_name)
            if not tables:
                return None
            choice = self._rng.choice(tables)
            if health is None:
                return choice
            is_warming = getattr(health, "is_warming", None) or (lambda s: False)
            if all(health.is_healthy(s) and not is_warming(s) for s in choice):
                return choice
            view = self._views.get(table_name, {})
            rerouted: RoutingTable = {}
            for server, segments in choice.items():
                if health.is_healthy(server) and not is_warming(server):
                    rerouted.setdefault(server, []).extend(segments)
                    continue
                for segment in segments:
                    online = [
                        s
                        for s, st in view.get(segment, {}).items()
                        if st in ONLINE_STATES
                    ]
                    healthy = [s for s in online if health.is_healthy(s)]
                    ready = [s for s in healthy if not is_warming(s)]
                    candidates = ready or (
                        [server] if health.is_healthy(server) else healthy
                    )
                    picked = self._rng.choice(candidates) if candidates else server
                    rerouted.setdefault(picked, []).append(segment)
            return rerouted

    def has_alternate(
        self, table_name: str, segments: List[str], exclude: Set[str]
    ) -> bool:
        """Cheap existence check: could ANY of these segments be
        re-issued to a replica outside ``exclude``?  (Hot path — called
        per attempt to size the attempt timeout; avoids building the
        full re-cover that ``alternates`` returns.)"""
        with self._lock:
            view = self._views.get(table_name)
            if view is None:
                return False
            for segment in segments:
                for s, st in view.get(segment, {}).items():
                    if st in ONLINE_STATES and s not in exclude:
                        return True
            return False

    def alternates(
        self,
        table_name: str,
        segments: List[str],
        exclude: Set[str],
        health=None,
    ) -> Tuple[RoutingTable, List[str]]:
        """Re-cover ``segments`` with replicas outside ``exclude``.

        Returns ``(assignment, unserved)``: the failover routing table
        plus any segments with no remaining replica.  Healthy replicas
        are preferred; a penalty-boxed replica is still used when it is
        the only one left (last-resort attempt beats giving up).
        """
        with self._lock:
            view = self._views.get(table_name)
            if view is None:
                return {}, list(segments)
            assignment: RoutingTable = {}
            unserved: List[str] = []
            for segment in segments:
                candidates = [
                    s
                    for s, st in view.get(segment, {}).items()
                    if st in ONLINE_STATES and s not in exclude
                ]
                if not candidates:
                    unserved.append(segment)
                    continue
                if health is not None:
                    healthy = [s for s in candidates if health.is_healthy(s)]
                    if healthy:
                        candidates = healthy
                    is_warming = getattr(health, "is_warming", None)
                    if is_warming is not None:
                        ready = [s for s in candidates if not is_warming(s)]
                        if ready:
                            candidates = ready
                assignment.setdefault(self._rng.choice(candidates), []).append(segment)
            return assignment, unserved

    def tables(self) -> List[str]:
        with self._lock:
            return list(self._routing.keys())

    def view_of(self, table_name: str) -> Optional[ExternalView]:
        """Copy of the raw external view for a table (the join planner
        reads it to place colocated build sides and to find shuffle
        owners' alternates)."""
        with self._lock:
            view = self._views.get(table_name)
            if view is None:
                return None
            return {seg: dict(replicas) for seg, replicas in view.items()}
