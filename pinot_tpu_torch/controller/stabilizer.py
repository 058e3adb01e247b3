"""SelfStabilizer: failure-driven convergence of ideal state onto the
live cluster (a copy of ``pinot_tpu.controller.stabilizer``: the same
constants and environment names).

The reference control plane (Helix full-auto rebalancer +
``ValidationManager``) continuously converges the external view toward
the ideal state, so replicas on a dead server are re-hosted without an
operator.  The heartbeat expiry in ``controller/network.py`` only
*hides* a dead server from routing; every replica it held would stay
lost until a human called ``rebalance_table``.  This manager closes the
loop:

- **Detect** under-replicated segments: replicas on dead (or
  unregistered) and draining servers do not count against the table's
  target replication.
- **Grace window** (``PINOT_TPU_STABILIZE_GRACE_S``): a server's death
  only becomes actionable after the window, so a GC pause or a rolling
  bounce never triggers mass data movement.  Draining is deliberate
  operator intent and gets no grace.
- **Re-replicate** onto live tenant servers, least-loaded first with
  load measured in DOCS (not segment count), so placement stays
  balanced under skewed segment sizes (the skew-resistant-placement
  idea from PIM-tree, PAPERS.md).  The new replica is driven ONLINE
  through the normal transition path and re-fetches the segment from
  the controller's durable store copy.
- **Clean up** one round later: once the external view shows the
  target number of live ONLINE replicas, the dead/draining replicas
  drop out of the ideal state (DROPPED is sent only to live holders).
- **CONSUMING segments** are never copied (a consumer's rows are not
  durable): when every holder is unavailable the segment is retired and
  handed to ``RealtimeSegmentManager.ensure_consuming_segments``, which
  re-creates it on a live server resuming from the last COMMITTED
  offset.

Every action is a persisted ideal-state write, so the whole plan is
crash-idempotent: a controller killed mid-round recovers the
partially-applied ideal state from the property store and the next
round converges to the same fixpoint (add-phase is keyed on deficits,
drop-phase on restored coverage — both derived, never remembered).

**Proactive skew-aware rebalancing.**  Healing only ever reacted
to death; at fleet breadth the killer is *skew* — a hot tenant's
doc-heavy, cost-heavy segments concentrating on one server while the
rest idle (the placement half of the PIM-tree / JSPIM skew argument:
skew-resistant placement, not just skew-aware kernels, keeps tails
flat).  Each round the planner:

- weighs every server's load as **docs x cost-rate**: segment docs
  (the capacity axis ``/debug/capacity`` reports) scaled by the
  table's recent scan rate (the ``cost.*`` attribution the brokers
  publish), with an optional per-server busy-fraction tiebreak from
  ``/debug/utilization`` — both wired through pluggable providers so
  the in-process harness can weigh without HTTP;
- applies **hysteresis**: the per-tenant max/mean load ratio must
  exceed ``PINOT_TPU_REBALANCE_SKEW_RATIO`` for
  ``PINOT_TPU_REBALANCE_HYSTERESIS`` consecutive rounds before
  anything moves — one hot minute moves nothing;
- plans at most ``PINOT_TPU_REBALANCE_MAX_MOVES`` moves per round,
  each **make-before-break**: phase 1 adds the replica on the cold
  server (fetched + CRC-verified + driven ONLINE through the normal
  transition path); phase 2 — a LATER round — drops the hot replica
  only after the external view proves the segment still has
  target-many live ONLINE replicas without it.  Routing covers never
  lose the segment mid-move, so the acceptance bar is zero failed
  queries, not best-effort.
- phase 2 is **derived, never remembered**: any segment with more
  replicas than target trims its most-loaded coverage-safe replica
  (an ERROR destination aborts the move instead), so a controller
  crash between the phases recovers the surplus from the property
  store and converges identically.

CONSUMING segments are never rebalanced (a consumer's rows are not
durable); rebalancing yields entirely while servers are dead, draining,
or any segment is under-replicated — healing always wins the round.
"""
from __future__ import annotations

import logging
import os
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from pinot_tpu_torch.common.conf import env_float as _env_float
from pinot_tpu_torch.controller.managers import _PeriodicManager
from pinot_tpu_torch.controller.resource_manager import (
    CONSUMING,
    ClusterResourceManager,
    ERROR,
    ONLINE,
)

logger = logging.getLogger(__name__)

_EVENT_RING = 256


class SelfStabilizer(_PeriodicManager):
    def __init__(
        self,
        resources: ClusterResourceManager,
        realtime_manager=None,
        interval_s: float = 2.0,
        grace_s: Optional[float] = None,
        now=None,
    ) -> None:
        super().__init__(interval_s, metrics_scope="stabilizer")
        self.resources = resources
        self.realtime_manager = realtime_manager
        if grace_s is None:
            grace_s = float(os.environ.get("PINOT_TPU_STABILIZE_GRACE_S", "5"))
        self.grace_s = grace_s
        self._now = now or time.monotonic
        # first-observed-dead timestamps; entries clear on recovery
        self._dead_since: Dict[str, float] = {}
        # heal/rebalance event ring for /debug/stabilizer and the
        # dashboard (the controller-side analog of the server's
        # selfHealing counters); every event carries a "class" field —
        # "heal" (failure-driven) vs "rebalance" (skew-driven) — so an
        # operator reading the ring can tell repair from optimization
        self._events: Deque[Dict[str, Any]] = deque(maxlen=_EVENT_RING)
        # -- proactive skew-aware rebalance knobs ----------------------
        self.rebalance_enabled = os.environ.get("PINOT_TPU_REBALANCE", "1") != "0"
        # per-tenant max/mean doc-x-cost load ratio that counts as skew
        self.rebalance_skew_ratio = _env_float("PINOT_TPU_REBALANCE_SKEW_RATIO", 2.0)
        # consecutive skewed evaluations before anything moves
        self.rebalance_hysteresis = int(
            _env_float("PINOT_TPU_REBALANCE_HYSTERESIS", 3)
        )
        # phase-1 move starts per round, cluster-wide
        self.rebalance_max_moves = int(
            _env_float("PINOT_TPU_REBALANCE_MAX_MOVES", 2)
        )
        # pluggable skew inputs (wired by the Controller to TTL-cached
        # /debug/capacity + /debug/utilization rollups; None = docs-only
        # weighting, which is what in-process harnesses get):
        #   cost_rate_fn() -> {raw table name: docsScanned rate1m}
        #   busy_fn()      -> {server name: busyFraction in [0, 1]}
        self.cost_rate_fn = None
        self.busy_fn = None
        # pluggable tier pressure (wired by the Controller to the
        # /debug/capacity residency section; None = no memory-pressure
        # weighting):  pressure_fn() -> {server name: hot/cap in [0, 1]}
        # — a server whose hot tier is pinned against its HBM cap has
        # its placement load inflated up to 2x, so the planner moves
        # segments OFF it before allocation failures start healing
        self.pressure_fn = None
        # pluggable warm-start readiness (wired by the Controller to the
        # heartbeat-reported warming flags; None = everyone ready, the
        # the ungated behavior):  readiness_fn(server name) -> bool
        self.readiness_fn = None
        # (table, segment) -> monotonic stamp of the FIRST readiness
        # deferral: a destination that never finishes prewarming can
        # only hold a trim for the prewarm window, never forever
        self.prewarm_timeout_s = _env_float("PINOT_TPU_PREWARM_TIMEOUT_S", 30.0)
        self._warm_waits: Dict[Tuple[str, str], float] = {}
        self._skew_rounds: Dict[str, int] = {}  # tenant -> consecutive
        # (table, segment) -> {"src", "dst"}: observability for
        # in-flight make-before-break moves.  NOT load-bearing — the
        # trim phase derives surplus from ideal state vs view, so a
        # restart that loses this map still completes every move.
        self._pending_moves: Dict[Tuple[str, str], Dict[str, str]] = {}
        for m in (
            "stabilizer.rounds",
            "stabilizer.replicasAdded",
            "stabilizer.replicasDropped",
            "stabilizer.consumingReassigned",
            "stabilizer.graceDeferrals",
            "stabilizer.leaseDeferrals",
            "rebalance.evaluations",
            "rebalance.skewDeferrals",
            "rebalance.movesStarted",
            "rebalance.movesCompleted",
            "rebalance.movesAborted",
            "rebalance.prewarmDeferrals",
        ):
            self.metrics.meter(m)
        for g in (
            "stabilizer.underReplicatedSegments",
            "stabilizer.drainingInstances",
            "stabilizer.deadServers",
            "rebalance.pendingMoves",
            "rebalance.imbalanceRatio",
        ):
            self.metrics.gauge(g).set(0)

    # -- observability --------------------------------------------------
    def _event(self, kind: str, cls: str = "heal", **fields: Any) -> None:
        self._events.append(
            {"tsMs": int(time.time() * 1000), "event": kind, "class": cls, **fields}
        )

    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def debug_snapshot(self) -> Dict[str, Any]:
        now = self._now()
        return {
            "graceSeconds": self.grace_s,
            "deadTracked": {
                name: round(now - since, 3)
                for name, since in sorted(self._dead_since.items())
            },
            "rebalance": {
                "enabled": self.rebalance_enabled,
                "skewRatio": self.rebalance_skew_ratio,
                "hysteresisRounds": self.rebalance_hysteresis,
                "maxMovesPerRound": self.rebalance_max_moves,
                "skewRounds": dict(self._skew_rounds),
                "pendingMoves": [
                    {"table": t, "segment": s, **info}
                    for (t, s), info in sorted(self._pending_moves.items())
                ],
                "prewarmTimeoutS": self.prewarm_timeout_s,
                "warmWaits": {
                    f"{t}/{s}": round(now - since, 3)
                    for (t, s), since in sorted(self._warm_waits.items())
                },
            },
            "events": self.events(),
            "metrics": self.metrics.snapshot(),
        }

    def _quiescent(self, healthy, draining, server_state) -> bool:
        """Cheap precheck: True when no round work can possibly exist —
        nobody draining, every ideal-state replica sits on a healthy
        server, and every non-consuming segment meets its target
        replication.  One lock hold, no copies, no metadata reads."""
        if draining:
            return False
        res = self.resources
        with res._lock:
            for table, ideal in res.ideal_states.items():
                config = res.table_configs.get(table)
                if config is None or not ideal:
                    continue
                n_eligible = sum(
                    1
                    for s in healthy
                    if config.server_tenant in server_state[s][2]
                )
                n_target = min(config.replication, n_eligible)
                for replicas in ideal.values():
                    if not set(replicas) <= healthy:
                        return False
                    if CONSUMING in replicas.values():
                        continue
                    if len(replicas) < n_target:
                        return False  # under-replicated: heal must run
                    if self.rebalance_enabled and len(replicas) > n_target:
                        # over-replicated: make-before-break phase 2
                        # pending (with the kill switch set, a frozen
                        # surplus must not defeat the cheap steady path)
                        return False
        return True

    # -- the convergence round -----------------------------------------
    def run_once(self) -> None:
        res = self.resources
        now = self._now()
        self.metrics.meter("stabilizer.rounds").mark()
        with res._lock:
            server_state = {
                n: (i.alive, i.draining, set(i.tags))
                for n, i in res.instances.items()
                if i.role == "server"
            }
            lease_until = {
                n: i.lease_until
                for n, i in res.instances.items()
                if i.role == "server"
            }
        healthy = {n for n, (a, d, _) in server_state.items() if a and not d}
        draining = {n for n, (a, d, _) in server_state.items() if a and d}

        def is_dead(s: str) -> bool:
            st = server_state.get(s)
            return st is None or not st[0]

        _actionable: Dict[str, bool] = {}

        def actionable_dead(s: str) -> bool:
            """Dead AND past the grace window (tracking starts at first
            observation, so a controller restarted mid-outage re-waits
            the window rather than acting on a stale clock) AND past its
            serving lease — a heartbeat-missing server whose lease has
            not expired may be alive-but-partitioned and still serving,
            so replicas move only after the lease window, never on a
            single missed heartbeat.  Memoized per round: the deferral
            meters count servers, not replicas."""
            if s in _actionable:
                return _actionable[s]
            if not is_dead(s):
                _actionable[s] = False
                return False
            since = self._dead_since.setdefault(s, now)
            if since == now:
                self._event("serverDead", server=s)
            ok = now - since >= self.grace_s
            if not ok:
                self.metrics.meter("stabilizer.graceDeferrals").mark()
            else:
                until = lease_until.get(s)
                if until is not None and now < until:
                    # lease fence: confirmed-dead is "lease expired";
                    # until then this is only "unreachable from here"
                    ok = False
                    self.metrics.meter("stabilizer.leaseDeferrals").mark()
                    self._event(
                        "leaseDeferral", server=s,
                        remainingS=round(until - now, 3),
                    )
            _actionable[s] = ok
            return ok

        # recoveries clear the death clock (a flap restarts the window)
        for s in [s for s in self._dead_since if not is_dead(s)]:
            del self._dead_since[s]
            self._event("serverRecovered", server=s)

        if self._quiescent(healthy, draining, server_state):
            # steady state: one lock hold over replica-set keys, no view
            # copies, no per-segment metadata reads — the 2s background
            # cadence must not contend with the serving path for nothing
            self.metrics.gauge("stabilizer.underReplicatedSegments").set(0)
            self.metrics.gauge("stabilizer.drainingInstances").set(0)
            self.metrics.gauge("stabilizer.deadServers").set(len(self._dead_since))
            # a healthy, fully-replicated cluster is EXACTLY when
            # proactive rebalancing is allowed to look for skew
            if self.rebalance_enabled and not self._dead_since:
                self._rebalance_tick(healthy, server_state)
            return

        under_replicated = 0
        consuming_repair = False
        for table in res.tables():
            config = res.table_configs.get(table)
            if config is None:
                continue
            eligible = sorted(
                s for s in healthy if config.server_tenant in server_state[s][2]
            )
            ideal = res.get_ideal_state(table)
            if not ideal:
                continue
            n_target = min(config.replication, len(eligible))
            # doc-weighted load: a server holding one huge segment is
            # "fuller" than one holding three tiny ones (skew-resistant
            # placement) — counted over the ideal state incl. this
            # round's own additions
            def weight(seg: str) -> int:
                info = res.get_segment_metadata(table, seg)
                meta = info.get("metadata") if info else None
                docs = getattr(meta, "num_docs", 0) if meta is not None else 0
                return max(1, int(docs or 0))

            load = {s: 0 for s in eligible}
            for seg, replicas in ideal.items():
                w = weight(seg)
                for s in replicas:
                    if s in load:
                        load[s] += w
            view = res.get_external_view(table)
            for seg in sorted(ideal):
                replicas = ideal[seg]
                unavailable = [
                    s for s in replicas if s in draining or actionable_dead(s)
                ]
                if CONSUMING in replicas.values():
                    # a consumer's rows are not durable — never copy the
                    # segment; if NO holder is serving it, retire it so
                    # ensure_consuming_segments re-creates it on a live
                    # server at the last committed offset
                    if replicas and not (set(replicas) & healthy) and len(
                        unavailable
                    ) == len(replicas):
                        if self.realtime_manager is not None:
                            self.realtime_manager.release_segment_consumers(seg)
                        held = res.retire_segment(table, seg)
                        consuming_repair = True
                        self.metrics.meter("stabilizer.consumingReassigned").mark()
                        self._event(
                            "consumingRetired", table=table, segment=seg,
                            servers=held,
                        )
                    elif unavailable:
                        # a healthy holder keeps consuming: shed only the
                        # unavailable replicas (a drain would otherwise
                        # never report drained — the next sequence opens
                        # at full replication on live servers at commit).
                        # Transiently under-replicated, as the
                        # reference's fixed consuming assignment is too.
                        for s in unavailable:
                            if self.realtime_manager is not None:
                                self.realtime_manager.release_segment_consumers(
                                    seg, server=s
                                )
                            if res.remove_segment_replica(table, seg, s):
                                self.metrics.meter(
                                    "stabilizer.replicasDropped"
                                ).mark()
                                self._event(
                                    "replicaDropped", table=table, segment=seg,
                                    server=s, consuming=True,
                                    reason="draining" if s in draining else "dead",
                                )
                    continue
                if n_target == 0:
                    under_replicated += 1
                    continue
                # drop phase FIRST, using the pre-round external view: a
                # dead/draining replica leaves the ideal state only after
                # the view proves target-many live replicas serve the
                # segment (so the add phase of round N is confirmed by
                # the view before round N+1 drops anything)
                target_state = next(iter(replicas.values()), ONLINE)
                covered = [
                    s
                    for s, st in view.get(seg, {}).items()
                    if s in healthy and s in replicas and st == target_state
                ]
                if len(covered) >= n_target:
                    for s in unavailable:
                        # readiness gate on DRAINING drops only: a drain
                        # is planned movement, so the replacement cover
                        # should be warm before the old replica leaves.
                        # Dead victims drop immediately — holding a
                        # corpse in the ideal state buys nothing.
                        if s in draining and not self._destinations_ready(
                            table, seg, covered, n_target, victim=s,
                            cls="heal",
                        ):
                            continue
                        if res.remove_segment_replica(table, seg, s):
                            self.metrics.meter("stabilizer.replicasDropped").mark()
                            self._event(
                                "replicaDropped", table=table, segment=seg,
                                server=s, reason="draining" if s in draining else "dead",
                            )
                            replicas.pop(s, None)
                # make-before-break phase 2: a segment with MORE live
                # replicas than target (the rebalance planner's phase-1
                # add, or a surplus left by a crash / replication
                # decrease) trims its most-loaded coverage-safe replica
                # once the view proves the rest serve — derived from
                # state, so a controller restart mid-move converges
                # here.  Gated on the same switch as the planner: the
                # PINOT_TPU_REBALANCE=0 kill switch must freeze ALL
                # rebalance movement, including completing phase 2.
                if self.rebalance_enabled and len(replicas) > n_target:
                    self._trim_surplus(
                        table, seg, replicas, view.get(seg, {}),
                        healthy, load, n_target, target_state, weight(seg),
                    )
                # add phase: replicas within grace still count (that IS
                # the grace: no movement yet), draining/actionable ones
                # do not
                counted = [
                    s
                    for s in replicas
                    if s in healthy or (is_dead(s) and not actionable_dead(s))
                ]
                deficit = n_target - len(counted)
                if deficit <= 0:
                    continue
                under_replicated += 1
                w = weight(seg)
                candidates = [s for s in eligible if s not in replicas]
                for _ in range(deficit):
                    if not candidates:
                        break
                    pick = min(candidates, key=lambda s: (load[s], s))
                    candidates.remove(pick)
                    if res.add_segment_replica(table, seg, pick):
                        load[pick] += w
                        self.metrics.meter("stabilizer.replicasAdded").mark()
                        self._event(
                            "replicaAdded", table=table, segment=seg,
                            server=pick, docs=w,
                        )
        if consuming_repair and self.realtime_manager is not None:
            try:
                self.realtime_manager.ensure_consuming_segments()
            except Exception:
                logger.exception("consuming-segment repair failed")
        self.metrics.gauge("stabilizer.underReplicatedSegments").set(under_replicated)
        self.metrics.gauge("stabilizer.drainingInstances").set(len(draining))
        self.metrics.gauge("stabilizer.deadServers").set(len(self._dead_since))
        if (
            self.rebalance_enabled
            and not draining
            and under_replicated == 0
            and not self._dead_since
        ):
            self._rebalance_tick(healthy, server_state)
        else:
            # healing (or draining) owns the round: skew observed while
            # replicas are being re-homed is transient by construction,
            # so the hysteresis clock restarts once the cluster is whole
            self._skew_rounds.clear()

    # -- warm-start readiness gate --------------------------------------
    def _ready(self, server: str) -> bool:
        if self.readiness_fn is None:
            return True
        try:
            return bool(self.readiness_fn(server))
        except Exception:
            # a broken readiness probe must never freeze movement
            logger.warning("readiness provider failed", exc_info=True)
            return True

    def _destinations_ready(
        self,
        table: str,
        seg: str,
        serving,
        n_target: int,
        victim: Optional[str] = None,
        dst: Optional[str] = None,
        cls: str = "rebalance",
    ) -> bool:
        """True when removing a replica may proceed: at least
        ``n_target`` of the replicas that would carry coverage
        afterwards have finished prewarming (or this (table, segment)'s
        prewarm wait timed out).  A still-warming destination serves
        correctly — it is just slow until its compiles land — so the
        deferral is bounded: the first deferral starts the clock, and
        past ``PINOT_TPU_PREWARM_TIMEOUT_S`` the movement proceeds
        anyway (a wedged prewarm must not pin surplus replicas)."""
        n_ready = sum(1 for s in serving if s != victim and self._ready(s))
        if n_ready >= n_target:
            self._warm_waits.pop((table, seg), None)
            return True
        first = self._warm_waits.setdefault((table, seg), self._now())
        if self._now() - first < self.prewarm_timeout_s:
            self.metrics.meter("rebalance.prewarmDeferrals").mark()
            self._event(
                "rebalanceTrimDeferred", cls=cls, table=table,
                segment=seg, server=victim, dst=dst,
                reason="destination warming",
            )
            return False
        self._warm_waits.pop((table, seg), None)
        self._event(
            "rebalancePrewarmTimeout", cls=cls, table=table,
            segment=seg, server=victim, dst=dst,
        )
        return True

    # -- proactive skew-aware rebalancing -------------------------------
    def _trim_surplus(
        self,
        table: str,
        seg: str,
        replicas: Dict[str, str],
        seg_view: Dict[str, str],
        healthy,
        load: Dict[str, int],
        n_target: int,
        target_state: str,
        w: int,
    ) -> None:
        """Drop surplus replicas of one segment, coverage-first: a
        victim may only leave while the external view still shows
        ``n_target`` live replicas serving WITHOUT it.  An ERROR
        destination aborts that move instead (the fetch/load failed —
        keep the source, drop the wreck)."""
        res = self.resources
        pending = self._pending_moves.get((table, seg), {})

        def covered_without(victim: str) -> bool:
            return (
                sum(
                    1
                    for s in replicas
                    if s != victim
                    and s in healthy
                    and seg_view.get(s) == target_state
                )
                >= n_target
            )

        # abort first: an ERROR replica in a surplus set is a failed
        # phase-1 destination — dropping it cancels the move cleanly.
        # The tenant's hysteresis clock restarts too, so a persistently
        # failing destination is retried once per hysteresis window
        # instead of every round (the validation manager keeps
        # resetting the ERROR replica meanwhile — whichever heals
        # first wins).
        for s in [s for s, st in seg_view.items() if st == ERROR and s in replicas]:
            if len(replicas) <= n_target:
                break
            if res.remove_segment_replica(table, seg, s):
                replicas.pop(s, None)
                self.metrics.meter("rebalance.movesAborted").mark()
                self._event(
                    "rebalanceMoveAborted", cls="rebalance", table=table,
                    segment=seg, server=s, reason="destination ERROR",
                )
                self._skew_rounds.clear()
                if pending.get("dst") == s:
                    self._pending_moves.pop((table, seg), None)
        while len(replicas) > n_target:
            # a victim must ITSELF be serving (healthy + view at target
            # state): a pending destination mid-fetch is never dropped
            # — cancelling a move just because the copy is slow would
            # livelock the planner into add/drop cycles
            candidates = [
                s
                for s in replicas
                if s in healthy
                and seg_view.get(s) == target_state
                and covered_without(s)
            ]
            if not candidates:
                return  # view not converged yet: never break coverage
            # the recorded move source first (most-loaded by intent);
            # otherwise the most-loaded replica — derived, crash-safe
            src = pending.get("src")
            if src in candidates:
                victim = src
            else:
                victim = max(candidates, key=lambda s: (load.get(s, 0), s))
            # readiness gate: the old replica leaves only once enough of
            # the remaining cover has finished prewarming (or the wait
            # timed out) — a make-before-break move must hand traffic to
            # a WARM destination, not a correct-but-cold one
            serving = [
                s
                for s in replicas
                if s in healthy and seg_view.get(s) == target_state
            ]
            if not self._destinations_ready(
                table, seg, serving, n_target,
                victim=victim, dst=pending.get("dst"),
            ):
                return
            if not res.remove_segment_replica(table, seg, victim):
                return
            replicas.pop(victim, None)
            if victim in load:
                load[victim] -= w
            self.metrics.meter("rebalance.movesCompleted").mark()
            self._event(
                "rebalanceMoveCompleted", cls="rebalance", table=table,
                segment=seg, server=victim, docs=w,
                dst=pending.get("dst"),
            )
            self._pending_moves.pop((table, seg), None)

    def _skew_inputs(self):
        """(cost rates by raw table, busy fraction by server, tier
        pressure by server) from the pluggable providers; failures
        degrade to docs-only weighting — a dead rollup must never stall
        the convergence loop."""
        rates: Dict[str, float] = {}
        busy: Dict[str, float] = {}
        pressure: Dict[str, float] = {}
        if self.cost_rate_fn is not None:
            try:
                rates = dict(self.cost_rate_fn() or {})
            except Exception:
                logger.warning("cost-rate provider failed", exc_info=True)
        if self.busy_fn is not None:
            try:
                busy = dict(self.busy_fn() or {})
            except Exception:
                logger.warning("busy-fraction provider failed", exc_info=True)
        if self.pressure_fn is not None:
            try:
                pressure = dict(self.pressure_fn() or {})
            except Exception:
                logger.warning("tier-pressure provider failed", exc_info=True)
        return rates, busy, pressure

    def _rebalance_tick(self, healthy, server_state) -> None:
        """One skew evaluation (+ possibly phase-1 move starts).  Load
        is doc-weighted per replica, scaled by the owning table's
        recent scan cost rate; imbalance is judged per server tenant
        (moves can only happen inside a tenant's eligible set)."""
        res = self.resources
        self.metrics.meter("rebalance.evaluations").mark()
        # sweep stale pending entries (segment/table deleted out from
        # under an in-flight move) so they never starve the budget
        for table, seg in list(self._pending_moves):
            if res.get_ideal_state(table).get(seg) is None:
                self._pending_moves.pop((table, seg), None)
        rates, busy, pressure = self._skew_inputs()
        with res._lock:
            configs = dict(res.table_configs)
        max_rate = max(rates.values()) if rates else 0.0

        def table_factor(config) -> float:
            # docs x cost-rate: a table burning the cluster weighs up
            # to 2x its doc weight, so the planner spreads IT first
            if max_rate <= 0:
                return 1.0
            return 1.0 + rates.get(config.raw_name, 0.0) / max_rate

        tenants: Dict[str, List[str]] = {}
        for table, config in configs.items():
            tenants.setdefault(config.server_tenant, []).append(table)

        worst_ratio = 0.0
        moves_budget = self.rebalance_max_moves - len(self._pending_moves)
        for tenant in sorted(tenants):
            eligible = sorted(
                s for s in healthy if tenant in server_state[s][2]
            )
            if len(eligible) < 2:
                self._skew_rounds.pop(tenant, None)
                continue
            load: Dict[str, float] = {s: 0.0 for s in eligible}
            # (weight, table, seg, replica set): phase-1 candidates
            movable: List[Tuple[float, str, str, set]] = []
            for table in sorted(tenants[tenant]):
                config = configs[table]
                factor = table_factor(config)
                ideal = res.get_ideal_state(table)
                n_target = min(config.replication, len(eligible))
                for seg, replicas in ideal.items():
                    info = res.get_segment_metadata(table, seg)
                    meta = info.get("metadata") if info else None
                    docs = getattr(meta, "num_docs", 0) if meta is not None else 0
                    w = max(1, int(docs or 0)) * factor
                    for s in replicas:
                        if s in load:
                            load[s] += w
                    if (
                        CONSUMING not in replicas.values()
                        and len(replicas) <= n_target
                        and (table, seg) not in self._pending_moves
                    ):
                        movable.append((w, table, seg, set(replicas)))
            # tier pressure: a server running hot against its HBM
            # cap reads as up to 2x its doc-x-cost load, so the planner
            # drains it preemptively — rebalance is the slow, permanent
            # answer to the pressure that demotion absorbs in the moment
            for s in load:
                p = pressure.get(s, 0.0)
                if p > 0:
                    load[s] *= 1.0 + min(1.0, max(0.0, float(p)))
            mean = sum(load.values()) / len(load)
            if mean <= 0:
                self._skew_rounds.pop(tenant, None)
                continue
            ratio = max(load.values()) / mean
            worst_ratio = max(worst_ratio, ratio)
            if ratio < self.rebalance_skew_ratio:
                self._skew_rounds.pop(tenant, None)
                continue
            seen = self._skew_rounds.get(tenant, 0) + 1
            self._skew_rounds[tenant] = seen
            if seen < self.rebalance_hysteresis:
                # hysteresis: one hot minute moves nothing
                self.metrics.meter("rebalance.skewDeferrals").mark()
                self._event(
                    "skewDeferred", cls="rebalance", tenant=tenant,
                    ratio=round(ratio, 3), consecutiveRounds=seen,
                )
                continue
            self._event(
                "skewDetected", cls="rebalance", tenant=tenant,
                ratio=round(ratio, 3), consecutiveRounds=seen,
            )
            moves_budget = self._plan_tenant_moves(
                tenant, eligible, load, busy, movable, moves_budget
            )
        self.metrics.gauge("rebalance.imbalanceRatio").set(round(worst_ratio, 3))
        self.metrics.gauge("rebalance.pendingMoves").set(len(self._pending_moves))

    def _plan_tenant_moves(
        self,
        tenant: str,
        eligible: List[str],
        load: Dict[str, float],
        busy: Dict[str, float],
        movable: List[Tuple[float, str, str, set]],
        budget: int,
    ) -> int:
        """Start bounded make-before-break moves: hottest server ->
        coldest (busy-fraction tiebreak), moving the largest segment
        that does not overshoot half the gap (an overshooting move
        would just invert the skew and oscillate)."""
        res = self.resources
        movable = sorted(movable, key=lambda m: -m[0])
        while budget > 0:
            src = max(eligible, key=lambda s: (load[s], s))
            dst = min(eligible, key=lambda s: (load[s], busy.get(s, 0.0), s))
            gap = load[src] - load[dst]
            if src == dst or gap <= 0:
                return budget
            pick = None
            for i, (w, table, seg, replicas) in enumerate(movable):
                if src in replicas and dst not in replicas and w <= gap / 2:
                    pick = i
                    break
            if pick is None:
                return budget
            w, table, seg, replicas = movable.pop(pick)
            if not res.add_segment_replica(table, seg, dst):
                continue
            self.metrics.meter("rebalance.movesStarted").mark()
            self._event(
                "rebalanceMoveStarted", cls="rebalance", table=table,
                segment=seg, src=src, dst=dst, docs=int(w), tenant=tenant,
            )
            self._pending_moves[(table, seg)] = {"src": src, "dst": dst}
            load[dst] += w  # src keeps its copy until phase 2 trims it
            budget -= 1
        return budget
