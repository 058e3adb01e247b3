"""Per-server health tracking: consecutive-failure circuit breaker.

The reference broker routes around bad servers indirectly (Helix drops
a dead instance from the external view); within the heartbeat window a
sick-but-registered server keeps absorbing scatter traffic and turning
queries partial.  This tracker closes that gap on the data plane: every
scatter attempt reports success/failure, and after ``failure_threshold``
consecutive failures the server enters a penalty box (circuit OPEN) for
``penalty_ms``.  While open, routing prefers other replicas.  After the
penalty expires the circuit goes HALF_OPEN: exactly one probe request
is allowed through; its outcome closes or re-opens the circuit.

The control plane feeds the same state machine: a heartbeat-miss →
server-dead transition (``ParticipantGateway``) arrives as
``mark_dead`` via the broker's view/instance listener, forcing the
circuit open without waiting for data-plane failures to accumulate —
one code path for "stop sending there", whether learned from missed
heartbeats or from failed scatters.

(Copy of ``pinot_tpu.broker.health``.)
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

CLOSED = "CLOSED"
OPEN = "OPEN"
HALF_OPEN = "HALF_OPEN"


class _Circuit:
    __slots__ = (
        "state", "consecutive_failures", "opened_at",
        "probe_inflight", "probe_claimed_at",
    )

    def __init__(self) -> None:
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self.probe_inflight = False
        self.probe_claimed_at = 0.0


class ServerHealthTracker:
    """Thread-safe circuit breaker map, one circuit per server name.

    ``clock`` is injectable so fault-injection tests can step time
    deterministically instead of sleeping through penalty windows.
    """

    def __init__(
        self,
        failure_threshold: int = 3,
        penalty_ms: float = 5_000.0,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        self.failure_threshold = max(1, failure_threshold)
        self.penalty_ms = penalty_ms
        self._clock = clock or time.monotonic
        self._circuits: Dict[str, _Circuit] = {}
        # servers that are alive but still prewarming their compile
        # working set — routing deprioritizes (never excludes) them
        self._warming: set = set()
        self._lock = threading.Lock()

    def _circuit(self, server: str) -> _Circuit:
        c = self._circuits.get(server)
        if c is None:
            c = self._circuits[server] = _Circuit()
        return c

    # -- data-plane reports -------------------------------------------
    def record_success(self, server: str) -> None:
        with self._lock:
            c = self._circuit(server)
            c.state = CLOSED
            c.consecutive_failures = 0
            c.probe_inflight = False

    def record_failure(self, server: str) -> None:
        with self._lock:
            c = self._circuit(server)
            c.consecutive_failures += 1
            if c.state == HALF_OPEN or c.consecutive_failures >= self.failure_threshold:
                # a failed probe re-opens with a fresh penalty window
                c.state = OPEN
                c.opened_at = self._clock()
                c.probe_inflight = False

    # -- control-plane reports (heartbeat-miss / recovery events) -----
    def mark_dead(self, server: str) -> None:
        """Force the circuit open (controller declared the server dead)."""
        with self._lock:
            c = self._circuit(server)
            c.state = OPEN
            c.opened_at = self._clock()
            c.consecutive_failures = max(
                c.consecutive_failures, self.failure_threshold
            )
            c.probe_inflight = False

    def mark_alive(self, server: str) -> None:
        """Controller saw the server again: close immediately (the
        re-registration already proved liveness, no probe needed)."""
        self.record_success(server)

    # -- routing queries ----------------------------------------------
    def _probe_free(self, c: _Circuit) -> bool:
        """A probe claim is a LEASE, not a permanent mark: if its holder
        vanished without reporting (attempt cancelled at query end, or a
        reply the gather loop never read), the claim expires after one
        penalty window so the server is not quarantined forever."""
        if not c.probe_inflight:
            return True
        if (self._clock() - c.probe_claimed_at) * 1000.0 >= self.penalty_ms:
            c.probe_inflight = False
            return True
        return False

    def is_healthy(self, server: str) -> bool:
        """True when routing should prefer this server (circuit CLOSED,
        or OPEN long enough that a half-open probe is due)."""
        with self._lock:
            c = self._circuits.get(server)
            if c is None or c.state == CLOSED:
                return True
            if c.state == OPEN and (self._clock() - c.opened_at) * 1000.0 >= self.penalty_ms:
                c.state = HALF_OPEN
            if c.state == HALF_OPEN:
                return self._probe_free(c)
            return False

    def allow_request(self, server: str) -> bool:
        """Gate an actual send.  CLOSED always passes; HALF_OPEN passes
        exactly one inflight probe per lease window; OPEN passes nothing
        (callers may still send to an OPEN server when it is the only
        replica)."""
        with self._lock:
            c = self._circuits.get(server)
            if c is None or c.state == CLOSED:
                return True
            if c.state == OPEN and (self._clock() - c.opened_at) * 1000.0 >= self.penalty_ms:
                c.state = HALF_OPEN
            if c.state == HALF_OPEN and self._probe_free(c):
                c.probe_inflight = True
                c.probe_claimed_at = self._clock()
                return True
            return False

    # -- warm-start readiness -----------------------------------------
    def set_warming(self, server: str, warming: bool) -> None:
        with self._lock:
            if warming:
                self._warming.add(server)
            else:
                self._warming.discard(server)

    def set_warming_servers(self, servers) -> None:
        """Replace the warming set wholesale (clusterstate refresh)."""
        with self._lock:
            self._warming = set(servers)

    def is_warming(self, server: str) -> bool:
        with self._lock:
            return server in self._warming

    def warming_servers(self) -> set:
        with self._lock:
            return set(self._warming)

    def state_of(self, server: str) -> str:
        with self._lock:
            c = self._circuits.get(server)
            return c.state if c is not None else CLOSED

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Dashboard/metrics view of every tracked circuit."""
        with self._lock:
            return {
                name: {
                    "state": c.state,
                    "consecutiveFailures": c.consecutive_failures,
                }
                for name, c in self._circuits.items()
            }
