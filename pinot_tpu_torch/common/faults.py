"""Fault injection for deterministic chaos tests (port of
``pinot_tpu.common.faults``; the names and the seeded decisions are the
reference's).

``FaultInjectingTransport`` wraps any transport exposing ``request(address,
payload, timeout)`` and injects per-address faults at the call site, so
the same scenarios run against ``LocalTransport`` (in process) and
``TcpTransport`` (real sockets) without touching server code: ``down``
(every request raises ``TransportError``), ``fail_next=n`` (the next ``n``
raise, then the address heals), ``error_rate`` (each request fails with
probability p from a seeded RNG), ``delay_s`` (sleep before forwarding)
and ``blackhole`` (sleep out the caller's timeout, then raise).  Every
call is appended to ``calls``.

``DeviceFaultInjector`` hooks a server's ``DeviceLane``
(``engine/dispatch.py``) and injects device-side faults before a launch:
failed launches (retryable or poison), allocation failures, sticky CUDA
faults, stalls that wedge the lane thread (the watchdog trigger), and
per-plan-digest poisoning.  The self-healing path (device retry,
watchdog restart, host failover, poison quarantine) then runs the same
way on the CPU as on the card.

``NetworkFaultInjector`` is the partition layer: it models the network
between roles as directed links keyed by instance NAME (``src -> dst``),
so one injector shared by every role-pair transport (broker -> server
scatter, server -> controller heartbeat, commit and fetch, broker ->
controller cluster-state poll) can cut, delay, duplicate or one-way
partition any link of the cluster.  Cutting ``a -> b`` loses a's requests
before they reach b; b's replies to a ride ``b -> a``, so cutting only that
direction delivers a's request (its side effects happen at b) and loses
the reply: the asymmetric partition that makes lease fencing necessary.
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from pinot_tpu_torch.transport.tcp import TransportError

Address = Tuple[str, int]


@dataclass
class FaultSpec:
    down: bool = False
    fail_next: int = 0
    error_rate: float = 0.0
    delay_s: float = 0.0
    blackhole: bool = False


@dataclass
class CallRecord:
    address: Address
    outcome: str  # "ok" | "down" | "fail_next" | "error_rate" | "blackhole" | "error"
    latency_s: float = 0.0


class FaultInjectingTransport:
    """Decorator transport: the inner one's ``request`` interface."""

    def __init__(self, inner, seed: int = 0) -> None:
        self.inner = inner
        self._rng = random.Random(seed)
        self._faults: Dict[Address, FaultSpec] = {}
        self._lock = threading.Lock()
        self.calls: List[CallRecord] = []

    # -- fault programming --------------------------------------------
    def set_fault(self, address: Address, **kwargs: Any) -> FaultSpec:
        """Program one address's faults, e.g. ``set_fault(a, down=True)``
        or ``set_fault(a, delay_s=0.5)``; modes not given reset."""
        spec = FaultSpec(**kwargs)
        with self._lock:
            self._faults[address] = spec
        return spec

    def clear_fault(self, address: Address) -> None:
        with self._lock:
            self._faults.pop(address, None)

    def clear_all(self) -> None:
        with self._lock:
            self._faults.clear()

    def calls_to(self, address: Address) -> List[CallRecord]:
        with self._lock:
            return [c for c in self.calls if c.address == address]

    # -- transport interface ------------------------------------------
    def request(self, address: Address, payload: bytes, timeout: float = 15.0) -> bytes:
        with self._lock:
            spec = self._faults.get(address)
            if spec is not None:
                if spec.down:
                    self.calls.append(CallRecord(address, "down"))
                    raise TransportError(f"injected: server {address} down")
                if spec.fail_next > 0:
                    spec.fail_next -= 1
                    self.calls.append(CallRecord(address, "fail_next"))
                    raise TransportError(f"injected: transient failure at {address}")
                if spec.error_rate > 0.0 and self._rng.random() < spec.error_rate:
                    self.calls.append(CallRecord(address, "error_rate"))
                    raise TransportError(f"injected: flaky link to {address}")
            delay = spec.delay_s if spec is not None else 0.0
            blackhole = spec.blackhole if spec is not None else False
        if blackhole:
            time.sleep(timeout)
            with self._lock:
                self.calls.append(CallRecord(address, "blackhole", timeout))
            raise TransportError(f"injected: request to {address} blackholed")
        if delay > 0.0:
            time.sleep(delay)
        t0 = time.perf_counter()
        try:
            reply = self.inner.request(address, payload, timeout=timeout)
        except Exception:
            with self._lock:
                self.calls.append(CallRecord(address, "error", time.perf_counter() - t0 + delay))
            raise
        with self._lock:
            self.calls.append(CallRecord(address, "ok", time.perf_counter() - t0 + delay))
        return reply


@dataclass
class LaunchRecord:
    """One lane launch as seen by the injector (digest is the StaticPlan
    digest the executor handed the lane; None for raw key-only
    submits)."""

    digest: Optional[str]
    # "ok" | "fail_next" | "alloc_fail" | "sticky" | "poison" | "stall"
    # | "corrupt"
    outcome: str


class DeviceFaultInjector:
    """Device-fault programming for the DeviceLane.

    - ``fail_next(n, retryable=True)`` — the next ``n`` launches raise a
      typed ``DeviceExecutionError`` (transient blip or hard fault).
    - ``alloc_fail_next(n)`` — the next ``n`` launches raise a RAW
      ``torch.cuda.OutOfMemoryError`` (what the caching allocator raises
      on the card), so the executor's real ``classify_device_error``
      path gives ``resource_exhausted``.
    - ``sticky_fail_next(n)`` — the next ``n`` launches raise a RAW
      RuntimeError in CUDA's illegal-memory-access wording: the
      ``sticky`` class, which takes the lane off the device for good.
    - ``stall_next(n, stall_s)`` — the next ``n`` launches sleep
      ``stall_s`` inside the lane thread before proceeding (the
      watchdog-restart trigger when ``stall_s`` exceeds the lane's stall
      timeout).
    - ``poison_plan(digest)`` — every launch whose StaticPlan digest
      matches raises a non-retryable poison error until ``heal()``.
    - ``corrupt_results(n, tier=..., digest_substring=..., delta=...)``
      — wrong-answer injection for the audit plane (``utils/audit.py``):
      a corrupted execution SUCCEEDS.  The executor consults
      ``check_corrupt`` after a tier produced its result and perturbs one
      numeric aggregation partial by ``delta``
      (``apply_result_corruption``).  Nothing raises, so retry, failover
      and poison never catch it; only the shadow audit can.  The host
      tier is never corrupted (it is the oracle).

    Every launch decision is recorded in ``launches``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.launches: List[LaunchRecord] = []
        self._fail_next = 0
        self._fail_retryable = True
        self._alloc_fail_next = 0
        self._sticky_next = 0
        self._stall_next = 0
        self._stall_s = 0.0
        self._poisoned: set = set()
        self._corrupt_next = 0
        self._corrupt_tier = ""
        self._corrupt_digest = ""
        self._corrupt_delta = 1.0

    # -- fault programming --------------------------------------------
    def fail_next(self, n: int, retryable: bool = True) -> None:
        with self._lock:
            self._fail_next = n
            self._fail_retryable = retryable

    def alloc_fail_next(self, n: int) -> None:
        with self._lock:
            self._alloc_fail_next = n

    def sticky_fail_next(self, n: int) -> None:
        with self._lock:
            self._sticky_next = n

    def stall_next(self, n: int, stall_s: float) -> None:
        with self._lock:
            self._stall_next = n
            self._stall_s = stall_s

    def poison_plan(self, digest: str) -> None:
        with self._lock:
            self._poisoned.add(digest)

    def corrupt_results(self, n: int = 1, tier: str = "", digest_substring: str = "",
                        delta: float = 1.0) -> None:
        """Arm wrong-answer injection: the next ``n`` executions whose
        serving tier matches ``tier`` (empty: any tier but the host) and
        whose plan-shape digest contains ``digest_substring`` get one
        numeric aggregation partial perturbed by ``delta``."""
        with self._lock:
            self._corrupt_next = n
            self._corrupt_tier = tier
            self._corrupt_digest = digest_substring
            self._corrupt_delta = delta

    @property
    def corruption_armed(self) -> bool:
        """Cheap pre-check: the executor derives a plan digest for the
        consult only while a corruption budget is armed."""
        return self._corrupt_next > 0

    def check_corrupt(self, plan_digest: Optional[str], tier: str) -> Optional[float]:
        """The executor's consult after a tier produced a result: the delta
        to apply, or None.  A match uses one of the armed budget."""
        with self._lock:
            if self._corrupt_next <= 0 or tier == "host":
                return None  # the oracle stays correct, always
            if self._corrupt_tier and tier != self._corrupt_tier:
                return None
            if self._corrupt_digest and self._corrupt_digest not in (plan_digest or ""):
                return None
            self._corrupt_next -= 1
            self.launches.append(LaunchRecord(plan_digest, "corrupt"))
            return self._corrupt_delta

    def heal(self) -> None:
        with self._lock:
            self._fail_next = 0
            self._alloc_fail_next = 0
            self._sticky_next = 0
            self._stall_next = 0
            self._stall_s = 0.0
            self._poisoned.clear()
            self._corrupt_next = 0
            self._corrupt_tier = ""
            self._corrupt_digest = ""
            self._corrupt_delta = 1.0

    def records_for(self, outcome: str) -> List[LaunchRecord]:
        with self._lock:
            return [r for r in self.launches if r.outcome == outcome]

    # -- lane hook -----------------------------------------------------
    def on_launch(self, digest: Optional[str], key: Any) -> None:
        """Called by the lane thread immediately before a launch; may
        sleep (stall) or raise."""
        from pinot_tpu_torch.engine.dispatch import DeviceExecutionError

        with self._lock:
            if digest is not None and digest in self._poisoned:
                self.launches.append(LaunchRecord(digest, "poison"))
                raise DeviceExecutionError(
                    f"injected: poisoned plan {digest}", retryable=False
                )
            if self._alloc_fail_next > 0:
                self._alloc_fail_next -= 1
                self.launches.append(LaunchRecord(digest, "alloc_fail"))
                # a RAW error: the executor must exercise its real
                # classification path (classify_device_error)
                raise torch.cuda.OutOfMemoryError(
                    "injected: CUDA out of memory. Tried to allocate 2.00 GiB"
                )
            if self._sticky_next > 0:
                self._sticky_next -= 1
                self.launches.append(LaunchRecord(digest, "sticky"))
                raise RuntimeError(
                    "injected: CUDA error: an illegal memory access was encountered"
                )
            if self._fail_next > 0:
                self._fail_next -= 1
                retryable = self._fail_retryable
                self.launches.append(LaunchRecord(digest, "fail_next"))
                raise DeviceExecutionError(
                    "injected: device launch failure", retryable=retryable
                )
            stall = 0.0
            if self._stall_next > 0:
                self._stall_next -= 1
                stall = self._stall_s
                self.launches.append(LaunchRecord(digest, "stall"))
            else:
                self.launches.append(LaunchRecord(digest, "ok"))
        if stall > 0.0:
            # sleep OUTSIDE the injector lock, inside the lane thread:
            # this is the wedge the watchdog must detect
            time.sleep(stall)


def apply_result_corruption(result, delta: float) -> bool:
    """Perturb one numeric field of ``result``'s first aggregation partial
    (the scalar list or the first group) in place: the wrong answer the
    armed ``corrupt_results`` injects.  Returns True when a field was
    perturbed (a selection, or a partial with no float field, stays as it
    is)."""
    partials = result.aggregations
    if not partials and result.groups:
        partials = result.groups[next(iter(result.groups))]
    if not partials:
        return False
    p = partials[0]
    for attr in ("count", "total", "value", "mn", "mx"):
        v = getattr(p, attr, None)
        if isinstance(v, float):
            setattr(p, attr, v + float(delta))
            return True
    return False


# ---------------------------------------------------------------------------
# Link-level network fault injection (the partition-tolerance chaos hook)
# ---------------------------------------------------------------------------

# the controller's link name: every role-pair link has instance names at
# both ends, and the controller is a singleton role
CONTROLLER_LINK = "controller"


class PartitionedLinkError(TransportError):
    """Injected: the packet (request or reply) died on a cut link."""


@dataclass
class LinkSpec:
    """Quality degradation of one directed link (``src -> dst``); a cut
    link is tracked apart (``NetworkFaultInjector.cut``)."""

    delay_s: float = 0.0
    duplicate: bool = False  # deliver the request twice (at-least-once wire)
    error_rate: float = 0.0  # flaky link: seeded per-call loss probability


@dataclass
class LinkEvent:
    src: str
    dst: str
    # "ok" | "dropped" | "replyDropped" | "delayed" | "duplicated" | "flaky"
    outcome: str


class NetworkFaultInjector:
    """Seedable, name-keyed link-fault programming for every role pair.

    One injector is shared by all the transports and HTTP clients of a
    cluster under test; each call site names itself with ``(src, dst)``
    instance names and routes its RPC through ``call``:

    - ``cut(a, b)`` — packets a->b are dropped: a's requests to b raise
      ``PartitionedLinkError`` without reaching b;
    - ``cut(b, a)`` (the reply path) — a's requests reach b (side effects
      happen) but the reply is lost: a still sees a transport error.  The
      one-way partition that tells a live-but-unreachable server from a
      dead one;
    - ``partition(a, b)`` — both directions;
    - ``set_link(a, b, ...)`` — delay, duplicate or seeded flaky loss on a
      live link;
    - ``heal(...)`` — clear one link, every link touching a node, or all.

    Every decision is recorded in ``events`` (a ring of 4,096); every
    outcome other than "ok" is also marked as ``netfaults.<outcome>`` on
    the calling role's registry (or the injector's fallback ``metrics``)."""

    _EVENT_RING = 4096  # bounded: long harness runs must not grow RAM

    def __init__(self, seed: int = 0, metrics=None) -> None:
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._cuts: set = set()  # directed (src, dst) pairs
        self._links: Dict[Tuple[str, str], LinkSpec] = {}
        self.events = deque(maxlen=self._EVENT_RING)
        # fallback registry; call sites pass their ROLE's registry per
        # call so netfaults.* lands on the role that saw the weather
        self.metrics = metrics

    # -- fault programming --------------------------------------------
    def cut(self, src: str, dst: str) -> None:
        """Drop packets flowing ``src -> dst`` (one direction only)."""
        with self._lock:
            self._cuts.add((src, dst))

    def partition(self, a: str, b: str) -> None:
        """Symmetric partition: no packets flow between ``a`` and ``b``."""
        with self._lock:
            self._cuts.add((a, b))
            self._cuts.add((b, a))

    def set_link(self, src: str, dst: str, **kwargs: Any) -> LinkSpec:
        spec = LinkSpec(**kwargs)
        with self._lock:
            self._links[(src, dst)] = spec
        return spec

    def heal(self, src: Optional[str] = None, dst: Optional[str] = None) -> None:
        """``heal()`` clears everything; ``heal(node)`` every cut and spec
        touching ``node``; ``heal(src, dst)`` that one directed link."""
        with self._lock:
            if src is None:
                self._cuts.clear()
                self._links.clear()
            elif dst is None:
                self._cuts = {c for c in self._cuts if src not in c}
                self._links = {k: v for k, v in self._links.items() if src not in k}
            else:
                self._cuts.discard((src, dst))
                self._links.pop((src, dst), None)

    def is_cut(self, src: str, dst: str) -> bool:
        with self._lock:
            return (src, dst) in self._cuts

    def events_for(self, src: str, dst: str) -> List[LinkEvent]:
        with self._lock:
            return [e for e in self.events if e.src == src and e.dst == dst]

    def _record(self, src: str, dst: str, outcome: str, metrics=None) -> None:
        with self._lock:
            self.events.append(LinkEvent(src, dst, outcome))
        m = metrics if metrics is not None else self.metrics
        if m is not None and outcome != "ok":
            m.meter(f"netfaults.{outcome}").mark()

    # -- the one call-site hook ----------------------------------------
    def call(self, src: str, dst: str, fn, metrics=None):
        """Run one RPC (``fn``) over the ``src -> dst`` link.

        May raise ``PartitionedLinkError`` without invoking ``fn`` (the
        request lost), invoke ``fn`` and then raise (the reply lost on the
        cut ``dst -> src`` direction: the asymmetric case), sleep first
        (delay), or invoke ``fn`` twice and return the second reply
        (duplicate delivery: the handlers upstream must be idempotent,
        which the at-least-once message board and the epoch and lease
        commit fences are for).  ``metrics`` is the calling role's
        registry for the ``netfaults.*`` marks."""
        with self._lock:
            request_cut = (src, dst) in self._cuts
            reply_cut = (dst, src) in self._cuts
            spec = self._links.get((src, dst))
            flaky = spec is not None and spec.error_rate > 0.0 and self._rng.random() < spec.error_rate
        if request_cut:
            self._record(src, dst, "dropped", metrics)
            raise PartitionedLinkError(f"injected: link {src}->{dst} is cut")
        if flaky:
            self._record(src, dst, "flaky", metrics)
            raise PartitionedLinkError(f"injected: flaky link {src}->{dst}")
        if spec is not None and spec.delay_s > 0.0:
            self._record(src, dst, "delayed", metrics)
            time.sleep(spec.delay_s)
        if spec is not None and spec.duplicate:
            # duplicate delivery: the first invocation's reply is
            # discarded, as a retransmitted request's would be
            self._record(src, dst, "duplicated", metrics)
            fn()
        reply = fn()
        if reply_cut:
            # the request executed at dst; the caller never learns
            self._record(src, dst, "replyDropped", metrics)
            raise PartitionedLinkError(f"injected: reply lost on cut link {dst}->{src}")
        self._record(src, dst, "ok", metrics)
        return reply


def call_on_controller_link(injector, src: str, fn, metrics=None):
    """Run one controller-bound RPC through ``injector`` as the link ``src
    -> controller`` (a plain call without an injector).  Both networked
    starters and the gateway's edge use it, so the link contract lives in
    one place."""
    if injector is None:
        return fn()
    return injector.call(src, CONTROLLER_LINK, fn, metrics=metrics)


class LinkFaultTransport:
    """Transport decorator that consults a ``NetworkFaultInjector`` on
    every request: the broker -> server scatter hook.  ``resolve`` maps a
    transport address to the destination's instance name; the default
    takes ``address[0]``, which is the name for ``LocalTransport``
    addresses (a networked broker passes a reverse lookup over its server
    address map)."""

    def __init__(self, inner, injector: NetworkFaultInjector, src: str, resolve=None, metrics=None) -> None:
        self.inner = inner
        self.injector = injector
        self.src = src
        self.metrics = metrics  # the owning role's registry (netfaults.*)
        self._resolve = resolve or (lambda address: str(address[0]))

    def request(self, address: Address, payload: bytes, timeout: float = 15.0) -> bytes:
        dst = self._resolve(address)
        return self.injector.call(
            self.src, dst, lambda: self.inner.request(address, payload, timeout=timeout), metrics=self.metrics
        )
