"""Device lane: the single-threaded dispatch stage of the serving
pipeline, with identical-dispatch coalescing, on one CUDA stream (port of
``pinot_tpu.engine.dispatch``).

The whole table executes as one table kernel over the stacked segment
axis, so the card is one serialized execution lane: a scheduler worker
that plans or finalizes while holding the device leaves it idle.  The
server query path is therefore a three-stage pipeline:

  PREP      (QueryScheduler worker pool): prune -> stage lookup ->
            StaticPlan -> query inputs -> host-to-device uploads, on the
            worker's current stream
  DISPATCH  (this module, one thread): kernel launches only, on the
            lane's own stream.  A launch enqueues the kernels, the byte
            packing and the non-blocking copy into pinned memory, records
            one CUDA event and returns: the lane keeps the card fed while
            earlier queries are still executing or finalizing.
  FINALIZE  (back on the worker that submitted): waits on that event,
            slices the packed host buffer, and builds the partials.

STREAMS: each lane owns one ``torch.cuda.Stream`` and every launch runs
under it, so the kernels' per-stream scratch (``fused_groupby._scratch``)
is the lane's own and two servers' lanes in one process overlap on the
card without sharing it.  Inputs uploaded by a worker on another stream
reach the lane through ``stream_handoff``: the lane stream waits on the
event recorded after PREP, and every such tensor is marked with
``record_stream`` so the caching allocator cannot hand its memory out
while the lane's kernels still read it.

COALESCING: waiters whose (StaticPlan, staged-table token, query-inputs
digest) match a dispatch that is queued, launching, or still EXECUTING
on the card attach to it instead of enqueueing their own — the one
packed output fans out to every waiter, so N concurrent repeats of the
same query cost ONE launch.  The window ends the moment the dispatch's
CUDA event has completed (``outputs_pending``): past that point handing
out the buffer would be result caching, which this deliberately is not.
A CPU launch is never pending.

DEADLINES: each waiter carries the broker-propagated monotonic deadline
(server/scheduler.py semantics).  A waiter whose deadline expired while
its dispatch sat in the lane queue is shed with ``QueryAbandonedError``
before any device work happens on its behalf; a dispatch all of whose
waiters expired is dropped without launching.

SUPERVISION: a launch exception that is a device fault
(``is_device_fault``) is classified into a typed ``DeviceExecutionError``
(retryable transient, deterministic poison, allocation failure, or a
sticky CUDA fault) before it reaches a waiter; any other exception (a
failed kernel build, a wrapper's own launch error, a bug) reaches the
waiter as raised, and the executor lets it propagate.
A sticky fault (illegal memory access, launch failure, device-side
assert...) corrupts the CUDA context: the lane marks itself dead and
never launches again, and every later query goes to the host tier.  A
watchdog thread detects an in-flight launch stalled past
``stall_timeout_s``: the wedged lane thread is abandoned (generation
bump — when its launch finally returns it discards the result and
exits), the stalled dispatch's waiters get a ``stalled`` error (the
executor fails them over to the host tier), and a fresh lane thread
re-drives everything still queued.

Left out of the port, for later slices: the micro-batching tier
(``BatchSpec`` / ``_BatchFetch``; it needs the batched kernel), the
compile cache, the cost-analysis thread, ``OccupancySampler`` and
multi-lane meshes (``LaneGroup`` holds one lane).
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Deque, Dict, Hashable, Iterable, List, Optional, Union

import torch

from pinot_tpu_torch.engine import config
from pinot_tpu_torch.server.scheduler import QueryAbandonedError

# completed dispatches kept open (still coalescible) at once; beyond
# this the oldest close early — a bound on pinned output buffers, not
# a correctness knob
_MAX_OPEN = 32

# poll period for closing open dispatches while the queue is idle; the
# check is a non-blocking event query per open dispatch
_SWEEP_S = 0.005

# every lane ever constructed, for the thread-leak check: a CLOSED lane
# must not keep threads alive
_all_lanes: "weakref.WeakSet[DeviceLane]" = weakref.WeakSet()


class DeviceExecutionError(RuntimeError):
    """Typed device-dispatch failure — the lane-supervision contract.

    ``retryable=True``: transient — one more device attempt is worth it.
    ``retryable=False``: poison — deterministic for this (plan, inputs),
    so the executor quarantines the plan and serves via the host tier.
    ``stalled`` marks watchdog-detected wedges (never device-retried).
    ``resource_exhausted`` marks device allocation failures: retried
    once, never poisoned (the plan is healthy; the card was full).
    ``sticky`` marks CUDA faults that corrupt the context: never
    retried, and the lane stops launching for good."""

    def __init__(
        self,
        message: str,
        retryable: bool,
        cause: Optional[BaseException] = None,
        stalled: bool = False,
        resource_exhausted: bool = False,
        sticky: bool = False,
    ) -> None:
        super().__init__(message)
        self.retryable = retryable
        self.cause = cause
        self.stalled = stalled
        self.resource_exhausted = resource_exhausted
        self.sticky = sticky


# allocation pressure: torch.cuda.OutOfMemoryError ("CUDA out of
# memory"), and the reference's RESOURCE_EXHAUSTED wording
_OOM_MARKERS = (
    "resource_exhausted",
    "out of memory",
    "out-of-memory",
)

# CUDA errors that leave the context unusable: every later call on it
# fails too, so the device is not tried again
_STICKY_MARKERS = (
    "illegal memory access",
    "unspecified launch failure",
    "device-side assert",
    "misaligned address",
    "an illegal instruction",
)


def is_device_fault(exc: BaseException) -> bool:
    """True for the failures the self-healing ladder answers: a typed
    ``DeviceExecutionError`` (the lane's watchdog, the fault injector), a
    CUDA allocation failure, or a sticky CUDA fault.  Anything else — a
    failed kernel build, a wrapper's own launch error, a planning bug —
    is the program's fault and propagates: the host tier never hides it."""
    if isinstance(exc, (DeviceExecutionError, torch.cuda.OutOfMemoryError)):
        return True
    low = str(exc).lower()
    return any(marker in low for marker in _OOM_MARKERS + _STICKY_MARKERS)


def classify_device_error(exc: BaseException) -> DeviceExecutionError:
    """Wrap a raw launch exception in the typed error (idempotent)."""
    if isinstance(exc, DeviceExecutionError):
        return exc
    text = f"{type(exc).__name__}: {exc}"
    low = text.lower()
    if any(marker in low for marker in _STICKY_MARKERS):
        return DeviceExecutionError(text, retryable=False, cause=exc, sticky=True)
    # an allocation failure is worth one more attempt; anything else is
    # deterministic for the plan — poison
    oom = isinstance(exc, torch.cuda.OutOfMemoryError) or any(
        marker in low for marker in _OOM_MARKERS
    )
    return DeviceExecutionError(text, retryable=oom, cause=exc, resource_exhausted=oom)


def plan_digest(plan: Any) -> str:
    """Stable (within a process) digest of a StaticPlan — the handle the
    device fault injector and the executor's poison quarantine share.
    StaticPlan is a frozen dataclass, so repr is deterministic."""
    return hashlib.blake2b(repr(plan).encode(), digest_size=8).hexdigest()


def leaked_lane_threads(grace_s: float = 2.0) -> List[threading.Thread]:
    """Threads still alive on CLOSED lanes after a grace period (open
    lanes are exempt)."""
    suspects: List[threading.Thread] = []
    for lane in list(_all_lanes):
        if not lane._closed:
            continue
        suspects.extend(t for t in lane._threads if t.is_alive())
    deadline = time.monotonic() + grace_s
    leaked = []
    for t in suspects:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            leaked.append(t)
    return leaked


def outputs_pending(value: Any) -> bool:
    """True while a launch's CUDA work has not finished: some leaf of the
    returned value carries an ``event`` (``packing.PackedHandle``) that
    has not completed.  CPU launches report False (no retention)."""
    leaves = value if isinstance(value, (tuple, list)) else (value,)
    for leaf in leaves:
        event = getattr(leaf, "event", None)
        if event is not None:
            try:
                if not event.query():
                    return True
            except Exception:
                return False
    return False


def ready_event(device: torch.device) -> Optional[torch.cuda.Event]:
    """Event recorded on the calling thread's current stream after PREP:
    the lane stream waits on it before it reads what PREP uploaded.  None
    on the CPU."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def stream_handoff(
    ready: Optional[torch.cuda.Event], tensors: Iterable[torch.Tensor]
) -> None:
    """Inside a launch: make the current (lane) stream wait for PREP's
    uploads, and mark every tensor made on another stream as used by
    this one, so the caching allocator keeps its memory until the lane's
    kernels are done with it."""
    if ready is None:
        return
    stream = torch.cuda.current_stream()
    stream.wait_event(ready)
    for t in tensors:
        if t.is_cuda:
            t.record_stream(stream)


class LaneClosedError(RuntimeError):
    """Submit after close(), or queued work drained by close()."""


class LaneTicket:
    """One waiter's slot: the submitting worker blocks on ``result`` and
    resumes FINALIZE when the lane delivers outputs (or an error).
    ``coalesced`` marks a ticket that attached to an identical in-flight
    dispatch instead of enqueueing its own."""

    __slots__ = ("deadline", "coalesced", "_event", "_value", "_error")

    def __init__(self, deadline: Optional[float]) -> None:
        self.deadline = deadline
        self.coalesced = False
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def _deliver(self, value: Any = None, error: Optional[BaseException] = None) -> None:
        self._value = value
        self._error = error
        self._event.set()

    def result(self, deadline: Optional[float] = None) -> Any:
        """Block until the dispatch delivers; honors the query deadline
        (raises the builtin ``TimeoutError`` like ``QueryScheduler.run``)."""
        timeout = None
        if deadline is not None:
            timeout = max(0.0, deadline - time.monotonic())
        if not self._event.wait(timeout):
            raise TimeoutError("device lane result exceeded query deadline")
        if self._error is not None:
            raise self._error
        return self._value


class _Dispatch:
    __slots__ = (
        "key", "launch", "pending", "waiters", "completed", "value",
        "error", "plan_digest",
    )

    def __init__(
        self,
        key: Hashable,
        launch: Callable[[], Any],
        pending: Callable[[Any], bool],
        plan_digest: Optional[str] = None,
    ) -> None:
        self.key = key
        self.launch = launch
        self.pending = pending
        self.plan_digest = plan_digest
        self.waiters: List[LaneTicket] = []
        self.completed = False
        self.value: Any = None
        self.error: Optional[BaseException] = None


class DeviceLane:
    """Single-threaded asynchronous kernel-launch queue on one CUDA
    stream, with identical-dispatch coalescing and watchdog supervision
    (see module docstring).

    ``device``: the card the lane launches on (None: the current CUDA
    device, raising without one; ``"cpu"`` runs launches inline on the
    host thread of the lane, with no stream).
    ``stall_timeout_s`` arms the watchdog (default 120 s, well above a
    first launch that builds the kernels; <= 0 disables it).
    ``fault_injector`` is an optional ``common.faults``
    ``DeviceFaultInjector`` consulted before every launch."""

    def __init__(
        self,
        device: Optional[Union[str, torch.device]] = None,
        metrics=None,
        stall_timeout_s: Optional[float] = None,
        fault_injector=None,
    ) -> None:
        self.device = config.resolve_device(device)
        self.stream = (
            torch.cuda.Stream(device=self.device) if self.device.type == "cuda" else None
        )
        self.metrics = metrics
        if stall_timeout_s is None:
            stall_timeout_s = 120.0
        self.stall_timeout_s = stall_timeout_s
        self.fault_injector = fault_injector
        self._cv = threading.Condition()
        self._queue: Deque[_Dispatch] = deque()
        self._by_key: Dict[Hashable, _Dispatch] = {}
        self._open: Deque[_Dispatch] = deque()  # launched, kernels still running
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        # spawned threads still of interest to the leak check
        self._threads: List[threading.Thread] = []
        self._threads_lock = threading.Lock()
        # restart fencing: a wedged thread that finally returns compares
        # its spawn-time generation against this and, when stale, drops
        # its result and exits without touching lane state
        self._generation = 0
        # (dispatch, started_at) while a launch is in flight
        self._inflight: Optional[tuple] = None
        self._closed = False
        # the sticky fault that took this lane off the device, if any
        self.dead: Optional[DeviceExecutionError] = None
        self.dispatch_count = 0
        self.coalesce_hits = 0
        self.shed_count = 0
        self.device_failure_count = 0
        self.restart_count = 0
        self.stale_completions = 0
        if metrics is not None:
            # pre-register the lane series so /metrics shows them at zero
            for name in ("lane.dispatches", "lane.coalesced", "lane.shed",
                         "lane.deviceFailures", "lane.restarts"):
                metrics.meter(name)
            metrics.gauge("lane.depth").set(0)
            metrics.gauge("lane.open").set(0)
            metrics.gauge("lane.inflight").set(0)
        _all_lanes.add(self)

    def _lane_mark(self, suffix: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.meter(f"lane.{suffix}").mark(n)

    # -- producer side -------------------------------------------------
    def submit(
        self,
        key: Hashable,
        launch: Callable[[], Any],
        deadline: Optional[float] = None,
        pending: Callable[[Any], bool] = outputs_pending,
        plan_digest: Optional[str] = None,
    ) -> LaneTicket:
        """Enqueue a kernel launch, or coalesce onto an identical one
        that is queued, launching, or still executing on the card.
        Returns immediately; the caller blocks on ``ticket.result`` when
        FINALIZE needs the outputs."""
        ticket = LaneTicket(deadline)
        with self._cv:
            if self._closed:
                raise LaneClosedError("device lane is closed")
            if self.dead is not None:
                ticket._deliver(error=self.dead)
                return ticket
            d = self._by_key.get(key)
            if d is not None and d.completed:
                # launched already: shareable only while its kernels are
                # still running (never serve finished outputs anew)
                if d.error is None and self._still_pending(d):
                    self._hit()
                    ticket.coalesced = True
                    ticket._deliver(value=d.value)
                    return ticket
                self._close_open(d)
                d = None
            if d is not None:
                d.waiters.append(ticket)
                ticket.coalesced = True
                self._hit()
            else:
                d = _Dispatch(key, launch, pending, plan_digest)
                d.waiters.append(ticket)
                self._by_key[key] = d
                self._queue.append(d)
                self._set_depth()
                # notify_all: the WATCHDOG also sleeps on this condition
                self._cv.notify_all()
            if self._thread is None:
                # lazy start: a lane that never runs a device query costs
                # no thread
                self._spawn_lane_locked()
                if self.stall_timeout_s and self.stall_timeout_s > 0:
                    self._spawn_watchdog_locked()
        return ticket

    def stats(self) -> Dict[str, int]:
        return {
            "depth": len(self._queue),
            "open": len(self._open),
            "dispatches": self.dispatch_count,
            "coalesceHits": self.coalesce_hits,
            "shed": self.shed_count,
            "deviceFailures": self.device_failure_count,
            "restarts": self.restart_count,
            "staleCompletions": self.stale_completions,
            "dead": self.dead is not None,
        }

    def mark_dead(self, error: DeviceExecutionError) -> None:
        """Take the lane off the device after a sticky CUDA fault (found
        by the lane's own launch, or by a worker's fetch): queued
        dispatches fail with the same error, and later submits get it at
        once."""
        with self._cv:
            if self.dead is None:
                self.dead = error
            drained = list(self._queue)
            self._queue.clear()
            for d in drained:
                d.completed = True
                d.error = error
                if self._by_key.get(d.key) is d:
                    self._by_key.pop(d.key)
            self._set_depth()
        for d in drained:
            for w in d.waiters:
                w._deliver(error=error)

    def close(self) -> None:
        """Idempotent: stop accepting submits, fail queued waiters, and
        let the lane + watchdog threads exit after any in-flight
        launch."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            drained = list(self._queue)
            self._queue.clear()
            self._open.clear()
            self._by_key.clear()
            for d in drained:
                d.completed = True
            self._cv.notify_all()
        err = LaneClosedError("device lane closed while queued")
        for d in drained:
            for w in d.waiters:
                w._deliver(error=err)

    def join(self, timeout_s: float = 5.0) -> None:
        """After ``close()``: wait (bounded) for the lane and watchdog
        threads to exit, so none is still inside torch when the
        interpreter tears down.  A thread wedged in a stalled launch is
        left behind once the bound runs out."""
        deadline = time.monotonic() + timeout_s
        for t in list(self._threads):
            if t is not threading.current_thread():
                t.join(max(0.0, deadline - time.monotonic()))

    # -- internals -----------------------------------------------------
    def _track_thread(self, t: threading.Thread) -> None:
        with self._threads_lock:
            alive = [x for x in self._threads if x.is_alive()]
            alive.append(t)
            self._threads = alive

    def _spawn_lane_locked(self) -> None:
        t = threading.Thread(
            target=self._run,
            args=(self._generation,),
            name=f"device-lane-g{self._generation}",
            daemon=True,
        )
        self._thread = t
        self._track_thread(t)
        t.start()

    def _spawn_watchdog_locked(self) -> None:
        if self._watchdog is not None:
            return
        w = threading.Thread(
            target=self._watch, name="device-lane-watchdog", daemon=True
        )
        self._watchdog = w
        self._track_thread(w)
        w.start()

    def _watch(self) -> None:
        """Watchdog: restart the lane when the in-flight launch stalls
        past ``stall_timeout_s`` — abandon the wedged thread (generation
        bump), fail the stalled dispatch's waiters with a typed stall
        error, and respawn a lane thread that re-drives the queue.
        Sleeps under the lane condition variable until the in-flight
        dispatch's stall deadline (or a coarse idle poll)."""
        idle_poll = max(0.05, self.stall_timeout_s / 4.0)
        while True:
            victims: List[LaneTicket] = []
            err: Optional[DeviceExecutionError] = None
            with self._cv:
                if self._closed:
                    return
                infl = self._inflight
                now = time.monotonic()
                if infl is None:
                    self._cv.wait(timeout=idle_poll)
                elif now - infl[1] <= self.stall_timeout_s:
                    self._cv.wait(
                        timeout=infl[1] + self.stall_timeout_s - now + 0.005
                    )
                else:
                    d = infl[0]
                    self._inflight = None
                    self._generation += 1
                    self.restart_count += 1
                    self.device_failure_count += 1
                    err = DeviceExecutionError(
                        f"device dispatch stalled > {self.stall_timeout_s:.3f}s; "
                        "lane restarted",
                        retryable=False,
                        stalled=True,
                    )
                    d.completed = True
                    if self._by_key.get(d.key) is d:
                        self._by_key.pop(d.key)
                    victims = d.waiters
                    d.waiters = []
                    d.error = err
                    self._spawn_lane_locked()
            if victims:
                self._lane_mark("restarts")
                self._lane_mark("deviceFailures")
                for w in victims:
                    w._deliver(error=err)

    def _hit(self) -> None:
        self.coalesce_hits += 1
        self._lane_mark("coalesced")

    def _set_depth(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("lane.depth").set(len(self._queue))
            self.metrics.gauge("lane.open").set(len(self._open))

    def _set_inflight(self, n: int) -> None:
        if self.metrics is not None:
            self.metrics.gauge("lane.inflight").set(n)

    def _still_pending(self, d: _Dispatch) -> bool:
        if d.pending is None:
            return False
        try:
            return bool(d.pending(d.value))
        except Exception:
            return False

    def _close_open(self, d: _Dispatch) -> None:
        """Drop a completed dispatch from the coalescible set (lock
        held)."""
        if self._by_key.get(d.key) is d:
            self._by_key.pop(d.key, None)
        try:
            self._open.remove(d)
        except ValueError:
            pass

    def _sweep_open_locked(self) -> None:
        for d in list(self._open):
            if d.error is not None or not self._still_pending(d):
                self._close_open(d)
        while len(self._open) > _MAX_OPEN:
            self._close_open(self._open[0])

    def _launch_context(self):
        """The lane's stream (and its card) for everything a launch
        enqueues; nothing on the CPU."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def _run(self, gen: int) -> None:
        while True:
            with self._cv:
                if gen != self._generation:
                    return  # restarted away while we held no work
                self._sweep_open_locked()
                while not self._queue and not self._closed and gen == self._generation:
                    if self._open:
                        # finite wait: open dispatches must close (and
                        # release their buffers) soon after the card
                        # finishes even when no new work arrives
                        self._cv.wait(timeout=_SWEEP_S)
                        self._sweep_open_locked()
                    else:
                        self._cv.wait()
                if gen != self._generation:
                    return
                if self._closed and not self._queue:
                    return
                d = self._queue.popleft()
                self._set_depth()
                # deadline shed at lane-dequeue time, mirroring the
                # scheduler's dequeue check: the broker already failed
                # over or timed out
                now = time.monotonic()
                dead = [w for w in d.waiters if w.deadline is not None and now >= w.deadline]
                d.waiters = [w for w in d.waiters if w.deadline is None or now < w.deadline]
                if not d.waiters:
                    d.completed = True
                    if self._by_key.get(d.key) is d:
                        self._by_key.pop(d.key)
                else:
                    # watchdog window opens BEFORE the launch call: a
                    # wedge inside the fault injector or the launch
                    # itself both count as in-flight stalls
                    self._inflight = (d, now)
            if dead:
                self.shed_count += len(dead)
                self._lane_mark("shed", len(dead))
                err = QueryAbandonedError(
                    "deadline expired while queued in device lane; "
                    "broker already gave up"
                )
                for w in dead:
                    w._deliver(error=err)
            if not d.waiters:
                continue
            # launch OUTSIDE the lock: coalescing submits must not block
            # behind a launch
            t0 = time.perf_counter()
            self._set_inflight(1)
            error: Optional[BaseException] = None
            value: Any = None
            try:
                inj = self.fault_injector
                if inj is not None:
                    inj.on_launch(d.plan_digest, d.key)
                with self._launch_context():
                    value = d.launch()
            except Exception as e:  # a device fault is typed; the rest is delivered as raised
                error = classify_device_error(e) if is_device_fault(e) else e
            except BaseException as e:  # deliver raw, keep the lane alive
                error = e
            finally:
                self._set_inflight(0)
            launch_ms = (time.perf_counter() - t0) * 1000
            if isinstance(error, DeviceExecutionError) and error.sticky:
                self.mark_dead(error)
            with self._cv:
                stale = gen != self._generation
                if not stale and self._inflight is not None and self._inflight[0] is d:
                    self._inflight = None
                if stale:
                    # the watchdog already failed our waiters and moved
                    # the lane on
                    self.stale_completions += 1
                    return
                self.dispatch_count += 1
                fault = isinstance(error, DeviceExecutionError)
                if fault:
                    self.device_failure_count += 1
                d.completed = True
                d.error = error
                d.value = None if error is not None else value
                waiters = list(d.waiters)
                d.waiters = []
                if error is None and not self._closed and self._still_pending(d):
                    # kernels still running: keep coalescible
                    self._open.append(d)
                elif self._by_key.get(d.key) is d:
                    self._by_key.pop(d.key)
                self._sweep_open_locked()
            if self.metrics is not None:
                self._lane_mark("dispatches")
                if fault:
                    self._lane_mark("deviceFailures")
                self.metrics.timer("phase.laneDispatch").update(launch_ms)
            for w in waiters:
                w._deliver(value=d.value, error=error)


class LaneGroup:
    """The server's device lanes.  The port drives one card per server,
    so the group holds ONE lane (multi-lane meshes are a later slice);
    the class keeps the reference's interface for the server and the
    executor."""

    def __init__(
        self,
        device: Optional[Union[str, torch.device]] = None,
        metrics=None,
        stall_timeout_s: Optional[float] = None,
        fault_injector=None,
    ) -> None:
        self.lanes: List[DeviceLane] = [
            DeviceLane(
                device,
                metrics=metrics,
                stall_timeout_s=stall_timeout_s,
                fault_injector=fault_injector,
            )
        ]

    @property
    def primary(self) -> DeviceLane:
        return self.lanes[0]

    @property
    def restart_count(self) -> int:
        return sum(l.restart_count for l in self.lanes)

    def stats(self) -> Dict[str, Any]:
        return self.lanes[0].stats()

    def close(self) -> None:
        for lane in self.lanes:
            lane.close()

    def join(self, timeout_s: float = 5.0) -> None:
        for lane in self.lanes:
            lane.join(timeout_s)
