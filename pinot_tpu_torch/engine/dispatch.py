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

BATCHING: coalescing merges only identical dispatches; the micro-batching
tier merges similar ones.  Dispatches that share a batch key (one
StaticPlan, which buckets the literals so ``a > 5`` and ``a > 999`` share
it; one staged-table token; one query-input signature) and carry a
``BatchSpec`` are collected at dequeue time into ONE launch
(``kernel.run_batched_table_kernel``): the batched K1 / K2 read the
resident columns once while every member's literals ride a stacked
member axis, the members' inputs go up in one stacked upload on the
lane's stream, and the outputs come back in one packed fetch
(``_BatchFetch``) from which each member's FINALIZE slices its own row:
payloads stay byte-identical to unbatched execution.  The window is
adaptive: an idle lane launches at once (batching never adds latency when
the card is free), while queued same-key demand (two or more members
already gathered) holds it open up to ``config.BATCH_WINDOW_MS`` for
more, filling to ``config.BATCH_MAX`` or the spec's ``max_members`` (the
row budget's cap).  A batched launch is one in-flight unit for the
watchdog, and its error reaches every member, typed as any launch error.

DEADLINES: each waiter carries the broker-propagated monotonic deadline
(server/scheduler.py semantics).  A waiter whose deadline expired while
its dispatch sat in the lane queue, or while its batch was forming, is
shed with ``QueryAbandonedError`` before any device work happens on its
behalf, its batchmates launching unaffected; a dispatch all of whose
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

Counters (``stats()``): depth, open dispatches, dispatches, coalesce
hits, sheds, device failures, restarts, stale completions, and the
batching tier's ``batchLaunches`` / ``batchedQueries`` (occupancy =
batchedQueries / batchLaunches) and how its windows closed.

COMPILE TIMELINE (``compile_info``): per device-plan digest, the first
successful launch's wall ms (``firstCallMs``, ``firstAt``), the launch
count and their summed ms, how the digest's first launch found its
kernels (``via``: "cold", "persistent" when the compile cache's plan
ledger shows this topology ran it before, "prewarmed" when the prewarm
worker launched it ahead, ``record_prewarmed``) and, once a helper thread
has computed it, the digest's static cost (``costAnalysis``,
``packing.kernel_cost_analysis``: a dict, or None for "unavailable").
The card compiles nothing at a first launch (the kernels are built once,
when the executor is made), so ``firstCallMs`` measures what a digest's
first launch pays on the card: the CUDA module's lazy load at that
kernel's first launch in the process and the caching allocator's first
blocks.  EXPLAIN reads it for its compile state; the ``compile.cold`` /
``.warm`` / ``.persistentHit`` / ``.persistentMiss`` / ``.prewarmed``
meters and the ``compile.firstCallMs`` timer count the same launches.

OCCUPANCY (``occupancy_read``): busy seconds (wall time inside launch
calls) and queue-depth seconds accumulate as plain floats at each state
change, so a launch allocates nothing for them; each reader (the
``device.util.*`` gauges, ``status()``, an ``OccupancySampler``) reads
the busy fraction and the mean queue depth over its own window.
``OccupancySampler`` is opt-in (the profiler brackets it), and
``OCCUPANCY_ALLOCATIONS`` counts its samples: with no sampler running it
stays 0.

Left out of the port, for later slices: multi-lane meshes (``LaneGroup``
holds one lane).
"""
from __future__ import annotations

import atexit
import contextlib
import hashlib
import threading
import time
import weakref
from collections import deque, namedtuple
from typing import Any, Callable, Deque, Dict, Hashable, Iterable, List, Optional, Union

import torch

from pinot_tpu_torch.engine import compilecache, config
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

# the occupancy plane's zero-overhead contract: incremented ONLY when an
# OccupancySampler records a sample.  The lane's own busy / depth
# accounting is float accumulation at state changes, so with no sampler
# running a launch allocates nothing for occupancy and this stays 0.
OCCUPANCY_ALLOCATIONS = 0

# the shutdown fence of the cost-analysis helper threads: at exit no new
# analysis starts and the running ones are joined (bounded), so none is
# still inside torch while the interpreter tears down
_shutting_down = False
_cost_threads_lock = threading.Lock()
_cost_threads: List[threading.Thread] = []


def _drain_cost_analysis_threads() -> None:
    global _shutting_down
    _shutting_down = True
    with _cost_threads_lock:
        pending = [t for t in _cost_threads if t.is_alive()]
        _cost_threads.clear()
    deadline = time.monotonic() + 10.0
    for t in pending:
        t.join(timeout=max(0.0, deadline - time.monotonic()))


atexit.register(_drain_cost_analysis_threads)


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
    dispatch instead of enqueueing its own; ``batch_size`` is the number
    of members of the (batched) launch it rode; ``device_start`` is the
    timing CUDA event the lane recorded on its stream just before the
    launch (None on the CPU), from which the launch's device span is
    read once its outputs are fetched."""

    __slots__ = ("deadline", "coalesced", "batch_size", "device_start", "_event", "_value", "_error")

    def __init__(self, deadline: Optional[float]) -> None:
        self.deadline = deadline
        self.coalesced = False
        self.batch_size = 1
        self.device_start = None
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


class BatchSpec:
    """One dispatch's micro-batching contract (built by the executor).

    ``key``: dispatches with equal keys stack into one launch; the
    executor keys on (StaticPlan, staged-table token, query-input
    signature): one device program, one resident table, identically
    shaped inputs.
    ``inputs``: what this member hands ``launch_batched`` (the
    executor's: its host inputs, which go up in one stacked upload with
    its batchmates', and the event recorded after its PREP).
    ``launch_batched``: callable(list of member inputs) -> ``(fetch,
    handle)`` launching the batched kernel on the lane's stream; ``fetch(
    handle, deadline)`` returns the whole batch's host outputs from one
    packed device-to-host copy.
    ``max_members``: the plan's cap under ``config.BATCH_MAX`` (the
    executor keeps batch x rows under the per-dispatch row budget); 0
    for none."""

    __slots__ = ("key", "inputs", "launch_batched", "max_members")

    def __init__(
        self,
        key: Hashable,
        inputs: Any,
        launch_batched: Callable[[List[Any]], Any],
        max_members: int = 0,
    ) -> None:
        self.key = key
        self.inputs = inputs
        self.launch_batched = launch_batched
        self.max_members = max_members


class _BatchFetch:
    """The shared FINALIZE handle of one batched launch: the first member
    to need its outputs makes the ONE packed fetch for the whole batch;
    every member slices its own row of the host outputs.  Members finalize on their own workers at once, so the
    fetch is under a lock."""

    def __init__(self, fetch: Callable) -> None:
        self._fetch = fetch
        self._lock = threading.Lock()
        self._outs: Any = None
        self._error: Optional[BaseException] = None

    def _resolve(self, handle, deadline: Optional[float]) -> Any:
        with self._lock:
            if self._error is not None:
                raise self._error
            if self._outs is None:
                try:
                    self._outs = self._fetch(handle, deadline)
                except TimeoutError:
                    raise  # this member's budget ran out; a batchmate may still fetch
                except BaseException as e:
                    self._error = e
                    raise
            return self._outs

    def member(self, index: int) -> Callable:
        def fetch_member(handle, deadline: Optional[float] = None) -> Any:
            from pinot_tpu_torch.engine.packing import slice_batched_outputs

            return slice_batched_outputs(self._resolve(handle, deadline), index)

        return fetch_member


class _Dispatch:
    __slots__ = (
        "key", "launch", "pending", "waiters", "completed", "value",
        "error", "plan_digest", "cost_provider", "batch", "batch_size", "device_start",
    )

    def __init__(
        self,
        key: Hashable,
        launch: Callable[[], Any],
        pending: Callable[[Any], bool],
        plan_digest: Optional[str] = None,
        cost_provider: Optional[Callable[[Any], Optional[dict]]] = None,
        batch: Optional[BatchSpec] = None,
    ) -> None:
        self.key = key
        self.launch = launch
        self.pending = pending
        self.plan_digest = plan_digest
        self.cost_provider = cost_provider
        self.batch = batch
        self.batch_size = 1  # members of the launch this dispatch rode
        self.device_start = None  # the launch's timing start event (LaneTicket)
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
    ``DeviceFaultInjector`` consulted before every launch.
    ``batch_max`` / ``batch_window_s`` are the micro-batching tier's cap
    and window, from ``config.BATCH_MAX`` / ``config.BATCH_WINDOW_MS`` at
    construction.
    ``precision`` ("x64" / "x32", the executor's) is the x64 axis of the
    compile cache's topology fingerprint."""

    def __init__(
        self,
        device: Optional[Union[str, torch.device]] = None,
        metrics=None,
        stall_timeout_s: Optional[float] = None,
        fault_injector=None,
        precision: str = "x64",
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
        # the persistent compile cache (engine/compilecache.py): its root
        # at construction (None: off, the plain cold / warm accounting),
        # and the topology fingerprint of its plan ledger, read at the
        # first launch that needs it (reading the card's name initializes
        # CUDA, which a lane must not do before it launches)
        self.persistent_cache_dir = compilecache.cache_root()
        self._x64 = config.Precision(precision).x64
        self._fingerprint: Optional[str] = None
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
        # (leader dispatch, started_at, members) while a launch (possibly
        # batched) is in flight
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
        self.batch_max = config.BATCH_MAX
        self.batch_window_s = config.BATCH_WINDOW_MS / 1000.0
        self.batch_launches = 0
        self.batched_queries = 0
        self.batch_window_full = 0
        self.batch_window_timeout = 0
        # the compile timeline (module docstring): digest -> {firstCallMs,
        # firstAt, launches, launchMsTotal, via[, costAnalysis]}
        self._compile: Dict[str, Dict[str, Any]] = {}
        # occupancy (module docstring): busy = wall seconds inside launch
        # calls, depth seconds integrate the queue depth over time; each
        # reader diffs against its own last checkpoint
        self._busy_s = 0.0
        self._busy_since: Optional[float] = None
        self._depth_s = 0.0
        self._depth_mark = time.monotonic()
        self._created_at = self._depth_mark
        self._occ_reads: Dict[str, tuple] = {}  # reader -> (t, busy, depth_s, last result)
        if metrics is not None:
            # pre-register the lane series so /metrics shows them at zero
            for name in ("lane.dispatches", "lane.coalesced", "lane.shed",
                         "lane.deviceFailures", "lane.restarts", "batch.launches",
                         "batch.queries", "batch.windowClosedFull",
                         "batch.windowClosedTimeout", "batch.windowClosedIdle",
                         "compile.cold", "compile.warm", "compile.persistentHit",
                         "compile.persistentMiss", "compile.prewarmed",
                         "compile.costAnalyses", "compile.costAnalysisUnavailable"):
                metrics.meter(name)
            metrics.timer("compile.firstCallMs")
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
        cost_provider: Optional[Callable[[Any], Optional[dict]]] = None,
        batch: Optional[BatchSpec] = None,
    ) -> LaneTicket:
        """Enqueue a kernel launch, or coalesce onto an identical one
        that is queued, launching, or still executing on the card.
        Returns immediately; the caller blocks on ``ticket.result`` when
        FINALIZE needs the outputs.  ``batch`` marks the dispatch
        stackable with same-key peers into one batched launch; a batched
        member's value is ``(fetch, handle)``, its row of the batch.
        ``cost_provider(value)`` (the utilization plane) returns the
        plan's static cost from the launch's value, or None; it runs once
        per plan digest, after the digest's first successful launch, on a
        helper thread, never on the lane thread."""
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
                    # a late rider of a batched member rode that batch too
                    ticket.batch_size = d.batch_size
                    ticket.device_start = d.device_start
                    ticket._deliver(value=d.value)
                    return ticket
                self._close_open(d)
                d = None
            if d is not None:
                d.waiters.append(ticket)
                ticket.coalesced = True
                self._hit()
            else:
                d = _Dispatch(key, launch, pending, plan_digest, cost_provider, batch)
                d.waiters.append(ticket)
                self._by_key[key] = d
                self._depth_tick_locked()
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
            # the micro-batching tier: batched launches, the queries they
            # carried, and how the formation windows closed
            "batchLaunches": self.batch_launches,
            "batchedQueries": self.batched_queries,
            "batchWindowFull": self.batch_window_full,
            "batchWindowTimeout": self.batch_window_timeout,
            "compiledPlans": len(self._compile),
        }

    def compile_info(self, digest: Optional[str]) -> Optional[Dict[str, Any]]:
        """The compile-timeline entry of a device-plan digest: None when
        it never launched (nor was prewarmed) here, else {firstCallMs,
        firstAt, launches, launchMsTotal, via[, costAnalysis]}.
        ``costAnalysis`` is absent while the helper thread runs, a dict
        once it landed, and None when it gave nothing ("unavailable")."""
        if digest is None:
            return None
        with self._cv:
            entry = self._compile.get(digest)
            return dict(entry) if entry is not None else None

    def record_prewarmed(self, digest: Optional[str], compile_ms: float) -> bool:
        """Register a digest the prewarm worker (server/prewarm.py)
        launched ahead on its own stream, without touching the serving
        meters: ``compile.prewarmed`` only, never ``compile.cold`` or
        ``firstCallMs``.  No-op when the digest already launched or was
        prewarmed here."""
        if digest is None:
            return False
        with self._cv:
            if digest in self._compile:
                return False
            self._evict_compile_locked()
            self._compile[digest] = {
                # the prewarm launch's wall ms: what the serving path did
                # NOT pay
                "firstCallMs": round(compile_ms, 3),
                "firstAt": round(time.time(), 3),
                "launches": 0,
                "launchMsTotal": 0.0,
                "via": "prewarmed",
            }
        if self.metrics is not None:
            self.metrics.meter("compile.prewarmed").mark()
        if self.persistent_cache_dir is not None:
            compilecache.record_plan(digest, self._ledger_fingerprint(), root=self.persistent_cache_dir)
        return True

    def _evict_compile_locked(self) -> None:
        """Bounded registry: evict the OLDEST entry only, so every other
        digest keeps its measured first call."""
        if len(self._compile) > 4096:
            victim = min(self._compile, key=lambda k: self._compile[k]["firstAt"])
            self._compile.pop(victim, None)

    def _ledger_fingerprint(self) -> str:
        if self._fingerprint is None:
            self._fingerprint = compilecache.topology_fingerprint(x64=self._x64)
        return self._fingerprint

    # -- occupancy (utilization plane) --------------------------------
    def _depth_tick_locked(self, now: Optional[float] = None) -> None:
        """Integrate the queue depth over time (lock held, called BEFORE
        every queue change): float accumulation, no allocation."""
        if now is None:
            now = time.monotonic()
        self._depth_s += len(self._queue) * (now - self._depth_mark)
        self._depth_mark = now

    def occupancy_read(self, key: str = "default", min_interval_s: float = 0.0) -> Dict[str, float]:
        """Windowed occupancy: the busy fraction and the time-weighted
        mean queue depth since THIS reader's previous call (the first call
        windows from the lane's construction).  Readers pass distinct keys
        so their windows never clobber each other; ``min_interval_s``
        returns the cached last result for a rapid re-read (two gauges on
        one key read one window).  An idle lane reads 0.0."""
        now = time.monotonic()
        with self._cv:
            prev = self._occ_reads.get(key)
            if prev is not None and min_interval_s > 0 and now - prev[0] < min_interval_s:
                return dict(prev[3])
            busy = self._busy_s
            if self._busy_since is not None:
                # the launch in flight counts as busy so far
                busy += max(0.0, now - self._busy_since)
            self._depth_tick_locked(now)
            depth_s = self._depth_s
            if prev is None:
                prev_t, prev_busy, prev_depth = self._created_at, 0.0, 0.0
            else:
                prev_t, prev_busy, prev_depth = prev[0], prev[1], prev[2]
            dt = max(now - prev_t, 1e-9)
            result = {
                "windowS": round(dt, 6),
                "busyFraction": round(min(max((busy - prev_busy) / dt, 0.0), 1.0), 6),
                "avgQueueDepth": round(max((depth_s - prev_depth) / dt, 0.0), 6),
                "depth": len(self._queue),
                "inflight": 1 if self._busy_since is not None else 0,
            }
            if len(self._occ_reads) > 32 and key not in self._occ_reads:
                # bounded reader registry: evict the least recently read
                oldest = min(self._occ_reads.items(), key=lambda kv: kv[1][0])[0]
                del self._occ_reads[oldest]
            self._occ_reads[key] = (now, busy, depth_s, result)
        return dict(result)

    def mark_dead(self, error: DeviceExecutionError) -> None:
        """Take the lane off the device after a sticky CUDA fault (found
        by the lane's own launch, or by a worker's fetch): queued
        dispatches fail with the same error, and later submits get it at
        once."""
        with self._cv:
            if self.dead is None:
                self.dead = error
            drained = list(self._queue)
            self._depth_tick_locked()
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
            self._depth_tick_locked()
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

    def _spawn_cost_analysis_locked(self, digest: str, provider, value) -> None:
        """One short-lived helper thread per cold plan digest: computes the
        static cost off the serving path and stores it (or None,
        "unavailable") in the compile timeline.  Tracked for the leak
        check, and in the module's drain list for the exit fence."""
        if _shutting_down:
            return
        t = threading.Thread(target=self._run_cost_analysis, args=(digest, provider, value),
                             name=f"lane-cost-analysis-{digest[:8]}", daemon=True)
        self._track_thread(t)
        with _cost_threads_lock:
            _cost_threads[:] = [x for x in _cost_threads if x.is_alive()]
            _cost_threads.append(t)
        t.start()

    def _run_cost_analysis(self, digest: str, provider, value) -> None:
        if _shutting_down:
            return
        try:
            analysis = provider(value)
        except Exception:
            analysis = None
        if analysis is not None and not isinstance(analysis, dict):
            analysis = None
        with self._cv:
            entry = self._compile.get(digest)
            if entry is not None:
                entry["costAnalysis"] = analysis
        if self.metrics is not None:
            self.metrics.meter(
                "compile.costAnalyses" if analysis is not None else "compile.costAnalysisUnavailable").mark()

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
                    wait_s = infl[1] + self.stall_timeout_s - now + 0.005
                    # asleep, never hold the launch (its closures keep the
                    # staged tensors of a table that may be demoted meanwhile)
                    infl = None
                    self._cv.wait(timeout=wait_s)
                else:
                    # a batched launch wedges as a unit: every member's
                    # waiters get the stall verdict
                    self._inflight = None
                    if self._busy_since is not None:
                        # bank the wedged launch's window as busy: the
                        # fresh lane thread owns _busy_since from here
                        self._busy_s += max(0.0, now - self._busy_since)
                        self._busy_since = None
                    self._generation += 1
                    self.restart_count += 1
                    self.device_failure_count += 1
                    err = DeviceExecutionError(
                        f"device dispatch stalled > {self.stall_timeout_s:.3f}s; "
                        "lane restarted",
                        retryable=False,
                        stalled=True,
                    )
                    for d in infl[2]:
                        d.completed = True
                        if self._by_key.get(d.key) is d:
                            self._by_key.pop(d.key)
                        victims.extend(d.waiters)
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

    # -- micro-batching formation (lock held) --------------------------
    def _gather_peers_locked(self, spec: BatchSpec, members: List[_Dispatch], cap: int) -> None:
        """Move queued dispatches whose batch key equals ``spec.key`` into
        ``members``, up to ``cap``.  Coalescing already folded identical
        dispatches together, so every peer has its own inputs."""
        taken = []
        for peer in self._queue:
            if len(members) + len(taken) >= cap:
                break
            if peer.batch is not None and peer.batch.key == spec.key:
                taken.append(peer)
        if taken:
            self._depth_tick_locked()
        for peer in taken:
            self._queue.remove(peer)
            members.append(peer)
        if taken:
            self._set_depth()

    def _form_batch_locked(self, d: _Dispatch, members: List[_Dispatch], gen: int) -> str:
        """The adaptive window: gather queued same-key peers at once; with
        fewer than 2 members (no same-shape demand) close at once, else
        hold the window up to ``batch_window_s`` for more arrivals, to the
        cap.  Returns how it closed: "full", "timeout" or "idle"."""
        spec = d.batch
        cap = self.batch_max
        if spec.max_members:
            cap = max(1, min(cap, spec.max_members))
        self._gather_peers_locked(spec, members, cap)
        if len(members) >= cap:
            return "full"
        if len(members) < 2 or self.batch_window_s <= 0:
            return "idle"
        end = time.monotonic() + self.batch_window_s
        while len(members) < cap and not self._closed and gen == self._generation:
            remaining = end - time.monotonic()
            if remaining <= 0:
                return "timeout"
            # the wait releases the lock: submits keep landing, and the
            # next gather picks up fresh same-key arrivals
            self._cv.wait(remaining)
            self._gather_peers_locked(spec, members, cap)
        return "full" if len(members) >= cap else "timeout"

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
            # drop the last launch's references before waiting for the next:
            # the thread's frame would keep the dispatch, its closures and
            # the staged tensors they hold alive (a demoted table's memory)
            d = m = members = live = dead = value = values = deliveries = mvalue = waiters = w = error = start = None
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
                self._depth_tick_locked()
                d = self._queue.popleft()
                self._set_depth()
                # micro-batching: gather same-key peers (and, under
                # demand, hold the window open for more) before the
                # deadline sweep, so members expiring meanwhile shed too
                members = [d]
                window_close = None
                if d.batch is not None and self.batch_max > 1:
                    window_close = self._form_batch_locked(d, members, gen)
                if self._closed or gen != self._generation:
                    # closed or restarted while forming: these members
                    # left the queue, so close()'s drain missed them
                    closing = LaneClosedError("device lane closed while a batch was forming")
                    victims: List[LaneTicket] = []
                    for m in members:
                        m.completed = True
                        m.error = closing
                        if self._by_key.get(m.key) is m:
                            self._by_key.pop(m.key)
                        victims.extend(m.waiters)
                        m.waiters = []
                    for w in victims:
                        w._deliver(error=closing)
                    return
                # deadline shed at lane-dequeue time, mirroring the
                # scheduler's dequeue check: the broker already failed
                # over or timed out.  A member expiring out of a forming
                # batch sheds alone; its batchmates launch.
                now = time.monotonic()
                dead: List[LaneTicket] = []
                live: List[_Dispatch] = []
                for m in members:
                    dead.extend(w for w in m.waiters if w.deadline is not None and now >= w.deadline)
                    m.waiters = [w for w in m.waiters if w.deadline is None or now < w.deadline]
                    if m.waiters:
                        live.append(m)
                    else:
                        m.completed = True
                        if self._by_key.get(m.key) is m:
                            self._by_key.pop(m.key)
                members = live
                if members:
                    # watchdog window opens BEFORE the launch call: a
                    # wedge inside the fault injector or the launch
                    # itself both count as in-flight stalls; a batched
                    # launch is ONE in-flight unit
                    self._inflight = (members[0], now, tuple(members))
                    self._busy_since = now  # occupancy: the card is busy
            if dead:
                self.shed_count += len(dead)
                self._lane_mark("shed", len(dead))
                err = QueryAbandonedError(
                    "deadline expired while queued in device lane; "
                    "broker already gave up"
                )
                for w in dead:
                    w._deliver(error=err)
            if not members:
                continue
            d = members[0]
            batched = len(members) > 1
            # launch OUTSIDE the lock: coalescing submits must not block
            # behind a launch
            t0 = time.perf_counter()
            self._set_inflight(1)
            error: Optional[BaseException] = None
            value: Any = None
            values: List[Any] = []
            start = None
            try:
                inj = self.fault_injector
                if inj is not None:
                    # one launch: the injector sees it once (members share
                    # the plan digest by construction)
                    inj.on_launch(d.plan_digest, d.key)
                with self._launch_context():
                    if self.stream is not None:
                        # the start of the launch's device span (the cost
                        # vector's deviceMs), on the lane's stream
                        start = torch.cuda.Event(enable_timing=True)
                        start.record(self.stream)
                    if batched:
                        fetch, handle = d.batch.launch_batched([m.batch.inputs for m in members])
                        shared = _BatchFetch(fetch)
                        values = [(shared.member(i), handle) for i in range(len(members))]
                    else:
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
            via = "cold"
            if (error is None and d.plan_digest is not None and self.persistent_cache_dir is not None
                    and d.plan_digest not in self._compile):
                # classify a first launch BEFORE taking the lane lock (the
                # ledger lookup is disk I/O); the entry check proper
                # happens under the lock below
                if compilecache.known_plan(d.plan_digest, self._ledger_fingerprint(),
                                           root=self.persistent_cache_dir):
                    via = "persistent"
            with self._cv:
                stale = gen != self._generation
                if not stale and self._busy_since is not None:
                    # occupancy: the launch window closed (a stale thread
                    # must not: the watchdog banked its window, and
                    # _busy_since belongs to the fresh lane thread)
                    self._busy_s += max(0.0, time.monotonic() - self._busy_since)
                    self._busy_since = None
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
                cold = False
                if error is None and d.plan_digest is not None:
                    entry = self._compile.get(d.plan_digest)
                    if entry is None:
                        cold = True
                        self._evict_compile_locked()
                        self._compile[d.plan_digest] = {
                            "firstCallMs": round(launch_ms, 3),
                            "firstAt": round(time.time(), 3),
                            "launches": 1,
                            "launchMsTotal": round(launch_ms, 3),
                            # how the first launch found its kernels:
                            # "cold", or "persistent" (the ledger shows
                            # this topology ran the digest before)
                            "via": via,
                        }
                        if d.cost_provider is not None:
                            # the static cost, once per digest, off the lane
                            self._spawn_cost_analysis_locked(
                                d.plan_digest, d.cost_provider, values[0] if batched else value)
                    else:
                        entry["launches"] += 1
                        entry["launchMsTotal"] = round(entry["launchMsTotal"] + launch_ms, 3)
                if batched:
                    self.batch_launches += 1
                    self.batched_queries += len(members)
                    if window_close == "full":
                        self.batch_window_full += 1
                    elif window_close == "timeout":
                        self.batch_window_timeout += 1
                deliveries = []
                for i, m in enumerate(members):
                    m.completed = True
                    m.error = error
                    m.batch_size = len(members)
                    m.device_start = start
                    m.value = None if error is not None else (values[i] if batched else value)
                    deliveries.append((m.value, list(m.waiters)))
                    m.waiters = []
                    if error is None and not self._closed and self._still_pending(m):
                        # kernels still running: keep coalescible
                        self._open.append(m)
                    elif self._by_key.get(m.key) is m:
                        self._by_key.pop(m.key)
                self._sweep_open_locked()
            if self.metrics is not None:
                self._lane_mark("dispatches")
                if fault:
                    self._lane_mark("deviceFailures")
                if batched:
                    self.metrics.meter("batch.launches").mark()
                    self.metrics.meter("batch.queries").mark(len(members))
                    self.metrics.meter({"full": "batch.windowClosedFull",
                                        "timeout": "batch.windowClosedTimeout"}
                                       .get(window_close, "batch.windowClosedIdle")).mark()
                if error is None and d.plan_digest is not None:
                    if cold and via == "persistent":
                        # not a cold first launch: the ledger shows this
                        # topology ran the digest before
                        self.metrics.meter("compile.persistentHit").mark()
                    elif cold:
                        self.metrics.meter("compile.cold").mark()
                        self.metrics.timer("compile.firstCallMs").update(launch_ms)
                        if self.persistent_cache_dir is not None:
                            self.metrics.meter("compile.persistentMiss").mark()
                    else:
                        self.metrics.meter("compile.warm").mark()
                self.metrics.timer("phase.laneDispatch").update(launch_ms)
            if cold and via == "cold" and self.persistent_cache_dir is not None:
                # ledger the digest, so the NEXT process classifies its
                # first launch as persistent
                compilecache.record_plan(d.plan_digest, self._ledger_fingerprint(), root=self.persistent_cache_dir)
            for mvalue, waiters in deliveries:
                for w in waiters:
                    w.batch_size = len(members)
                    w.device_start = start
                    w._deliver(value=mvalue, error=error)


# the lane a query's shape executes on (the reference's LaneSelection,
# less the chip group: one lane, one card)
LaneSelection = namedtuple("LaneSelection", ["index", "lane"])


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
        precision: str = "x64",
    ) -> None:
        self.lanes: List[DeviceLane] = [
            DeviceLane(
                device,
                metrics=metrics,
                stall_timeout_s=stall_timeout_s,
                fault_injector=fault_injector,
                precision=precision,
            )
        ]

    @property
    def primary(self) -> DeviceLane:
        return self.lanes[0]

    @property
    def restart_count(self) -> int:
        return sum(l.restart_count for l in self.lanes)

    def select(self, shape_key=None) -> LaneSelection:
        """The lane for a query shape: the one lane."""
        return LaneSelection(0, self.lanes[0])

    def stats(self) -> Dict[str, Any]:
        return self.lanes[0].stats()

    def compile_info(self, digest: Optional[str]) -> Optional[Dict[str, Any]]:
        return self.lanes[0].compile_info(digest)

    def occupancy_read(self, key: str = "default", min_interval_s: float = 0.0) -> Dict[str, float]:
        return self.lanes[0].occupancy_read(key, min_interval_s)

    def close(self) -> None:
        for lane in self.lanes:
            lane.close()

    def join(self, timeout_s: float = 5.0) -> None:
        for lane in self.lanes:
            lane.join(timeout_s)


class OccupancySampler:
    """Periodic lane-occupancy sampler: a small thread recording (wall
    ts, busy fraction, mean queue depth, depth) into a bounded ring, the
    queue-depth-over-time series behind ``status()["device"]`` and the
    profiling workflow.

    Opt-in: nothing starts it by default, and while it does not run the
    lane's launch path allocates nothing for occupancy
    (``OCCUPANCY_ALLOCATIONS``).  ``start()`` / ``stop()`` are
    idempotent; the thread registers with its lane's leak-check list and
    exits on its own when the lane closes; a closed lane is refused."""

    def __init__(self, lane: DeviceLane, interval_s: float = 0.25, capacity: int = 240) -> None:
        self.lane = lane
        self.interval_s = max(0.02, float(interval_s))
        self._ring: Deque[tuple] = deque(maxlen=max(8, capacity))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._key = f"sampler-{id(self):x}"
        self.samples_taken = 0

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive() and not self._stop.is_set()

    def start(self) -> None:
        with self._lock:
            if self.running or self.lane._closed:
                return
            prev = self._thread
            if prev is not None and prev.is_alive():
                # a stop() set the event but has not finished joining:
                # finish the join before re-arming, or the old thread could
                # miss the cleared event and sample beside the new one
                self._stop.set()
                prev.join(timeout=2)
                if prev.is_alive():
                    return
            self._stop = threading.Event()  # one event a thread
            t = threading.Thread(target=self._run, args=(self._stop,), name="lane-occupancy-sampler", daemon=True)
            self._thread = t
            self.lane._track_thread(t)
            t.start()

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
            t = self._thread
        if t is not None:
            t.join(timeout=2)
        # drop this sampler's reader checkpoint, so repeated lifecycles on
        # a long-lived lane do not walk the registry's bound
        with self.lane._cv:
            self.lane._occ_reads.pop(self._key, None)

    def _run(self, stop: threading.Event) -> None:
        global OCCUPANCY_ALLOCATIONS
        while not stop.wait(self.interval_s):
            if self.lane._closed:
                return
            occ = self.lane.occupancy_read(self._key)
            OCCUPANCY_ALLOCATIONS += 1
            self.samples_taken += 1
            self._ring.append((round(time.time(), 3), occ["busyFraction"], occ["avgQueueDepth"], occ["depth"]))

    def snapshot(self, last: int = 60) -> Dict[str, Any]:
        samples = list(self._ring)[-max(1, last):]
        return {
            "running": self.running,
            "intervalS": self.interval_s,
            "samplesTaken": self.samples_taken,
            "samples": [
                {"ts": s[0], "busyFraction": s[1], "avgQueueDepth": s[2], "depth": s[3]}
                for s in samples
            ],
        }
