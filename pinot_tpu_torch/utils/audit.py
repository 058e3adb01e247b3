"""Continuous correctness audit (copy of ``pinot_tpu.utils.audit``).

A device tier that returns a plausible but wrong payload raises nothing,
so retry, failover and poison stay silent and the error reaches the
client.  Two background samplers re-derive ground truth and compare:

- ``ShadowAuditor`` (server side): re-executes a 1-in-N sample of
  completed queries on the host oracle
  (``QueryExecutor.execute_host_oracle``, numpy over the segments' host
  arrays) over the exact views the reply served (a consuming segment's
  view is its snapshot at the row watermark; the job holds the views, so
  a residency demotion or a superseded snapshot's retirement cannot take
  them away).  Payloads are compared after stripping accounting, with a
  bounded numeric tolerance (``payloads_equivalent``): the card's grouped
  float sums and the host's honestly differ with the order of addition.
  A divergence increments ``audit.divergences``, dumps a flight-recorder
  bundle with both payloads, and quarantines the (plan digest, tier)
  through the executor's poison map, so the lying tier stops serving
  that shape.

- ``ReplicaAuditor`` (broker side): re-issues a sampled query's first
  batch to both the original server and an alternate covering replica
  and compares the reduced, accounting-stripped payloads.  Realtime
  tables are left out: their replicas consume independently, so offset
  drift would read as a divergence.

Both samplers draw from one process-wide token budget
(``PINOT_TPU_AUDIT_BUDGET_PER_S``).  The work runs on background threads
with a bounded queue (drop, never block), never on the serving path.

The shadow oracle and the comparison run in a forked child, which sees
the sampled views copy-on-write and sends back only the verdict (the
reference runs them on the auditor's thread).  On the thread an oracle
shares the server's interpreter with every serving thread for its whole
run: one the host tier runs row by row (a distinct count without a
group-by, an ordered selection) holds it for minutes at full width, and
even a numpy one slows the serving threads while it runs.  The child
costs one ``fork`` (``audit.forkMs``) for every sample queued when it
starts, so the auditor drains its queue at the oracles' pace, not at one
fork a sample, and a core while it runs; the verdicts are the reference's.
A sample whose answer to the same query over the same views already waits
in the queue is dropped as a duplicate (``audit.duplicates``): its verdict
would be that one's, and a closed loop of one query then never fills the
queue, so a different (wrong) answer finds room.  Where ``os.fork`` is missing the
check runs on the thread.

Knobs:

- ``PINOT_TPU_AUDIT_SAMPLE_N``     shadow sample rate (1-in-N completed
                                   queries), default 64; 0 disables.
- ``PINOT_TPU_AUDIT_REPLICA_N``    replica sample rate, default 256;
                                   0 disables.
- ``PINOT_TPU_AUDIT_BUDGET_PER_S`` the shared token budget, default 8/s."""
from __future__ import annotations

import gc
import hashlib
import logging
import os
import pickle
import signal
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.common.conf import env_float, env_int

logger = logging.getLogger(__name__)

# every auditor that ever started a thread, for the test-suite leak
# guard (same contract as prewarm._workers: only a STOPPED auditor
# whose thread survives is a leak)
_workers: List[Any] = []
_workers_lock = threading.Lock()


def leaked_audit_threads(grace_s: float = 2.0) -> List[str]:
    """Names of audit threads of STOPPED auditors still alive after
    ``grace_s`` of joining (the tests' leak guard)."""
    deadline = time.monotonic() + grace_s
    leaked: List[str] = []
    with _workers_lock:
        workers = list(_workers)
    for w in workers:
        t = w._thread
        if t is None or not w._stop.is_set():
            continue
        t.join(timeout=max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            leaked.append(t.name)
    return leaked


def _shadow(executor, job: dict):
    """The shadow check of one sampled reply: the host oracle over the
    views it served, then the comparison.  Returns (oracle ms,
    equivalent, produced payload, expected payload), the payloads only
    on a divergence."""
    request = job["request"]
    t0 = time.perf_counter()
    oracle = executor.execute_host_oracle(job["views"], request)
    shadow_ms = (time.perf_counter() - t0) * 1000.0
    produced = canonical_payload(request, job["result"])
    expected = canonical_payload(request, oracle)
    if payloads_equivalent(produced, expected):
        return shadow_ms, True, None, None
    return shadow_ms, False, produced, expected


_PRCTL = None  # libc's prctl, resolved in the parent: the child loads nothing


def _die_with_parent(parent: int) -> None:
    if _PRCTL is not None:
        _PRCTL(1, signal.SIGKILL)  # PR_SET_PDEATHSIG: the forking thread's exit kills the child
    if os.getppid() != parent:
        os._exit(0)


def _child_main(executor, jobs: list, w: int, parent: int) -> None:
    """The forked child's whole life: ``_shadow`` over the parent's views
    for each job, the verdicts (``("ok", verdict)`` or ``("error",
    message)`` a job) pickled to ``w``, then ``os._exit``.  It never
    returns into the parent's code, runs no cycle collection (a
    collected tensor of the parent's would reach the CUDA allocator), and
    closes every inherited descriptor but ``w`` and stderr, so a socket
    the parent closes is closed."""
    try:
        gc.disable()
        _die_with_parent(parent)
        null = os.open(os.devnull, os.O_RDWR)
        os.dup2(null, 0)
        os.dup2(null, 1)
        os.close(null)
        os.closerange(3, w)
        os.closerange(w + 1, max(w + 2, os.sysconf("SC_OPEN_MAX")))
        out = []
        for job in jobs:
            try:
                out.append(("ok", _shadow(executor, job)))
            except BaseException as e:  # noqa: BLE001 - reported to the parent as an audit error
                out.append(("error", f"{type(e).__name__}: {e}"))
        data = memoryview(pickle.dumps(out, protocol=pickle.HIGHEST_PROTOCOL))
        while data:
            data = data[os.write(w, data):]
    finally:
        os._exit(0)


def _sample_key(request, views, result, table: str):
    """What makes two samples' verdicts equal: the query and the exact views
    (the result cache's key) and the answer served (its pickled partials);
    None where either cannot be had (no dedupe then)."""
    from pinot_tpu_torch.engine.rescache import ResultCache

    try:
        query = ResultCache.key_for(request, views, table)
        if query is None:
            return None
        answer = pickle.dumps((result.aggregations, result.groups, result.selection_columns,
                               result.selection_rows), protocol=pickle.HIGHEST_PROTOCOL)
    except Exception:  # noqa: BLE001 - an unkeyable sample is audited, never deduped
        return None
    return query, hashlib.blake2b(answer, digest_size=16).digest()


def _kill(pid: int) -> None:
    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


class SamplerBudget:
    """Token bucket shared by EVERY sampler in the process: the "one
    sampler budget" that bounds total audit overhead.  ``take()`` is a
    non-blocking permit check — a sample denied a token is simply not
    audited (counted by the caller as dropped), never queued."""

    def __init__(self, per_s: Optional[float] = None, burst: float = 4.0) -> None:
        self.per_s = (
            per_s
            if per_s is not None
            else env_float("PINOT_TPU_AUDIT_BUDGET_PER_S", 8.0)
        )
        self.burst = max(1.0, burst)
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def take(self, n: float = 1.0) -> bool:
        if self.per_s <= 0:
            return False
        now = time.monotonic()
        with self._lock:
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.per_s
            )
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


# THE shared budget (both auditors in a process draw from it; tests may
# swap in private instances)
BUDGET = SamplerBudget()


# accounting fields every differential strips (freshnessMs included):
# wall-clock, per-tier work
# counters, and scatter topology legitimately differ between a
# production tier and the host oracle / an alternate replica — the DATA
# fields (selection rows, aggregation values, totalDocs, exceptions)
# must not.
ACCOUNTING_FIELDS = (
    "timeUsedMs",
    "requestId",
    "cost",
    "numDocsScanned",
    "numEntriesScannedInFilter",
    "numEntriesScannedPostFilter",
    "numSegmentsQueried",
    "numServersQueried",
    "numServersResponded",
    "numSegmentsUnserved",
    "partialResponse",
    "numRetries",
    "numHedges",
    "freshnessMs",
    "planDigest",
    "traceInfo",
    "explain",
)


def strip_accounting(payload: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(payload)
    for key in ACCOUNTING_FIELDS:
        out.pop(key, None)
    return out


def canonical_payload(request, result) -> Dict[str, Any]:
    """One IntermediateResult -> the comparable client payload: run the
    REAL broker reduce over it (so formatting, trimming, and ordering
    are exactly what a client would see), then strip accounting."""
    from pinot_tpu_torch.engine.reduce import reduce_to_response

    return strip_accounting(reduce_to_response(request, [result], []).to_json())


def _as_number(x: Any) -> Optional[float]:
    if isinstance(x, bool):
        return None
    if isinstance(x, (int, float)):
        return float(x)
    if isinstance(x, str):
        try:
            return float(x)
        except ValueError:
            return None
    return None


def payloads_equivalent(
    a: Any, b: Any, rel_tol: float = 5e-4, abs_tol: float = 1e-3
) -> bool:
    """Structural payload equality with a numeric tolerance on leaves,
    exact everywhere else.

    Why not byte identity: a float32 device sum and the float64 host
    oracle legitimately disagree (accumulation order + precision), and
    byte-comparing the formatted values would quarantine healthy tiers.
    The tolerance is sized for float32 tree-reduction noise at real scan
    sizes — relative error grows ~sqrt(n)·eps, so a 10M-row sum honestly
    wobbles ~2e-4; 5e-4 covers that with margin (an earlier 1e-5 draft
    false-positived on a clean 1M-row Q1 sum and quarantined the healthy
    device tier).  Genuine wrong answers — a corrupted tier, a dropped
    segment, a stale replica — shift aggregates by whole values, orders
    of magnitude above the band, and the exact-aggregate contract (ints,
    min/max, counts) still compares exactly: identical values are always
    close.  Structure, keys, ordering, group labels, and non-numeric
    strings remain byte-exact."""
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return False
        return all(
            payloads_equivalent(a[k], b[k], rel_tol, abs_tol) for k in a
        )
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return False
        return all(
            payloads_equivalent(x, y, rel_tol, abs_tol)
            for x, y in zip(a, b)
        )
    if a == b:
        return True
    na, nb = _as_number(a), _as_number(b)
    if na is None or nb is None:
        return False
    import math

    return math.isclose(na, nb, rel_tol=rel_tol, abs_tol=abs_tol)


# ---------------------------------------------------------------------------
# Server-side shadow differential auditor
# ---------------------------------------------------------------------------


class ShadowAuditor:
    """Background differential checker for one ``ServerInstance``.

    ``offer()`` is the serving-path hook (``_process_traced``, after a
    successful execution): a deterministic 1-in-N counter plus the
    shared token budget decide whether the completed query is queued
    for shadow re-execution.  Holding the offered ``views`` pins the
    exact snapshot production served; the worker replays the request on
    the host oracle and compares canonical payloads."""

    _QUEUE_MAX = 16
    _DIVERGENCE_RING = 16

    def __init__(
        self,
        instance,
        sample_n: Optional[int] = None,
        budget: Optional[SamplerBudget] = None,
    ) -> None:
        self.instance = instance
        self.sample_n = (
            sample_n
            if sample_n is not None
            else env_int("PINOT_TPU_AUDIT_SAMPLE_N", 64)
        )
        self.budget = budget if budget is not None else BUDGET
        self.metrics = instance.metrics
        for m in (
            "audit.samples", "audit.divergences", "audit.dropped",
            "audit.errors", "audit.quarantines", "audit.duplicates",
        ):
            self.metrics.meter(m)
        self._count = 0
        self._queue: deque = deque()
        self._queued_keys: set = set()  # _sample_key of every queued job
        self._divergences: deque = deque(maxlen=self._DIVERGENCE_RING)
        self._trigger = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._child: Optional[int] = None  # the pid of a forked oracle in flight
        self.metrics.gauge("audit.queueDepth").set_fn(lambda: len(self._queue))

    @property
    def enabled(self) -> bool:
        return self.sample_n > 0

    # -- serving-path hook (must stay cheap) ---------------------------
    def offer(self, req: dict, request, views, result) -> bool:
        """Called inline after a successful non-explain, non-join
        execution.  The fast path is one counter increment; only the
        1-in-N winners pay the budget check and enqueue."""
        if not self.enabled or self._stop.is_set():
            return False
        self._count += 1
        if self._count % self.sample_n:
            return False
        if (
            result.exceptions
            or request.explain
            or request.join is not None
            or getattr(result, "_served_tier", None) in (None, "host")
        ):
            # host-served replies ARE the oracle — re-checking them
            # could only burn budget agreeing with itself
            return False
        if not self.budget.take():
            self.metrics.meter("audit.dropped").mark()
            return False
        job = {
            "requestId": str(req.get("requestId") or ""),
            "table": req.get("table", ""),
            "request": request,
            "views": list(views),
            "result": result,
            "enqueuedAt": time.monotonic(),
        }
        key = _sample_key(request, views, result, job["table"])
        with self._lock:
            if key is not None and key in self._queued_keys:
                self.metrics.meter("audit.duplicates").mark()
                return False
            if len(self._queue) >= self._QUEUE_MAX:
                self.metrics.meter("audit.dropped").mark()
                return False
            self._queue.append(job)
            if key is not None:
                self._queued_keys.add(key)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run,
                    name=f"audit-{self.instance.name}",
                    daemon=True,
                )
                with _workers_lock:
                    _workers.append(self)
                self._thread.start()
        self._trigger.set()
        return True

    def stop(self) -> None:
        self._stop.set()
        self._trigger.set()
        with self._lock:
            child = self._child
        if child is not None:
            _kill(child)
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        with self._lock:
            self._queue.clear()
            self._queued_keys.clear()

    # -- worker --------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            if not self._trigger.wait(timeout=0.5):
                continue
            self._trigger.clear()
            while not self._stop.is_set():
                with self._lock:
                    jobs = list(self._queue)
                    self._queue.clear()
                    self._queued_keys.clear()
                if not jobs:
                    break
                if hasattr(os, "fork"):
                    # one child for every queued sample
                    try:
                        verdicts = self._shadow_in_child(jobs)
                    except Exception:
                        logger.exception("shadow audit failed")
                        self.metrics.meter("audit.errors").mark(len(jobs))
                        continue
                    if verdicts is None:
                        return  # stopped mid-audit
                    for job, verdict in zip(jobs, verdicts):
                        job["verdict"] = verdict
                for job in jobs:
                    try:
                        self._audit_one(job)
                    except Exception:
                        # a sick audit must never kill the worker — one
                        # sample is lost, the next drains normally
                        logger.exception("shadow audit failed")
                        self.metrics.meter("audit.errors").mark()

    def _audit_one(self, job: dict) -> None:
        """One sample's verdict: the child's (``job["verdict"]``), or
        ``_shadow`` on this thread where there is no ``fork``."""
        request = job["request"]
        verdict = job.pop("verdict", None)
        if verdict is None:
            verdict = _shadow(self.instance.executor, job)
        else:
            status, verdict = verdict
            if status != "ok":
                raise RuntimeError(f"the shadow oracle failed in its child: {verdict}")
        shadow_ms, same, produced, expected = verdict
        self.metrics.timer("audit.shadowMs").update(shadow_ms)
        self.metrics.meter("audit.samples").mark()
        if same:
            return
        # -- divergence: the device (or an optimization tier) lied -----
        from pinot_tpu_torch.engine.plandigest import plan_shape_digest

        digest = plan_shape_digest(request)
        tier = getattr(job["result"], "_served_tier", "unknown")
        detect_ms = (time.monotonic() - job["enqueuedAt"]) * 1000.0
        self.metrics.meter("audit.divergences").mark()
        self.metrics.meter("audit.quarantines").mark()
        self.metrics.timer("audit.detectMs").update(detect_ms)
        self.instance.executor.audit_quarantine(
            digest, tier, f"shadow differential mismatch ({job['requestId']})"
        )
        record = {
            "requestId": job["requestId"],
            "table": job["table"],
            "planDigest": digest,
            "tier": tier,
            "detectMs": round(detect_ms, 3),
            "ts": round(time.time(), 3),
        }
        self._divergences.append(record)
        logger.warning(
            "AUDIT DIVERGENCE: tier %s served a wrong answer for shape %s "
            "(request %s) — quarantined", tier, digest, job["requestId"],
        )
        self.instance.flightrec.maybe_dump(
            "auditDivergence",
            {
                **record,
                "producedPayload": produced,
                "expectedPayload": expected,
            },
        )

    def _shadow_in_child(self, jobs: list):
        """``_shadow`` of each job in one forked child (module docstring):
        the verdicts, ``("ok", verdict)`` or ``("error", message)`` a job;
        None when ``stop`` killed it."""
        global _PRCTL
        if _PRCTL is None and sys.platform.startswith("linux"):
            import ctypes

            _PRCTL = ctypes.CDLL(None).prctl
        parent = os.getpid()
        r, w = os.pipe()
        t0 = time.perf_counter()
        try:
            pid = os.fork()
        except OSError:
            os.close(r)
            os.close(w)
            raise
        if pid == 0:
            _child_main(self.instance.executor, jobs, w, parent)
        self.metrics.timer("audit.forkMs").update((time.perf_counter() - t0) * 1000.0)
        os.close(w)
        with self._lock:
            self._child = pid
            stopping = self._stop.is_set()
        if stopping:
            _kill(pid)
        try:
            with os.fdopen(r, "rb") as f:
                data = f.read()
        finally:
            with self._lock:
                self._child = None
            os.waitpid(pid, 0)
        if not data:
            if self._stop.is_set():
                return None
            raise RuntimeError("the shadow oracle's child exited without a verdict")
        return pickle.loads(data)

    # -- observability -------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "sampleN": self.sample_n,
            "budgetPerS": self.budget.per_s,
            "offered": self._count,
            "samples": self.metrics.meter("audit.samples").count,
            "divergences": self.metrics.meter("audit.divergences").count,
            "dropped": self.metrics.meter("audit.dropped").count,
            "errors": self.metrics.meter("audit.errors").count,
            "queueDepth": len(self._queue),
            "recentDivergences": list(self._divergences),
            "quarantined": self.instance.executor.audit_quarantined_snapshot(),
        }


# ---------------------------------------------------------------------------
# Broker-side replica divergence auditor
# ---------------------------------------------------------------------------


class ReplicaAuditor:
    """Background replica cross-checker for one broker.

    ``offer()`` samples completed, successful, non-join, non-explain,
    non-partial queries; the worker re-issues the query's FIRST batch
    to both the original server and an alternate covering replica and
    compares the reduced, accounting-stripped payloads.  Realtime
    physical tables are excluded — their replicas consume the stream
    independently, so honest offset drift would read as divergence."""

    _QUEUE_MAX = 8
    _DIVERGENCE_RING = 16

    def __init__(
        self,
        broker,
        sample_n: Optional[int] = None,
        budget: Optional[SamplerBudget] = None,
    ) -> None:
        self.broker = broker
        self.sample_n = (
            sample_n
            if sample_n is not None
            else env_int("PINOT_TPU_AUDIT_REPLICA_N", 256)
        )
        self.budget = budget if budget is not None else BUDGET
        self.metrics = broker.metrics
        for m in (
            "audit.replicaChecks", "audit.replicaDivergences",
            "audit.replicaDropped", "audit.replicaErrors",
        ):
            self.metrics.meter(m)
        self._count = 0
        self._queue: deque = deque()
        self._divergences: deque = deque(maxlen=self._DIVERGENCE_RING)
        self._trigger = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self.sample_n > 0

    def offer(
        self,
        request,
        batches,
        request_id: str,
        timeout_ms: float,
        resp,
    ) -> bool:
        """Serving-path hook (end of ``_handle_admitted``): cheap
        counter first, then eligibility, then the shared budget."""
        if not self.enabled or self._stop.is_set() or not batches:
            return False
        self._count += 1
        if self._count % self.sample_n:
            return False
        if (
            request.explain
            or request.join is not None
            or resp.exceptions
            or resp.partial_response
        ):
            return False
        batch = batches[0]
        if batch.table.endswith("_REALTIME"):
            return False
        if not self.broker.routing.has_alternate(
            batch.table, list(batch.segments), {batch.server}
        ):
            return False  # replication factor 1: nothing to cross-check
        if not self.budget.take():
            self.metrics.meter("audit.replicaDropped").mark()
            return False
        job = {
            "requestId": request_id,
            "table": batch.table,
            "pql": batch.pql,
            "segments": list(batch.segments),
            "server": batch.server,
            "timeoutMs": float(timeout_ms),
            "enqueuedAt": time.monotonic(),
        }
        with self._lock:
            if len(self._queue) >= self._QUEUE_MAX:
                self.metrics.meter("audit.replicaDropped").mark()
                return False
            self._queue.append(job)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run,
                    name=f"replica-audit-{self.broker.name}",
                    daemon=True,
                )
                with _workers_lock:
                    _workers.append(self)
                self._thread.start()
        self._trigger.set()
        return True

    def stop(self) -> None:
        self._stop.set()
        self._trigger.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        with self._lock:
            self._queue.clear()

    # -- worker --------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            if not self._trigger.wait(timeout=0.5):
                continue
            self._trigger.clear()
            while not self._stop.is_set():
                with self._lock:
                    job = self._queue.popleft() if self._queue else None
                if job is None:
                    break
                try:
                    self._audit_one(job)
                except Exception:
                    logger.exception("replica audit failed")
                    self.metrics.meter("audit.replicaErrors").mark()

    def _reduced(self, request, parts) -> Dict[str, Any]:
        from pinot_tpu_torch.engine.reduce import reduce_to_response

        return strip_accounting(reduce_to_response(request, parts, []).to_json())

    def _audit_one(self, job: dict) -> None:
        from pinot_tpu_torch.pql import optimize_request, parse_pql

        request = optimize_request(parse_pql(job["pql"]))
        assignment, leftover = self.broker.routing.alternates(
            job["table"], job["segments"], {job["server"]}
        )
        if leftover or not assignment:
            return  # the alternate cover evaporated since the offer
        aid = f"{job['requestId']}-raudit"
        primary = self.broker._send_one(
            job["server"], job["table"], job["pql"], job["segments"],
            trace=False, debug_options=None, timeout_ms=job["timeoutMs"],
            attempt_timeout_ms=None, request_id=f"{aid}-p",
        )
        alternates = [
            self.broker._send_one(
                server, job["table"], job["pql"], list(segments),
                trace=False, debug_options=None, timeout_ms=job["timeoutMs"],
                attempt_timeout_ms=None, request_id=f"{aid}-a",
            )
            for server, segments in sorted(assignment.items())
        ]
        if primary.exceptions or any(a.exceptions for a in alternates):
            return  # an errored re-issue proves nothing about data
        self.metrics.meter("audit.replicaChecks").mark()
        lhs = self._reduced(request, [primary])
        rhs = self._reduced(request, alternates)
        divergent = not payloads_equivalent(lhs, rhs)
        record = {
            "requestId": job["requestId"],
            "table": job["table"],
            "server": job["server"],
            "alternates": sorted(assignment),
            "divergent": divergent,
            "detectMs": round(
                (time.monotonic() - job["enqueuedAt"]) * 1000.0, 3
            ),
            "ts": round(time.time(), 3),
        }
        # cross-link: the slow-query log entry (when recorded) gains the
        # audit verdict, so /debug/queries answers "was this checked?"
        self.broker.querylog.annotate(
            job["requestId"], auditRef={"type": "replica", "divergent": divergent}
        )
        if not divergent:
            return
        self.metrics.meter("audit.replicaDivergences").mark()
        self._divergences.append(record)
        logger.warning(
            "REPLICA DIVERGENCE: %s vs %s disagree on table %s (request %s)",
            job["server"], sorted(assignment), job["table"], job["requestId"],
        )
        self.broker.flightrec.maybe_dump(
            "replicaDivergence",
            {**record, "primaryPayload": lhs, "alternatePayload": rhs},
        )

    def snapshot(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "sampleN": self.sample_n,
            "budgetPerS": self.budget.per_s,
            "offered": self._count,
            "checks": self.metrics.meter("audit.replicaChecks").count,
            "divergences": self.metrics.meter("audit.replicaDivergences").count,
            "dropped": self.metrics.meter("audit.replicaDropped").count,
            "errors": self.metrics.meter("audit.replicaErrors").count,
            "queueDepth": len(self._queue),
            "recentDivergences": list(self._divergences),
        }
