"""Fleet plan prewarming: launch the hot working set BEFORE it serves
(port of ``pinot_tpu.server.prewarm``).

A restarted server (rollout, rebalance destination, crash recovery)
starts with an empty lane compile timeline: every plan shape's first
launch pays, on the live query, what a first launch costs on the card
(the CUDA module's lazy load of the kernel instantiation, the caching
allocator's first blocks; ``compile.firstCallMs``).  At segment-load
time this worker pulls the fleet's top-K plan shapes for the tables the
server hosts (the controller's ``/debug/workload``), rebuilds each
shape's phantom staged metadata (``engine/explain.build_prewarm_spec``:
nothing of the table is staged) and launches its kernel instantiations
once on this background thread's own CUDA stream.  The serving lane is
never entered: the first real query of a prewarmed shape counts
``compile.warm`` (its digest ``compile.prewarmed``), never
``compile.cold``, and never meets the lane's stall watchdog.

Readiness: ``request_prewarm`` flips the worker to *warming*
synchronously; it returns to *ready* when the pass drains or its deadline
(``PINOT_TPU_PREWARM_TIMEOUT_S``) expires.  The networked starter reports
the flag on every heartbeat; brokers deprioritize (never exclude) a
warming replica.

Knobs: ``PINOT_TPU_PREWARM_TOP_K`` (shapes a pass, default 8; 0
disables), ``PINOT_TPU_PREWARM_TIMEOUT_S`` (a pass's deadline, default
30 s).  With no workload source wired (plain in-process instances) the
worker never starts and the server is always ready.  The stabilizer
holds an old replica's trim while its destination warms, up to the
same timeout (``SelfStabilizer._destinations_ready``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, List, Optional

logger = logging.getLogger(__name__)

# every worker that ever started a thread, for the test-suite leak
# guard (workers still serving are exempt — a STOPPED worker whose
# thread survives is the leak, matching the other conftest guards)
_workers: List["PrewarmWorker"] = []
_workers_lock = threading.Lock()


def leaked_prewarm_threads(grace_s: float = 2.0) -> List[str]:
    """Names of prewarm threads of STOPPED workers still alive after
    ``grace_s`` of joining (conftest guard: ``stop()`` must actually
    end the worker).  Workers still serving (live servers held by
    module-scoped fixtures) are exempt."""
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


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class PrewarmWorker:
    """Background prewarm driver for one ``ServerInstance``.

    ``workload_source(tables, n)`` is the pluggable fleet-workload feed:
    it returns plan-stat entries (``utils/planstats`` ``_entry_dict``
    shape — ``exemplarPql`` + ``table`` are what matters here) ranked
    hottest-first, already filtered to ``tables``.  The in-process
    starter feeds it from the local broker's registry; the networked
    starter fetches the controller's fleet roll-up over HTTP.
    """

    def __init__(
        self,
        instance,
        workload_source: Optional[Callable[[List[str], int], List[dict]]] = None,
        top_k: Optional[int] = None,
        timeout_s: Optional[float] = None,
    ) -> None:
        self.instance = instance
        self.workload_source = workload_source
        self.top_k = (
            top_k
            if top_k is not None
            else _env_int("PINOT_TPU_PREWARM_TOP_K", 8)
        )
        self.timeout_s = (
            timeout_s
            if timeout_s is not None
            else _env_float("PINOT_TPU_PREWARM_TIMEOUT_S", 30.0)
        )
        self.metrics = instance.metrics
        for m in (
            "prewarm.shapes", "prewarm.compiled",
            "prewarm.skipped", "prewarm.failed",
        ):
            self.metrics.meter(m)
        self._warming = False
        self._last_pass_ms: Optional[float] = None
        self._trigger = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.metrics.gauge("server.warming").set_fn(
            lambda: 1 if self._warming else 0
        )

    # -- lifecycle ----------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.workload_source is not None and self.top_k > 0

    def request_prewarm(self, table: Optional[str] = None) -> None:
        """Ask for a prewarm pass (segment load / registration / table
        assignment).  Flips to *warming* synchronously — the next
        heartbeat already reports it — and wakes the worker; triggers
        arriving during a pass coalesce into one follow-up pass."""
        if not self.enabled or self._stop.is_set():
            return
        with self._lock:
            self._warming = True
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run,
                    name=f"prewarm-{self.instance.name}",
                    daemon=True,
                )
                with _workers_lock:
                    _workers.append(self)
                self._thread.start()
        self._trigger.set()

    def stop(self) -> None:
        self._stop.set()
        self._trigger.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        with self._lock:
            self._warming = False

    # -- readiness surface --------------------------------------------
    @property
    def warming(self) -> bool:
        return self._warming

    def state(self) -> dict:
        return {
            "warming": self._warming,
            "ready": not self._warming,
            "enabled": self.enabled,
            "topK": self.top_k,
            "timeoutS": self.timeout_s,
            "lastPassMs": self._last_pass_ms,
            "compiled": self.metrics.meter("prewarm.compiled").count,
            "skipped": self.metrics.meter("prewarm.skipped").count,
            "failed": self.metrics.meter("prewarm.failed").count,
        }

    # -- worker -------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            if not self._trigger.wait(timeout=0.5):
                continue
            # debounce: segment loads arrive in bursts; let the burst
            # settle so one pass covers the whole assignment
            self._stop.wait(0.05)
            self._trigger.clear()
            if self._stop.is_set():
                break
            t0 = time.perf_counter()
            try:
                self._pass()
            except Exception:
                # the worker must never die on a feed or launch surprise —
                # a failed pass just means colder first queries
                logger.exception("prewarm pass failed")
                self.metrics.meter("prewarm.failed").mark()
            self._last_pass_ms = round((time.perf_counter() - t0) * 1000.0, 3)
            if not self._trigger.is_set():
                # no new trigger arrived during the pass: warmed up
                self._warming = False

    def _hosted_tables(self) -> List[str]:
        raw = {
            self.instance._raw_table(t)
            for t in self.instance.data_manager.table_names()
        }
        return sorted(raw)

    def _pass(self) -> None:
        deadline = time.monotonic() + max(0.1, self.timeout_s)
        tables = self._hosted_tables()
        if not tables:
            return
        try:
            entries = self.workload_source(tables, self.top_k) or []
        except Exception as e:
            logger.warning("prewarm workload fetch failed: %s", e)
            self.metrics.meter("prewarm.failed").mark()
            return
        capped = entries[: self.top_k]
        for i, entry in enumerate(capped):
            if self._stop.is_set():
                return
            if time.monotonic() >= deadline:
                # deadline-capped: whatever is left pays its first launch
                # on the serving path (honestly counted there)
                remaining = len(capped) - i
                self.metrics.meter("prewarm.skipped").mark(max(1, remaining))
                logger.warning(
                    "prewarm deadline (%.1fs) hit with %d shapes left",
                    self.timeout_s, remaining,
                )
                return
            self.metrics.meter("prewarm.shapes").mark()
            try:
                if not self._prewarm_entry(entry):
                    self.metrics.meter("prewarm.skipped").mark()
            except Exception as e:
                logger.warning(
                    "prewarm failed for shape %s: %s",
                    entry.get("digest", "?"), e,
                )
                self.metrics.meter("prewarm.failed").mark()

    def _prewarm_entry(self, entry: dict) -> bool:
        """Prewarm one workload entry's exemplar shape.  Returns True when
        a launch happened (False: nothing to do — no exemplar, table not
        hosted here, shape already launched here, or the plan runs off
        the card)."""
        pql = entry.get("exemplarPql") or ""
        if not pql:
            return False
        from pinot_tpu_torch.engine.explain import build_prewarm_spec
        from pinot_tpu_torch.pql import optimize_request, parse_pql

        request = optimize_request(parse_pql(pql))
        if request.explain:
            return False
        raw = self.instance._raw_table(request.table_name)
        compiled_any = False
        for tname in self.instance.data_manager.table_names():
            if self.instance._raw_table(tname) != raw:
                continue
            tdm = self.instance.data_manager.table(tname)
            if tdm is None:
                continue
            acquired = tdm.acquire_segments()
            try:
                views = [a.query_view() for a in acquired]
                spec = build_prewarm_spec(self.instance.executor, views, request)
            finally:
                tdm.release_segments(acquired)
            if spec is None:
                continue
            # the launch runs HERE, on this background thread and its own
            # stream: the serving lane is never entered, so prewarm never
            # stalls a live launch or trips the watchdog.  The phantom
            # holds metadata only, so the segments are already released.
            t0 = time.perf_counter()
            spec["compile"]()
            compile_ms = (time.perf_counter() - t0) * 1000.0
            if spec["lane"].record_prewarmed(spec["planDigest"], compile_ms):
                self.metrics.meter("prewarm.compiled").mark()
                compiled_any = True
        return compiled_any
