"""Per-request distributed tracing: hierarchical span trees.

The reference registers a requestId-scoped trace registry and wraps
worker threads so operators can log step latencies
(``core/util/trace/TraceContext.java:41``, ``TraceRunnable``); the trace
rides back in DataTable metadata and is merged per server
(``BrokerReduceService.java:84-87``).

Here each role builds a span TREE per request: every span carries a
scope-prefixed id, a parent id, a wall-clock anchor (epoch ms, so
broker and server trees align on one waterfall), a duration, and a
tag dict.  Spans serialize as plain dicts so they ride the DataTable
``trace`` metadata unchanged and merge broker-side into
``BrokerResponse.traceInfo`` (the broker re-parents each server tree
under the scatter attempt that carried it — ``broker/broker.py``).

Span dict schema (the wire/JSON contract, see README "Observability"):

    {"span": name, "id": "scope:n", "parent": "scope:m" | None,
     "startMs": epoch_ms, "ms": duration_ms, "tags": {..}}

``tags`` is omitted when empty; events are spans with ``ms == 0``.

ZERO-OVERHEAD WHEN DISABLED: a disabled context's ``span()`` returns a
shared no-op context manager and ``add``/``event`` return immediately —
no span dicts, no generator frames.  ``SPAN_ALLOCATIONS`` counts every
span dict ever built so tests can assert the disabled path allocates
none.  Parenting uses contextvars (a per-thread span stack), not thread
wrappers.

(Copy of ``pinot_tpu.utils.trace``.)
"""
from __future__ import annotations

import contextvars
import threading
import time
from typing import Any, Dict, List, Optional

_current: contextvars.ContextVar[Optional["TraceContext"]] = contextvars.ContextVar(
    "pinot_tpu_torch_trace", default=None
)
# stack of span ids for the current thread/task: the top is the parent
# of the next span opened on this thread
_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "pinot_tpu_torch_trace_stack", default=()
)

# module-wide count of span dicts ever allocated — the disabled-trace
# zero-overhead guard (tests assert no delta across an untraced query)
SPAN_ALLOCATIONS = 0


class _NullSpan:
    """Shared no-op context manager for disabled traces."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Open-span context manager: allocates the span dict on enter (so
    children opened inside can reference its id), fills the duration on
    exit, and keeps the contextvar parent stack balanced."""

    __slots__ = ("_ctx", "_span", "_token", "_t0")

    def __init__(self, ctx: "TraceContext", name: str, tags: Dict[str, Any]) -> None:
        self._ctx = ctx
        self._span = ctx._alloc(name, 0.0, time.time() * 1000.0, _parent_id(), tags)
        self._token = None
        self._t0 = 0.0

    def __enter__(self):
        self._token = _stack.set(_stack.get() + (self._span["id"],))
        self._t0 = time.perf_counter()
        return self._span

    def __exit__(self, *exc):
        self._span["ms"] = round((time.perf_counter() - self._t0) * 1000.0, 3)
        if self._token is not None:
            _stack.reset(self._token)
        return False


def _parent_id() -> Optional[str]:
    stack = _stack.get()
    return stack[-1] if stack else None


class TraceContext:
    """One role's span tree for one request (requestId-scoped)."""

    __slots__ = ("enabled", "scope", "trace_id", "spans", "_seq", "_lock")

    def __init__(self, enabled: bool = False, scope: str = "", trace_id: str = "") -> None:
        self.enabled = enabled
        self.scope = scope
        self.trace_id = trace_id
        self.spans: List[Dict[str, Any]] = []
        self._seq = 0
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------
    def _alloc(
        self,
        name: str,
        ms: float,
        start_ms: float,
        parent: Optional[str],
        tags: Dict[str, Any],
    ) -> Dict[str, Any]:
        global SPAN_ALLOCATIONS
        with self._lock:
            self._seq += 1
            sid = f"{self.scope}:{self._seq}"
            span: Dict[str, Any] = {
                "span": name,
                "id": sid,
                "parent": parent,
                "startMs": round(start_ms, 3),
                "ms": ms,
            }
            if tags:
                span["tags"] = dict(tags)
            self.spans.append(span)
            SPAN_ALLOCATIONS += 1
            return span

    def span(self, name: str, **tags):
        """Open a timed child span (context manager).  Nesting on the
        same thread parents automatically via the contextvar stack."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, tags)

    def add(
        self,
        name: str,
        ms: float,
        start_ms: Optional[float] = None,
        parent: Optional[str] = "__auto__",
        **tags,
    ) -> Optional[str]:
        """Record an already-measured span; returns its id.  ``start_ms``
        defaults to now minus the duration; ``parent`` defaults to the
        calling thread's current span (pass ``None`` for a root)."""
        if not self.enabled:
            return None
        if start_ms is None:
            start_ms = time.time() * 1000.0 - ms
        p = _parent_id() if parent == "__auto__" else parent
        return self._alloc(name, round(ms, 3), start_ms, p, tags)["id"]

    def event(self, name: str, **tags) -> Optional[str]:
        """Zero-duration marker span (retry / failover / coalesce-hit)."""
        if not self.enabled:
            return None
        return self._alloc(name, 0.0, time.time() * 1000.0, _parent_id(), tags)["id"]

    # -- export --------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """{scope: [span dicts]} — the shape that rides DataTable
        ``trace`` metadata; empty when disabled or nothing recorded."""
        if not self.enabled or not self.spans:
            return {}
        with self._lock:
            return {self.scope: list(self.spans)}


# a single shared disabled context: callers on the untraced path reuse
# it instead of constructing a TraceContext per request
NULL_TRACE = TraceContext(enabled=False)


def current_trace() -> Optional[TraceContext]:
    return _current.get()


def set_current(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the thread's current trace; returns the token
    for ``reset_current``.  Used by scheduler workers, which do not
    inherit the submitting thread's context."""
    return _current.set(ctx)


def reset_current(token) -> None:
    _current.reset(token)


def merge_scope(
    scopes: Dict[str, List[Dict[str, Any]]],
    incoming: Dict[str, List[Dict[str, Any]]],
    root_parent: Optional[str] = None,
) -> None:
    """Merge one reply's {scope: spans} into an accumulating scope map.

    Root spans (parent None) of each incoming tree are re-parented onto
    ``root_parent`` (the broker's serverAttempt span), linking all trees
    into one.  When the same scope already exists (two batches answered
    by one server), the incoming tree is stored under ``scope#k`` with
    its internal ids rewritten, so parent links stay unambiguous."""
    for scope, spans in incoming.items():
        key = scope
        k = 1
        while key in scopes:
            k += 1
            key = f"{scope}#{k}"
        if key != scope:
            prefix = f"{scope}:"
            new_prefix = f"{key}:"

            def _remap(sid):
                if isinstance(sid, str) and sid.startswith(prefix):
                    return new_prefix + sid[len(prefix):]
                return sid

            spans = [
                dict(s, id=_remap(s.get("id")), parent=_remap(s.get("parent")))
                for s in spans
            ]
        else:
            spans = [dict(s) for s in spans]
        if root_parent is not None:
            for s in spans:
                if s.get("parent") is None:
                    s["parent"] = root_parent
        scopes[key] = spans
