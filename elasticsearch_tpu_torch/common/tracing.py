"""Per-request span-tree tracing (lightweight, always-cheap).

Reference analog: the `X-Opaque-Id` header + task-manager description
propagation in org.elasticsearch.tasks, and the APM-style span trees
the reference ships via apm-agent — here a minimal in-process recorder
so a single slow request can be decomposed (queue wait vs. kernel vs.
merge vs. fetch) without any external collector.

Design:
  * `Trace` holds a bounded list of `Span`s (nanosecond marks of one
    clock, `now_ns()`: CLOCK_MONOTONIC, the clock `time.monotonic()`
    reads, so a span can be laid over a device trace mapped onto it;
    parent/child ids, free-form tags like index/shard/bucket).
  * `TRACE_CTX` is a contextvar: the REST layer arms it per request
    (`begin()` / `end()`), and every seam that wants a span just reads
    the var — `None` means tracing is off and costs one dict lookup.
    Fan-out pools propagate the var with `contextvars.copy_context()`;
    the Trace object itself is shared and thread-safe, so spans added
    from shard/leg worker threads land in the request's tree. The
    batcher's jobs carry the trace and their parent span id to its
    worker threads, which record their spans into it from marks.
  * A span recorded after its children reserves its id first
    (`Trace.reserve()`, then `add_span(..., span_id=...)`), and code
    below it parents onto it through `set_parent()`.
  * Completed traces go into a bounded ring (`ES_TPU_TRACE_RING`,
    default 256) queryable via `GET /_internal/traces` — a test/smoke
    surface, not a production exporter.
  * `ES_TPU_TRACING=off` disables arming entirely (`begin()` → None).

`OPAQUE_ID_CTX` carries the request's `X-Opaque-Id` header value so
task descriptions, slow-log records, and traces can all attribute work
to the caller's id without threading a parameter through every layer.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# the CURRENT request's X-Opaque-Id header (None outside a request or
# when the client sent none)
OPAQUE_ID_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "opaque_id", default=None
)

# the CURRENT request's Trace (None = tracing off / not a traced path)
TRACE_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "trace_ctx", default=None
)

# parent span id for nested `Trace.span()` scopes (copy-on-thread via
# contextvars, so concurrent legs each see their own parent chain)
_PARENT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "span_parent", default=None
)

# hard cap per trace: a runaway fan-out must not grow one trace without
# bound (drops are counted, not silent)
MAX_SPANS = 512

_trace_ids = itertools.count(1)

# the clock of every span mark (CLOCK_MONOTONIC)
CLOCK = "CLOCK_MONOTONIC"
now_ns = time.monotonic_ns


def enabled() -> bool:
    return os.environ.get("ES_TPU_TRACING", "on").lower() not in (
        "off", "0", "false",
    )


def _ring_cap() -> int:
    try:
        return max(1, int(os.environ.get("ES_TPU_TRACE_RING", "256")))
    except ValueError:
        return 256


class Span:
    __slots__ = ("id", "parent_id", "name", "start_ns", "end_ns", "tags")

    def __init__(
        self, id: int, parent_id: Optional[int], name: str,
        start_ns: int, end_ns: int, tags: Dict[str, Any],
    ):
        self.id = id
        self.parent_id = parent_id
        self.name = name
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.tags = tags

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_ns": self.start_ns,
            "duration_ns": max(0, self.end_ns - self.start_ns),
            "tags": self.tags,
        }


class Trace:
    """One request's span tree. Thread-safe: fan-out worker threads
    append concurrently (the object rides a copied context into the
    pools). Marks are `now_ns()` (CLOCK_MONOTONIC), so spans recorded
    on different threads order correctly within one host."""

    def __init__(self, name: str, opaque_id: Optional[str] = None,
                 **tags: Any):
        self.trace_id = f"trace-{next(_trace_ids)}"
        self.name = name
        self.opaque_id = opaque_id
        self.tags = dict(tags)
        self.start_ns = now_ns()
        self.end_ns: Optional[int] = None
        self.wall_start = time.time()
        self._spans: List[Span] = []
        self._dropped = 0
        self._span_ids = itertools.count(1)
        self._lock = threading.Lock()

    # ---- recording ----

    def reserve(self) -> int:
        """A span id for a span recorded later, after its children."""
        with self._lock:
            return next(self._span_ids)

    def add_span(
        self, name: str, start_ns: int, end_ns: int,
        parent_id: Optional[int] = None, span_id: Optional[int] = None,
        **tags: Any,
    ) -> Optional[int]:
        """Retroactive span from two already-taken `now_ns()` marks (the
        cheap pattern for code that timed itself anyway), under the id
        `span_id` reserved for it if given. Returns the span id, or None
        if the trace is full."""
        if parent_id is None:
            parent_id = _PARENT_CTX.get()
        with self._lock:
            if len(self._spans) >= MAX_SPANS:
                self._dropped += 1
                return None
            sid = next(self._span_ids) if span_id is None else span_id
            self._spans.append(
                Span(sid, parent_id, name, int(start_ns), int(end_ns), tags)
            )
        return sid

    def span(self, name: str, **tags: Any):
        """Context-manager scope: times the block and parents any span
        recorded inside it (contextvar chain, thread-local per leg)."""
        return _SpanScope(self, name, tags)

    def finish(self) -> None:
        """Closes the trace and publishes it to the ring."""
        if self.end_ns is not None:
            return
        self.end_ns = now_ns()
        _ring_append(self)

    # ---- export ----

    def to_dict(self) -> dict:
        with self._lock:
            spans = [s.to_dict() for s in self._spans]
            dropped = self._dropped
        end = self.end_ns or now_ns()
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "opaque_id": self.opaque_id,
            "tags": self.tags,
            "started_at": self.wall_start,
            "duration_ns": max(0, end - self.start_ns),
            "span_count": len(spans),
            "dropped_spans": dropped,
            "spans": spans,
        }


class _SpanScope:
    __slots__ = ("trace", "name", "tags", "t0", "_tok")

    def __init__(self, trace: Trace, name: str, tags: Dict[str, Any]):
        self.trace = trace
        self.name = name
        self.tags = tags
        self.t0 = 0
        self._tok = None

    def __enter__(self):
        self.t0 = now_ns()
        # reserve the id up front so children can parent onto it; the
        # end time is patched at exit
        with self.trace._lock:
            sid = next(self.trace._span_ids)
        self._tok = _PARENT_CTX.set(sid)
        return self

    def __exit__(self, exc_type, exc, tb):
        end = now_ns()
        sid = _PARENT_CTX.get()
        parent = None
        if self._tok is not None:
            parent = self._tok.old_value
            if parent is contextvars.Token.MISSING:
                parent = None
            _PARENT_CTX.reset(self._tok)
        with self.trace._lock:
            if len(self.trace._spans) >= MAX_SPANS:
                self.trace._dropped += 1
            else:
                self.trace._spans.append(
                    Span(sid, parent, self.name, self.t0, end, self.tags)
                )
        return False


# ---- completed-trace ring (GET /_internal/traces) ----

_ring_lock = threading.Lock()
_ring: deque = deque(maxlen=_ring_cap())


def _ring_append(trace: Trace) -> None:
    with _ring_lock:
        _ring.append(trace)


def recent(n: int = 50) -> List[dict]:
    """Newest-first dicts of the last `n` completed traces."""
    with _ring_lock:
        traces = list(_ring)[-max(0, int(n)):]
    return [t.to_dict() for t in reversed(traces)]


def clear() -> None:
    with _ring_lock:
        _ring.clear()


# ---- REST-layer arming helpers ----

def begin(name: str, **tags: Any):
    """Arms TRACE_CTX for the current context. Returns an opaque handle
    for `end()`, or None when tracing is disabled."""
    if not enabled():
        return None
    tr = Trace(name, opaque_id=OPAQUE_ID_CTX.get(), **tags)
    tok = TRACE_CTX.set(tr)
    return (tr, tok)


def end(handle) -> None:
    """Finishes the trace begun by `begin()` (no-op on None)."""
    if handle is None:
        return
    tr, tok = handle
    try:
        TRACE_CTX.reset(tok)
    except ValueError:  # pragma: no cover - cross-context reset
        TRACE_CTX.set(None)
    tr.finish()


def current() -> Optional[Trace]:
    return TRACE_CTX.get()


def parent() -> Optional[int]:
    """The id of the span open in the current context (None: none)."""
    return _PARENT_CTX.get()


def set_parent(span_id: Optional[int]):
    """Parents the spans recorded in the current context onto
    `span_id` until `reset_parent()` with the returned token."""
    return _PARENT_CTX.set(span_id)


def reset_parent(token) -> None:
    _PARENT_CTX.reset(token)
