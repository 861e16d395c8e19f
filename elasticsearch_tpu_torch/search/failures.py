"""Shard-failure accounting for fault-tolerant search execution.

Reference analogs: org.elasticsearch.action.search.ShardSearchFailure
(the per-shard failure entries inside `_shards.failures`),
SearchPhaseExecutionException (the 503 raised when
allow_partial_search_results=false), and the per-request search
timeout (`SearchSourceBuilder.timeout()` → QueryPhase's cooperative
timer → `timed_out: true` with accumulated partial hits).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional


class SearchTimeoutError(Exception):
    """A shard exceeded the request's search timeout budget. The
    coordinator converts it into a timed-out shard entry + partial
    results rather than failing the request."""

    err_type = "timeout_exception"

    def __init__(self, reason: str = "search timed out"):
        super().__init__(reason)
        self.reason = reason


def failure_type(exc: BaseException) -> str:
    """Wire error type for an exception (ElasticsearchException
    .getExceptionName analog): explicit err_type attr when present,
    else the snake_cased class name."""
    et = getattr(exc, "err_type", None)
    if isinstance(et, str) and et:
        return et
    name = type(exc).__name__
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


def shard_failure(
    index: str, shard: int, node: Optional[str], exc: BaseException
) -> Dict[str, Any]:
    """One `_shards.failures[]` entry (ShardSearchFailure.toXContent
    shape: shard / index / node / nested reason {type, reason})."""
    return {
        "shard": int(shard),
        "index": index,
        "node": node,
        "reason": {"type": failure_type(exc), "reason": str(exc)},
    }


def parse_timeout(value) -> Optional[float]:
    """Request `timeout` → seconds. None / -1 / "-1" = no timeout;
    bare numbers are milliseconds (TimeValue's default search-timeout
    unit); "50ms"/"1s"/"2m" parse as usual. Malformed values raise."""
    if value is None:
        return None
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return None if value < 0 else float(value) / 1000.0
    s = str(value).strip()
    if s in ("", "-1"):
        return None
    for suffix, mult in (
        ("ms", 0.001), ("s", 1.0), ("m", 60.0), ("h", 3600.0),
    ):
        if s.endswith(suffix):
            num = s[: -len(suffix)]
            try:
                return float(num) * mult
            except ValueError:
                break
    try:
        return float(s) / 1000.0
    except ValueError:
        raise ValueError(
            f"failed to parse setting [timeout] with value [{value}]"
        )


def parse_allow_partial(value, default: bool = True) -> bool:
    """allow_partial_search_results accepts bool or its string forms
    (the query-string path delivers strings)."""
    if value is None:
        return default
    if isinstance(value, bool):
        return value
    return str(value).lower() not in ("false", "0")


def deadline_from(body: dict) -> Optional[float]:
    """Monotonic deadline for a request body carrying `timeout`, or
    None when untimed."""
    t = parse_timeout(body.get("timeout"))
    if t is None:
        return None
    return time.monotonic() + t
