"""Per-index search slow logs.

Reference analog: `index.search.slowlog.threshold.{query,fetch}.{warn,
info,debug,trace}` in org.elasticsearch.index.SearchSlowLog — dynamic
per-index thresholds, one structured single-line record per offending
phase, emitted through a per-index logger so operators can route/filter
by index name.

Here each index owns a `SearchSlowLog` bound to the stdlib logger
`index.search.slowlog.<index>`; records are one-line JSON (took,
shards, truncated source, X-Opaque-Id, profile summary when the request
was profiled). Counters per level feed `{index}/_stats` so tests and
dashboards can assert firing without scraping log output.

`FETCH_ACC` is the fetch-phase accumulator: `IndexService.search()`
arms it with a mutable dict, shard fetch loops add their nanoseconds
(the dict object is shared across fan-out threads via copied
contexts), and the coordinator reads the total for the fetch-phase
threshold check. It is always-on and costs one contextvar read plus an
int add per shard.
"""

from __future__ import annotations

import contextvars
import json
import logging
import threading
from typing import Any, Dict, Optional

# fetch-phase time accumulator for the current request:
# {"fetch_ns": int} or None outside a search
FETCH_ACC: contextvars.ContextVar = contextvars.ContextVar(
    "fetch_acc", default=None
)

LEVELS = ("warn", "info", "debug", "trace")

_LOG_LEVELS = {
    "warn": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": logging.DEBUG,
}

_SOURCE_CAP = 1000  # chars of serialized source kept per record


def parse_threshold_ms(value) -> float:
    """Setting value -> threshold in fractional ms. "-1" (or any
    negative) disables; "0" fires on every request; otherwise accepts
    bare numbers (ms) or the suffixed forms the settings parser emits
    (ns/micros/ms/s/m/h)."""
    if value is None:
        return -1.0
    s = str(value).strip().lower()
    if not s:
        return -1.0
    mult = 1.0  # -> ms
    for suffix, m in (
        ("micros", 1e-3), ("nanos", 1e-6), ("ns", 1e-6),
        ("ms", 1.0), ("s", 1000.0), ("m", 60000.0), ("h", 3600000.0),
    ):
        if s.endswith(suffix):
            s = s[: -len(suffix)]
            mult = m
            break
    try:
        v = float(s)
    except ValueError:
        return -1.0
    if v < 0:
        return -1.0
    return v * mult


def pick_level(took_ms: float, thresholds: Dict[str, float]) -> Optional[str]:
    """Most severe level whose enabled threshold the took meets.
    Severity order is warn > info > debug > trace, so scanning in
    LEVELS order returns the right record level when several match."""
    for lvl in LEVELS:
        t = thresholds.get(lvl, -1.0)
        if t >= 0 and took_ms >= t:
            return lvl
    return None


class SearchSlowLog:
    """Per-index slow-log emitter with dynamic thresholds."""

    def __init__(self, index_name: str):
        self.index = index_name
        self._logger = logging.getLogger(f"index.search.slowlog.{index_name}")
        self._lock = threading.Lock()
        # phase -> level -> threshold in ms (-1 disabled)
        self._thresholds: Dict[str, Dict[str, float]] = {
            "query": {lvl: -1.0 for lvl in LEVELS},
            "fetch": {lvl: -1.0 for lvl in LEVELS},
        }
        self.counters: Dict[str, int] = {
            f"{phase}_{lvl}": 0
            for phase in ("query", "fetch") for lvl in LEVELS
        }

    # ---- configuration ----

    def configure(self, settings: Dict[str, Any]) -> None:
        """Reads the flat `search.slowlog.threshold.*` keys from an
        index settings dict (values as stored by the settings layer)."""
        with self._lock:
            for phase in ("query", "fetch"):
                for lvl in LEVELS:
                    key = f"search.slowlog.threshold.{phase}.{lvl}"
                    if key in settings:
                        self._thresholds[phase][lvl] = parse_threshold_ms(
                            settings[key]
                        )

    def thresholds(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {p: dict(t) for p, t in self._thresholds.items()}

    def enabled(self) -> bool:
        with self._lock:
            return any(
                t >= 0
                for phase in self._thresholds.values()
                for t in phase.values()
            )

    # ---- emission ----

    def on_search(
        self,
        took_ms: float,
        fetch_ms: float,
        *,
        shards: int = 1,
        source: Optional[dict] = None,
        opaque_id: Optional[str] = None,
        profile_summary: Optional[dict] = None,
    ) -> Dict[str, Optional[str]]:
        """Called once per completed coordinator search. Returns the
        levels that fired per phase (for tests); emits at most one
        record per phase."""
        with self._lock:
            q_lvl = pick_level(took_ms, self._thresholds["query"])
            f_lvl = pick_level(fetch_ms, self._thresholds["fetch"])
            if q_lvl:
                self.counters[f"query_{q_lvl}"] += 1
            if f_lvl:
                self.counters[f"fetch_{f_lvl}"] += 1
        if q_lvl:
            self._emit("query", q_lvl, took_ms, shards, source,
                       opaque_id, profile_summary)
        if f_lvl:
            self._emit("fetch", f_lvl, fetch_ms, shards, source,
                       opaque_id, profile_summary)
        return {"query": q_lvl, "fetch": f_lvl}

    def _emit(self, phase, level, took_ms, shards, source, opaque_id,
              profile_summary) -> None:
        record = {
            "type": "index_search_slowlog",
            "level": level,
            "phase": phase,
            "index": self.index,
            "took_ms": round(float(took_ms), 3),
            "shards": int(shards),
            "source": _truncate_source(source),
            "opaque_id": opaque_id,
        }
        if profile_summary:
            record["profile"] = profile_summary
        try:
            self._logger.log(
                _LOG_LEVELS[level], "%s",
                json.dumps(record, default=str, separators=(",", ":")),
            )
        except Exception:  # logging must never fail a search
            pass

    # ---- stats ----

    def stats(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "thresholds_ms": {
                    p: dict(t) for p, t in self._thresholds.items()
                },
            }


def _truncate_source(source: Optional[dict]) -> Optional[str]:
    if source is None:
        return None
    try:
        s = json.dumps(source, default=str, separators=(",", ":"))
    except Exception:
        s = str(source)
    if len(s) > _SOURCE_CAP:
        s = s[:_SOURCE_CAP] + "...(truncated)"
    return s
