"""Segment-build orchestration for streaming ingest.

`build_segment` turns a batch of parsed documents into an immutable
`Segment` through the host `SegmentBuilder` — the reference's oracle
path. The reference's device build (`ES_TPU_DEVICE_BUILD`, the jitted
kernels of ops/index_build.py) is not ported yet: `auto` and `off` build
on the host, and `force` raises, naming the slice that brings it.

This module also owns the node-wide ingest/refresh stats registry (the
`ingest` block of `_nodes/stats`): refresh counts and lag percentiles,
build counters, concurrent-build overlap, and generations discarded on
mid-build failure.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List

import numpy as np

from ..cuts import DEVICE_BUILD, not_ported
from .mapping import Mappings, ParsedDocument
from .segment import Segment, SegmentBuilder

# ---------------------------------------------------------------------------
# ingest / refresh observability
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
INGEST_STATS = {
    "refreshes": 0,  # committed refreshes (all shards, all indices)
    "concurrent_refreshes": 0,  # double-buffered (built outside the lock)
    "concurrent_merges": 0,  # double-buffered merges (built outside the lock)
    "device_builds": 0,  # segments whose columns were built on device
    "host_builds": 0,  # segments built by the host SegmentBuilder
    "fallbacks": 0,  # device-path failures → host build
    "degraded": 0,  # HBM-budget degrades → host build
    "generations_discarded": 0,  # half-builds dropped (fault / superseded)
    "overlap_ms": 0.0,  # build wall time overlapped with serving
    "prewarm_ms": 0.0,  # post-swap executor/mesh prewarm wall time
    "wait_for_waits": 0,  # ?refresh=wait_for blocks on the next swap
}
_REFRESH_LAGS = deque(maxlen=4096)  # worst-doc visibility lag per refresh, ms


def note(key: str, n=1) -> None:
    with _LOCK:
        INGEST_STATS[key] += n


def note_refresh_lag(ms: float) -> None:
    with _LOCK:
        _REFRESH_LAGS.append(float(ms))


def refresh_lag_percentiles() -> dict:
    with _LOCK:
        lags = list(_REFRESH_LAGS)
    if not lags:
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None, "samples": 0}
    arr = np.asarray(lags)
    return {
        "p50_ms": round(float(np.percentile(arr, 50)), 2),
        "p95_ms": round(float(np.percentile(arr, 95)), 2),
        "p99_ms": round(float(np.percentile(arr, 99)), 2),
        "samples": len(lags),
    }


def stats_snapshot() -> dict:
    """The `ingest` block of `_nodes/stats` (joined with the `build`
    ledger bytes; no device build kernels run in the port yet)."""
    from ..common.memory import hbm_ledger

    with _LOCK:
        out = dict(INGEST_STATS)
    out["overlap_ms"] = round(out["overlap_ms"], 2)
    out["prewarm_ms"] = round(out["prewarm_ms"], 2)
    out["refresh_lag"] = refresh_lag_percentiles()
    out["build_kernels"] = {}
    out["build_ledger_bytes"] = int(
        hbm_ledger.stats()["by_category"].get("build", 0)
    )
    return out


def reset_stats() -> None:
    """Test/bench hook: zero the counters and the lag reservoir."""
    with _LOCK:
        for k, v in list(INGEST_STATS.items()):
            INGEST_STATS[k] = 0.0 if isinstance(v, float) else 0
        _REFRESH_LAGS.clear()


# ---------------------------------------------------------------------------
# build entry point
# ---------------------------------------------------------------------------


def build_segment(
    mappings: Mappings,
    docs: List[ParsedDocument],
    generation: int = 0,
    shard_id: int = 0,
    prefer_device: bool = False,
) -> Segment:
    """An immutable Segment from parsed docs, built on the host.
    `ES_TPU_DEVICE_BUILD=force` asks for the device build, which the
    port does not have yet, so it raises; `prefer_device` (the owning
    index's backend) is accepted for the reference's signature."""
    from ..common.settings import device_build_mode

    if device_build_mode() == "force":
        raise not_ported("the device segment build (ops/index_build.py)", DEVICE_BUILD)
    builder = SegmentBuilder(mappings, generation)
    for d in docs:
        builder.add(d)
    note("host_builds")
    return builder.build()
