"""IndexService: the shard set of one index, with ES routing semantics.

Reference analogs: org.elasticsearch.index.IndexService (per-index shard
registry, created by IndicesService from IndexMetadata),
OperationRouting.shardId = floorMod(murmur3(routing), num_shards)
(cluster/routing/IndexRouting), and the coordinator search fan-out
(TransportSearchAction scatter + SearchPhaseController merge). Two
deployment shapes share this class:

* **local mode** (default): every shard lives in this process — the
  single-node ES layout; fan-out is in-process calls.
* **distributed mode**: ``routing`` maps shard→node id, only shards
  routed to ``local_node`` get engines here, and every operation on a
  remote shard rides ``remote_call(owner, action, payload)`` over the
  transport (TransportSearchAction / TransportShardBulkAction collapsed
  onto one seam). The search path runs the FULL per-shard query phase
  on the owning node — scoring, agg partials, sort values, knn,
  source filtering, highlighting — and the coordinator merges the
  per-shard pages exactly as the local path does (query-then-fetch
  with the fetch folded into the shard response, SURVEY.md §3.3; the
  fold trades (n_shards-1)×size over-fetched sources for one fewer
  DCN round trip and no reader-pinning window between phases).

PyTorch port: local mode, and distributed mode under cluster/node.py
(``routing``/``local_node``/``remote_call``; every engine a replica, a
peer recovery or a promotion opens stays on the index's ``device``). An
index with ``search.backend: torch`` (the default) serves through
`TorchExecutor` on the service's ``device`` — "cuda" unless the caller
passes another — and the port's QueryBatcher; ``numpy`` selects the
NumpyExecutor oracle. Retrievers and ``rank: {rrf}`` run their legs
concurrently and fuse on the card (ops/fusion.py) when every leg rode
the batcher. A single numeric sort key collects on the card (rank
columns); other sorts take the oracle's host route, as in the
reference. A `rescore` runs between the merge and the fetch: on the
card through the batcher's `rerank` family for a shard's page or a
one-shard index's fused candidates, else through the host oracle. With
a ``base_path`` each shard is an on-disk engine (flush, crash recovery,
file snapshots, peer recovery); a reopened shard's segments upload to
the device when its executor is first built. With `ES_TPU_MESH=force`
(or `auto` on two or more devices) the hot flat-plan bodies serve
through the index's MeshExecutor (parallel/mesh_executor.py): one
stacked launch over every (shard, segment) entry per batcher group.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ..analysis import AnalysisRegistry
from ..common.faults import faults
from ..common.slowlog import FETCH_ACC, SearchSlowLog
from ..common.tracing import OPAQUE_ID_CTX, TRACE_CTX
from ..index.engine import OpResult, ShardEngine, VersionConflictError
from ..index.mapping import Mappings
from ..search import dsl
from ..search.admission import (
    EsOverloadedError,
    RequestCacheOnlyMiss,
    admission,
    apply_brownout,
)
from ..search.coordinator import _col_key
from ..search.executor import NumpyExecutor
from ..search.failures import (
    SearchTimeoutError,
    deadline_from,
    failure_type,
    parse_allow_partial,
    shard_failure,
)
from ..utils.murmur3 import shard_id as route_shard_id

from ..common.settings import INDEX_SETTINGS, SettingsError, validate_index_settings

DEFAULT_SETTINGS = {k: s.default for k, s in INDEX_SETTINGS.items()}

# shared shard fan-out pool (coordinator scatter; leaf tasks only, so a
# saturated pool queues requests rather than deadlocking)
_FANOUT_POOL = ThreadPoolExecutor(max_workers=32, thread_name_prefix="search-fanout")

# hybrid retriever legs get their OWN pool: a leg task is NOT a leaf (a
# standard leg runs a whole coordinator search, which submits shard
# tasks to _FANOUT_POOL and blocks) — sharing one pool would let
# saturated leg tasks starve the shard tasks they wait on. Legs nested
# inside a leg thread run inline instead (same cycle, one pool deeper).
_LEG_POOL_PREFIX = "rrf-leg"
_LEG_POOL = ThreadPoolExecutor(max_workers=32, thread_name_prefix=_LEG_POOL_PREFIX)

ACTION_SHARD_SEARCH = "indices:data/read/search_shard"
ACTION_SHARD_COUNT = "indices:data/read/count_shard"
ACTION_SHARD_OPS = "indices:data/write/shard_ops"
ACTION_SHARD_GET = "indices:data/read/get"
ACTION_SHARD_REFRESH = "indices:admin/refresh_shards"
ACTION_SHARD_FLUSH = "indices:admin/flush_shards"
ACTION_SHARD_STATS = "indices:monitor/shard_stats"
ACTION_CTX_OPEN = "indices:data/read/ctx_open"
ACTION_CTX_CLOSE = "indices:data/read/ctx_close"
ACTION_SHARD_REPLICA_OPS = "indices:data/write/replica_ops"
ACTION_SNAPSHOT_SHARD = "internal:snapshot/shard"
ACTION_SHARD_DFS = "indices:data/read/dfs"
ACTION_SHARD_CAN_MATCH = "indices:data/read/can_match"


def _request_scoped_error(e: BaseException) -> bool:
    """Errors that indict the REQUEST, not the shard copy: parse
    errors, 4xx-shaped ClusterErrors, and backpressure/breaker
    rejections. They propagate unchanged from the fan-out instead of
    becoming `_shards.failures` entries — retrying a malformed query
    on a replica cannot succeed, and a 429 must keep its contract."""
    from ..common.memory import CircuitBreakingException
    from ..search.batcher import EsRejectedExecutionError
    from .service import ClusterError

    if isinstance(
        e, (dsl.QueryParseError, EsRejectedExecutionError,
            CircuitBreakingException, EsOverloadedError),
    ):
        return True
    try:
        from ..search.aggs import AggParseError

        if isinstance(e, AggParseError):
            return True
    except ImportError:  # pragma: no cover
        pass
    return isinstance(e, ClusterError) and e.status < 500


def _retriable_routing_error(e: BaseException) -> bool:
    """Write failures worth re-resolving the owner for: the drained
    relocation source's shard_not_in_primary_mode refusal, a copy the
    routing table moved off the contacted node, a node that vanished
    from the membership table, and plain transport failures (the owner
    crashed — failover promotes a replica within the retry window).
    Everything request-scoped (conflicts, validation, red shards)
    propagates immediately."""
    from ..transport.service import TransportError
    from .allocation import RELOCATED_MARKER

    if isinstance(e, TransportError):
        return True
    msg = str(e)
    return (
        RELOCATED_MARKER in msg
        or "not allocated to" in msg
        or "unknown node" in msg
    )


def _tree_has_range(q) -> bool:
    if isinstance(q, dsl.RangeQuery):
        return True
    if isinstance(q, dsl.BoolQuery):
        return any(
            _tree_has_range(c)
            for c in list(q.must) + list(q.filter) + list(q.should)
        )
    if isinstance(q, dsl.ConstantScoreQuery):
        return _tree_has_range(q.filter_query)
    if isinstance(q, (dsl.FunctionScoreQuery, dsl.ScriptScoreQuery)):
        return _tree_has_range(q.query)
    return False


def _shard_field_bounds(eng, field: str):
    """(min, max) over a shard's doc values for `field`, None when the
    field is absent; cached per engine change generation."""
    cache = getattr(eng, "_field_bounds_cache", None)
    if cache is None or cache[0] != eng.change_generation:
        cache = (eng.change_generation, {})
        eng._field_bounds_cache = cache
    bounds = cache[1].get(field, "?")
    if bounds != "?":
        return bounds
    lo = None
    hi = None
    for seg in eng.segments:
        nf = seg.numerics.get(field)
        if nf is None or not nf.exists.any():
            continue
        vals = nf.values[nf.exists]
        lo = float(vals.min()) if lo is None else min(lo, float(vals.min()))
        hi = float(vals.max()) if hi is None else max(hi, float(vals.max()))
    bounds = None if lo is None else (lo, hi)
    cache[1][field] = bounds
    return bounds


def _can_match(q, eng, mappings, analysis) -> bool:
    """Conservative per-shard matchability (MatchNoneQuery rewrite of
    CanMatchPreFilterSearchPhase): False ONLY when the shard provably
    has no matching doc."""
    from ..index.mapping import TEXT
    from ..search.executor import _coerce_numeric, search_field_terms

    if isinstance(q, dsl.RangeQuery):
        mf = mappings.get(q.field)
        if mf is None or not mf.is_numeric():
            return True
        bounds = _shard_field_bounds(eng, q.field)
        if bounds is None:
            return False  # no doc has the field at all
        lo, hi = bounds
        try:
            if q.gte is not None and hi < _coerce_numeric(mf.type, q.gte):
                return False
            if q.gt is not None and hi <= _coerce_numeric(mf.type, q.gt):
                return False
            if q.lte is not None and lo > _coerce_numeric(mf.type, q.lte):
                return False
            if q.lt is not None and lo >= _coerce_numeric(mf.type, q.lt):
                return False
        except (TypeError, ValueError):
            return True
        return True
    if isinstance(q, (dsl.TermQuery, dsl.MatchQuery)):
        mf = mappings.get(q.field)
        if mf is None:
            return True
        if mf.type == TEXT:
            if isinstance(q, dsl.MatchQuery):
                terms = search_field_terms(
                    mappings, analysis, q.field, q.query,
                    getattr(q, "analyzer", None),
                )
                # OR needs any term present; AND needs all
                need_all = q.operator == "and"
            else:
                terms = [dsl.term_token(q.value)]
                need_all = True
            checks = [
                any(
                    (pf := seg.postings.get(q.field)) is not None
                    and pf.term_id(t) >= 0
                    for seg in eng.segments
                )
                for t in terms
            ]
            if not checks:
                return False
            return all(checks) if need_all else any(checks)
        return True
    if isinstance(q, dsl.BoolQuery):
        for c in list(q.must) + list(q.filter):
            if not _can_match(c, eng, mappings, analysis):
                return False
        if q.should and not (q.must or q.filter):
            if q.minimum_should_match is not None:
                msm = dsl.parse_minimum_should_match(
                    q.minimum_should_match, len(q.should)
                )
                if msm <= 0:
                    return True  # msm 0: every doc matches
            return any(
                _can_match(c, eng, mappings, analysis) for c in q.should
            )
        return True
    if isinstance(q, dsl.ConstantScoreQuery):
        return _can_match(q.filter_query, eng, mappings, analysis)
    if isinstance(q, (dsl.FunctionScoreQuery, dsl.ScriptScoreQuery)):
        return _can_match(q.query, eng, mappings, analysis)
    if isinstance(q, dsl.MatchNoneQuery):
        return False
    return True  # anything else: conservatively matchable


def _dfs_terms(query, mappings, analysis) -> Dict[str, set]:
    """field → scoring terms whose global statistics the DFS round must
    gather (DfsPhase.execute walks the rewritten query's terms)."""
    out: Dict[str, set] = {}

    def add(field: str, terms) -> None:
        out.setdefault(field, set()).update(terms)

    def analyzed(field: str, text: str, override=None):
        from ..index.mapping import TEXT
        from ..search.executor import search_field_terms

        mf = mappings.get(field)
        if mf is not None and mf.type != TEXT:
            # match on keyword/numeric degrades to a term query at
            # execution — stat the raw value
            return [str(text)]
        return search_field_terms(mappings, analysis, field, text, override)

    def walk(q) -> None:
        if q is None:
            return
        if isinstance(q, (dsl.MatchQuery, dsl.MatchPhraseQuery)):
            add(
                q.field,
                analyzed(q.field, q.query, getattr(q, "analyzer", None)),
            )
        elif isinstance(q, dsl.TermQuery):
            add(q.field, [str(q.value)])
        elif isinstance(q, dsl.TermsQuery):
            add(q.field, [str(v) for v in q.values])
        elif isinstance(q, dsl.MultiMatchQuery):
            from ..search.executor import expand_match_fields

            for fname, _ in expand_match_fields(mappings, q.fields):
                add(fname, analyzed(fname, q.query))
        elif isinstance(q, dsl.BoolQuery):
            for sub in list(q.must) + list(q.should) + list(q.filter):
                walk(sub)
        elif isinstance(q, dsl.DisMaxQuery):
            for sub in q.queries:
                walk(sub)
        elif isinstance(q, dsl.BoostingQuery):
            walk(q.positive)
        elif isinstance(q, dsl.ConstantScoreQuery):
            walk(q.filter_query)
        elif isinstance(q, (dsl.FunctionScoreQuery, dsl.ScriptScoreQuery)):
            walk(q.query)
        elif isinstance(q, dsl.QueryStringQuery):
            from ..search.executor import rewrite_query_string

            walk(rewrite_query_string(q, mappings))

    walk(query)
    return out


def norm_shard_routing(entry) -> dict:
    """Normalizes a routing-table entry to the replicated shape
    {"primary", "replicas", "in_sync", "primary_term"} (ShardRouting +
    the in-sync allocation set that IndexMetadata carries, SURVEY §2.6).
    Pre-replication states stored a bare primary node id string.

    An in-flight relocation rides an optional ``relocating`` key:
    ``{"from": node, "to": node, "copy": "primary"|"replica"}`` — the
    target already sits in ``replicas`` (not in-sync) and peer-recovers
    like any initializing copy; the cutover in
    TpuNode._handle_shard_started retires the source atomically."""
    if isinstance(entry, str):
        return {"primary": entry, "replicas": [], "in_sync": [entry],
                "primary_term": 1}
    primary = entry.get("primary")
    in_sync = entry.get("in_sync")
    if in_sync is None:
        in_sync = [primary] if primary is not None else []
    out = {
        "primary": primary,
        "replicas": list(entry.get("replicas", [])),
        "in_sync": list(in_sync),
        "primary_term": int(entry.get("primary_term", 1)),
    }
    if entry.get("relocating"):
        out["relocating"] = dict(entry["relocating"])
    return out


def _reader_locations(ex) -> Dict[str, Tuple[int, int]]:
    """{doc_id → (segment, local_doc)} for one executor's PINNED reader
    snapshot — the generation-consistent replacement for the live
    engine's `_locations` map in multi-phase requests. Only live copies
    enter the map. Built once per executor (= one reader generation) and
    cached on it."""
    locs = getattr(ex, "_reader_locations_cache", None)
    if locs is None:
        locs = {}
        reader = ex.reader
        for si, seg in enumerate(reader.segments):
            live = reader.live_docs[si]
            for local, doc_id in enumerate(seg.doc_ids):
                if live is None or live[local]:
                    locs[doc_id] = (si, local)
        ex._reader_locations_cache = locs
    return locs


class IndexService:
    """The shard set of one index (see module docstring for the two
    deployment shapes)."""

    def __init__(
        self,
        name: str,
        settings: Optional[dict] = None,
        mappings_json: Optional[dict] = None,
        analysis: Optional[AnalysisRegistry] = None,
        base_path: Optional[str] = None,
        routing: Optional[Dict[Any, str]] = None,
        local_node: Optional[str] = None,
        remote_call=None,
        response_times: Optional[Dict[str, float]] = None,
        device="cuda",
    ):
        self.name = name
        # the card every TorchExecutor of this index runs on; the CPU
        # only when the caller asks for it (no fallback)
        import torch

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"IndexService [{name}]: device 'cuda' was asked for and no "
                "CUDA device is available (pass device='cpu' to run on the CPU)"
            )
        self.settings = dict(DEFAULT_SETTINGS)
        # index.analysis.* is a free-form group setting (custom analyzers,
        # filters, char_filters) consumed by the AnalysisRegistry, not the
        # scalar registry
        self.analysis_config = _extract_analysis(settings or {})
        if settings:
            flat = _flatten_settings(settings)
            flat = {k: v for k, v in flat.items() if not k.startswith("analysis.")}
            flat.pop("uuid", None)  # round-trip fields from metadata()
            flat.pop("creation_date", None)
            flat.pop("provided_name", None)
            self.settings.update(validate_index_settings(flat, creating=True))
        self.creation_date = int(time.time() * 1000)
        self.uuid = _index_uuid(name, self.creation_date)
        self.mappings = Mappings(mappings_json or {})
        self.analysis = analysis or AnalysisRegistry(
            {"analysis": self.analysis_config} if self.analysis_config else None
        )
        self.base_path = base_path
        n = int(self.settings["number_of_shards"])
        if n < 1:
            raise ValueError("number_of_shards must be >= 1")
        self.num_shards = n
        # distributed-mode wiring (None/None/None = local mode)
        self.routing: Optional[Dict[int, dict]] = (
            {int(k): norm_shard_routing(v) for k, v in routing.items()}
            if routing
            else None
        )
        self.local_node = local_node
        self.remote_call = remote_call
        # per-node EWMA response seconds (ARS); shared with the node
        self.response_times: Dict[str, float] = (
            response_times if response_times is not None else {}
        )
        # primary-side replication tracking: shard → extra targets added
        # during peer recovery, before they enter the in-sync set
        # (ReplicationTracker.initiateTracking)
        self._tracked: Dict[int, set] = {}
        # relocation handoff gate (IndexShardOperationPermits +
        # relocated-state, radically simplified): per-shard in-flight
        # write counts, plus the shards whose primary has completed the
        # relocation drain — writes there are refused with a retryable
        # marker until the cutover state lands (or the relocation dies)
        self._op_permits: Dict[int, int] = {}
        self._handed_off: set = set()
        self._permit_cond = threading.Condition()
        # round-robin cursor for in-sync copy selection on search
        # (adaptive replica selection, radically simplified)
        self._ars_cursor = 0
        # coordinator → master shard-failure reporting hook; the
        # distributed node wires this to TpuNode._report_shard_failed
        # so a copy that failed a search leaves the in-sync set
        # (ShardStateAction.shardFailed bookkeeping)
        self.on_shard_failure = None
        self._local: Dict[int, ShardEngine] = {}
        for s in range(n):
            if not self._owns(s):
                continue
            if self._torn_transfer(s):
                # the node died MID-peer-recovery: the shard dir is a
                # half-copied transfer (the `_recovering` marker is
                # still present), not a crash-consistent commit — no
                # engine open may touch it; peer recovery re-wipes it
                continue
            shard_path = (
                os.path.join(base_path, str(s)) if base_path is not None else None
            )
            self._local[s] = ShardEngine(
                self.mappings, self.analysis, path=shard_path, shard_id=s,
                primary_term=self._primary_term(s),
                codec=str(self.settings.get("codec", "default")),
                **self._durability_opts(),
            )
        # executor cache: shard id → (change_generation, executor)
        self._executors: Dict[int, tuple] = {}
        self._executor_lock = threading.Lock()
        # created eagerly (its worker thread only starts on first submit)
        # so concurrent first searches can't race a lazy init
        from ..search.batcher import QueryBatcher

        self._batcher = QueryBatcher()
        # whole-index serving engine (parallel/mesh_executor.py),
        # created on first use
        self._mesh = None
        # SearchStats (per-index totals; query_current omitted)
        self.search_stats = {
            "query_total": 0,
            "query_time_in_millis": 0,
            "fetch_total": 0,
        }
        # per-index search slow log (common/slowlog.py), thresholds
        # from the dynamic search.slowlog.threshold.* index settings
        self._slowlog = SearchSlowLog(self.name)
        self._slowlog.configure(self.settings)
        # hybrid (RRF) execution breakdown: cumulative per-leg wall
        # times measured from leg fan-out start, so overlapped legs sum
        # to MORE than the request wall time; `device_fused` /
        # `host_fused` count fusions and `{batcher,pool,inline}_legs`
        # count how each leg ran (the port's addition: a leg that
        # quietly left the batcher shows here)
        self._rrf_lock = threading.Lock()
        self.rrf_stats = {
            "searches": 0,
            "bm25_leg_ms": 0.0,
            "knn_leg_ms": 0.0,
            "sparse_leg_ms": 0.0,
            "fuse_ms": 0.0,
            "device_fused": 0,
            "host_fused": 0,
            "batcher_legs": 0,
            "pool_legs": 0,
            "inline_legs": 0,
        }
        # bounded per-leg latency reservoirs (newest-wins), kept OUTSIDE
        # rrf_stats, whose values are reset-to-zero numbers
        from collections import deque as _deque

        self.rrf_leg_samples = {
            "bm25": _deque(maxlen=4096),
            "knn": _deque(maxlen=4096),
            "sparse": _deque(maxlen=4096),
        }
        # ---- background refresher (index.refresh_interval): the NRT
        # loop that turns buffered writes into searchable generations on
        # a cadence, with the heavy segment build double-buffered
        # against serving (ShardEngine.refresh_concurrent) and the new
        # generation's executors/mesh stack prewarmed before the swap is
        # observed by queries. ES_TPU_BG_REFRESH=off (tier-1) disables
        # the thread entirely; `?refresh=wait_for` blocks on the next
        # completed tick via _refresh_cond. ----
        self._refresh_cond = threading.Condition()
        self._refresh_ticks = 0
        self._refresher_stop = False
        self._refresher: Optional[threading.Thread] = None
        from ..common.settings import bg_refresh_enabled

        if bg_refresh_enabled():
            self._refresher = threading.Thread(
                target=self._refresh_loop,
                name=f"refresher[{self.name}]",
                daemon=True,
            )
            self._refresher.start()

    # ---- routing ----

    def _entry(self, sid: int) -> Optional[dict]:
        if self.routing is None:
            return None
        return self.routing.get(sid)

    def _copies(self, sid: int) -> List[str]:
        e = self._entry(sid)
        if e is None:
            return []
        out = [e["primary"]] if e["primary"] is not None else []
        out.extend(e["replicas"])
        return out

    def _owns(self, sid: int) -> bool:
        """True if this node holds a copy (primary OR replica)."""
        if self.routing is None:
            return True
        return self.local_node in self._copies(sid)

    def _primary_term(self, sid: int) -> int:
        e = self._entry(sid)
        return 1 if e is None else e["primary_term"]

    def _needs_peer_recovery(self, sid: int) -> bool:
        """True when this node's copy is an out-of-sync replica — the
        shape peer recovery owns end to end (wipe → transfer → install)."""
        e = self._entry(sid)
        return (
            e is not None
            and e["primary"] not in (None, self.local_node)
            and self.local_node in e["replicas"]
            and self.local_node not in e["in_sync"]
        )

    def _marker_path(self, sid: int) -> Optional[str]:
        if self.base_path is None:
            return None
        return os.path.join(self.base_path, str(sid), "_recovering")

    def _torn_transfer(self, sid: int) -> bool:
        """True when the shard dir is a half-copied peer-recovery
        transfer (the `_recovering` marker survives a crash between the
        wipe and the transfer completing). Unlike a crashed WRITE — the
        commit protocol keeps those recoverable — a torn transfer is
        garbage no engine open may touch; peer recovery re-wipes it."""
        marker = self._marker_path(sid)
        return marker is not None and os.path.exists(marker)

    def _durability_opts(self) -> dict:
        """index.translog.* settings → ShardEngine kwargs (previously
        every engine silently ran at the 'request' default regardless
        of the index setting), plus the device segment-build preference
        (torch-backend indices build on the index's device, see
        index/segment_build.py)."""
        from ..search.failures import parse_timeout

        interval = parse_timeout(
            self.settings.get("translog.sync_interval", "5s")
        )
        return {
            "durability": str(
                self.settings.get("translog.durability", "request")
            ),
            "sync_interval": 5.0 if interval is None else interval,
            "device_build": (
                str(self.settings.get("search.backend", "numpy")) == "torch"
            ),
            "device": self.device,
        }

    def apply_translog_settings(self) -> None:
        """Pushes dynamic index.translog.* changes into OPEN engines —
        the settings are dynamic, so without this a live flip to
        `request` durability would silently keep the async loss window
        until the next restart/recovery."""
        opts = self._durability_opts()
        for eng in self._local.values():
            tl = eng.translog
            if tl is None:
                continue
            with eng._lock:
                if tl.durability != opts["durability"]:
                    if opts["durability"] == "request":
                        # close the volatile window at the flip, not at
                        # the next (fsynced) append
                        tl.sync()
                    tl.durability = opts["durability"]
                tl.sync_interval = opts["sync_interval"]

    def _owner(self, sid: int) -> Optional[str]:
        """PRIMARY node id for a shard (write routing), or None in
        local mode."""
        e = self._entry(sid)
        return None if e is None else e["primary"]

    def _search_node(self, sid: int) -> Optional[str]:
        """Copy selection for reads: any in-sync copy, preferring the
        local one, then the copy with the lowest EWMA response time
        (adaptive replica selection — ResponseCollectorService); round-
        robin among never-measured copies. None = execute locally."""
        e = self._entry(sid)
        if e is None:
            return None
        in_sync = [n for n in e["in_sync"] if n in self._copies(sid)]
        if not in_sync:
            return e["primary"]
        if self.local_node in in_sync:
            return self.local_node
        self._ars_cursor += 1
        times = self.response_times
        if times:
            # every ~8th selection probes round-robin so copies that
            # measured slow once keep getting fresh samples (no herding)
            if self._ars_cursor % 8 != 0:
                unmeasured = [n for n in in_sync if n not in times]
                if unmeasured:
                    return unmeasured[self._ars_cursor % len(unmeasured)]
                return min(in_sync, key=lambda n: times[n])
        return in_sync[self._ars_cursor % len(in_sync)]

    def _red_shard(self, sid: int) -> bool:
        """True when NO searchable copy of the shard exists: the primary
        is gone and the in-sync set holds no assigned copy (a red shard
        in cluster-health terms). Local mode is never red."""
        e = self._entry(sid)
        if e is None:
            return False
        if e["primary"] is not None:
            return False
        return not [n for n in e["in_sync"] if n in self._copies(sid)]

    def _retry_copy(self, sid: int, exclude) -> Optional[str]:
        """Next in-sync copy to retry a failed shard call on, excluding
        the copies already tried (AsyncSearchContext's
        performPhaseOnShard move-to-next-copy). None = no copy left."""
        e = self._entry(sid)
        if e is None:
            return None
        cands = [
            n
            for n in e["in_sync"]
            if n in self._copies(sid) and n not in exclude
        ]
        if not cands:
            return None
        if self.local_node in cands:
            return self.local_node
        return cands[0]

    def _reresolve_copy(self, sid: int, exclude, e) -> Optional[str]:
        """Last-resort read-copy re-resolution for topology races: a
        relocation cutover (or failover) can retire the only copy a
        stale coordinator knows about — `_retry_copy` then has nowhere
        to go even though a freshly-promoted copy exists.  For transport
        / allocation-shaped failures only, wait briefly for the next
        cluster state to land here and pick again, so searches ride
        through the publish window instead of failing."""
        if self.routing is None or not _retriable_routing_error(e):
            return None
        for _ in range(8):
            time.sleep(0.05)
            cand = self._search_node(sid)
            if cand is not None and cand not in exclude:
                return cand
        return None

    def _note_shard_failed(self, sid: int, node: Optional[str]) -> None:
        """Best-effort master notification that a remote copy failed a
        read (mirrors the write path's _report_shard_failed)."""
        if node is None or node == self.local_node:
            return
        cb = self.on_shard_failure
        if cb is None:
            return
        try:
            cb(self.name, sid, node)
        except Exception:
            pass  # reporting must never fail the search

    def replica_targets(self, sid: int) -> List[str]:
        """Write fan-out set on the primary: assigned in-sync copies plus
        recovery-tracked targets, minus self (ReplicationOperation's
        replication group)."""
        e = self._entry(sid)
        if e is None:
            return []
        targets = set(n for n in e["in_sync"] if n in self._copies(sid))
        targets |= self._tracked.get(sid, set())
        targets.discard(self.local_node)
        return sorted(targets)

    def add_tracked(self, sid: int, node: str) -> None:
        self._tracked.setdefault(sid, set()).add(node)

    # ---- relocation handoff permits (IndexShardOperationPermits) ----

    def begin_shard_op(self, sid: int) -> None:
        """Takes a write permit on a locally-primaried shard; refused
        with a retryable 503 once the relocation drain has completed
        (ES: ShardNotInPrimaryModeException — the coordinator re-resolves
        the owner and retries against the promoted target)."""
        from .allocation import RELOCATED_MARKER
        from .service import ClusterError

        with self._permit_cond:
            if sid in self._handed_off:
                raise ClusterError(
                    503,
                    f"{RELOCATED_MARKER}: shard [{self.name}][{sid}] has "
                    "handed off its primary during relocation; retry",
                    "shard_not_in_primary_mode_exception",
                )
            self._op_permits[sid] = self._op_permits.get(sid, 0) + 1

    def end_shard_op(self, sid: int) -> None:
        with self._permit_cond:
            left = self._op_permits.get(sid, 0) - 1
            if left <= 0:
                self._op_permits.pop(sid, None)
            else:
                self._op_permits[sid] = left
            self._permit_cond.notify_all()

    def drain_for_handoff(self, sid: int, timeout: float = 10.0) -> bool:
        """Relocation cutover, source side: block NEW writes on the
        shard, then wait for in-flight write handlers (local apply +
        synchronous replica fan-out, which includes the recovery-tracked
        relocation target) to finish.  After this returns, every acked
        op lives on the target — the shard-started report that follows
        makes the cutover a single atomic state publish."""
        with self._permit_cond:
            self._handed_off.add(sid)
            return self._permit_cond.wait_for(
                lambda: self._op_permits.get(sid, 0) == 0, timeout
            )

    def is_handed_off(self, sid: int) -> bool:
        return sid in self._handed_off

    def clear_handoff(self, sid: int) -> None:
        with self._permit_cond:
            self._handed_off.discard(sid)

    @property
    def shards(self) -> List[ShardEngine]:
        """Locally-held shard engines (all shards in local mode)."""
        return [self._local[s] for s in sorted(self._local)]

    @property
    def local_shards(self) -> Dict[int, ShardEngine]:
        """shard id → locally-held engine (IndicesService view)."""
        return dict(self._local)

    def apply_routing(self, routing: Optional[Dict[int, Any]]) -> None:
        """Reconciles local engines with a new routing table (the
        IndicesClusterStateService.applyClusterState shard create/remove
        path): engines are created for newly-owned shards and closed for
        shards routed away. Callers check ``recovery_needed()`` after
        applying to find replica copies that must peer-recover."""
        if routing is not None:
            self.routing = {
                int(k): norm_shard_routing(v) for k, v in routing.items()
            }
        # copy-on-write: readers (search/refresh/stats threads) iterate
        # self._local without the state lock, so it is never mutated in
        # place — a fresh dict is swapped in atomically
        local = dict(self._local)
        for sid in range(self.num_shards):
            if self._owns(sid) and sid not in local:
                if self._needs_peer_recovery(sid):
                    # peer recovery wipes the directory and installs the
                    # engine itself; opening the leftover (possibly
                    # half-transferred) files here raced the in-flight
                    # transfer and could crash the state-apply thread
                    continue
                shard_path = (
                    os.path.join(self.base_path, str(sid))
                    if self.base_path is not None
                    else None
                )
                local[sid] = ShardEngine(
                    self.mappings, self.analysis, path=shard_path, shard_id=sid,
                    primary_term=self._primary_term(sid),
                    codec=str(self.settings.get("codec", "default")),
                    **self._durability_opts(),
                )
            elif not self._owns(sid) and sid in local:
                eng = local.pop(sid)
                self._executors.pop(sid, None)
                eng.close()
            if self.routing is not None:
                e = self._entry(sid)
                if e is not None:
                    # a promoted local primary adopts the bumped term
                    eng = local.get(sid)
                    if eng is not None and e["primary"] == self.local_node:
                        eng.primary_term = max(eng.primary_term, e["primary_term"])
                    # recovery-tracked targets that reached the in-sync
                    # set (or were routed away) no longer need tracking
                    tracked = self._tracked.get(sid)
                    if tracked:
                        tracked &= set(e["replicas"]) - set(e["in_sync"])
        self._local = local
        # a handoff gate stays closed only while ITS relocation is still
        # in flight: the cutover routes the shard away (engine closed
        # above), while a cancelled relocation / dead target leaves this
        # node primary with no relocating marker — writes must resume
        if self._handed_off:
            with self._permit_cond:
                for sid in list(self._handed_off):
                    e = self._entry(sid)
                    if (
                        e is None
                        or not e.get("relocating")
                        or e["primary"] != self.local_node
                    ):
                        self._handed_off.discard(sid)
                self._permit_cond.notify_all()

    def recovery_needed(self) -> List[int]:
        """Locally-assigned replica shards that are not yet in-sync —
        the set the owning node must peer-recover from their primaries.
        Deliberately NOT keyed off self._local: engines for these copies
        are no longer opened eagerly (the recovery installs them), so
        the routing table is the only truth."""
        return [
            sid for sid in range(self.num_shards)
            if self._needs_peer_recovery(sid)
        ]


    def local_shard(self, sid: int) -> ShardEngine:
        eng = self._local.get(sid)
        if eng is None:
            raise KeyError(
                f"shard [{self.name}][{sid}] is not allocated to this node"
            )
        return eng

    def shard_for(self, doc_id: str, routing: Optional[str] = None) -> ShardEngine:
        sid = route_shard_id(
            routing if routing is not None else doc_id, self.num_shards
        )
        return self.local_shard(sid)

    # ---- document ops ----

    def _shard_ops(self, sid: int, ops: List[dict]) -> List[dict]:
        """Applies a batch of ops to one shard, local or remote.
        Returns wire-shaped result dicts (TransportShardBulkAction)."""
        if self.routing is None:
            return apply_shard_ops(self.local_shard(sid), ops)
        from .service import ClusterError

        # bounded retry with owner re-resolution (TransportReplication-
        # Action's retryable ReplicationOperation failures): a relocation
        # cutover refuses writes at the drained source for the few ms
        # until the new routing lands here — the retry hides the window,
        # so clients never see a serving gap on topology changes
        last: Optional[Exception] = None
        for attempt in range(60):
            owner = self._owner(sid)
            if owner is None:
                # red shard: every copy died — refuse the write instead
                # of acking it into a stale local replica (ES: 503)
                raise ClusterError(
                    503,
                    f"primary shard [{self.name}][{sid}] is not active",
                    "unavailable_shards_exception",
                )
            # distributed mode always rides the handler seam — even for
            # the local owner (remote_call short-circuits) — because the
            # handler is where dynamic-mapping updates round-trip
            try:
                out = self.remote_call(
                    owner,
                    ACTION_SHARD_OPS,
                    {"index": self.name, "shard": sid, "ops": ops},
                )
                return out["results"]
            except Exception as e:
                if attempt == 59 or not _retriable_routing_error(e):
                    raise
                last = e
                time.sleep(0.05)
        raise last  # pragma: no cover - loop always returns or raises

    def _one_op(self, sid: int, op: dict) -> OpResult:
        r = self._shard_ops(sid, [op])[0]
        if not r.get("ok"):
            if r.get("etype") == "version_conflict_engine_exception":
                raise VersionConflictError(r.get("error", "version conflict"))
            raise RuntimeError(r.get("error", "shard operation failed"))
        return OpResult(
            doc_id=r.get("_id", op.get("id")),
            result=r["result"],
            version=int(r.get("_version", 1)),
            seq_no=int(r.get("_seq_no", 0)),
            primary_term=int(r.get("_primary_term", 1)),
        )

    def index_doc(
        self,
        doc_id: str,
        source: dict,
        op_type: str = "index",
        routing: Optional[str] = None,
        **kwargs,
    ) -> OpResult:
        sid = route_shard_id(
            routing if routing is not None else doc_id, self.num_shards
        )
        if self.routing is None:
            return self.local_shard(sid).index(doc_id, source, op_type, **kwargs)
        op = {"op": "index", "id": doc_id, "source": source, "op_type": op_type}
        op.update({k: v for k, v in kwargs.items() if v is not None})
        return self._one_op(sid, op)

    def delete_doc(
        self, doc_id: str, routing: Optional[str] = None, **kwargs
    ) -> OpResult:
        sid = route_shard_id(
            routing if routing is not None else doc_id, self.num_shards
        )
        if self.routing is None:
            return self.local_shard(sid).delete(doc_id, **kwargs)
        op = {"op": "delete", "id": doc_id}
        op.update({k: v for k, v in kwargs.items() if v is not None})
        return self._one_op(sid, op)

    def get_doc(self, doc_id: str, routing: Optional[str] = None) -> Optional[dict]:
        # realtime get routes to the PRIMARY (TransportGetAction with
        # realtime=true reads through the primary's version map)
        sid = route_shard_id(
            routing if routing is not None else doc_id, self.num_shards
        )
        if self.routing is None:
            return self.local_shard(sid).get(doc_id)
        owner = self._owner(sid)
        if owner is None:
            from .service import ClusterError

            raise ClusterError(
                503,
                f"primary shard [{self.name}][{sid}] is not active",
                "unavailable_shards_exception",
            )
        if owner == self.local_node:
            return self.local_shard(sid).get(doc_id)
        out = self.remote_call(
            owner,
            ACTION_SHARD_GET,
            {"index": self.name, "shard": sid, "id": doc_id},
        )
        return out["doc"] if out["found"] else None

    def _remote_owners(self) -> List[str]:
        """Every node holding any copy of any shard, except this one."""
        if self.routing is None:
            return []
        nodes: set = set()
        for sid in self.routing:
            nodes.update(self._copies(sid))
        nodes.discard(self.local_node)
        return sorted(nodes)

    def refresh(self) -> None:
        for s in self.shards:
            s.refresh()
        for owner in self._remote_owners():
            self.remote_call(owner, ACTION_SHARD_REFRESH, {"index": self.name})

    # ---- background refresher (NRT loop) ----

    def _refresh_interval_s(self) -> Optional[float]:
        """index.refresh_interval as seconds; None = disabled (-1)."""
        from ..search.failures import parse_timeout

        raw = str(self.settings.get("refresh_interval", "1s"))
        if raw == "-1":
            return None
        val = parse_timeout(raw)
        return 1.0 if val is None else max(float(val), 0.01)

    def apply_refresh_settings(self) -> None:
        """Pushes a dynamic `index.refresh_interval` update into the
        running refresher (wakes it so the new cadence applies now)."""
        with self._refresh_cond:
            self._refresh_cond.notify_all()

    def apply_slowlog_settings(self) -> None:
        """Pushes dynamic `index.search.slowlog.threshold.*` updates
        into the per-index slow log."""
        self._slowlog.configure(self.settings)

    def _refresh_loop(self) -> None:
        while True:
            with self._refresh_cond:
                if self._refresher_stop:
                    return
                interval = self._refresh_interval_s()
                self._refresh_cond.wait(
                    timeout=interval if interval is not None else None
                )
                if self._refresher_stop:
                    return
                if interval is None:
                    continue  # refresh_interval: -1 → idle until wake
            try:
                self._refresh_tick()
            except Exception:
                pass  # a failed tick keeps the old generation serving

    def _refresh_tick(self) -> None:
        """One NRT cycle: concurrently build+swap every dirty local
        shard, build the new generation's executors so the first query
        after the swap finds them, then signal `wait_for` waiters."""
        from ..index import segment_build

        refreshed = []
        for sid, eng in sorted(self._local.items()):
            try:
                if eng.dirty and eng.refresh_concurrent():
                    refreshed.append((sid, eng))
            except Exception:
                continue  # old generation keeps serving; next tick retries
        # merge policy: when a shard accumulated too many segments, fold
        # them through the same double-buffered path — the big rebuild
        # runs outside the engine lock, so the write stream stays paced
        max_segs = int(self.settings.get("merge.policy.max_segments", 8))
        for sid, eng in sorted(self._local.items()):
            if len(eng.segments) <= max_segs:
                continue
            try:
                if eng.merge_concurrent(max_segs) and all(
                    e is not eng for _s, e in refreshed
                ):
                    refreshed.append((sid, eng))
            except Exception:
                continue  # policy retries next tick; serving unaffected
        t0 = time.perf_counter()
        for sid, eng in refreshed:
            try:
                ex = self._executor(eng)
                prewarm = getattr(ex, "prewarm", None)
                if prewarm is not None:
                    prewarm(self.settings)
            except Exception:
                pass
        mesh_err = None
        if refreshed and self._mesh is not None:
            # the new generation's stack is built with it, not inside its
            # first request; a stack that cannot be built (budget, no
            # live segment) leaves the next request to degrade. Any other
            # error fails the tick after its waiters are woken, and the
            # next request meets it again
            from ..parallel.mesh_executor import MeshUnavailable

            try:
                if self._mesh.available():
                    self._mesh.ensure_snapshot()
            except MeshUnavailable:
                pass
            except Exception as e:
                mesh_err = e
        if refreshed:
            segment_build.note(
                "prewarm_ms", (time.perf_counter() - t0) * 1000.0
            )
        with self._refresh_cond:
            self._refresh_ticks += 1
            self._refresh_cond.notify_all()
        if mesh_err is not None:
            raise mesh_err

    def wait_for_refresh(self, timeout: float = 30.0) -> None:
        """`?refresh=wait_for` semantics: block until the change is
        searchable. With the background refresher running this waits on
        the NEXT completed tick (nudging it awake rather than forcing an
        inline refresh, so wait_for still batches with the interval);
        without one it degrades to a blocking refresh."""
        from ..index import segment_build

        r = self._refresher
        if (
            r is None
            or not r.is_alive()
            or self._refresh_interval_s() is None
        ):
            self.refresh()
            return
        segment_build.note("wait_for_waits")
        deadline = time.monotonic() + timeout
        with self._refresh_cond:
            target = self._refresh_ticks + 1
            self._refresh_cond.notify_all()  # wake the refresher now
            while self._refresh_ticks < target:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._refresh_cond.wait(timeout=left)
            done = self._refresh_ticks >= target
        if not done:
            self.refresh()  # refresher wedged: fall back to blocking

    def flush(self) -> None:
        for s in self.shards:
            s.flush()
        for owner in self._remote_owners():
            self.remote_call(owner, ACTION_SHARD_FLUSH, {"index": self.name})
        self._persist_meta()

    def _persist_meta(self) -> None:
        """Durable index metadata, including dynamically-added mappings —
        the IndexMetadata persistence that in ES rides every dynamic
        mapping update through the master (SURVEY.md §3.2)."""
        if self.base_path is None:
            return
        import json

        os.makedirs(self.base_path, exist_ok=True)
        meta_settings = {k: v for k, v in self.settings.items()}
        if self.analysis_config:
            meta_settings["analysis"] = self.analysis_config
        meta = {
            "settings": meta_settings,
            "mappings": self.mappings.to_json(),
            "uuid": self.uuid,
            "creation_date": self.creation_date,
        }
        tmp = os.path.join(self.base_path, "_meta.json.tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.base_path, "_meta.json"))

    @classmethod
    def load_meta(cls, base_path: str) -> Optional[dict]:
        import json

        try:
            with open(os.path.join(base_path, "_meta.json"), encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _release_serving_resources(self) -> None:
        """Tears down the process-local serving machinery shared by
        close() and crash(): batcher threads, the
        executors' device-memory ledger charges (postings, doc values, norms, agg
        columns, …) — a closed index keeps no device residency; before
        this, every index close leaked its executors' ledger bytes for
        the life of the process — and this index's cache entries."""
        r = self._refresher
        if r is not None:
            with self._refresh_cond:
                self._refresher_stop = True
                self._refresh_cond.notify_all()
            r.join(timeout=5.0)
            self._refresher = None
        self._batcher.close()
        if self._mesh is not None:
            self._mesh.close()
        with self._executor_lock:
            execs, self._executors = dict(self._executors), {}
        for _gen, ex in execs.values():
            if hasattr(ex, "close"):
                ex.close()
        from ..search.query_cache import filter_cache, request_cache

        filter_cache.clear([self.uuid])
        request_cache.clear([self.uuid])

    def close(self) -> None:
        # flushAndClose semantics (InternalEngine.close): make everything
        # durable, trim the WAL, persist metadata. Only local shards —
        # remote engines belong to their owning node's lifecycle.
        for s in self.shards:
            s.flush()
        self._persist_meta()
        for s in self.shards:
            s.close()
        self._release_serving_resources()

    def crash(self) -> None:
        """Simulated power loss for the whole index (durability
        harness): engines are abandoned WITHOUT flush/close — their
        translogs drop any acked-but-unfsynced tail — while the
        process-local serving machinery a dead box takes with it anyway
        is still released so the surviving test process stays hermetic.
        Disk state is exactly what a dead box would leave behind."""
        for s in self.shards:
            try:
                s.crash()
            except Exception:
                pass
        self._release_serving_resources()

    def clear_caches(self, query: bool = True, request: bool = True) -> int:
        """POST {index}/_cache/clear: drops this index's filter-bitset
        and/or request-cache entries; returns the entry count removed."""
        from ..search.query_cache import filter_cache, request_cache

        n = 0
        if query:
            n += filter_cache.clear([self.uuid])
        if request:
            n += request_cache.clear([self.uuid])
        return n

    # ---- search: shard-level query phase (SearchService.executeQueryPhase
    # analog; runs on the shard's owning node) ----

    def _executor(self, shard: ShardEngine):
        cached = self._executors.get(shard.shard_id)
        if cached is not None and cached[0] == shard.change_generation:
            return cached[1]
        with self._executor_lock:
            cached = self._executors.get(shard.shard_id)
            if cached is not None and cached[0] == shard.change_generation:
                return cached[1]
            from ..search.query_cache import (
                CacheCtx,
                filter_cache,
                request_cache,
            )

            reader = shard.reader()
            gen = shard.change_generation
            shard_key = f"{self.uuid}[{shard.shard_id}]"
            backend = str(self.settings.get("search.backend", "torch"))
            if backend == "torch":
                from ..search import executor_torch

                stale = self._executors.get(shard.shard_id)
                reuse = (
                    stale[1]
                    if stale is not None
                    and isinstance(stale[1], executor_torch.TorchExecutor)
                    else None
                )
                # the fused-route threshold is read here, at build time,
                # so a caller (a test) may lower the module constant
                ex = executor_torch.TorchExecutor(
                    reader,
                    device=self.device,
                    fused_min_docs=executor_torch.FUSED_MIN_DOCS,
                    reuse_from=reuse,
                )
                ex.cache_ctx = CacheCtx(shard_key, gen, "torch")
                ex._oracle.cache_ctx = CacheCtx(shard_key, gen, "np")
                # the sparse columns and the IVF indexes are built with
                # the generation, not inside its first request
                ex.warm_impacts(self.settings)
                ex.warm_ann(self.settings)
            elif backend == "numpy":
                ex = NumpyExecutor(reader)
                ex.cache_ctx = CacheCtx(shard_key, gen, "np")
            else:  # the setting's validator admits nothing else
                raise ValueError(f"unknown search.backend [{backend}]")
            # the refresh/merge that bumped the generation made every
            # older-generation cache entry unreachable (keys embed the
            # generation) — reclaim their bytes eagerly
            filter_cache.invalidate_shard(shard_key, keep_generation=gen)
            request_cache.invalidate_shard(shard_key, keep_generation=gen)
            old = self._executors.get(shard.shard_id)
            self._executors[shard.shard_id] = (gen, ex)
        if old is not None and hasattr(old[1], "close"):
            # release the stale generation's ledger charges (an
            # executor pinned by scroll/PIT contexts stops charging once
            # closed — see TorchExecutor._charge)
            old[1].close()
        return ex

    def _wait_batched(self, job, sid: int, shard_deadline, task):
        """Collects a batcher future under the shard's timeout budget
        and the request task's cancellation. An expired budget CANCELS
        the job before raising SearchTimeoutError — a bare abandon would
        leave the job queued, where it could later dispatch into this
        dead waiter (wasted device work nobody reads); cancelling makes
        the dequeue-time gate drop it so it never launches. A task
        cancel landing while the job is still queued cancels it in place
        the same way and propagates task_cancelled_exception."""
        from ..search.batcher import QueryBatcher
        from ..tasks import TaskCancelledException

        def _timeout() -> SearchTimeoutError:
            err = SearchTimeoutError(
                f"shard [{self.name}][{sid}] batched query "
                "exceeded the search timeout budget"
            )
            # never abandon the job: cancelled → dropped at dequeue
            self._batcher.cancel(job, error=err)
            return err

        step = 0.02 if (task is not None and task.cancellable) else None
        while True:
            if task is not None:
                try:
                    task.check_cancelled()
                except TaskCancelledException:
                    self._batcher.cancel(job)
                    raise
            wait_s = step
            if shard_deadline is not None:
                remaining = shard_deadline - time.monotonic()
                if remaining <= 0 and not job.done():
                    raise _timeout()
                wait_s = (
                    remaining if wait_s is None
                    else min(wait_s, max(remaining, 0.0))
                )
            try:
                return QueryBatcher.wait(job, timeout=wait_s)
            except TimeoutError:
                if shard_deadline is None or (
                    time.monotonic() < shard_deadline
                ):
                    continue  # poll tick; budget not spent yet
                raise _timeout()

    def shard_search_local(
        self, sid: int, body: Optional[dict], pinned_executor=None,
        task=None,
    ) -> dict:
        """Full per-shard query phase + folded fetch for ONE locally-held
        shard. Returns a wire-shaped dict:
          {total, relation, max_score,
           hits: [{_id, _score, _source?, sort?, highlight?}],
           aggs?: partial, profile?: entry}
        `body` arrives with from/size already collapsed to 0/(from+size)
        by the coordinator."""
        ts = time.perf_counter_ns()
        body = body or {}
        # per-shard cooperative timeout (QueryPhase's timer analog): the
        # request's `timeout` rides the wire inside the body and each
        # shard enforces its own budget; expiry raises SearchTimeoutError
        # which the coordinator converts into a timed-out partial result
        shard_deadline = deadline_from(body)

        def _check_shard_deadline():
            if (
                shard_deadline is not None
                and time.monotonic() > shard_deadline
            ):
                raise SearchTimeoutError(
                    f"shard [{self.name}][{sid}] exceeded the search "
                    "timeout budget"
                )
        # ---- shard request cache (IndicesRequestCache): whole size:0 /
        # agg-only responses keyed by (canonical request bytes, refresh
        # generation) — a refresh that changed anything bumps the
        # generation, so a stale entry can never be served ----
        rc_key = None
        if (
            pinned_executor is None
            and int(body.get("size", 10)) == 0
            and not body.get("profile")
            and "_dfs" not in body
        ):
            from ..search.query_cache import (
                request_cache,
                request_cacheable_body,
            )

            rc_flag = body.get("request_cache")
            rc_enabled = (
                bool(rc_flag)
                if rc_flag is not None
                else bool(self.settings.get("requests.cache.enable", True))
            )
            cache_only = bool(body.get("_cache_only"))
            if (rc_enabled or cache_only) and request_cacheable_body(body):
                rc_key = (
                    f"{self.uuid}[{sid}]",
                    self.local_shard(sid).change_generation,
                    dsl.canonical_body_key(body),
                )
                hit = request_cache.get(*rc_key)
                if hit is not None:
                    return hit
            if cache_only:
                # tier-3 brownout (cache_only): an agg body that missed
                # the shard request cache is shed instead of computed
                raise RequestCacheOnlyMiss(
                    self.name, sid, retry_after_s=admission.retry_after_s()
                )
        k = int(body.get("size", 10))
        min_score = body.get("min_score")
        source_spec = body.get("_source", True)
        search_after = body.get("search_after")
        sort_specs = None
        if "sort" in body:
            from ..search.executor import parse_sort

            sort_specs = parse_sort(body["sort"])
            if search_after is None and [s["field"] for s in sort_specs] == [
                "_score"
            ]:
                sort_specs = None  # default relevance order
        if search_after is not None:
            if sort_specs is None:
                raise dsl.QueryParseError(
                    "Sort must contain at least one field when using search_after"
                )
            if len(search_after) != len(sort_specs):
                raise dsl.QueryParseError(
                    f"search_after has {len(search_after)} value(s) but sort "
                    f"has {len(sort_specs)}"
                )
        query = dsl.parse_query(body["query"]) if "query" in body else None
        knn_body = body.get("knn")
        knn = None
        if knn_body is not None:
            knn = [
                dsl.parse_knn(kb)
                for kb in (knn_body if isinstance(knn_body, list) else [knn_body])
            ]
            if str(self.settings.get("search.backend")) == "torch":
                # IVF ANN routing (index.knn.type, ?exact=true escape
                # hatch, per-section nprobe): the numpy oracle backend
                # never routes — it IS the exact reference
                from ..search import ann as ann_mod

                ann_mod.annotate(knn, self.settings, body)
        aggs_body = body.get("aggs") or body.get("aggregations")
        agg_nodes = None
        if aggs_body is not None:
            from ..search.aggs import parse_aggs

            agg_nodes = parse_aggs(aggs_body)
        profile = bool(body.get("profile"))
        # ES default: totals tracked accurately up to 10_000, pruning
        # allowed past it (SearchSourceBuilder.TRACK_TOTAL_HITS_ACCURATE
        # default of 10_000 in RestSearchAction)
        tth = body.get("track_total_hits", 10_000)

        shard = self.local_shard(sid)
        ex = pinned_executor if pinned_executor is not None else self._executor(shard)
        td = None
        masks = None
        svals: List[list] = []
        # DFS global statistics override for this request (context-
        # scoped so executor caches stay shard-local)
        dfs_stats = body.get("_dfs")
        dfs_token = None
        dfs_norm_token = None
        if dfs_stats is not None:
            from ..search.executor import DFS_NORM_CACHE, DFS_STATS

            dfs_token = DFS_STATS.set(dfs_stats)
            dfs_norm_token = DFS_NORM_CACHE.set({})
        prof_phases: Optional[dict] = None
        prof_token = None
        if profile:
            from ..search.executor import PROFILE_CTX

            # one dict serves both sinks: unbatched executors write the
            # PROFILE_CTX keys (device_scoring_ns/...), batched jobs
            # carry it as j.prof and the dispatcher fills "families"
            prof_phases = {"families": {}}
            prof_token = PROFILE_CTX.set(prof_phases)
        # ---- batched fast path: flat match / serve plans and bare knn
        # sections on the torch backend go through the cross-request
        # micro-batching dispatcher (shared launches across concurrent
        # requests). DFS requests skip it: their weights are request-
        # specific, not cacheable ----
        if (
            agg_nodes is None
            and sort_specs is None
            and search_after is None
            and min_score is None
            and pinned_executor is None
            and dfs_stats is None
            and str(self.settings.get("search.backend")) == "torch"
        ):
            from ..search.batcher import (
                extract_knn_plan,
                extract_match_plan,
                extract_serve_plan,
                extract_sparse_plan,
                split_filtered_bool,
            )
            from ..search.executor_torch import TorchExecutor

            if isinstance(ex, TorchExecutor):
                plan = None
                kind = "match"
                if isinstance(query, dsl.SparseVectorQuery):
                    # learned-sparse leg: resolve the storage column
                    # (int8 default / fp32 via `"exact": true`) and ride
                    # the batcher's `sparse` job family
                    from ..search import sparse as sparse_mod

                    query.sparse = sparse_mod.resolve(
                        self.settings, bool(body.get("exact"))
                    )
                    plan = extract_sparse_plan(query, self.mappings)
                    kind = "sparse"
                elif query is not None and knn is None:
                    plan = extract_match_plan(
                        query, self.mappings, self.analysis, tth
                    )
                    if plan is None:
                        plan = extract_serve_plan(
                            query, self.mappings, self.analysis
                        )
                        kind = "serve"
                elif query is None and knn is not None:
                    plan = extract_knn_plan(knn, self.mappings)
                    kind = "knn"
                if plan is not None:
                    try:
                        job = self._batcher.submit_nowait(
                            ex, plan, k, kind=kind, query=query,
                            deadline=shard_deadline, prof=prof_phases,
                        )
                        # the batcher future honors the shard's timeout
                        # budget: an expired wait abandons the job (the
                        # worker sheds it at dequeue) and reports this
                        # shard timed-out instead of blocking; with a
                        # cancellable task the wait polls, so a cancel
                        # landing before dispatch drops the job from
                        # the queue — it never launches
                        td = self._wait_batched(job, sid, shard_deadline, task)
                    except RuntimeError:
                        # batcher closed mid-request → the executor's
                        # per-query path, still on the same device; any
                        # other failure (a launch) reaches the caller
                        if not self._batcher._closed:
                            raise
                        td = None
                if td is None and plan is None and query is not None and knn is None:
                    # bool with filter clauses: peel the filters into a
                    # cached device bitset and run the scoring part as a
                    # fused plan with the bitset masking the scorers
                    split = split_filtered_bool(query)
                    if split is not None and all(
                        dsl.is_cacheable_filter(c) for c in split[1]
                    ):
                        td = ex.search_plan_filtered(
                            split[0], split[1], k, tth,
                            self.mappings, self.analysis,
                        )
        agg_partial = None
        try:
            agg_deviceable = (
                td is None
                and agg_nodes is not None
                and sort_specs is None
                and search_after is None
                and knn is None
                and min_score is None
                and pinned_executor is None
                and dfs_stats is None
                and not isinstance(ex, NumpyExecutor)
            )
            if agg_deviceable:
                # ---- device aggregations: the whole agg tree compiles
                # to segment-sum passes and rides the batcher's `agg`
                # job family. An injected `aggs.collect` fault or the
                # device-memory budget (the breaker, or an agg column
                # that would not fit: DeviceAggUnsupported, which a
                # dispatch raises only from that check) sends the body
                # to the host collector below, as in the reference; any
                # other failure reaches the caller. Trees the compiler
                # does not take (search/aggs_device.try_compile) never
                # run on the card, so a device answer is exact ----
                from ..common.faults import InjectedFault
                from ..common.memory import CircuitBreakingException
                from ..search import aggs_device

                dplan = aggs_device.try_compile(
                    ex, agg_nodes, self.mappings, self.name, sid, query, k
                )
                if dplan is not None:
                    got = None
                    try:
                        job = self._batcher.submit_nowait(
                            ex, dplan, k, kind="agg",
                            deadline=shard_deadline, prof=prof_phases,
                        )
                        got = self._wait_batched(job, sid, shard_deadline, task)
                    except (
                        InjectedFault,
                        CircuitBreakingException,
                        aggs_device.DeviceAggUnsupported,
                    ):
                        aggs_device.note_fallback()
                    except RuntimeError:
                        if not self._batcher._closed:
                            raise
                        aggs_device.note_fallback()
                    if got is not None:
                        td, agg_partial = got
                        aggs_device.note_device_routed()
            if td is None and agg_deviceable:
                # keyword terms aggs bucket on the card in the query
                # pass: an index_add_ per segment, compact downloads
                got = ex.execute_with_terms_aggs(query, agg_nodes, k, tth)
                if got is not None:
                    td, agg_partial = got
            if td is None:
                if sort_specs is not None:
                    device_sorted = None
                    if (
                        not isinstance(ex, NumpyExecutor)
                        and agg_nodes is None
                        and knn is None
                        and min_score is None
                    ):
                        # single numeric-key sorts collect on the card
                        # (rank columns; one k-row download)
                        device_sorted = ex.execute_sorted_device(
                            query, sort_specs, size=k,
                            search_after=search_after,
                        )
                    if device_sorted is not None:
                        td, svals = device_sorted
                        masks = None  # no aggs on this path (condition)
                    else:
                        # multi-key, keyword, _score/_doc/_id and
                        # `missing` overrides: the reference's own host
                        # route, the oracle's sorted collection
                        oracle = (
                            ex if isinstance(ex, NumpyExecutor) else ex._oracle
                        )
                        td, masks, svals = oracle.execute_sorted(
                            query,
                            sort_specs,
                            size=k,
                            from_=0,
                            knn=knn,
                            min_score=min_score,
                            search_after=search_after,
                        )
                else:
                    td, masks = ex.execute(
                        query, size=k, from_=0, knn=knn, min_score=min_score
                    )
            if agg_nodes is not None and agg_partial is None:
                # trees the device compiler does not take (and the
                # numpy backend): the host collector over the query's
                # masks — the reference's routing, not a fallback
                from ..search import aggs_device
                from ..search.aggs import AggCollector

                oracle = ex if isinstance(ex, NumpyExecutor) else ex._oracle
                agg_partial = AggCollector(oracle).collect(agg_nodes, masks)
                aggs_device.note_host_routed()
        finally:
            if dfs_token is not None:
                from ..search.executor import DFS_NORM_CACHE, DFS_STATS

                DFS_STATS.reset(dfs_token)
                DFS_NORM_CACHE.reset(dfs_norm_token)
            if prof_token is not None:
                from ..search.executor import PROFILE_CTX

                PROFILE_CTX.reset(prof_token)

        # ---- rescore phase (search/rescorer.py): second-stage
        # late-interaction reranking of the top window_size candidates,
        # BETWEEN merge and fetch — on the torch backend the maxsim
        # rides the batcher's `rerank` job family over the device-
        # resident rank_vectors column (one launch + one packed download
        # per group); sources are fetched only for the re-sorted page ----
        if (
            "rescore" in body
            and sort_specs is None
            and td is not None
            and td.hits
        ):
            from ..search import rescorer

            rescore_spec = rescorer.parse_rescore(body, validate_size=False)
            if rescore_spec is not None:
                t_resc = time.perf_counter_ns()
                td = self._apply_rescore(
                    ex, rescore_spec, td, sid, shard_deadline, task,
                    prof=prof_phases,
                )
                if prof_phases is not None:
                    prof_phases["rescore_ns"] = (
                        prof_phases.get("rescore_ns", 0)
                        + time.perf_counter_ns() - t_resc
                    )

        # ---- folded fetch phase: sources + highlight for this shard's
        # candidates (FetchPhase, SURVEY.md §3.3) ----
        _check_shard_deadline()
        t_fetch = time.perf_counter_ns()
        highlight_specs = None
        highlight_terms = None
        if "highlight" in body:
            from ..search.highlight import extract_highlight_terms, parse_highlight

            highlight_specs = parse_highlight(body["highlight"])
            highlight_terms = extract_highlight_terms(
                query, self.mappings, self.analysis
            )
        from ..search.executor import filter_source

        script_fields = body.get("script_fields")
        fields_spec = body.get("fields")
        # nested queries requesting inner_hits (InnerHitsPhase)
        nested_inner = _nested_with_inner_hits(query) if query else []
        field_names: List[str] = []
        if fields_spec:
            # expand once, from a snapshot (concurrent dynamic mapping
            # may grow the dict); the fields option serves MAPPED fields
            # only, for exact names and patterns alike
            import fnmatch as _fn

            mapped = sorted(self.mappings.fields)
            for fspec in fields_spec:
                pat = fspec if isinstance(fspec, str) else fspec.get("field")
                if not pat:
                    continue
                if any(ch in pat for ch in "*?"):
                    field_names.extend(
                        f for f in mapped if _fn.fnmatch(f, pat)
                    )
                elif pat in self.mappings.fields:
                    field_names.append(pat)
        reader = ex.reader
        hits = []
        for i, h in enumerate(td.hits):
            src = reader.segments[h.segment].sources[h.local_doc]
            entry: dict = {
                "_id": h.doc_id,
                "_score": None if sort_specs is not None else h.score,
            }
            filtered = filter_source(src, source_spec)
            if filtered is not None and source_spec is not False:
                entry["_source"] = filtered
            if sort_specs is not None:
                entry["sort"] = list(svals[i]) if i < len(svals) else []
            if highlight_specs is not None and src is not None:
                hl = self._highlight_hit(src, highlight_specs, highlight_terms)
                if hl:
                    entry["highlight"] = hl
            if field_names:
                # the `fields` option (FetchFieldsPhase): flat lists of
                # values for mapped fields; the key is omitted when no
                # requested field has a value (ES shape)
                from ..search.executor import _extract_field

                got: Dict[str, list] = {}
                for fname in field_names:
                    vals = _extract_field(src or {}, fname)
                    if vals:
                        got[fname] = list(vals)
                if got:
                    entry.setdefault("fields", {}).update(got)
            if nested_inner and src is not None:
                from ..search.executor import _nested_objects

                oracle = ex if isinstance(ex, NumpyExecutor) else ex._oracle
                ih: Dict[str, dict] = {}
                for nq in nested_inner:
                    spec = nq.inner_hits or {}
                    ih_name = spec.get("name", nq.path)
                    if ih_name in ih:
                        raise dsl.QueryParseError(
                            f"[inner_hits] already contains an entry for "
                            f"key [{ih_name}]"
                        )
                    ih_size = int(spec.get("size", 3))
                    ih_source = spec.get("_source", True)
                    objs = _nested_objects(src, nq.path)
                    matched = [
                        (oi, obj)
                        for oi, obj in enumerate(objs)
                        if oracle._nested_obj_match(obj, nq.query, nq.path)
                    ]
                    inner_hits_list = []
                    for oi, obj in matched[:ih_size]:
                        ihit: dict = {
                            "_index": self.name,
                            "_id": h.doc_id,
                            "_nested": {"field": nq.path, "offset": oi},
                            "_score": None,
                        }
                        if ih_source is not False:
                            filtered_obj = filter_source(obj, ih_source)
                            if filtered_obj is not None:
                                ihit["_source"] = filtered_obj
                        inner_hits_list.append(ihit)
                    ih[ih_name] = {
                        "hits": {
                            "total": {"value": len(matched),
                                      "relation": "eq"},
                            "max_score": None,
                            "hits": inner_hits_list,
                        }
                    }
                if ih:
                    entry["inner_hits"] = ih
            if script_fields:
                from ..script import ScriptError, script_service
                from ..search.executor import _source_field_lookup

                lookup = _source_field_lookup(
                    reader.segments[h.segment], h.local_doc
                )
                flds = entry.setdefault("fields", {})
                for fname, spec in script_fields.items():
                    try:
                        v = script_service.run_field(
                            spec.get("script") if isinstance(spec, dict) else spec,
                            lookup,
                        )
                    except ScriptError as e:
                        raise dsl.QueryParseError(str(e))
                    flds[fname] = v if isinstance(v, list) else [v]
            hits.append(entry)
        fetch_ns = time.perf_counter_ns() - t_fetch
        acc = FETCH_ACC.get()
        if acc is not None:
            # always-on fetch-phase accumulator: the coordinator's
            # slowlog fetch threshold reads the request total
            acc["fetch_ns"] += fetch_ns
        if prof_phases is not None:
            prof_phases["fetch_ns"] = (
                prof_phases.get("fetch_ns", 0) + fetch_ns
            )
        out = {
            "total": int(td.total),
            "relation": td.relation,
            "max_score": None if td.max_score is None else float(td.max_score),
            "hits": hits,
        }
        if agg_partial is not None:
            out["aggs"] = agg_partial
        if "suggest" in body:
            out["suggest"] = self._shard_suggest(ex, body["suggest"])
        tr = TRACE_CTX.get()
        if tr is not None:
            tr.add_span(
                "shard_search", ts, time.perf_counter_ns(),
                index=self.name, shard=sid,
                backend=str(self.settings.get("search.backend")),
            )
        if profile:
            # per-shard query-phase breakdown ("profile": true —
            # Profilers/QueryProfiler response shape). The breakdown
            # separates DEVICE kernel time (everything queued up to the
            # block_until_ready barrier), device→host TRANSFER time, and
            # host merge time (SURVEY §5: "per-kernel device times …
            # in the same response shape").
            elapsed = time.perf_counter_ns() - ts
            phases = prof_phases or {}
            device_ns = int(phases.get("device_scoring_ns", 0))
            transfer_ns = int(phases.get("device_transfer_ns", 0))
            merge_ns = int(phases.get("host_merge_ns", 0))
            accounted = device_ns + transfer_ns + merge_ns
            out["profile"] = {
                "id": f"[{self.uuid}][{self.name}][{sid}]",
                "searches": [
                    {
                        "query": [
                            {
                                "type": type(query).__name__
                                if query is not None
                                else "MatchAllQuery",
                                "description": json_dumps_safe(
                                    body.get("query", {"match_all": {}})
                                ),
                                "time_in_nanos": elapsed,
                                "breakdown": {
                                    "device_scoring": device_ns,
                                    "device_transfer": transfer_ns,
                                    "host_merge": merge_ns,
                                    "host_other": max(
                                        0, elapsed - accounted
                                    ),
                                    "backend": str(
                                        self.settings.get("search.backend")
                                    ),
                                },
                            }
                        ],
                        "rewrite_time": 0,
                        "collector": [
                            {
                                "name": "SimpleTopDocsCollector",
                                "reason": "search_top_hits",
                                "time_in_nanos": merge_ns or elapsed,
                            }
                        ],
                    }
                ],
                "aggregations": [],
                # batcher-family breakdown: one entry per plan family
                # this request dispatched through (match/serve/knn/
                # sparse/agg/rerank and the mesh_* variants) — launch
                # count, kernel dispatch/collect wall time, queue wait,
                # roofline flops, pad bucket, batch width, express-lane
                # and pruning hits
                "families": dict(phases.get("families", {})),
                "phases": {
                    "rescore_ns": int(phases.get("rescore_ns", 0)),
                    "fetch_ns": int(phases.get("fetch_ns", 0)),
                },
                "pruned_jobs": int(phases.get("pruned_jobs", 0)),
            }
        if rc_key is not None:
            from ..search.query_cache import request_cache

            request_cache.put(*rc_key, out)
        return out

    # ---- can_match prefilter (CanMatchPreFilterSearchPhase) ----

    def shard_can_match_local(self, sid: int, body: Optional[dict]) -> bool:
        """Cheap per-shard match possibility check: range queries test
        the shard's doc-value min/max, term/match queries test term-
        dictionary presence; unknown nodes are conservatively matchable.
        Deleted docs are ignored (over-inclusion is safe)."""
        body = body or {}
        if "query" not in body:
            return True
        try:
            q = dsl.parse_query(body["query"])
        except dsl.QueryParseError:
            return True
        eng = self._local.get(sid)
        if eng is None:
            return True
        return _can_match(q, eng, self.mappings, self.analysis)

    def _can_match_round(self, body: dict):
        """(skipped shard ids, pinned shard→copy owners). Engaged like
        the reference: many shards (pre_filter_shard_size, default 128)
        or a range query in the tree; never when aggs/knn need every
        shard's contribution. When engaged, the SAME copy the prefilter
        consulted serves the search (owners map pins it), so refresh-
        visibility differences between copies can't skip a shard one
        copy would have matched."""
        if (
            self.num_shards <= 1
            or "query" not in body
            or body.get("aggs")
            or body.get("aggregations")
            or body.get("knn")
            or body.get("suggest")
        ):
            # suggest/aggs/knn need every shard's contribution
            return set(), None
        try:
            q = dsl.parse_query(body["query"])
        except dsl.QueryParseError:
            return set(), None
        threshold = int(body.get("pre_filter_shard_size", 128))
        if self.num_shards < threshold and not _tree_has_range(q):
            return set(), None
        owners = {
            sid: self._search_node(sid) for sid in range(self.num_shards)
        }
        skipped = set()

        def one(sid: int) -> bool:
            owner = owners[sid]
            if owner is None or owner == self.local_node:
                return self.shard_can_match_local(sid, body)
            try:
                return bool(
                    self.remote_call(
                        owner,
                        ACTION_SHARD_CAN_MATCH,
                        {"index": self.name, "shard": sid, "body": body},
                    )["can_match"]
                )
            except Exception:
                return True  # a failed prefilter never skips a shard

        # num_shards >= 2 here (guarded above)
        futs = [
            _FANOUT_POOL.submit(one, sid) for sid in range(self.num_shards)
        ]
        for sid, f in enumerate(futs):
            if not f.result():
                skipped.add(sid)
        return skipped, owners

    # ---- suggest phase (SuggestPhase: term suggester) ----

    def _shard_suggest(self, ex, suggest_body: dict) -> dict:
        """Per-shard term-suggester candidates: for each analyzed token,
        dictionary terms within max_edits with their doc freq, plus the
        token's own df (for suggest_mode=missing at reduce)."""
        from ..search.executor import _levenshtein_at_most

        reader = ex.reader
        out: Dict[str, list] = {}
        for name, spec in (suggest_body or {}).items():
            if not isinstance(spec, dict) or "term" not in spec:
                continue
            term_spec = spec["term"] or {}
            field = term_spec.get("field")
            text = spec.get("text", "")
            if not field:
                raise dsl.QueryParseError(
                    f"suggester [{name}] requires [term.field]"
                )
            max_edits = int(term_spec.get("max_edits", 2))
            mf = self.mappings.get(field)
            analyzer_name = (
                (mf.search_analyzer or mf.analyzer)
                if mf is not None
                else "standard"
            )
            try:
                toks = self.analysis.get(analyzer_name).analyze(str(text))
            except ValueError:
                toks = []
            # one vocabulary scan per UNIQUE token; distance checked per
            # unique candidate term, df resolved once per candidate
            vocab: set = set()
            for seg in reader.segments:
                pf = seg.postings.get(field)
                if pf is not None:
                    vocab.update(pf.terms)
            cand_cache: Dict[str, Dict[str, int]] = {}
            entries = []
            for t_obj in toks:
                tok = t_obj.text
                own_df, _ = reader.term_stats(field, tok)
                cands = cand_cache.get(tok)
                if cands is None:
                    cands = {}
                    for t in vocab:
                        if t == tok or abs(len(t) - len(tok)) > max_edits:
                            continue
                        if _levenshtein_at_most(tok, t, max_edits):
                            cands[t] = reader.term_stats(field, t)[0]
                    cand_cache[tok] = cands
                entries.append(
                    {
                        "text": tok,
                        # analyzer offsets point at the SURFACE text, so
                        # corrections splice into the right span even
                        # when the token differs by case/stemming
                        "offset": t_obj.start_offset,
                        "length": t_obj.end_offset - t_obj.start_offset,
                        "own_df": int(own_df),
                        "options": cands,
                    }
                )
            out[name] = entries
        return out

    # ---- DFS phase (search_type=dfs_query_then_fetch) ----

    def shard_dfs_local(self, sid: int, spec: Dict[str, List[str]]) -> dict:
        """One shard's term/field statistics for the DFS round
        (DfsPhase.execute → DfsSearchResult)."""
        ex = self._executor(self.local_shard(sid))
        reader = ex.reader
        fields: Dict[str, list] = {}
        terms: Dict[str, dict] = {}
        for f, ts in spec.items():
            dc, ttf = reader.field_stats(f)
            fields[f] = [dc, ttf]
            terms[f] = {t: reader.term_stats(f, t)[0] for t in ts}
        return {"fields": fields, "terms": terms}

    def _dfs_round(
        self, body: dict, skipped: Optional[set] = None
    ) -> Optional[dict]:
        """Aggregates df/doc_count/sum_ttf across every shard for the
        query's terms (SearchPhaseController.aggregateDfs); the result
        rides the per-shard request as `_dfs` and overrides shard-local
        statistics during scoring."""
        if "query" not in body:
            return None
        try:
            q = dsl.parse_query(body["query"])
        except dsl.QueryParseError:
            return None
        wanted = _dfs_terms(q, self.mappings, self.analysis)
        if not wanted:
            return None
        spec = {f: sorted(ts) for f, ts in wanted.items()}

        def one(sid: int) -> dict:
            try:
                owner = self._search_node(sid)
                if owner is None or owner == self.local_node:
                    return self.shard_dfs_local(sid, spec)
                return self.remote_call(
                    owner,
                    ACTION_SHARD_DFS,
                    {"index": self.name, "shard": sid, "spec": spec},
                )
            except Exception:
                # a shard that can't contribute statistics must not fail
                # the round — if it is truly broken the query phase will
                # record the failure with full accounting
                return {"fields": {}, "terms": {}}

        agg_fields = {f: [0, 0] for f in spec}
        agg_terms: Dict[str, Dict[str, int]] = {
            f: {t: 0 for t in ts} for f, ts in spec.items()
        }
        sids = [
            sid for sid in range(self.num_shards)
            if not (skipped and sid in skipped)
        ]
        if len(sids) <= 1:
            results = [one(s) for s in sids]
        else:
            futs = [_FANOUT_POOL.submit(one, sid) for sid in sids]
            results = [f.result() for f in futs]
        for r in results:
            for f, (dc, ttf) in r["fields"].items():
                agg_fields[f][0] += int(dc)
                agg_fields[f][1] += int(ttf)
            for f, tmap in r["terms"].items():
                for t, df in tmap.items():
                    agg_terms[f][t] += int(df)
        return {"fields": agg_fields, "terms": agg_terms}

    def shard_count_local(self, sid: int, body: Optional[dict]) -> dict:
        body = body or {}
        query = dsl.parse_query(body["query"]) if "query" in body else None
        ex = self._executor(self.local_shard(sid))
        td = ex.search(query, size=0)
        return {"count": int(td.total)}

    # ---- search: coordinator fan-out + reduce ----

    def _fan_out(
        self,
        body: dict,
        pinned: Optional[List] = None,
        skipped: Optional[set] = None,
        owners: Optional[Dict[int, Optional[str]]] = None,
        deadline: Optional[float] = None,
        task=None,
    ):
        """Scatter the per-shard request to every shard (local direct
        call or transport hop) with per-shard failure isolation.

        Returns ``(results, failures, timed_out)``: `results[sid]` is
        the wire-shaped shard result or None when the shard failed;
        `failures` holds ShardSearchFailure-shaped entries; `timed_out`
        is True when any shard blew the request's `timeout` budget.

        One shard's exception never poisons the fan-out: the call is
        retried once on another in-sync copy (excluding the failed
        node, with the failure reported toward the master like
        `_report_shard_failed`), and only then recorded as failed. A
        red shard (no searchable copy) is failed without dispatch.
        `pinned[sid]` is a local executor or a {"node","ctx"} token
        from pin_executors(). Shards in `skipped` (can_match prefilter)
        contribute empty results without dispatch; `owners` pins copy
        selection to the copies the prefilter consulted."""
        from ..tasks import TaskCancelledException

        def attempt(sid: int, owner: Optional[str], pin) -> dict:
            faults.check(
                "shard.search", index=self.name, shard=sid,
                node=owner if owner is not None else (self.local_node or "local"),
            )
            if owner is None or owner == self.local_node:
                return self.shard_search_local(
                    sid, body, pinned_executor=pin, task=task
                )
            return self.remote_call(
                owner,
                ACTION_SHARD_SEARCH,
                {"index": self.name, "shard": sid, "body": body},
            )

        def run(sid: int):
            if skipped and sid in skipped:
                return "ok", {
                    "total": 0,
                    "relation": "eq",
                    "max_score": None,
                    "hits": [],
                }
            if task is not None:
                task.check_cancelled()
            pin = pinned[sid] if pinned is not None else None
            if isinstance(pin, dict):
                # remote (or registry-held) pinned context: the reader
                # context is node-bound, so there is no copy to retry on
                try:
                    return "ok", self.remote_call(
                        pin["node"],
                        ACTION_SHARD_SEARCH,
                        {
                            "index": self.name,
                            "shard": sid,
                            "body": body,
                            "ctx": pin["ctx"],
                        },
                    )
                except SearchTimeoutError as e:
                    return "timeout", shard_failure(
                        self.name, sid, pin["node"], e
                    )
                except Exception as e:
                    if _request_scoped_error(e):
                        raise
                    return "fail", shard_failure(self.name, sid, pin["node"], e)
            if self._red_shard(sid):
                from .service import ClusterError

                return "fail", shard_failure(
                    self.name,
                    sid,
                    None,
                    ClusterError(
                        503,
                        f"primary shard [{self.name}][{sid}] is not active",
                        "unavailable_shards_exception",
                    ),
                )
            owner = (
                owners[sid] if owners is not None else self._search_node(sid)
            )
            try:
                return "ok", attempt(sid, owner, pin)
            except TaskCancelledException:
                raise
            except SearchTimeoutError as e:
                return "timeout", shard_failure(self.name, sid, owner, e)
            except Exception as e:
                if _request_scoped_error(e):
                    raise
                self._note_shard_failed(sid, owner)
                # a slow-then-failed primary must not overshoot the
                # request's `timeout` budget by a whole second attempt:
                # when the deadline is already spent, the failure is
                # reported as a timed-out shard instead of retried
                if deadline is not None and time.monotonic() >= deadline:
                    return "timeout", shard_failure(
                        self.name, sid, owner,
                        SearchTimeoutError(
                            f"shard [{self.name}][{sid}] failed "
                            f"({failure_type(e)}) with the request "
                            "budget spent; replica retry skipped"
                        ),
                    )
                alt = self._retry_copy(sid, exclude={owner})
                if alt is None:
                    # stale routing (relocation cutover / failover mid-
                    # publish): wait for the next state and pick again
                    alt = self._reresolve_copy(sid, {owner}, e)
                if alt is not None:
                    # node-wide retry budget (token bucket fed by live
                    # admitted traffic): during an incident, replica
                    # retries cannot amplify a brownout into a storm
                    if not admission.retry_allowed():
                        return "fail", shard_failure(
                            self.name, sid, owner, e
                        )
                    try:
                        return "ok", attempt(sid, alt, pin)
                    except SearchTimeoutError as e2:
                        return "timeout", shard_failure(self.name, sid, alt, e2)
                    except Exception as e2:
                        if _request_scoped_error(e2):
                            raise
                        self._note_shard_failed(sid, alt)
                        return "fail", shard_failure(self.name, sid, alt, e2)
                return "fail", shard_failure(self.name, sid, owner, e)

        n = self.num_shards
        if n == 1 and deadline is None and task is None:
            outcomes = [run(0)]
        else:
            # copy the caller's context per shard so contextvars (the
            # request's Trace, the FETCH_ACC accumulator, X-Opaque-Id)
            # reach the fan-out worker threads — the vars hold shared
            # mutable objects, so writes made in the workers are visible
            # to the coordinator
            cctx = contextvars.copy_context()
            futs = [
                _FANOUT_POOL.submit(cctx.copy().run, run, sid)
                for sid in range(n)
            ]
            outcomes = []
            for sid, f in enumerate(futs):
                outcomes.append(
                    self._gather_one(f, sid, deadline, task)
                )
        results: List[Optional[dict]] = [None] * n
        failures: List[dict] = []
        timed_out = False
        for sid, (tag, payload) in enumerate(outcomes):
            if tag == "ok":
                results[sid] = payload
            else:
                failures.append(payload)
                if tag == "timeout":
                    timed_out = True
        return results, failures, timed_out

    def _gather_one(self, fut, sid: int, deadline: Optional[float], task):
        """Bounded wait for one shard future: an expired request budget
        abandons the shard (its worker thread finishes into the void)
        and records a timed-out failure; with a cancellable task, the
        wait polls so a cancel landing mid-collect aborts promptly."""
        from concurrent.futures import TimeoutError as _FutTimeout

        while True:
            if task is not None:
                task.check_cancelled()
            step: Optional[float] = 0.02 if task is not None else None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0 and not fut.done():
                    fut.cancel()
                    return "timeout", shard_failure(
                        self.name,
                        sid,
                        None,
                        SearchTimeoutError(
                            f"shard [{self.name}][{sid}] did not complete "
                            "within the search timeout"
                        ),
                    )
                step = remaining if step is None else min(step, remaining)
            try:
                return fut.result(timeout=step)
            except _FutTimeout:
                continue

    def pin_executors(self, keep_alive: Optional[float] = None) -> List:
        """Point-in-time executor snapshot (ReaderContext acquire): scroll
        and PIT searches reuse these so concurrent refreshes don't change
        the view between pages. In distributed mode every shard gets a
        reader context held in its owning node's registry and the pin is
        a {"node","ctx"} token (the scroll-id → per-shard ReaderContext
        indirection of SearchService.createAndPutReaderContext)."""
        if self.routing is None:
            return [self._executor(self._local[s]) for s in range(self.num_shards)]
        pins: List[dict] = []
        payload: dict = {"index": self.name}
        if keep_alive is not None:
            payload["keep_alive"] = float(keep_alive)
        for sid in range(self.num_shards):
            owner = self._search_node(sid) or self.local_node
            out = self.remote_call(
                owner, ACTION_CTX_OPEN, {**payload, "shard": sid}
            )
            pins.append({"node": owner, "ctx": out["ctx"]})
        return pins


    def release_pins(self, pins: List) -> None:
        for pin in pins or []:
            if isinstance(pin, dict):
                try:
                    self.remote_call(
                        pin["node"], ACTION_CTX_CLOSE, {"ctx": pin["ctx"]}
                    )
                except Exception:
                    pass  # best-effort (context TTL reaps it anyway)

    # ---- whole-index serving (parallel/mesh_executor.py): one stacked
    # launch over every (shard, segment) entry replaces the per-shard
    # fan-out for the hot flat-plan request shapes ----

    # body keys the mesh fetch path can serve; anything else (aggs,
    # sort, highlight, profile, timeout, …) takes the per-shard path
    _MESH_BODY_KEYS = frozenset(
        {
            "query", "knn", "size", "from", "_source",
            "track_total_hits", "allow_partial_search_results",
            "allow_degraded", "rescore", "exact", "profile",
        }
    )

    def mesh_executor(self):
        mex = self._mesh
        if mex is None:
            with self._executor_lock:
                if self._mesh is None:
                    from ..parallel.mesh_executor import MeshExecutor

                    self._mesh = MeshExecutor(self)
                mex = self._mesh
        return mex

    def _mesh_fallback_ok(self, e: BaseException) -> bool:
        """The errors a routed mesh request may degrade on, besides
        MeshUnavailable: an injected fault (the `batcher.dispatch` /
        `batcher.collect` sites and the family sites with mesh=1) and a
        closed batcher. A real device, shape or parse error is not among
        them."""
        from ..common.faults import InjectedFault

        return isinstance(e, InjectedFault) or bool(
            getattr(self._batcher, "_closed", False)
        )

    def _mesh_search(self, body: dict, task=None) -> Optional[dict]:
        """Whole-index execution of one request: B concurrent same-plan
        requests × all shards run as ONE stacked launch (batched through
        the QueryBatcher's mesh job kinds) — per-entry scoring and local
        top-k, the k-way merge and the totals in the same step — instead
        of S per-shard jobs, S launches and S host round trips. Returns
        the wire response, or None to fall through to the per-shard
        coordinator (ineligible body, mesh off, `MeshUnavailable`, an
        injected fault or a closed batcher). Any other error raises to
        the caller: no fallback hides the device. Results are the
        per-shard path's — same scoring formula, same (score desc, shard
        asc, segment asc, doc asc) merge order."""
        mesh = self.mesh_executor()
        if not mesh.available():
            return None
        if "aggs" in body or "aggregations" in body:
            # size:0 agg bodies execute as ONE stacked launch (bucket
            # accumulators summed across the entries) when eligible
            return self._mesh_agg_search(body, mesh, task)
        if any(k not in self._MESH_BODY_KEYS for k in body):
            return None
        if deadline_from(body) is not None:
            return None  # cooperative timeouts stay on the shard path
        has_q = "query" in body
        has_knn = "knn" in body
        if has_q == has_knn:  # hybrid or match_all: shard path
            return None
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        if size <= 0 or from_ < 0:
            return None
        tth = body.get("track_total_hits", 10_000)
        from ..search.batcher import (
            QueryBatcher,
            extract_knn_plan,
            extract_match_plan,
            extract_serve_plan,
        )

        kind = None
        if has_q:
            query = dsl.parse_query(body["query"])  # parse errors are
            # request-scoped: surface them exactly like the shard path
            if isinstance(query, dsl.SparseVectorQuery):
                from ..search import sparse as sparse_mod
                from ..search.batcher import extract_sparse_plan

                query.sparse = sparse_mod.resolve(
                    self.settings, bool(body.get("exact"))
                )
                plan = extract_sparse_plan(query, self.mappings)
                kind = "mesh_sparse"
            else:
                plan = extract_match_plan(
                    query, self.mappings, self.analysis, tth
                )
                kind = "mesh_match"
                if plan is None:
                    plan = extract_serve_plan(
                        query, self.mappings, self.analysis
                    )
                    kind = "mesh_serve"
        else:
            knn_body = body["knn"]
            knn = [
                dsl.parse_knn(kb)
                for kb in (knn_body if isinstance(knn_body, list) else [knn_body])
            ]
            from ..search import ann as ann_mod

            ann_mod.annotate(knn, self.settings, body)
            plan = extract_knn_plan(knn, self.mappings)
            kind = "mesh_knn"
        if plan is None:
            return None
        if "rescore" in body:
            # fused mesh rescore: only flat match plans carry it (knn +
            # rescore stays on the shard path), and only when the
            # reranker is actually on (mode off = the escape hatch)
            from ..common.settings import rerank_mode
            from ..models import rerank as rerank_model
            from ..search import rescorer

            if kind != "mesh_match":
                return None
            spec = rescorer.parse_rescore(body, validate_size=False)
            if spec is not None:
                model = rerank_model.resolve_model(
                    self.mappings, self.settings, spec.field
                )
                if model is None:
                    raise dsl.QueryParseError(
                        f"[rescore] field [{spec.field}] is not mapped "
                        "as [rank_vectors]"
                    )
                if rerank_mode() == "off":
                    rerank_model.note("skipped")
                else:
                    # rides the MatchPlan into the batcher group key:
                    # different specs / page sizes never share a launch
                    # (MatchPlan is frozen — attach out-of-band)
                    object.__setattr__(plan, "rescore", (model, spec))
                    object.__setattr__(
                        plan, "rescore_sig", (model, spec, from_ + size)
                    )
        from ..parallel.mesh_executor import MeshUnavailable

        t0 = time.perf_counter()
        tns0 = time.perf_counter_ns()
        mesh_prof = {"families": {}} if body.get("profile") else None
        try:
            job = self._batcher.submit_nowait(
                mesh, plan, from_ + size, kind=kind, prof=mesh_prof,
            )
            td = QueryBatcher.wait(job)
        except MeshUnavailable as e:
            if e.budget:
                mesh.note_degraded()
            mesh.note_fallback()
            return None
        except BaseException as e:
            if not self._mesh_fallback_ok(e):
                raise
            mesh.note_fallback()
            return None
        from ..search.executor import filter_source

        source_spec = body.get("_source", True)
        snap = td.snapshot
        out_hits = []
        for h in td.hits[from_ : from_ + size]:
            entry: dict = {
                "_index": self.name,
                "_id": h.doc_id,
                "_score": float(h.score),
            }
            src = snap.readers[h.shard].segments[h.segment].sources[h.local_doc]
            filtered = filter_source(src, source_spec)
            if filtered is not None and source_spec is not False:
                entry["_source"] = filtered
            out_hits.append(entry)
        hits_obj: dict = {"max_score": td.max_score, "hits": out_hits}
        if tth is True:
            hits_obj["total"] = {"value": td.total, "relation": "eq"}
        elif tth is not False:
            limit = int(tth)
            hits_obj["total"] = {
                "value": min(td.total, limit),
                "relation": "gte" if td.total > limit else "eq",
            }
        took = int((time.perf_counter() - t0) * 1000)
        self.search_stats["query_total"] += 1
        self.search_stats["query_time_in_millis"] += took
        self.search_stats["fetch_total"] += 1
        mesh.note_routed()
        tr = TRACE_CTX.get()
        if tr is not None:
            tr.add_span(
                "mesh_search", tns0, time.perf_counter_ns(),
                index=self.name, shards=self.num_shards, took_ms=took,
            )
        n = self.num_shards
        resp = {
            "took": took,
            "timed_out": False,
            "_shards": {"total": n, "successful": n, "skipped": 0,
                        "failed": 0},
            "hits": hits_obj,
        }
        if mesh_prof is not None:
            resp["profile"] = {
                "coordinator": {
                    "phases": {"mesh_ns": int(
                        (time.perf_counter() - t0) * 1e9
                    )},
                    "took_ns": int((time.perf_counter() - t0) * 1e9),
                    "mesh": True,
                },
                "families": dict(mesh_prof.get("families", {})),
                "shards": [],
            }
        return resp

    # body keys the mesh AGG path can serve (size:0, so no fetch keys)
    _MESH_AGG_BODY_KEYS = frozenset(
        {
            "query", "size", "aggs", "aggregations", "track_total_hits",
            "_source", "allow_partial_search_results", "allow_degraded",
            "request_cache", "profile",
        }
    )

    def _mesh_agg_search(self, body: dict, mesh, task=None) -> Optional[dict]:
        """Whole-index execution of one size:0 agg body: per-entry
        segment-sum bucket accumulators reduce across the entry axis
        with sum/amin/amax (ordinal tables unioned at stack build), one
        launch and one compact download for the whole index. Returns the wire response or None to fall through to the
        per-shard coordinator (whose shard-level device-agg engine and
        request cache then serve the request).

        Routing note: the per-shard path owns the shard request cache,
        so in ``auto`` mesh mode only cache-opted-out bodies ride the
        mesh; ``ES_TPU_MESH=force`` routes every eligible body (bench /
        mesh tests)."""
        from ..common.settings import device_aggs_mode, mesh_mode

        if device_aggs_mode() == "off":
            return None
        if any(k not in self._MESH_AGG_BODY_KEYS for k in body):
            return None
        if int(body.get("size", 10)) != 0:
            return None
        if deadline_from(body) is not None:
            return None  # cooperative timeouts stay on the shard path
        if mesh_mode() != "force" and body.get("request_cache") is not False:
            return None
        mplan = None
        if "query" in body:
            query = dsl.parse_query(body["query"])
            if not isinstance(query, dsl.MatchAllQuery):
                from ..search.batcher import extract_match_plan

                mplan = extract_match_plan(
                    query, self.mappings, self.analysis,
                    body.get("track_total_hits", 10_000),
                )
                if mplan is None:
                    return None
        try:
            from ..search.aggs import parse_aggs, reduce_aggs

            agg_nodes = parse_aggs(
                body.get("aggs") or body.get("aggregations")
            )
        except Exception:
            return None  # the shard path raises the user-facing error
        from ..parallel.mesh_executor import MeshUnavailable
        from ..search import aggs_device
        from ..search.batcher import QueryBatcher

        t0 = time.perf_counter()
        mesh_prof = {"families": {}} if body.get("profile") else None
        try:
            plan = mesh.compile_agg(agg_nodes, mplan, self.mappings)
            job = self._batcher.submit_nowait(
                mesh, plan, 0, kind="mesh_agg", prof=mesh_prof,
            )
            got = QueryBatcher.wait(job)
        except MeshUnavailable as e:
            if e.budget:
                mesh.note_degraded()
            mesh.note_fallback()
            return None
        except BaseException as e:
            if not self._mesh_fallback_ok(e):
                raise
            mesh.note_fallback()
            return None
        tth = body.get("track_total_hits", 10_000)
        hits_obj: dict = {"max_score": got["max_score"], "hits": []}
        total = got["total"]
        if tth is True:
            hits_obj["total"] = {"value": total, "relation": "eq"}
        elif tth is not False:
            limit = int(tth)
            hits_obj["total"] = {
                "value": min(total, limit),
                "relation": "gte" if total > limit else "eq",
            }
        took = int((time.perf_counter() - t0) * 1000)
        self.search_stats["query_total"] += 1
        self.search_stats["query_time_in_millis"] += took
        mesh.note_routed()
        aggs_device.note_mesh_routed()
        aggs_device.note_kernel_ms((time.perf_counter() - t0) * 1000.0)
        n = self.num_shards
        resp = {
            "took": took,
            "timed_out": False,
            "_shards": {"total": n, "successful": n, "skipped": 0,
                        "failed": 0},
            "hits": hits_obj,
            "aggregations": reduce_aggs(agg_nodes, [got["partials"]]),
        }
        if mesh_prof is not None:
            resp["profile"] = {
                "coordinator": {
                    "phases": {"mesh_ns": int(
                        (time.perf_counter() - t0) * 1e9
                    )},
                    "took_ns": int((time.perf_counter() - t0) * 1e9),
                    "mesh": True,
                },
                "families": dict(mesh_prof.get("families", {})),
                "shards": [],
            }
        return resp

    def search(
        self,
        body: Optional[dict] = None,
        pinned_executors: Optional[List] = None,
        task=None,
    ) -> dict:
        body = body or {}
        # arm the fetch-phase accumulator for this request: shard fetch
        # loops add into the shared dict (it rides copied contexts into
        # the fan-out pools), the slowlog fetch threshold reads the sum
        acc_token = FETCH_ACC.set({"fetch_ns": 0})
        try:
            if pinned_executors is not None:
                # scroll/PIT continuations were admitted when the
                # context opened; re-gating every page would
                # double-charge them
                resp = self._search_reduced(body, pinned_executors, task)
                self._slowlog_note(body, resp)
                return resp
            # ---- per-node admission gate (search/admission.py):
            # weighted fair queueing across indices, AIMD concurrency
            # limit, deadline shedding, brownout degraded modes. Raises
            # EsOverloadedError (429 + Retry-After) when this request
            # is shed. ----
            ticket = admission.acquire(
                self.name,
                weight=float(
                    self.settings.get("search.admission.weight", 1.0)
                ),
                deadline=deadline_from(body),
            )
            try:
                degraded, actions = apply_brownout(body, ticket.tier)
                resp = self._search_reduced(degraded, None, task)
                if ticket.tier > 0:
                    # brownout visibility: every degraded response says
                    # which tier served it and what was shed
                    resp["_overload"] = {
                        "pressure_tier": ticket.tier,
                        "pressure_mode": ticket.mode,
                        "actions": actions,
                    }
                self._slowlog_note(degraded, resp)
                return resp
            finally:
                admission.release(ticket)
        finally:
            FETCH_ACC.reset(acc_token)

    def _slowlog_note(self, body: dict, resp: dict) -> None:
        """Feeds one completed coordinator search to the per-index slow
        log. Fully fenced: a slowlog bug must never fail a search."""
        try:
            if not self._slowlog.enabled():
                return
            acc = FETCH_ACC.get()
            fetch_ms = (
                acc["fetch_ns"] / 1e6 if acc is not None else 0.0
            )
            summary = None
            prof = resp.get("profile")
            if prof:
                coord = prof.get("coordinator") or {}
                summary = {
                    "phases_ns": dict(coord.get("phases", {})),
                    "shards": len(prof.get("shards") or []),
                }
            shards = resp.get("_shards") or {}
            self._slowlog.on_search(
                float(resp.get("took", 0)),
                fetch_ms,
                shards=int(shards.get("total", self.num_shards)),
                source=body,
                opaque_id=OPAQUE_ID_CTX.get(),
                profile_summary=summary,
            )
        except Exception:
            pass

    def _search_reduced(
        self,
        body: Optional[dict] = None,
        pinned_executors: Optional[List] = None,
        task=None,
    ) -> dict:
        resp, agg_nodes, agg_partials = self.search_internal(
            body, pinned_executors, task=task
        )
        if agg_nodes is not None:
            from ..search.aggs import reduce_aggs

            resp["aggregations"] = reduce_aggs(agg_nodes, agg_partials)
        return resp

    def search_internal(
        self,
        body: Optional[dict] = None,
        pinned_executors: Optional[List] = None,
        extra_filter: Optional[dict] = None,
        task=None,
    ):
        """Returns (response-without-aggs, agg_nodes, agg_partials) so a
        multi-index coordinator can reduce aggs across indices (the
        QueryPhaseResultConsumer split). ``extra_filter`` supports
        filtered aliases (AliasFilter ANDed into the query)."""
        body = body or {}
        _validate_sparse_fields(body.get("query"), self.mappings)
        if "retriever" in body:
            _validate_sparse_fields(body.get("retriever"), self.mappings)
        if "rescore" in body:
            from ..search import rescorer

            # coordinator-side request validation (KnnSearchBuilder
            # style): malformed rescore elements 400 here, before any
            # shard work
            rescorer.parse_rescore(body)
            if pinned_executors is not None:
                # QueryRescorer parity: rescore over a scroll / PIT
                # context is a request error, not a server-side one
                raise dsl.QueryParseError(
                    "Cannot use [rescore] option in conjunction with "
                    "[scroll] or a point in time."
                )
        if "retriever" in body:
            return self._retriever_search(body, extra_filter), None, []
        rank = body.get("rank")
        if (
            isinstance(rank, dict)
            and "rrf" in rank
            and "query" in body
            and "knn" in body
        ):
            # top-level query + knn + rank.rrf (the 8.8 hybrid search
            # API) rides the SAME concurrent-leg + device-fusion path
            # as the rrf retriever tree
            return (
                self._retriever_search(_rank_to_retriever(body), extra_filter),
                None,
                [],
            )
        if extra_filter is not None:
            inner = body.get("query", {"match_all": {}})
            body = {
                **body,
                "query": {"bool": {"must": [inner], "filter": [extra_filter]}},
            }
        # mesh fast path: one whole-index stacked launch for the hot
        # flat-plan shapes (pinned contexts stay on the shard path — a
        # point-in-time reader must not see a rebuilt stack)
        if pinned_executors is None:
            mesh_resp = self._mesh_search(body, task=task)
            if mesh_resp is not None:
                return mesh_resp, None, []
        t0 = time.perf_counter()
        tns = time.perf_counter_ns()
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        # coordinator-side parses (merge keys + agg reduce plan only; the
        # shards re-parse the body themselves so it can ride the wire)
        sort_specs = None
        if "sort" in body:
            from ..search.executor import parse_sort

            sort_specs = parse_sort(body["sort"])
            if body.get("search_after") is None and [
                s["field"] for s in sort_specs
            ] == ["_score"]:
                sort_specs = None
        aggs_body = body.get("aggs") or body.get("aggregations")
        agg_nodes = None
        if aggs_body is not None:
            from ..search.aggs import parse_aggs

            agg_nodes = parse_aggs(aggs_body)
        profile = bool(body.get("profile"))
        tth = body.get("track_total_hits", 10_000)

        # every shard returns the full global page's worth of hits
        sub = {**body, "from": 0, "size": from_ + size}
        # coordinator-phase marks (profile + tracing): the phase spans
        # tile tns → the reduce mark, so their sum accounts the whole
        # coordinator wall time up to response assembly
        m_parse = time.perf_counter_ns()
        # can_match prefilter FIRST (the reference's phase order), so a
        # DFS round never fans out to shards about to be skipped; pinned
        # contexts pin every shard, so the prefilter only runs unpinned
        if pinned_executors is None:
            skipped_shards, fixed_owners = self._can_match_round(body)
        else:
            skipped_shards, fixed_owners = set(), None
        m_canmatch = time.perf_counter_ns()
        if body.get("search_type") == "dfs_query_then_fetch":
            dfs = self._dfs_round(body, skipped_shards)
            if dfs is not None:
                sub["_dfs"] = dfs
        m_dfs = time.perf_counter_ns()
        deadline = deadline_from(body)
        per_shard, failures, timed_out = self._fan_out(
            sub, pinned_executors, skipped_shards, fixed_owners,
            deadline=deadline, task=task,
        )
        m_fanout = time.perf_counter_ns()
        allow_partial = parse_allow_partial(
            body.get("allow_partial_search_results")
        )
        shard_results = [r for r in per_shard if r is not None]
        if failures and not allow_partial:
            from .service import ClusterError

            first = failures[0]["reason"]
            raise ClusterError(
                503,
                f"Search rejected due to missing shards "
                f"[[{self.name}][{failures[0]['shard']}]]: "
                f"{first['type']}: {first['reason']} "
                "(allow_partial_search_results is false)",
                "search_phase_execution_exception",
            )
        if failures and not shard_results and not timed_out:
            # every shard failed hard: there is nothing partial to serve
            # (SearchPhaseExecutionException "all shards failed")
            from .service import ClusterError

            first = failures[0]["reason"]
            raise ClusterError(
                503,
                f"all shards failed: {first['type']}: {first['reason']}",
                "search_phase_execution_exception",
            )

        # ---- coordinator reduce (SearchPhaseController.reducedQueryPhase:
        # merge-sort per-shard pages by score/sort key, shard asc, rank
        # asc — within a shard rank order already encodes (segment, doc)
        # ascending tie-breaks) ----
        total = sum(r["total"] for r in shard_results)
        max_score = None
        for r in shard_results:
            ms = r.get("max_score")
            if ms is not None:
                max_score = ms if max_score is None else max(max_score, ms)
        entries = []
        for si, r in enumerate(per_shard):
            if r is None:
                continue
            for rank, h in enumerate(r["hits"]):
                if sort_specs is not None:
                    key = tuple(
                        _col_key(v, spec)
                        for v, spec in zip(h.get("sort", []), sort_specs)
                    )
                else:
                    sc = h.get("_score")
                    key = (-(sc if sc is not None else 0.0),)
                entries.append((key, si, rank, h))
        entries.sort(key=lambda e: e[:3])
        out_hits = [
            {"_index": self.name, **h} for _, _, _, h in entries[from_ : from_ + size]
        ]
        m_reduce = time.perf_counter_ns()
        took = int((time.perf_counter() - t0) * 1000)
        self.search_stats["query_total"] += 1
        self.search_stats["query_time_in_millis"] += took
        self.search_stats["fetch_total"] += 1
        hits_obj: dict = {
            "max_score": None if sort_specs is not None else max_score,
            "hits": out_hits,
        }
        gte_shard = any(r.get("relation") == "gte" for r in shard_results)
        if tth is True:
            hits_obj["total"] = {"value": total, "relation": "eq"}
        elif tth is not False:
            limit = int(tth)
            hits_obj["total"] = {
                "value": min(total, limit),
                "relation": "gte" if (total > limit or gte_shard) else "eq",
            }
        n = self.num_shards
        shards_obj: dict = {
            "total": n,
            "successful": n - len(failures),
            "skipped": len(skipped_shards),
            "failed": len(failures),
        }
        if failures:
            shards_obj["failures"] = failures
        resp = {
            "took": took,
            "timed_out": timed_out,
            "_shards": shards_obj,
            "hits": hits_obj,
        }
        coord_phases = {
            "parse_ns": m_parse - tns,
            "can_match_ns": m_canmatch - m_parse,
            "dfs_ns": m_dfs - m_canmatch,
            "fan_out_ns": m_fanout - m_dfs,
            "reduce_ns": m_reduce - m_fanout,
        }
        tr = TRACE_CTX.get()
        if tr is not None:
            root = tr.add_span(
                "coordinator", tns, m_reduce,
                index=self.name, shards=n, took_ms=took,
            )
            prev = tns
            for pname, mark in (
                ("parse", m_parse), ("can_match", m_canmatch),
                ("dfs", m_dfs), ("fan_out", m_fanout),
                ("reduce", m_reduce),
            ):
                tr.add_span(pname, prev, mark, parent_id=root)
                prev = mark
        if profile:
            resp["profile"] = {
                "coordinator": {
                    "phases": coord_phases,
                    "took_ns": m_reduce - tns,
                },
                "shards": [
                    r["profile"] for r in shard_results if r.get("profile")
                ],
            }
        if "suggest" in body:
            resp["suggest"] = _reduce_suggest(
                body["suggest"],
                [r["suggest"] for r in shard_results if r.get("suggest")],
            )
        agg_partials = [
            r["aggs"] for r in shard_results if r.get("aggs") is not None
        ]
        return resp, agg_nodes, agg_partials

    # ---- hybrid retrieval: the retriever tree, concurrent legs, RRF ----

    def _rerank_job(self, ex, plan, n, mode, deadline=None, sid=None,
                     task=None, prof=None):
        """Runs one rerank job through the batcher's `rerank` family and
        returns (scores, perm, kernel_ms), or None when the first-stage
        order stands. The degrade contract, narrower than the
        reference's (which keeps the first stage on ANY failure): an
        injected `rerank.score` fault or a batcher closed under the
        request counts `fallbacks`; a column over the device-memory
        budget counts `skipped` (an error under ES_TPU_RERANK=force).
        Timeout, task cancel and 429 keep their request semantics, and
        any other error — a failed launch on the card — fails the
        request."""
        from ..common.faults import InjectedFault
        from ..models import rerank as rerank_model
        from ..search.batcher import QueryBatcher

        try:
            job = self._batcher.submit_nowait(
                ex, plan, n, kind="rerank", deadline=deadline, prof=prof,
            )
            if sid is None:
                got = QueryBatcher.wait(job)
            else:
                got = self._wait_batched(job, sid, deadline, task)
        except InjectedFault:
            rerank_model.note("fallbacks")
            return None
        except RuntimeError:
            if not self._batcher._closed:
                raise
            rerank_model.note("fallbacks")
            return None
        tag, scores, perm, kernel_ms = got
        if tag != "ok":
            if mode == "force":
                raise RuntimeError(
                    "[rescore] rerank column unavailable under "
                    "ES_TPU_RERANK=force"
                )
            rerank_model.note("skipped")
            return None
        return scores, perm, kernel_ms

    def _rerank_model(self, spec):
        from ..models import rerank as rerank_model

        model = rerank_model.resolve_model(self.mappings, self.settings, spec.field)
        if model is None:
            raise dsl.QueryParseError(
                f"[rescore] field [{spec.field}] is not mapped as "
                "[rank_vectors]"
            )
        return model

    def _highlight_hit(self, src: dict, specs: dict, terms_by_field: dict) -> dict:
        from ..search.highlight import highlight_field

        out = {}
        for fname, spec in specs.items():
            terms = terms_by_field.get(fname)
            if not terms:
                continue
            value = src.get(fname)
            if value is None and "." in fname:
                node = src
                for part in fname.split("."):
                    node = node.get(part) if isinstance(node, dict) else None
                    if node is None:
                        break
                value = node
            if value is None:
                continue
            mf = self.mappings.get(fname)
            analyzer_name = mf.analyzer if mf is not None else "standard"
            try:
                analyzer = self.analysis.get(analyzer_name)
            except ValueError:
                continue
            values = value if isinstance(value, list) else [value]
            frags: List[str] = []
            for v in values:
                frags.extend(
                    highlight_field(
                        str(v),
                        terms,
                        analyzer,
                        spec["pre"],
                        spec["post"],
                        spec["fragment_size"],
                        spec["number_of_fragments"],
                    )
                )
            if frags:
                out[fname] = frags
        return out

    def _apply_rescore(self, ex, spec, td, sid, shard_deadline, task,
                       prof=None):
        """Applies one shard's rescore phase to its first-stage
        TopDocs: the numpy backend takes the host float oracle, the
        torch backend the batcher's `rerank` family (ops/rerank.py),
        under `_rerank_job`'s degrade contract. ES_TPU_RERANK=off keeps
        the first-stage order (counted `skipped`)."""
        from ..common.settings import rerank_mode
        from ..models import rerank as rerank_model
        from ..search import rescorer

        model = self._rerank_model(spec)
        mode = rerank_mode()
        if mode == "off":
            rerank_model.note("skipped")
            return td
        if isinstance(ex, NumpyExecutor):
            # the numpy backend IS the float oracle
            return rescorer.host_rescore_topdocs(ex.reader, model, spec, td)
        plan = rescorer.build_plan(
            ex.reader, model, spec,
            [(h.score, h.segment, h.local_doc) for h in td.hits],
        )
        got = self._rerank_job(ex, plan, len(td.hits), mode, shard_deadline,
                               sid, task, prof)
        if got is None:
            return td
        scores, perm, kernel_ms = got
        rerank_model.note_rescore(
            min(spec.window_size, len(td.hits)), device=True,
            kernel_ms=kernel_ms,
        )
        return rescorer.apply_perm_to_topdocs(td, scores, perm)

    def _rescore_ranked(
        self, spec, ranked: List[tuple], pins=None, prof=None
    ) -> List[tuple]:
        """Rescore phase for the retriever/rrf coordinator path over a
        fused ranked [(doc_id, score)] list. A single local torch shard
        reranks on the card; everything else — multi-shard, numpy —
        takes the host oracle, as in the reference. Same degrade
        contract as `_apply_rescore`.

        Candidates map to (segment, doc) through the PINNED reader's
        own location table (`_reader_locations`), never the live
        engine's `_locations` — a refresh landing between the legs and
        the rescore would otherwise point fused doc ids at local docs
        of a DIFFERENT generation (wrong token rows rescored)."""
        import numpy as np

        from ..common.settings import rerank_mode
        from ..models import rerank as rerank_model
        from ..search import rescorer
        from ..search.executor_torch import TorchExecutor

        model = self._rerank_model(spec)
        mode = rerank_mode()
        if mode == "off":
            rerank_model.note("skipped")
            return ranked
        window = min(int(spec.window_size), len(ranked))
        # device path: one local torch shard → the fused candidates keep
        # exact (segment, doc) identity via the pinned reader's locations
        if (
            self.routing is None
            and self.num_shards == 1
            and str(self.settings.get("search.backend")) == "torch"
        ):
            try:
                ex = pins[0] if pins else self._executor(self.local_shard(0))
            except KeyError:
                ex = None
            if ex is not None and isinstance(ex, TorchExecutor):
                locs = _reader_locations(ex)
                cands = []
                for doc_id, score in ranked:
                    loc = locs.get(doc_id)
                    if loc is None:
                        cands = None
                        break
                    cands.append((float(score), int(loc[0]), int(loc[1])))
                if cands is not None:
                    plan = rescorer.build_plan(ex.reader, model, spec, cands)
                    got = self._rerank_job(ex, plan, len(cands), mode, prof=prof)
                    if got is None:
                        return ranked
                    scores, perm, kernel_ms = got
                    rerank_model.note_rescore(window, device=True, kernel_ms=kernel_ms)
                    out = []
                    for s, p in zip(scores, perm):
                        if not np.isfinite(s):
                            break
                        out.append((ranked[int(p)][0], float(s)))
                    return out
        # host oracle path (multi-shard / numpy backend)
        qtoks = rerank_model.prepare_query_vectors(
            spec.query_vectors, model.dims, model.similarity
        )
        blended = []
        for doc_id, score in ranked[:window]:
            msim = 0.0
            try:
                sid = route_shard_id(doc_id, self.num_shards)
                if pins and sid < len(pins) and not isinstance(pins[sid], dict):
                    px = pins[sid]
                else:
                    px = self._executor(self.local_shard(sid))
                loc = _reader_locations(px).get(doc_id)
                if loc is not None:
                    mvf = px.reader.segments[loc[0]].multi_vectors.get(model.field)
                    if mvf is not None:
                        s0 = int(mvf.tok_offsets[loc[1]])
                        s1 = int(mvf.tok_offsets[loc[1] + 1])
                        msim = rerank_model.host_maxsim(qtoks, mvf.tok_vectors[s0:s1])
            except KeyError:
                pass  # shard not local: candidate keeps first stage
            blended.append(
                float(
                    np.float32(spec.query_weight) * np.float32(score)
                    + np.float32(spec.rescore_query_weight) * np.float32(msim)
                )
            )
        order = sorted(range(window), key=lambda i: (-blended[i], i))
        rerank_model.note_rescore(window, device=False)
        return [(ranked[i][0], blended[i]) for i in order] + list(ranked[window:])

    def _retriever_search(
        self, body: dict, extra_filter: Optional[dict] = None
    ) -> dict:
        """`retriever` tree: standard / knn / rrf (x-pack rank-rrf:
        RRFRetrieverBuilder — score = Σ 1/(rank_constant + rank) over
        child retrievers, exact-doc dedup, rank_window_size candidates).

        All children of an `rrf` node run CONCURRENTLY — plannable legs
        (flat match / multi_match / bool text plans and bare knn
        sections on a single-shard torch index) are submitted through
        the QueryBatcher's future API so the BM25 and kNN device work
        overlaps; everything else fans out on the leg pool. When every
        leg came back with (segment, doc) identity from one executor
        the fusion runs on the card (ops/fusion.rrf_fuse_device), else
        on the host.

        Generation pinning: the per-shard executors are resolved ONCE,
        up front, and every phase (legs, fetch) reads that snapshot, so
        a refresh landing mid-request can't mix two generations."""
        t0 = time.perf_counter()
        tns = time.perf_counter_ns()
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        source_spec = body.get("_source", True)
        profile = bool(body.get("profile"))
        # retriever-path profile sink: per-leg breakdowns land in
        # "legs", batcher families in "families" — the body is never
        # mutated, so the profiled request rides the identical path
        prof: Optional[dict] = {"legs": []} if profile else None
        pins = None
        if self.routing is None:
            try:
                pins = self.pin_executors()
            except KeyError:
                pins = None
        window = max(from_ + size, 10)
        ranked = self._run_retriever(
            body["retriever"], window, size, extra_filter, pins, prof_out=prof
        )
        m_retr = time.perf_counter_ns()
        if "rescore" in body and ranked:
            from ..search import rescorer

            rescore_spec = rescorer.parse_rescore(body)
            if rescore_spec is not None:
                # second stage over the FUSED candidates (the RAG shape:
                # filtered hybrid retrieval → rerank → fetch); sources
                # are fetched below, after the window re-sort
                ranked = self._rescore_ranked(rescore_spec, ranked, pins, prof=prof)
        m_resc = time.perf_counter_ns()
        page = ranked[from_ : from_ + size]
        from ..search.executor import filter_source

        out_hits = []
        for doc_id, score in page:
            src = self._fetch_source_pinned(doc_id, pins)
            entry = {"_index": self.name, "_id": doc_id, "_score": float(score)}
            if src is not None and source_spec is not False:
                filtered = filter_source(src, source_spec)
                if filtered is not None:
                    entry["_source"] = filtered
            out_hits.append(entry)
        m_fetch = time.perf_counter_ns()
        acc = FETCH_ACC.get()
        if acc is not None:
            acc["fetch_ns"] += m_fetch - m_resc
        took = int((time.perf_counter() - t0) * 1000)
        tr = TRACE_CTX.get()
        if tr is not None:
            root = tr.add_span(
                "retriever_search", tns, m_fetch, index=self.name, took_ms=took,
            )
            tr.add_span("retriever", tns, m_retr, parent_id=root)
            tr.add_span("rescore", m_retr, m_resc, parent_id=root)
            tr.add_span("fetch", m_resc, m_fetch, parent_id=root)
        n = self.num_shards
        resp = {
            "took": took,
            "timed_out": False,
            "_shards": {"total": n, "successful": n, "skipped": 0, "failed": 0},
            "hits": {
                "total": {"value": len(ranked), "relation": "eq"},
                "max_score": max((s for _, s in page), default=None),
                "hits": out_hits,
            },
        }
        if prof is not None:
            resp["profile"] = {
                "coordinator": {
                    "phases": {
                        "retriever_ns": m_retr - tns,
                        "rescore_ns": m_resc - m_retr,
                        "fetch_ns": m_fetch - m_resc,
                    },
                    "took_ns": m_fetch - tns,
                },
                "legs": prof.get("legs", []),
                "families": dict(prof.get("families", {})),
                "fuse_ns": int(prof.get("fuse_ns", 0)),
                "shards": [],
            }
        return resp

    def _fetch_source_pinned(self, doc_id: str, pins):
        """Fetch-phase source read from the PINNED reader generation
        (the snapshot the candidates were scored against); realtime get
        is the fallback for unpinned requests."""
        if pins:
            sid = route_shard_id(doc_id, self.num_shards)
            pin = pins[sid] if sid < len(pins) else None
            if pin is not None and not isinstance(pin, dict):
                loc = _reader_locations(pin).get(doc_id)
                if loc is not None:
                    return pin.reader.segments[loc[0]].sources[loc[1]]
                return None  # not in the pinned generation
        doc = self.get_doc(doc_id)
        return None if doc is None else doc["_source"]

    def _run_retriever(
        self, ret: dict, window: int, size: int,
        extra_filter: Optional[dict], pins=None, prof_out=None,
    ) -> List[tuple]:
        """ranked [(doc_id, score)] for one retriever node (sync)."""
        if not isinstance(ret, dict) or len(ret) != 1:
            raise dsl.QueryParseError("[retriever] malformed")
        kind, params = next(iter(ret.items()))
        if kind == "standard":
            sub = {"size": window, "_source": False}
            if prof_out is not None:
                sub["profile"] = True
            if "query" in params:
                sub["query"] = params["query"]
            filters = [f for f in (params.get("filter"), extra_filter) if f is not None]
            if filters:
                sub["query"] = {
                    "bool": {
                        "must": [sub.get("query", {"match_all": {}})],
                        "filter": filters,
                    }
                }
            # _search_reduced, not search(): legs run INSIDE the parent
            # request's admission grant (re-admitting each leg would
            # double-charge the limit and can self-deadlock); pins ride
            # along so every leg scores against the request's snapshot
            resp = self._search_reduced(sub, pins)
            if prof_out is not None and resp.get("profile"):
                prof_out.setdefault("legs", []).append(
                    {"label": "bm25", "profile": resp["profile"]}
                )
            return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]
        if kind == "knn":
            knn_params = dict(params)
            if extra_filter is not None:
                # alias filter constrains the knn candidate set too
                existing = knn_params.get("filter")
                knn_params["filter"] = (
                    {"bool": {"filter": [existing, extra_filter]}}
                    if existing is not None
                    else extra_filter
                )
            knn_sub = {"knn": knn_params, "size": window, "_source": False}
            if prof_out is not None:
                knn_sub["profile"] = True
            resp = self._search_reduced(knn_sub, pins)
            if prof_out is not None and resp.get("profile"):
                prof_out.setdefault("legs", []).append(
                    {"label": "knn", "profile": resp["profile"]}
                )
            return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]
        if kind == "rrf":
            return self._run_rrf(params, window, size, extra_filter, pins, prof_out=prof_out)
        raise dsl.QueryParseError(f"unknown retriever [{kind}]")

    def _run_rrf(
        self, params: dict, window: int, size: int,
        extra_filter: Optional[dict], pins=None, prof_out=None,
    ) -> List[tuple]:
        """Concurrent child legs + fusion. All legs share ONE
        rank_window_size candidate budget."""
        rank_constant = int(params.get("rank_constant", 60))
        window2 = int(params.get("rank_window_size", max(window, size)))
        children = params.get("retrievers", [])
        t_start = time.perf_counter()
        t_start_ns = time.perf_counter_ns()
        # submit every leg before collecting any: plannable legs enter
        # the batcher (device overlap), the rest ride the leg pool
        handles = [
            self._submit_leg(child, window2, extra_filter, pins, profiled=prof_out is not None)
            for child in children
        ]
        legs = [self._wait_leg(h, window2, extra_filter, t_start, pins) for h in handles]
        t_fuse = time.perf_counter()
        fused: Optional[List[tuple]] = None
        device = False
        executors = {id(l["ex"]) for l in legs if l["ex"] is not None}
        if (
            len(legs) >= 2
            and all(l["td"] is not None for l in legs)
            and len(executors) == 1
        ):
            fused = self._fuse_legs_device(legs, window2, rank_constant)
            device = True
        if fused is None:
            # host fuse: dict accumulation, tie-break on ascending doc
            # id string
            acc: Dict[str, float] = {}
            for leg in legs:
                for rank, (doc_id, _) in enumerate(leg["ranked"], 1):
                    acc[doc_id] = acc.get(doc_id, 0.0) + 1.0 / (rank_constant + rank)
            fused = sorted(acc.items(), key=lambda kv: (-kv[1], kv[0]))[:window2]
        t_end = time.perf_counter()
        with self._rrf_lock:
            st = self.rrf_stats
            st["searches"] += 1
            st["fuse_ms"] += (t_end - t_fuse) * 1000.0
            st["device_fused" if device else "host_fused"] += 1
            for leg in legs:
                mode = {"batcher": "batcher_legs", "pool": "pool_legs"}.get(
                    leg["mode"], "inline_legs"
                )
                st[mode] += 1
                if leg["label"] in ("bm25", "knn", "sparse"):
                    st[f"{leg['label']}_leg_ms"] += leg["ms"]
                    self.rrf_leg_samples[leg["label"]].append(leg["ms"])
        if prof_out is not None:
            out_legs = prof_out.setdefault("legs", [])
            for leg in legs:
                entry = {"label": leg["label"], "mode": leg.get("mode", "?"), "ms": leg["ms"]}
                lp = leg.get("prof")
                if lp:
                    entry["families"] = dict(lp.get("families", {}))
                if leg.get("sub_profile"):
                    entry["profile"] = leg["sub_profile"]
                out_legs.append(entry)
            prof_out["fuse_ns"] = prof_out.get("fuse_ns", 0) + int((t_end - t_fuse) * 1e9)
            prof_out["fused_on_device"] = device
        tr = TRACE_CTX.get()
        if tr is not None:
            t_end_ns = time.perf_counter_ns()
            root = tr.add_span(
                "rrf", t_start_ns, t_end_ns,
                index=self.name, legs=len(legs), device_fused=device,
            )
            for leg in legs:
                tr.add_span(
                    f"leg:{leg['label']}", t_start_ns,
                    t_start_ns + int(leg["ms"] * 1e6), parent_id=root,
                    mode=leg.get("mode", "?"),
                )
        return fused

    def _submit_leg(
        self, child: dict, window: int, extra_filter: Optional[dict],
        pins=None, profiled=False,
    ) -> dict:
        """Async leg submission: a batcher future when the child reduces
        to a device plan, else a leg-pool future running the sync path.
        EsRejectedExecutionError propagates (HTTP 429)."""
        if not isinstance(child, dict) or len(child) != 1:
            raise dsl.QueryParseError("[retriever] malformed")
        kind, params = next(iter(child.items()))
        label = {"standard": "bm25", "knn": "knn"}.get(kind, "other")
        if (
            kind == "standard"
            and isinstance(params, dict)
            and isinstance(params.get("query"), dict)
            and "sparse_vector" in params["query"]
        ):
            # the third hybrid leg: a standard retriever whose query is
            # a learned-sparse clause gets its own per-leg timing bucket
            label = "sparse"
        planned = self._plan_leg(kind, params, window, extra_filter, pins)
        if planned is not None:
            ex, plan, pkind, query = planned
            leg_prof = {"families": {}} if profiled else None
            try:
                job = self._batcher.submit_nowait(
                    ex, plan, window, kind=pkind, query=query, prof=leg_prof,
                )
                return {
                    "mode": "batcher", "job": job, "ex": ex,
                    "label": label, "child": child, "prof": leg_prof,
                }
            except RuntimeError:
                pass  # batcher closed → the sync path below
        sink = {"legs": []} if profiled else None
        if threading.current_thread().name.startswith(_LEG_POOL_PREFIX):
            # nested rrf: already on a leg thread — run inline rather
            # than wait on a pool slot a sibling may be starving
            return {
                "mode": "done",
                "ranked": self._run_retriever(
                    child, window, window, extra_filter, pins, prof_out=sink,
                ),
                "label": label, "child": child, "prof_sink": sink,
            }
        # copied context per leg: the fetch accumulator, trace and opaque
        # id stay visible inside pool threads
        cctx = contextvars.copy_context()
        fut = _LEG_POOL.submit(
            cctx.copy().run,
            self._run_retriever, child, window, window, extra_filter, pins, sink,
        )
        return {
            "mode": "pool", "fut": fut, "label": label, "child": child,
            "prof_sink": sink,
        }

    def _plan_leg(
        self, kind: str, params: dict, window: int,
        extra_filter: Optional[dict], pins=None,
    ):
        """(executor, plan, plan_kind, query) when this child can ride
        the batcher directly: single locally-held shard, torch backend,
        no filters. None → leg-pool path."""
        if (
            self.routing is not None
            or self.num_shards != 1
            or extra_filter is not None
            or str(self.settings.get("search.backend")) != "torch"
        ):
            return None
        from ..search.batcher import (
            extract_knn_plan,
            extract_match_plan,
            extract_serve_plan,
        )
        from ..search.executor_torch import TorchExecutor

        if pins:
            ex = pins[0]  # the request's snapshot generation
        else:
            try:
                ex = self._executor(self.local_shard(0))
            except KeyError:
                return None
        if not isinstance(ex, TorchExecutor):
            return None
        if kind == "standard":
            if params.get("filter") is not None or "query" not in params:
                return None
            query = dsl.parse_query(params["query"])
            if isinstance(query, dsl.SparseVectorQuery):
                from ..search import sparse as sparse_mod
                from ..search.batcher import extract_sparse_plan

                query.sparse = sparse_mod.resolve(self.settings, False)
                plan = extract_sparse_plan(query, self.mappings)
                if plan is None:
                    return None
                return ex, plan, "sparse", query
            plan = extract_match_plan(query, self.mappings, self.analysis, 10_000)
            if plan is not None:
                return ex, plan, "match", query
            plan = extract_serve_plan(query, self.mappings, self.analysis)
            if plan is not None:
                return ex, plan, "serve", query
            return None
        if kind == "knn":
            try:
                sec = dsl.parse_knn(params)
            except (dsl.QueryParseError, KeyError, TypeError, ValueError):
                return None  # malformed → the sync path raises the real error
            from ..search import ann as ann_mod

            ann_mod.annotate([sec], self.settings, None)
            plan = extract_knn_plan([sec], self.mappings)
            if plan is None:
                return None
            return ex, plan, "knn", None
        return None

    def _wait_leg(
        self, handle: dict, window: int, extra_filter: Optional[dict],
        t_start: float, pins=None,
    ) -> dict:
        """Collects one leg: {"ranked", "td", "ex", "label", "ms"}."""
        td = None
        ex = None
        mode = handle["mode"]
        if mode == "batcher":
            from ..search.batcher import QueryBatcher

            try:
                td = QueryBatcher.wait(handle["job"])
                ex = handle["ex"]
                ranked = [(h.doc_id, h.score) for h in td.hits]
            except RuntimeError:
                # batcher closed mid-flight → the sync path, still on
                # the same device; any other failure reaches the caller
                if not self._batcher._closed:
                    raise
                mode = "inline"
                ranked = self._run_retriever(handle["child"], window, window, extra_filter, pins)
        elif mode == "done":
            ranked = handle["ranked"]
        else:
            ranked = handle["fut"].result()
        sink = handle.get("prof_sink")
        sub_profile = None
        if sink and sink.get("legs"):
            sub_profile = sink["legs"][0].get("profile")
        return {
            "ranked": ranked,
            "td": td,
            "ex": ex,
            "label": handle["label"],
            "mode": mode,
            "prof": handle.get("prof"),
            "sub_profile": sub_profile,
            "ms": (time.perf_counter() - t_start) * 1000.0,
        }

    def _fuse_legs_device(self, legs: List[dict], k: int, rank_constant: int) -> List[tuple]:
        """RRF on the card over the legs' top-window (segment, doc)
        lists: global int doc ids (segment base + local doc) keep
        exact-doc identity, fusion + dedup + top-k run on the executor's
        device (ops/fusion), and winners map back to _id strings on the
        host. Tie-break is ascending global doc — the (segment, doc) asc
        order every other merge uses."""
        import numpy as np
        import torch

        from ..ops.fusion import rrf_fuse_device

        ex = next(l["ex"] for l in legs if l["ex"] is not None)
        reader = ex.reader
        bases = np.zeros(len(reader.segments) + 1, np.int64)
        np.cumsum([seg.num_docs for seg in reader.segments], out=bases[1:])
        id_map: Dict[int, str] = {}
        arrays = []
        width = max(int(k), 1)
        for leg in legs:
            arr = np.full((1, width), -1, np.int32)
            for r, h in enumerate(leg["td"].hits[:width]):
                g = int(bases[h.segment] + h.local_doc)
                arr[0, r] = g
                id_map[g] = h.doc_id
            arrays.append(arr)
        s, d = rrf_fuse_device(arrays, k, rank_constant, device=ex.device)
        # one packed download (scores bitcast beside the docs)
        packed = torch.cat([s.view(torch.int32), d], dim=1)[0].cpu().numpy()
        width = int(s.shape[1])
        s = packed[:width].copy().view(np.float32)
        d = packed[width:]
        out: List[tuple] = []
        for sc, doc in zip(s, d):
            if doc < 0 or not np.isfinite(sc):
                break  # padding sorts last
            out.append((id_map[int(doc)], float(sc)))
        return out

    def count(
        self, body: Optional[dict] = None, extra_filter: Optional[dict] = None
    ) -> dict:
        body = body or {}
        if extra_filter is not None:
            inner = body.get("query", {"match_all": {}})
            body = {
                **body,
                "query": {"bool": {"must": [inner], "filter": [extra_filter]}},
            }

        def attempt(sid: int, owner: Optional[str]) -> dict:
            faults.check(
                "shard.count", index=self.name, shard=sid,
                node=owner if owner is not None else (self.local_node or "local"),
            )
            if owner is None or owner == self.local_node:
                return self.shard_count_local(sid, body)
            return self.remote_call(
                owner,
                ACTION_SHARD_COUNT,
                {"index": self.name, "shard": sid, "body": body},
            )

        def run(sid: int):
            if self._red_shard(sid):
                from .service import ClusterError

                return "fail", shard_failure(
                    self.name,
                    sid,
                    None,
                    ClusterError(
                        503,
                        f"primary shard [{self.name}][{sid}] is not active",
                        "unavailable_shards_exception",
                    ),
                )
            owner = self._search_node(sid)
            try:
                return "ok", attempt(sid, owner)
            except Exception as e:
                if _request_scoped_error(e):
                    raise
                self._note_shard_failed(sid, owner)
                alt = self._retry_copy(sid, exclude={owner})
                if alt is None:
                    # stale routing (relocation cutover / failover):
                    # wait for the next state and pick again
                    alt = self._reresolve_copy(sid, {owner}, e)
                if alt is not None:
                    if not admission.retry_allowed():
                        # node-wide retry budget: same cap as _fan_out
                        return "fail", shard_failure(
                            self.name, sid, owner, e
                        )
                    try:
                        return "ok", attempt(sid, alt)
                    except Exception as e2:
                        if _request_scoped_error(e2):
                            raise
                        self._note_shard_failed(sid, alt)
                        return "fail", shard_failure(self.name, sid, alt, e2)
                return "fail", shard_failure(self.name, sid, owner, e)

        n = self.num_shards
        if n == 1:
            outcomes = [run(0)]
        else:
            futs = [_FANOUT_POOL.submit(run, sid) for sid in range(n)]
            outcomes = [f.result() for f in futs]
        failures = [p for tag, p in outcomes if tag != "ok"]
        if failures and not parse_allow_partial(
            (body or {}).get("allow_partial_search_results")
        ):
            from .service import ClusterError

            first = failures[0]["reason"]
            raise ClusterError(
                503,
                f"Count rejected due to missing shards "
                f"[[{self.name}][{failures[0]['shard']}]]: "
                f"{first['type']}: {first['reason']} "
                "(allow_partial_search_results is false)",
                "search_phase_execution_exception",
            )
        shards_obj: dict = {
            "total": n,
            "successful": n - len(failures),
            "skipped": 0,
            "failed": len(failures),
        }
        if failures:
            shards_obj["failures"] = failures
        return {
            "count": sum(p["count"] for tag, p in outcomes if tag == "ok"),
            "_shards": shards_obj,
        }

    # ---- metadata ----

    @property
    def primary_shards(self) -> List[ShardEngine]:
        """Locally-held engines for shards whose PRIMARY is this node —
        the copies that count once in doc/stat aggregates."""
        return [
            self._local[s]
            for s in sorted(self._local)
            if self._owner(s) in (None, self.local_node)
        ]

    @property
    def num_docs(self) -> int:
        n = sum(s.num_docs for s in self.primary_shards)
        for owner in self._remote_owners():
            try:
                out = self.remote_call(
                    owner, ACTION_SHARD_STATS, {"index": self.name}
                )
                n += int(out.get("docs", 0))
            except Exception:
                pass
        return n

    # ---- snapshots (SnapshotShardsService.snapshotShard) ----

    # ---- peer recovery, target side (RecoveryTarget) ----

    def begin_peer_recovery(self, sid: int) -> Optional[str]:
        """Discards the placeholder engine + any stale on-disk state so
        phase-1 files can land in a clean shard directory. Copy-on-write
        on _local (see apply_routing)."""
        local = dict(self._local)
        eng = local.pop(sid, None)
        self._local = local
        self._executors.pop(sid, None)
        if eng is not None:
            eng.close()
        if self.base_path is None:
            return None
        shard_path = os.path.join(self.base_path, str(sid))
        if os.path.isdir(shard_path):
            import shutil

            shutil.rmtree(shard_path, ignore_errors=True)
        # the `_recovering` marker makes a crash mid-transfer detectable:
        # until finish_peer_recovery removes it, the directory contents
        # are a half-copied transfer no engine open may trust
        os.makedirs(shard_path, exist_ok=True)
        with open(os.path.join(shard_path, "_recovering"), "w",
                  encoding="utf-8") as f:
            f.write(self.local_node or "")
        return shard_path

    def finish_peer_recovery(self, sid: int) -> ShardEngine:
        """Opens the recovered shard (replaying any copied translog
        tail) and installs it."""
        shard_path = (
            os.path.join(self.base_path, str(sid))
            if self.base_path is not None
            else None
        )
        if shard_path is not None:
            # the transfer is complete: the directory now holds a copy
            # of the primary's crash-consistent commit, safe to open
            try:
                os.remove(os.path.join(shard_path, "_recovering"))
            except OSError:
                pass
        eng = ShardEngine(
            self.mappings, self.analysis, path=shard_path, shard_id=sid,
            primary_term=self._primary_term(sid),
            codec=str(self.settings.get("codec", "default")),
            **self._durability_opts(),
        )
        local = dict(self._local)
        local[sid] = eng
        self._local = local
        self._executors.pop(sid, None)
        return eng

    # ---- snapshots (SnapshotShardsService.snapshotShard) ----

    def snapshot_shard_local(self, sid: int) -> dict:
        """One shard's snapshot payload: the committed file set for
        disk-backed engines (immutable segments + manifest — exactly the
        incremental unit BlobStoreRepository ships), or a doc dump for
        in-memory engines."""
        eng = self.local_shard(sid)
        if eng.path is None:
            return {"docs": dump_engine_docs(eng)}
        with eng._lock:
            eng.flush()
            files: Dict[str, bytes] = {}
            for root, _, fnames in os.walk(eng.path):
                for fn in fnames:
                    full = os.path.join(root, fn)
                    rel = os.path.relpath(full, eng.path)
                    # flush committed everything; the WAL tail is empty
                    if rel.startswith("translog"):
                        continue
                    try:
                        with open(full, "rb") as f:
                            files[rel] = f.read()
                    except OSError:
                        pass
            return {"files": files}

    def snapshot_shards(self) -> Dict[int, dict]:
        """Collects every shard's payload, pulling remote shards from
        their primary over the transport."""
        import base64

        out: Dict[int, dict] = {}
        for sid in range(self.num_shards):
            owner = self._owner(sid)
            if owner is None or owner == self.local_node:
                out[sid] = self.snapshot_shard_local(sid)
            else:
                r = self.remote_call(
                    owner, ACTION_SNAPSHOT_SHARD,
                    {"index": self.name, "shard": sid},
                )
                if "files_b64" in r:
                    out[sid] = {
                        "files": {
                            k: base64.b64decode(v)
                            for k, v in r["files_b64"].items()
                        }
                    }
                else:
                    out[sid] = {"docs": r["docs"]}
        return out

    def local_stats(self) -> dict:
        """Stats over the PRIMARY shards held on THIS node (wire-shaped;
        replicas are excluded so cross-node aggregation counts each
        document once)."""
        store_bytes = 0
        if self.base_path and os.path.isdir(self.base_path):
            for root, _, files in os.walk(self.base_path):
                for f in files:
                    try:
                        store_bytes += os.path.getsize(os.path.join(root, f))
                    except OSError:
                        pass
        shards = self.primary_shards
        if shards:
            ops = {
                k: sum(s.op_stats[k] for s in shards) for k in shards[0].op_stats
            }
        else:
            ops = {
                "index_total": 0,
                "index_time_in_nanos": 0,
                "delete_total": 0,
                "refresh_total": 0,
                "flush_total": 0,
                "merge_total": 0,
            }
        deleted = sum(
            int((~l).sum()) if l is not None else 0
            for s in shards
            for l in s.live_docs
        )
        return {
            "docs": sum(s.num_docs for s in shards),
            "deleted": deleted,
            "store_bytes": store_bytes,
            "index_total": ops["index_total"],
            "index_time_in_nanos": ops["index_time_in_nanos"],
            "delete_total": ops["delete_total"],
            "refresh_total": ops["refresh_total"],
            "flush_total": ops["flush_total"],
            "merge_total": ops["merge_total"],
            "segments": sum(len(s.segments) for s in shards),
        }

    def stats(self) -> dict:
        agg = self.local_stats()
        for owner in self._remote_owners():
            try:
                out = self.remote_call(
                    owner, ACTION_SHARD_STATS, {"index": self.name}
                )
            except Exception:
                continue
            for k in agg:
                agg[k] += out.get(k, 0)
        body = {
            "docs": {"count": agg["docs"], "deleted": agg["deleted"]},
            "store": {"size_in_bytes": agg["store_bytes"]},
            "indexing": {
                "index_total": agg["index_total"],
                "index_time_in_millis": agg["index_time_in_nanos"] // 1_000_000,
                "delete_total": agg["delete_total"],
            },
            "search": {
                **self.search_stats,
                "slowlog": self._slowlog.stats(),
            },
            "refresh": {"total": agg["refresh_total"]},
            "flush": {"total": agg["flush_total"]},
            "merges": {"total": agg["merge_total"]},
            "segments": {"count": agg["segments"]},
        }
        from ..search.query_cache import filter_cache, request_cache

        body["query_cache"] = filter_cache.stats_for_index(self.uuid)
        body["request_cache"] = request_cache.stats_for_index(self.uuid)
        return {"uuid": self.uuid, "primaries": body, "total": body}

    def metadata(self) -> dict:
        index_settings = {
            **{k: str(v) for k, v in self.settings.items()},
            "uuid": self.uuid,
            "creation_date": str(self.creation_date),
            "provided_name": self.name,
        }
        if self.analysis_config:
            index_settings["analysis"] = self.analysis_config
        return {
            "settings": {"index": index_settings},
            "mappings": self.mappings.to_json(),
        }


def _rank_to_retriever(body: dict) -> dict:
    """Rewrites a top-level {query, knn, rank: {rrf}} hybrid search to
    the equivalent rrf retriever tree so both APIs share one execution
    path (the reference's RRFRankBuilder does the same collapse)."""
    rrf = dict(body["rank"].get("rrf") or {})
    knn_body = body["knn"]
    knn_list = knn_body if isinstance(knn_body, list) else [knn_body]
    rrf["retrievers"] = [{"standard": {"query": body["query"]}}] + [
        {"knn": kb} for kb in knn_list
    ]
    out = {k: v for k, v in body.items() if k not in ("rank", "knn", "query")}
    out["retriever"] = {"rrf": rrf}
    return out


def _validate_sparse_fields(node, mappings: Mappings) -> None:
    """Coordinator-side 400 for a `sparse_vector` clause aimed at a
    field that is not mapped `sparse_vector` (SparseVectorQueryBuilder
    rewrites to MatchNone in the reference; here a typo'd field name is
    a request bug, so fail loudly before any shard work). Walks the RAW
    JSON body — query trees, retriever legs and rescore windows alike —
    so every entry point shares one check."""
    if isinstance(node, dict):
        sv = node.get("sparse_vector")
        if isinstance(sv, dict) and "field" in sv:
            fname = str(sv["field"])
            mf = mappings.get(fname)
            from ..index.mapping import SPARSE_VECTOR

            if mf is None or mf.type != SPARSE_VECTOR:
                raise dsl.QueryParseError(
                    f"[sparse_vector] field [{fname}] is not mapped as "
                    "[sparse_vector]"
                )
        for v in node.values():
            _validate_sparse_fields(v, mappings)
    elif isinstance(node, list):
        for v in node:
            _validate_sparse_fields(v, mappings)


def _nested_with_inner_hits(q) -> list:
    """Nested query nodes carrying inner_hits, anywhere in the tree."""
    out = []
    if isinstance(q, dsl.NestedQuery):
        if q.inner_hits is not None:
            out.append(q)
        return out
    if isinstance(q, dsl.BoolQuery):
        for c in (
            list(q.must) + list(q.should) + list(q.filter) + list(q.must_not)
        ):
            out.extend(_nested_with_inner_hits(c))
    elif isinstance(q, dsl.ConstantScoreQuery):
        out.extend(_nested_with_inner_hits(q.filter_query))
    elif isinstance(q, (dsl.FunctionScoreQuery, dsl.ScriptScoreQuery)):
        out.extend(_nested_with_inner_hits(q.query))
    elif isinstance(q, dsl.DisMaxQuery):
        for c in q.queries:
            out.extend(_nested_with_inner_hits(c))
    return out


def _reduce_suggest(suggest_body: dict, shard_parts: List[dict]) -> dict:
    """Coordinator suggest reduce (TermSuggester reduce): sum candidate
    and own doc freqs across shards, honor suggest_mode, score by
    normalized edit similarity (desc), then freq (desc)."""
    out: Dict[str, list] = {}
    for name, spec in (suggest_body or {}).items():
        if not isinstance(spec, dict) or "term" not in spec:
            continue
        term_spec = spec["term"] or {}
        size = int(term_spec.get("size", 5))
        mode = str(term_spec.get("suggest_mode", "missing"))
        parts = [p.get(name, []) for p in shard_parts]
        if not parts or not parts[0]:
            out[name] = []
            continue
        entries = []
        for ti, skeleton in enumerate(parts[0]):
            own_df = 0
            freqs: Dict[str, int] = {}
            for p in parts:
                if ti >= len(p):
                    continue
                own_df += int(p[ti].get("own_df", 0))
                for t, f in p[ti].get("options", {}).items():
                    freqs[t] = freqs.get(t, 0) + int(f)
            tok = skeleton["text"]
            options = []
            if not (mode == "missing" and own_df > 0):
                from ..search.executor import levenshtein_distance

                for t, f in freqs.items():
                    if mode == "popular" and f <= own_df:
                        continue
                    dist = levenshtein_distance(tok, t)
                    score = 1.0 - dist / max(len(tok), len(t), 1)
                    options.append({"text": t, "score": round(score, 6),
                                    "freq": f})
                options.sort(key=lambda o: (-o["score"], -o["freq"], o["text"]))
            entries.append(
                {
                    "text": tok,
                    "offset": skeleton["offset"],
                    "length": skeleton["length"],
                    "options": options[:size],
                }
            )
        out[name] = entries
    return out



def dump_engine_docs(eng: ShardEngine) -> List[dict]:
    """Live docs of one engine as seqno/version-stamped wire dicts
    (snapshot doc-mode payloads and doc-replay restores)."""
    docs: List[dict] = []
    with eng._lock:
        for doc_id, ve in eng._versions.items():
            if ve.deleted:
                continue
            doc = eng.get(doc_id)
            if doc is None:
                continue
            docs.append(
                {
                    "id": doc_id,
                    "source": doc["_source"],
                    "version": ve.version,
                    "seq_no": ve.seq_no,
                }
            )
    docs.sort(key=lambda d: d["seq_no"])
    return docs


def apply_shard_ops(eng: ShardEngine, ops: List[dict]) -> List[dict]:
    """Applies wire-shaped ops to one engine (the shard side of
    TransportShardBulkAction.performOnPrimary). Shared by the local path
    and the transport handler."""
    results = []
    for op in ops:
        try:
            if op["op"] == "index":
                r = eng.index(
                    op["id"],
                    op["source"],
                    op_type=op.get("op_type", "index"),
                    if_seq_no=op.get("if_seq_no"),
                    if_primary_term=op.get("if_primary_term"),
                )
                results.append(
                    {
                        "ok": True,
                        "_id": r.doc_id,
                        "result": r.result,
                        "_version": r.version,
                        "_seq_no": r.seq_no,
                        "_primary_term": r.primary_term,
                    }
                )
            elif op["op"] == "delete":
                r = eng.delete(
                    op["id"],
                    if_seq_no=op.get("if_seq_no"),
                    if_primary_term=op.get("if_primary_term"),
                )
                results.append(
                    {
                        "ok": True,
                        "_id": r.doc_id,
                        "result": r.result,
                        "_version": r.version,
                        "_seq_no": r.seq_no,
                        "_primary_term": r.primary_term,
                    }
                )
            else:
                results.append({"ok": False, "error": f"bad op {op['op']}"})
        except VersionConflictError as e:
            results.append(
                {
                    "ok": False,
                    "error": str(e),
                    "etype": "version_conflict_engine_exception",
                }
            )
    return results


def json_dumps_safe(obj) -> str:
    import json

    try:
        return json.dumps(obj)
    except (TypeError, ValueError):
        return str(obj)


def _extract_analysis(settings: dict) -> dict:
    node = settings.get("index", settings)
    if isinstance(node, dict):
        cfg = node.get("analysis") or settings.get("analysis")
        if isinstance(cfg, dict):
            return cfg
    return {}


def _flatten_settings(settings: dict) -> dict:
    """Accepts both {"index": {"number_of_shards": 2}} and flat
    {"index.number_of_shards": 2} / {"number_of_shards": 2} forms."""
    out: Dict[str, Any] = {}

    def walk(prefix: str, node: Any):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        else:
            key = prefix
            if key.startswith("index."):
                key = key[len("index.") :]
            out[key] = node

    walk("", settings)
    return out


def _index_uuid(name: str, creation_date: int) -> str:
    import hashlib

    h = hashlib.sha1(f"{name}:{creation_date}".encode()).hexdigest()
    return h[:22]
