"""Typed settings registry with ES scope semantics.

Reference analog: org.elasticsearch.common.settings — `Setting<T>` with
`Property.{Dynamic,NodeScope,IndexScope,Final}` registered in
`ClusterSettings` / `IndexScopedSettings`; dynamic updates dispatch to
registered consumers (`addSettingsUpdateConsumer`), final settings
reject updates, unknown settings are rejected on write (SURVEY.md §5
"Config / flag system"). The north-star selector
``index.search.backend`` is exactly an index-scoped static setting here.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

NODE_SCOPE = "node"
CLUSTER_SCOPE = "cluster"
INDEX_SCOPE = "index"

# ---- env-backed node-scope serving knobs (read at process start like
# ES's jvm.options / system properties; not dynamically updatable) ----

# Batches a dispatcher worker keeps in flight on device before blocking
# on a collect: 1 reproduces the pre-pipeline dispatch→collect loop
# bit-for-bit, 2 double-buffers (batch N+1's kernels launch while batch
# N's hits are built on the host).
PIPELINE_DEPTH_ENV = "ES_TPU_PIPELINE_DEPTH"
PIPELINE_DEPTH_DEFAULT = 2

# Peak accelerator FLOP/s used as the MFU/roofline denominator. The
# default is the dense bf16 tensor-core peak of one NVIDIA H100 SXM
# (989e12, NVIDIA's data sheet, at the card's full 700 W) — a
# conservative (large) denominator for the fp32 scoring, so reported MFU
# understates rather than flatters. Override per part.
PEAK_FLOPS_ENV = "ES_TPU_PEAK_FLOPS"
PEAK_FLOPS_DEFAULT = 989e12

# ---- continuous-batching launch-shape ladder (search/batcher.py) ----
#
# ES_TPU_BATCH_BUCKETS:  comma/space-separated query-row bucket sizes the
#                        serving kernels compile at (default derived from
#                        the BPAD cap: "1,4,8,16,…,BPAD"). Dispatch pads a
#                        group to the SMALLEST bucket >= its occupancy, so
#                        a batch of 3 jobs pays a 4-wide launch instead of
#                        the full fixed width. "32" reproduces the
#                        pre-ladder fixed-shape behavior (the latency-
#                        smoke baseline). Values outside [1, BPAD] are
#                        dropped; an empty/invalid list falls back to the
#                        default ladder.
# ES_TPU_BUCKET_WARMUP:  "1" (default) | "0" — eagerly compile every
#                        ladder bucket of a kernel family the first time
#                        that family dispatches, so bucket selection never
#                        compiles on the steady-state hot path. Tier-1
#                        pins it off (tests/conftest.py) to keep suite
#                        compile time down; tests re-arm it per batcher.

BATCH_BUCKETS_ENV = "ES_TPU_BATCH_BUCKETS"
BATCH_WARMUP_ENV = "ES_TPU_BUCKET_WARMUP"

_BUCKETS_MEMO: Dict[Any, tuple] = {}


def _default_batch_buckets(bpad: int) -> tuple:
    out = [1]
    b = 4
    while b < bpad:
        out.append(b)
        b *= 2
    if bpad not in out:
        out.append(bpad)
    return tuple(out)


def batch_buckets(bpad: int = 32) -> tuple:
    """Ascending launch-shape ladder for the query-row dimension."""
    raw = os.environ.get(BATCH_BUCKETS_ENV, "").strip()
    key = (raw, int(bpad))
    memo = _BUCKETS_MEMO.get(key)
    if memo is not None:
        return memo
    vals: tuple = ()
    if raw:
        try:
            parsed = sorted({int(x) for x in raw.replace(",", " ").split()})
            vals = tuple(v for v in parsed if 1 <= v <= bpad)
        except ValueError:
            vals = ()
    if not vals:
        vals = _default_batch_buckets(bpad)
    _BUCKETS_MEMO[key] = vals
    return vals


def bucket_for(n: int, buckets, multiple_of: int = 1) -> int:
    """Smallest ladder bucket >= n (and divisible by `multiple_of`, the
    mesh ``data``-axis constraint). Falls back to rounding n up to the
    multiple when no ladder entry qualifies."""
    m = max(1, int(multiple_of))
    for b in buckets:
        if b >= n and b % m == 0:
            return b
    return m * (-(-max(int(n), 1) // m))


def bucket_warmup() -> bool:
    """Whether first-dispatch eager bucket warmup is enabled."""
    raw = os.environ.get(BATCH_WARMUP_ENV, "").strip().lower()
    return raw not in ("0", "off", "false")


def pipeline_depth() -> int:
    """Dispatcher in-flight ring depth (>= 1)."""
    raw = os.environ.get(PIPELINE_DEPTH_ENV, "")
    try:
        v = int(raw) if raw else PIPELINE_DEPTH_DEFAULT
    except ValueError:
        v = PIPELINE_DEPTH_DEFAULT
    return max(1, v)


# ---- mesh-parallel serving knobs (parallel/mesh_executor.py) ----
#
# ES_TPU_MESH:          "auto" (default: engage when >= 2 devices and the
#                       index has >= 2 shards), "force" (route every
#                       eligible group to the mesh, even on 1 device —
#                       bench sweeps use this), or "off".
# ES_TPU_MESH_DEVICES:  cap on how many devices the serving mesh uses
#                       (default: all visible devices).
# ES_TPU_MESH_DATA:     size of the ``data`` (query-batch) mesh axis
#                       (default 1 — all devices go to the shards axis).
#                       Must divide the BPAD query batch; invalid values
#                       fall back to 1.
# ES_TPU_MESH_T_MAX:    per-(entry, query) tile-slot cap for one mesh
#                       text launch; groups that overflow fall back to
#                       the single-device path (default 4096).

MESH_MODE_ENV = "ES_TPU_MESH"
MESH_DEVICES_ENV = "ES_TPU_MESH_DEVICES"
MESH_DATA_ENV = "ES_TPU_MESH_DATA"
MESH_T_MAX_ENV = "ES_TPU_MESH_T_MAX"
MESH_T_MAX_DEFAULT = 4096


def mesh_mode() -> str:
    """Serving-mesh routing mode: "auto" | "force" | "off"."""
    v = os.environ.get(MESH_MODE_ENV, "auto").strip().lower()
    return v if v in ("auto", "force", "off") else "auto"


def mesh_devices_cap() -> int:
    """Max devices the serving mesh may use (0 = all)."""
    raw = os.environ.get(MESH_DEVICES_ENV, "")
    try:
        v = int(raw) if raw else 0
    except ValueError:
        v = 0
    return max(0, v)


def mesh_data_axis() -> int:
    """Requested size of the mesh ``data`` axis (>= 1)."""
    raw = os.environ.get(MESH_DATA_ENV, "")
    try:
        v = int(raw) if raw else 1
    except ValueError:
        v = 1
    return max(1, v)


def mesh_t_max() -> int:
    """Tile-slot cap per (entry, query) for one mesh text launch."""
    raw = os.environ.get(MESH_T_MAX_ENV, "")
    try:
        v = int(raw) if raw else MESH_T_MAX_DEFAULT
    except ValueError:
        v = MESH_T_MAX_DEFAULT
    return max(64, v)


# ---- device-aggregations knobs (search/aggs_device.py) ----
#
# ES_TPU_DEVICE_AGGS:  "auto" (default) — size:0/agg bodies whose whole
#                      agg tree is device-supported AND float-exact-safe
#                      (integer-valued columns within the float32 exact
#                      window; see search/aggs_device.py) run as
#                      segment-sum kernels on device, everything else on
#                      the host AggCollector; "force" — unsupported
#                      trees RAISE instead of silently host-routing (the
#                      bench/CI routing assertion mode; runtime faults
#                      still fall back to the host); "off" — every agg
#                      body uses the host collector.

DEVICE_AGGS_ENV = "ES_TPU_DEVICE_AGGS"


def device_aggs_mode() -> str:
    """Device-aggregations routing mode: "auto" | "force" | "off"."""
    v = os.environ.get(DEVICE_AGGS_ENV, "auto").strip().lower()
    return v if v in ("auto", "force", "off") else "auto"


# ---- second-stage reranking knobs (search/rescorer.py) ----
#
# ES_TPU_RERANK:  "auto" (default) — `rescore` bodies on the jax backend
#                 run the late-interaction maxsim kernel on device over
#                 the fused top-k (ops/rerank.py); any rerank-path
#                 failure degrades to the FIRST-STAGE ranking (never a
#                 failed request), and an HBM budget breach skips the
#                 rerank column build (degrade-to-skip). "force" — a
#                 silently-skipped device rerank (missing column,
#                 budget degrade) RAISES instead (the bench/CI routing
#                 assertion mode; runtime faults still fall back to the
#                 first-stage order). "off" — rescore sections are
#                 accepted but not executed (the ?rescore=false escape
#                 hatch applied node-wide).

RERANK_ENV = "ES_TPU_RERANK"


def rerank_mode() -> str:
    """Second-stage rerank routing mode: "auto" | "force" | "off"."""
    v = os.environ.get(RERANK_ENV, "auto").strip().lower()
    return v if v in ("auto", "force", "off") else "auto"


# ---- streaming-ingest knobs (index/segment_build.py, cluster/indices.py) ----
#
# ES_TPU_DEVICE_BUILD:  "auto" (default) and "off" — the host
#                       SegmentBuilder (the port has no device build
#                       yet); "force" asks for the device build
#                       (ops/index_build.py in the reference), which
#                       raises in the port, naming the slice that
#                       brings it (index/segment_build.py).
# ES_TPU_BG_REFRESH:    "auto" (default) — every IndexService runs a
#                       background refresher thread driven by the
#                       dynamic `index.refresh_interval` setting
#                       (double-buffered: the next generation's columns
#                       build while the current one serves; the swap is
#                       one atomic generation bump). "off" — no
#                       background thread; refresh only on explicit
#                       calls (tier-1 pins this for determinism).

DEVICE_BUILD_ENV = "ES_TPU_DEVICE_BUILD"
BG_REFRESH_ENV = "ES_TPU_BG_REFRESH"


def device_build_mode() -> str:
    """Device segment-build routing mode: "auto" | "force" | "off"."""
    v = os.environ.get(DEVICE_BUILD_ENV, "auto").strip().lower()
    return v if v in ("auto", "force", "off") else "auto"


def bg_refresh_enabled() -> bool:
    """Whether IndexService starts the background refresher thread."""
    v = os.environ.get(BG_REFRESH_ENV, "auto").strip().lower()
    return v not in ("off", "0", "false")


# ---- admission-control knobs (search/admission.py) ----
#
# ES_TPU_ADMISSION:            "on" (default) | "off" — the per-node
#                              admission layer (weighted fair queueing,
#                              AIMD concurrency limit, deadline shed,
#                              brownout tiers, retry budget) in front
#                              of the batcher. Tests pin it off and
#                              arm it explicitly.
# ES_TPU_ADMISSION_TARGET_MS:  AIMD queue-delay target (default 75):
#                              the batcher enqueue→dispatch wait the
#                              limit steers toward.
# ES_TPU_ADMISSION_MAX_QUEUE:  admission queue bound (default 1024);
#                              overflow sheds with 429 + Retry-After.
#
# The same knobs are dynamically updatable as cluster settings
# (search.admission.*, registered below; ClusterService wires the
# update consumers to admission.configure()).


def peak_flops() -> float:
    """Accelerator peak FLOP/s for MFU accounting."""
    raw = os.environ.get(PEAK_FLOPS_ENV, "")
    try:
        v = float(raw) if raw else PEAK_FLOPS_DEFAULT
    except ValueError:
        v = PEAK_FLOPS_DEFAULT
    return v if v > 0 else PEAK_FLOPS_DEFAULT


class SettingsError(ValueError):
    pass


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    if s in ("true", "1"):
        return True
    if s in ("false", "0"):
        return False
    raise SettingsError(f"cannot parse boolean [{v}]")


def _parse_time(v) -> str:
    """TimeValue strings kept as-is but validated (e.g. '1s', '500ms')."""
    s = str(v)
    if s in ("-1", "0"):
        # -1 = disabled; bare 0 = zero time (the slowlog "always fire"
        # threshold, matching the reference's TimeValue.ZERO)
        return s
    for suffix in ("nanos", "micros", "ms", "s", "m", "h", "d"):
        if s.endswith(suffix):
            try:
                float(s[: -len(suffix)])
                return s
            except ValueError:
                break
    raise SettingsError(f"failed to parse setting value [{v}] as a time value")


@dataclass
class Setting:
    key: str
    default: Any
    scope: str = CLUSTER_SCOPE
    dynamic: bool = True
    final: bool = False
    parser: Callable[[Any], Any] = str
    validator: Optional[Callable[[Any], None]] = None

    def parse(self, value: Any) -> Any:
        try:
            v = self.parser(value)
        except SettingsError:
            raise
        except (TypeError, ValueError) as e:
            raise SettingsError(
                f"failed to parse value [{value}] for setting [{self.key}]: {e}"
            )
        if self.validator is not None:
            self.validator(v)
        return v


def _positive(name):
    def check(v):
        if v < 1:
            raise SettingsError(f"[{name}] must be >= 1")

    return check


def _non_negative(name):
    def check(v):
        if v < 0:
            raise SettingsError(f"[{name}] must be >= 0")

    return check


def _positive_f(name):
    def check(v):
        if not (v > 0):
            raise SettingsError(f"[{name}] must be > 0")

    return check


def _one_of(name, allowed):
    def check(v):
        if v not in allowed:
            raise SettingsError(
                f"[{name}] must be one of {'|'.join(allowed)}, got [{v}]"
            )

    return check


# ---- index-scoped registry (IndexScopedSettings.BUILT_IN_INDEX_SETTINGS) ----

INDEX_SETTINGS: Dict[str, Setting] = {
    s.key: s
    for s in [
        Setting("number_of_shards", 1, INDEX_SCOPE, dynamic=False, final=True,
                parser=int, validator=_positive("number_of_shards")),
        Setting("number_of_replicas", 1, INDEX_SCOPE, parser=int,
                validator=_non_negative("number_of_replicas")),
        Setting("refresh_interval", "1s", INDEX_SCOPE, parser=_parse_time),
        # torch is the default: the REST serving path runs on the card
        # (TorchExecutor); "numpy" selects the CPU oracle. Any other
        # value is refused, so no index silently serves from the oracle
        Setting("search.backend", "torch", INDEX_SCOPE, dynamic=False,
                validator=_one_of("search.backend", ("torch", "numpy"))),
        Setting("max_result_window", 10000, INDEX_SCOPE, parser=int,
                validator=_positive("max_result_window")),
        # write durability (index/translog.py): "request" fsyncs the WAL
        # before every ack; "async" bounds the acked-but-volatile window
        # to translog.sync_interval (the crash matrix in
        # tests/test_durability.py proves both contracts)
        Setting("translog.durability", "request", INDEX_SCOPE,
                validator=_one_of("translog.durability",
                                  ("request", "async"))),
        Setting("translog.sync_interval", "5s", INDEX_SCOPE,
                parser=_parse_time),
        Setting("merge.policy.max_segments", 8, INDEX_SCOPE, parser=int,
                validator=_positive("merge.policy.max_segments")),
        Setting("knn.quantization", "none", INDEX_SCOPE),
        # IVF ANN tier (ops/ivf.py, search/ann.py): "exact" keeps every
        # knn request on the brute-force oracle; "ivf" clusters each
        # segment's vectors at executor build and probes top-nprobe
        # clusters at query time (per-request `nprobe` override and the
        # ?exact=true escape hatch always available)
        Setting("knn.type", "exact", INDEX_SCOPE,
                validator=_one_of("knn.type", ("exact", "ivf"))),
        # cluster count per segment (0 = auto ~sqrt(N))
        Setting("knn.nlist", 0, INDEX_SCOPE, parser=int,
                validator=_non_negative("knn.nlist")),
        # default probe width (per-request knn.nprobe overrides)
        Setting("knn.nprobe", 8, INDEX_SCOPE, parser=int,
                validator=_positive("knn.nprobe")),
        # learned-sparse impact storage (ops/impact.py, search/sparse.py):
        # int8 — the default — serves from the 4x-smaller per-term
        # symmetric column; "none" keeps the fp32 plane (always present
        # as the exact oracle; a body-level `"exact": true` routes one
        # request to it regardless)
        Setting("sparse.quantization", "int8", INDEX_SCOPE,
                validator=_one_of("sparse.quantization",
                                  ("none", "int8"))),
        # second-stage reranker token storage (search/rescorer.py):
        # int8 mirrors the kNN quantization path — per-token symmetric
        # scales, 4x less HBM per maxsim gather
        Setting("rerank.quantization", "none", INDEX_SCOPE,
                validator=_one_of("rerank.quantization",
                                  ("none", "int8"))),
        # shard request cache default for size:0/agg-only requests
        # (IndicesRequestCache's index.requests.cache.enable); the
        # per-request ?request_cache= param overrides it either way
        Setting("requests.cache.enable", True, INDEX_SCOPE,
                parser=_parse_bool),
        # per-index fair-share weight for the admission layer's stride
        # scheduler: under contention an index drains admission-queue
        # slots proportionally to its weight (default equal shares)
        Setting("search.admission.weight", 1.0, INDEX_SCOPE, parser=float,
                validator=_positive_f("search.admission.weight")),
        Setting("hidden", False, INDEX_SCOPE, parser=_parse_bool),
        Setting("codec", "default", INDEX_SCOPE, dynamic=False),
        Setting("default_pipeline", None, INDEX_SCOPE),
        Setting("final_pipeline", None, INDEX_SCOPE),
        # per-index search slow logs (common/slowlog.py): dynamic
        # per-level thresholds for the query and fetch phases; "-1"
        # disables a level, "0" fires it on every request
        *[
            Setting(
                f"search.slowlog.threshold.{phase}.{lvl}", "-1",
                INDEX_SCOPE, parser=_parse_time,
            )
            for phase in ("query", "fetch")
            for lvl in ("warn", "info", "debug", "trace")
        ],
    ]
}

# ---- cluster-scoped registry ----

CLUSTER_SETTINGS: Dict[str, Setting] = {
    s.key: s
    for s in [
        # allocation/rebalance master switch (EnableAllocationDecider):
        # "all" (default) allows every copy to allocate/relocate,
        # "primaries" restricts to primary copies, "none" freezes both
        # replica allocation and rebalancing (explicit reroute `move`
        # commands are operator intent and bypass only this decider)
        Setting("cluster.routing.allocation.enable", "all",
                validator=_one_of("cluster.routing.allocation.enable",
                                  ("all", "primaries", "none"))),
        # comma-separated node names to drain (FilterAllocationDecider's
        # cluster.routing.allocation.exclude._name): no copy may
        # allocate or rebalance onto an excluded node, and the
        # background rebalancer actively moves copies off of it
        Setting("cluster.routing.allocation.exclude._name", ""),
        # concurrent relocations the rebalancer may keep in flight
        # (ConcurrentRebalanceAllocationDecider)
        Setting("cluster.routing.allocation.cluster_concurrent_rebalance",
                2, parser=int,
                validator=_positive(
                    "cluster.routing.allocation.cluster_concurrent_rebalance")),
        # HBM/disk watermark (DiskThresholdDecider analog reading the
        # per-node circuit-breaker ledger): a node whose tracked-bytes
        # utilisation exceeds this fraction of its breaker budget
        # refuses new shard copies
        Setting("cluster.routing.allocation.watermark.high", 0.9,
                parser=float,
                validator=_positive_f(
                    "cluster.routing.allocation.watermark.high")),
        Setting("action.auto_create_index", True, parser=_parse_bool),
        Setting("search.default_search_timeout", "-1", parser=_parse_time),
        # request default for allow_partial_search_results: false turns
        # ANY shard failure/timeout into a 503 search_phase_execution_
        # exception instead of a partial 200 (TransportSearchAction's
        # SEARCH_DEFAULT_ALLOW_PARTIAL_RESULTS analog)
        Setting("search.default_allow_partial_results", True,
                parser=_parse_bool),
        Setting("search.max_buckets", 65536, parser=int,
                validator=_positive("search.max_buckets")),
        # overload-protection layer (search/admission.py): dynamically
        # updatable; ClusterService wires update consumers through to
        # admission.configure()
        Setting("search.admission.enabled", True, parser=_parse_bool),
        Setting("search.admission.target_delay_ms", 75, parser=int,
                validator=_positive("search.admission.target_delay_ms")),
        Setting("search.admission.max_queue", 1024, parser=int,
                validator=_positive("search.admission.max_queue")),
        Setting("search.admission.retry_budget.ratio", 0.1, parser=float,
                validator=_non_negative(
                    "search.admission.retry_budget.ratio")),
        Setting("indices.recovery.max_bytes_per_sec", "40mb"),
    ]
}


def validate_index_settings(flat: Dict[str, Any], creating: bool) -> Dict[str, Any]:
    """Validates + parses a flat settings dict against the index registry.

    Unknown settings are rejected (like IndexScopedSettings.validate);
    on update (creating=False) final/static settings are rejected too.
    """
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        setting = INDEX_SETTINGS.get(key)
        if setting is None:
            raise SettingsError(
                f"unknown setting [index.{key}] please check that any required "
                "plugins are installed, or check the breaking changes "
                "documentation for removed settings"
            )
        if not creating and (setting.final or not setting.dynamic):
            raise SettingsError(
                f"final {INDEX_SCOPE} setting [index.{key}], not updateable"
            )
        out[key] = setting.parse(value)
    return out


class ClusterSettingsStore:
    """Mutable cluster-wide settings: persistent + transient layers with
    update-consumer dispatch (ClusterSettings.applySettings)."""

    def __init__(self):
        self.persistent: Dict[str, Any] = {}
        self.transient: Dict[str, Any] = {}
        self._consumers: Dict[str, List[Callable[[Any], None]]] = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> Any:
        if key in self.transient:
            return self.transient[key]
        if key in self.persistent:
            return self.persistent[key]
        s = CLUSTER_SETTINGS.get(key)
        return s.default if s else None

    def add_consumer(self, key: str, fn: Callable[[Any], None]) -> None:
        self._consumers.setdefault(key, []).append(fn)

    def update(self, body: dict) -> dict:
        with self._lock:
            changed: Dict[str, Any] = {}
            for layer_name in ("persistent", "transient"):
                layer_body = body.get(layer_name) or {}
                layer = getattr(self, layer_name)
                for key, value in _flatten(layer_body).items():
                    setting = CLUSTER_SETTINGS.get(key)
                    if setting is None:
                        raise SettingsError(
                            f"transient setting [{key}], not recognized"
                            if layer_name == "transient"
                            else f"persistent setting [{key}], not recognized"
                        )
                    if value is None:
                        layer.pop(key, None)
                        changed[key] = self.get(key)
                    else:
                        parsed = setting.parse(value)
                        layer[key] = parsed
                        changed[key] = parsed
            for key, value in changed.items():
                for fn in self._consumers.get(key, []):
                    fn(value)
            return {
                "acknowledged": True,
                "persistent": _unflatten(self.persistent),
                "transient": _unflatten(self.transient),
            }

    def to_json(self) -> dict:
        return {
            "persistent": _unflatten(self.persistent),
            "transient": _unflatten(self.transient),
        }

    def load_layers(self, persistent: dict, transient: dict) -> None:
        """Replaces both layers wholesale (cluster-state application on a
        follower: the master published the authoritative settings).  Fires
        consumers only for keys whose effective value actually changed."""
        with self._lock:
            keys = (set(self.persistent) | set(self.transient)
                    | set(persistent) | set(transient))
            before = {k: self.get(k) for k in keys}
            self.persistent = dict(persistent)
            self.transient = dict(transient)
            fired = []
            for k in keys:
                after = self.get(k)
                if after != before[k]:
                    fired.append((k, after))
            for key, value in fired:
                for fn in self._consumers.get(key, []):
                    fn(value)


def _flatten(node: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(node, dict):
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                out.update(_flatten(v, key))
            else:
                out[key] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out
