"""Device-resident aggregations engine — the compiler from a parsed
``AggNode`` tree to a plan of segment-sum passes (ops/agg_kernels.py).

PyTorch port of `elasticsearch_tpu/search/aggs_device.py`: the same
compiler, specs, layouts and partials, on the TorchExecutor's device.
Columns go up through ops/scoring.upload (pinned, asynchronous); the
permutation tables are built on the host (the reference may build them
with its device segment-build kernels, which the port does not have
yet).

The host ``AggCollector`` (search/aggs.py) walks doc values with numpy
per shard and is the float ORACLE: every partial this module emits is
wire-identical to the host collector's, so the coordinator reduce
(``reduce_aggs``) needs no changes and a device-collected shard can
reduce together with a host-collected one. The request cache, brownout
tiers, and multi-index reduce therefore all work unchanged on top.

Routing contract ("never a silent wrong answer"):

  * ``try_compile`` returns a plan ONLY when every node in the tree is
    device-supported AND the touched columns satisfy the exactness
    profile below; anything else returns None and the whole tree runs
    on the host collector (``ES_TPU_DEVICE_AGGS=force`` raises instead,
    so CI can assert routing).
  * bucket/doc counts are int32 cumsums — exact by construction.
  * metric sums ride int32 cumsums over a host-prepared int32
    copy of the column, only for integer-valued columns whose Σ|v|
    stays inside the int32 window per segment: every partial sum is
    then exact in any association order, so the device result equals
    the oracle's float64 sum bit-for-bit.
  * min/max/percentiles require f32-exact columns (every value survives
    a float64→float32→float64 round trip), making them exact too.
  * histogram / date_histogram / range bucket boundaries are computed
    with EXACT integer arithmetic on a per-(segment, field) int32
    offset column (value − column_min), so floor-division and range
    membership can never disagree with the oracle's float64 math.
    (Float32 doc-value columns would mis-bucket date millis — float32
    resolution at 1.7e12 is ~2 minutes.)

Supported tree: metric leaves sum/avg/min/max/value_count/stats (+
percentiles via device sorted-quantile at the ROOT level), buckets
terms (keyword via the multi-value ordinal CSR, numeric via per-column
value ordinals), histogram, date_histogram (fixed intervals),
range/date_range, filter/filters (riding the filter-bitset cache),
with ONE level of nesting: any supported bucket node over metric-leaf
subs (bucket-id × metric segment_sum). Deeper nesting, calendar
intervals, keyword metrics, and every other agg type route to the host.

Device memory: the per-(segment, field) integer offset and value-ordinal
columns this engine uploads are charged to the ``aggs`` ledger category
via the owning executor (released on executor close, i.e. on every
engine change-generation bump); budget pressure routes the tree to the
host path at compile time instead of tripping the breaker.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.faults import faults
from ..index.mapping import BOOLEAN, DATE, KEYWORD, TEXT, parse_date_millis
from ..ops import agg_kernels, scoring
from . import dsl
from .aggs import (
    AggNode,
    AggParseError,
    PIPELINE_TYPES,
    _bkey,
    _int_param,
    _norm_order,
    _order_buckets,
    _parse_dh_interval,
    _range_key_part,
    _req,
)
from .executor import Hit, TopDocs

# hard cap on device bucket cardinality per node per segment (mirrors
# search.max_buckets); larger cardinalities route to the host
MAX_DEVICE_BUCKETS = 65536
# int32 sum window: Σ|v| below this keeps every partial sum exact
# (sums accumulate as int32 scatter-adds over an int32 value column)
I32_SUM_BOUND = float(2**31 - 2**16)
# float32 exact-integer window (the mesh's float32 psum max path)
F32_SUM_BOUND = float(2**24)
# two-word integer column split: value − min = hi·2**24 + lo, both
# words int32 — exact for any span below 2**53 (all date millis)
WIDE_SHIFT = 24

_INT_KEY_TYPES = ("integer", "long", "short", "byte", DATE)


def _host(x) -> np.ndarray:
    """A device result as a host array (the download)."""
    return scoring.download(x, site="agg")[0]


class DeviceAggUnsupported(Exception):
    """This tree (or its columns) cannot run exactly on device; the
    caller routes the WHOLE body to the host collector."""

    def __init__(self, reason: str, budget: bool = False):
        super().__init__(reason)
        self.reason = reason
        self.budget = budget


# ---------------------------------------------------------------------------
# node-level stats (the `_nodes/stats` aggs block)
# ---------------------------------------------------------------------------

_STATS_LOCK = threading.Lock()
AGG_STATS = {
    "device_routed": 0,  # shard agg collections served by this engine
    "host_routed": 0,  # shard agg collections on the host AggCollector
    "fallbacks": 0,  # injected fault / breaker mid-flight → host rerun
    "mesh_routed": 0,  # whole-index agg launches (parallel/mesh_executor.py)
    "kernel_ms": 0.0,  # device dispatch+download wall time
}


def note_device_routed() -> None:
    with _STATS_LOCK:
        AGG_STATS["device_routed"] += 1


def note_host_routed() -> None:
    with _STATS_LOCK:
        AGG_STATS["host_routed"] += 1


def note_fallback() -> None:
    with _STATS_LOCK:
        AGG_STATS["fallbacks"] += 1


def note_mesh_routed() -> None:
    with _STATS_LOCK:
        AGG_STATS["mesh_routed"] += 1


def note_kernel_ms(ms: float) -> None:
    with _STATS_LOCK:
        AGG_STATS["kernel_ms"] += ms


def stats_snapshot() -> dict:
    from ..common.memory import hbm_ledger

    with _STATS_LOCK:
        out = dict(AGG_STATS)
    out["kernel_ms"] = round(out["kernel_ms"], 3)
    out["ledger_bytes"] = hbm_ledger.stats()["by_category"].get("aggs", 0)
    return out


def reset_stats() -> None:
    """Test hook: zero the routing counters."""
    with _STATS_LOCK:
        for k in AGG_STATS:
            AGG_STATS[k] = 0.0 if k == "kernel_ms" else 0


# ---------------------------------------------------------------------------
# per-(segment, field) column exactness profiles + device agg columns
# ---------------------------------------------------------------------------


@dataclass
class ColProfile:
    """Host-side facts about one numeric doc-value column that decide
    what may run on device exactly (computed once per executor
    generation — the column is immutable for the executor's life)."""

    present: bool
    n_exist: int = 0
    integer_valued: bool = False
    f32_exact: bool = False
    abs_sum: float = 0.0
    vmin: float = 0.0
    vmax: float = 0.0

    @property
    def sum_exact(self) -> bool:
        return (
            not self.present
            or self.n_exist == 0
            or (self.integer_valued and self.abs_sum < I32_SUM_BOUND)
        )

    @property
    def cmp_exact(self) -> bool:
        return not self.present or self.n_exist == 0 or self.f32_exact


def col_profile(ex, si: int, field: str) -> ColProfile:
    key = (si, field)
    cached = ex._agg_profiles.get(key)
    if cached is not None:
        return cached
    with ex._build_lock:
        cached = ex._agg_profiles.get(key)
        if cached is not None:
            return cached
        nf = ex.reader.segments[si].numerics.get(field)
        if nf is None:
            prof = ColProfile(present=False)
        else:
            v = nf.values[nf.exists]
            if len(v) == 0:
                prof = ColProfile(present=True, n_exist=0)
            else:
                finite = bool(np.isfinite(v).all())
                prof = ColProfile(
                    present=True,
                    n_exist=int(len(v)),
                    integer_valued=finite
                    and bool((v == np.floor(v)).all())
                    and bool((np.abs(v) < 2**62).all()),
                    f32_exact=finite
                    and bool(
                        (v.astype(np.float32).astype(np.float64) == v).all()
                    ),
                    abs_sum=float(np.abs(v).sum()),
                    vmin=float(v.min()),
                    vmax=float(v.max()),
                )
        ex._agg_profiles[key] = prof
        return prof


def _charge_aggs(ex, nbytes: int) -> None:
    """Charges an agg column upload to the `aggs` ledger category; a
    budget breach DEGRADES compilation to the host path (never trips)."""
    from ..common.memory import hbm_ledger

    if not hbm_ledger.would_fit(nbytes):
        hbm_ledger.note_degraded()
        raise DeviceAggUnsupported(
            f"agg column of {nbytes} bytes exceeds the HBM budget",
            budget=True,
        )
    ex._charge("aggs", nbytes, False)


def wide_col(ex, si: int, field: str):
    """Two-word exact integer view of one column: (device int32 hi,
    device int32 lo, device bool exists, base, dmax) where value −
    base = hi·2**24 + lo. Exact for any date-millis span (Δ < 2**53),
    where a single int32 offset — let alone a float32 doc-value
    column — could not represent the column. None when the segment
    lacks the column. Cached per (segment, field)."""
    key = ("wide", si, field)
    if key in ex._agg_cols:
        return ex._agg_cols[key]
    with ex._build_lock:
        if key in ex._agg_cols:
            return ex._agg_cols[key]
        nf = ex.reader.segments[si].numerics.get(field)
        if nf is None:
            ex._agg_cols[key] = None
            return None
        prof = col_profile(ex, si, field)
        base = int(prof.vmin) if prof.n_exist else 0
        dmax = int(prof.vmax) - base if prof.n_exist else 0
        hi_host = np.zeros(len(nf.values), np.int32)
        lo_host = np.zeros(len(nf.values), np.int32)
        if prof.n_exist:
            delta = nf.values[nf.exists].astype(np.int64) - base
            hi_host[nf.exists] = (delta >> WIDE_SHIFT).astype(np.int32)
            lo_host[nf.exists] = (
                delta & ((1 << WIDE_SHIFT) - 1)
            ).astype(np.int32)
        _charge_aggs(ex, int(hi_host.nbytes + lo_host.nbytes))
        dn = ex.device_segments[si].numerics.get(field)
        out = (
            scoring.upload(hi_host, ex.device),
            scoring.upload(lo_host, ex.device),
            dn[1],
            base,
            dmax,
        )
        ex._agg_cols[key] = out
        return out


def int_col(ex, si: int, field: str):
    """Cached device int32 copy of an integer-valued column (0 where
    missing) — the exact sum accumulator operand. Callers gate on
    ``ColProfile.sum_exact`` so the cast and the sums can never
    overflow/round."""
    key = ("int", si, field)
    if key in ex._agg_cols:
        return ex._agg_cols[key]
    with ex._build_lock:
        if key in ex._agg_cols:
            return ex._agg_cols[key]
        nf = ex.reader.segments[si].numerics.get(field)
        if nf is None:
            ex._agg_cols[key] = None
            return None
        host = np.zeros(len(nf.values), np.int32)
        host[nf.exists] = nf.values[nf.exists].astype(np.int64).astype(
            np.int32
        )
        _charge_aggs(ex, int(host.nbytes))
        out = scoring.upload(host, ex.device)
        ex._agg_cols[key] = out
        return out


# ---- bucket SPACES (host facts: ids per slot, slot→doc map, static
# gate, cardinality) and their device LAYOUTS (the sorted-permutation
# operands the segment-sum kernels consume) ----


def _space_kw(ex, si: int, field: str):
    """Keyword terms bucket space over the multi-value ordinal CSR:
    ids = mv_ords (entry-level), slot→doc map = the CSR row expansion."""
    key = ("space_kw", si, field)
    if key in ex._agg_cols:
        return ex._agg_cols[key]
    with ex._build_lock:
        if key in ex._agg_cols:
            return ex._agg_cols[key]
        of = ex.reader.segments[si].ordinals.get(field)
        if of is None:
            ex._agg_cols[key] = None
            return None
        n = ex.reader.segments[si].num_docs
        map_host = np.repeat(
            np.arange(n, dtype=np.int64), np.diff(of.mv_offsets)
        )
        space = (
            of.mv_ords.astype(np.int64),
            map_host,
            np.ones(len(of.mv_ords), bool),
            len(of.ord_terms),
        )
        ex._agg_cols[key] = space
        return space


def _space_num(ex, si: int, field: str):
    """Numeric terms bucket space: per-column value ordinals (the
    hashed-ords analog — exact for any float column). Also caches the
    sorted unique values for key mapping at collect."""
    key = ("space_num", si, field)
    if key in ex._agg_cols:
        return ex._agg_cols[key]
    with ex._build_lock:
        if key in ex._agg_cols:
            return ex._agg_cols[key]
        nf = ex.reader.segments[si].numerics.get(field)
        if nf is None:
            ex._agg_cols[key] = None
            return None
        uniq = np.unique(nf.values[nf.exists])
        if len(uniq) > MAX_DEVICE_BUCKETS:
            raise DeviceAggUnsupported(
                f"numeric terms cardinality {len(uniq)} exceeds "
                f"{MAX_DEVICE_BUCKETS}"
            )
        ids = np.full(len(nf.values), len(uniq), np.int64)
        if len(uniq):
            ids[nf.exists] = np.searchsorted(uniq, nf.values[nf.exists])
        space = (ids, None, nf.exists, len(uniq))
        ex._agg_cols[key] = (space, uniq)
        return ex._agg_cols[key]


def _space_hist(ex, si: int, field: str, interval: int, offset: int):
    """Histogram bucket space: ids are floor((v − offset) / interval) −
    qmin computed host-side in EXACT int64 — the dashboard case (one
    interval, many queries) pays the host pass once per executor
    generation. Returns ((ids, map, gate, nb), qmin) or None."""
    key = ("space_hist", si, field, int(interval), int(offset))
    if key in ex._agg_cols:
        return ex._agg_cols[key]
    with ex._build_lock:
        if key in ex._agg_cols:
            return ex._agg_cols[key]
        nf = ex.reader.segments[si].numerics.get(field)
        if nf is None or not nf.exists.any():
            ex._agg_cols[key] = None
            return None
        # numpy int64 floor-division follows Python floor semantics, so
        # pre-1970 dates bucket exactly like the oracle's np.floor
        q = (nf.values[nf.exists].astype(np.int64) - offset) // interval
        qmin = int(q.min())
        nb = int(q.max()) - qmin + 1
        if nb > MAX_DEVICE_BUCKETS:
            raise DeviceAggUnsupported(
                f"histogram would make {nb} buckets"
            )
        ids = np.full(len(nf.values), nb, np.int64)
        ids[nf.exists] = q - qmin
        out = ((ids, None, nf.exists, nb), qmin)
        ex._agg_cols[key] = out
        return out


def counts_layout(ex, si: int, skey: tuple, space):
    """Device operands for sorted_bucket_counts: the bucket-major slot
    permutation (composed with the slot→doc map), the pre-permuted
    static gate, and the int32 bucket boundaries."""
    key = ("clay", si) + skey
    if key in ex._agg_cols:
        return ex._agg_cols[key]
    with ex._build_lock:
        if key in ex._agg_cols:
            return ex._agg_cols[key]
        ids, map_host, gate, nb = space
        from ..common.settings import device_build_mode
        from ..ops.index_build import agg_perm_tables_device

        got = None
        if device_build_mode() != "off":
            # bucket ids are small ints: the stable argsort + boundary
            # table build rides the device build ops on the index's
            # device (bit-identical by the stable-sort contract); only
            # the int32 guard's None keeps the host path
            got = agg_perm_tables_device(ids, nb, ex.device)
        if got is not None:
            perm, bounds = got
        else:
            perm = np.argsort(ids, kind="stable")
            bounds = np.searchsorted(ids[perm], np.arange(nb + 1)).astype(np.int32)
        map_p = (
            perm if map_host is None else map_host[perm]
        ).astype(np.int32)
        gate_p = gate[perm]
        _charge_aggs(
            ex, int(map_p.nbytes + gate_p.nbytes + bounds.nbytes)
        )
        out = {
            "map": scoring.upload(map_p, ex.device),
            "gate": scoring.upload(gate_p, ex.device),
            "bounds": scoring.upload(bounds, ex.device),
        }
        ex._agg_cols[key] = out
        return out


def metric_layout(ex, si: int, skey: tuple, mfield: str,
                  need_int: bool, space):
    """Device operands for sorted_bucket_metrics: slots re-sorted by
    (bucket, metric value asc) so per-bucket extrema are rank lookups,
    with the metric column pre-permuted (float32 for min/max, exact
    int32 copy for sums). None when the segment lacks the column."""
    key = ("mlay", si, mfield, bool(need_int)) + skey
    if key in ex._agg_cols:
        return ex._agg_cols[key]
    with ex._build_lock:
        if key in ex._agg_cols:
            return ex._agg_cols[key]
        nf = ex.reader.segments[si].numerics.get(mfield)
        if nf is None:
            ex._agg_cols[key] = None
            return None
        ids, map_host, gate, nb = space
        if map_host is None:
            mvals = nf.values
            mex = nf.exists
        else:
            mvals = nf.values[map_host]
            mex = nf.exists[map_host]
        perm = np.lexsort((mvals, ids))
        bounds = np.searchsorted(
            ids[perm], np.arange(nb + 1)
        ).astype(np.int32)
        gate_p = (gate & mex)[perm]
        v_p = mvals[perm].astype(np.float32)
        iv_p = np.zeros(len(perm), np.int32)
        if need_int:
            sel_vals = mvals[perm][gate_p]
            iv_p[gate_p] = sel_vals.astype(np.int64).astype(np.int32)
        map_p = (
            perm if map_host is None else map_host[perm]
        ).astype(np.int32)
        _charge_aggs(
            ex,
            int(
                map_p.nbytes + gate_p.nbytes + v_p.nbytes
                + iv_p.nbytes + bounds.nbytes
            ),
        )
        out = {
            "map": scoring.upload(map_p, ex.device),
            "gate": scoring.upload(gate_p, ex.device),
            "v": scoring.upload(v_p, ex.device),
            "iv": scoring.upload(iv_p, ex.device),
            "bounds": scoring.upload(bounds, ex.device),
        }
        ex._agg_cols[key] = out
        return out


# ---------------------------------------------------------------------------
# metric leaves
# ---------------------------------------------------------------------------

_METRIC_KINDS = (
    "sum", "avg", "min", "max", "value_count", "stats", "percentiles",
)
_NEEDS_SUM = {"sum", "avg", "stats"}
_NEEDS_CMP = {"min", "max", "stats", "percentiles"}


class _MetricSpec:
    """One supported metric leaf (standalone or a bucket sub-agg)."""

    def __init__(self, ex, node: AggNode, mappings, root: bool):
        self.name = node.name
        self.kind = node.type
        self.field = _req(node, "field")
        self.percents = node.params.get(
            "percents", [1, 5, 25, 50, 75, 95, 99]
        )
        mf = mappings.get(self.field)
        if mf is not None and mf.type in (KEYWORD, TEXT):
            raise DeviceAggUnsupported(
                f"metric [{self.kind}] over keyword/text field "
                f"[{self.field}]"
            )
        if self.kind == "percentiles" and not root:
            raise DeviceAggUnsupported(
                "percentiles under a bucket agg"
            )
        for si in range(len(ex.reader.segments)):
            p = col_profile(ex, si, self.field)
            if self.kind in _NEEDS_SUM and not p.sum_exact:
                raise DeviceAggUnsupported(
                    f"[{self.field}] sum not float32-exact "
                    "(non-integer values or |sum| >= 2^24)"
                )
            if self.kind in _NEEDS_CMP and not p.cmp_exact:
                raise DeviceAggUnsupported(
                    f"[{self.field}] values not float32-exact"
                )

    @property
    def sig(self) -> tuple:
        return ("metric", self.kind, self.field, tuple(self.percents))

    # ---- root-level (single implicit bucket) ----

    def _ivals(self, ex, si: int):
        # the int32 sum operand; kinds that never sum ride a shared
        # zeros column (their sum output is discarded)
        if self.kind in _NEEDS_SUM:
            return int_col(ex, si, self.field)
        return _ZERO_IDS(ex, si)

    def dispatch_root(self, ex, si: int, mask):
        dn = ex.device_segments[si].numerics.get(self.field)
        if dn is None:
            return None
        v, e = dn
        sel = mask & e
        if self.kind == "percentiles":
            return agg_kernels.masked_sorted(sel, v)
        return agg_kernels.masked_metric(sel, v, self._ivals(ex, si))

    def collect_root(self, pends) -> dict:
        if self.kind == "percentiles":
            vals: List[np.ndarray] = []
            for p in pends:
                if p is None:
                    continue
                sorted_v, cnt = p
                c = int(_host(cnt))
                if c:
                    vals.append(
                        _host(sorted_v)[:c].astype(np.float64)
                    )
            flat = np.concatenate(vals) if vals else np.zeros(0)
            return {
                "t": "percentiles",
                "values": flat.tolist(),
                "percents": self.percents,
            }
        count = 0
        total = 0.0
        mn = None
        mx = None
        for p in pends:
            if p is None:
                continue
            c, s, lo, hi = (_host(x) for x in p)
            c = int(c)
            if not c:
                continue
            count += c
            total += float(s)
            lo = float(lo)
            hi = float(hi)
            mn = lo if mn is None else min(mn, lo)
            mx = hi if mx is None else max(mx, hi)
        return _metric_partial(self.kind, count, total, mn, mx)

    # ---- bucketed (bucket-id × metric segment_sum) ----

    def dispatch_sorted(self, ex, si: int, mask, skey: tuple, space):
        """Per-bucket (count, sum, min, max) arrays over a bucket
        space's sorted metric layout (bucket-id × metric segment_sum)."""
        lay = metric_layout(
            ex, si, skey, self.field, self.kind in _NEEDS_SUM, space
        )
        if lay is None:
            return None
        return agg_kernels.sorted_bucket_metrics(
            mask, lay["map"], lay["gate"], lay["v"], lay["iv"],
            lay["bounds"],
        )

    def dispatch_sub_masked(self, ex, si: int, sel):
        """Single-bucket metric over an explicit selection mask (the
        range/filter bucket subs)."""
        dn = ex.device_segments[si].numerics.get(self.field)
        if dn is None:
            return None
        v, e = dn
        return agg_kernels.masked_metric(sel & e, v, self._ivals(ex, si))


def _metric_partial(kind: str, count: int, total: float,
                    mn: Optional[float], mx: Optional[float]) -> dict:
    """The host collector's exact partial wire shape for one metric."""
    if kind == "avg":
        return {"t": "avg", "sum": total, "count": count}
    if kind == "sum":
        return {"t": "sum", "sum": total}
    if kind == "min":
        return {"t": "min", "min": mn}
    if kind == "max":
        return {"t": "max", "max": mx}
    if kind == "value_count":
        return {"t": "value_count", "count": count}
    return {
        "t": "stats",
        "count": count,
        "sum": total,
        "min": mn,
        "max": mx,
    }


class _SubAccum:
    """Accumulates bucket-sub metric components across segments, keyed
    by the parent's bucket key."""

    def __init__(self, specs: List[_MetricSpec]):
        self.specs = specs
        self.acc: List[Dict[Any, list]] = [dict() for _ in specs]

    def add_arrays(self, sub_outs, keys_of_idx) -> None:
        """sub_outs: per spec, (cnt, sum, min, max) device arrays (or
        None); keys_of_idx: [(bucket_index, key)] worth accumulating."""
        for spi, out in enumerate(sub_outs):
            if out is None:
                continue
            cnt, sm, mn, mx = (np.atleast_1d(_host(x)) for x in out)
            store = self.acc[spi]
            for bi, key in keys_of_idx:
                c = int(cnt[bi])
                if not c:
                    continue
                cur = store.get(key)
                if cur is None:
                    store[key] = [c, float(sm[bi]), float(mn[bi]),
                                  float(mx[bi])]
                else:
                    cur[0] += c
                    cur[1] += float(sm[bi])
                    cur[2] = min(cur[2], float(mn[bi]))
                    cur[3] = max(cur[3], float(mx[bi]))

    def subs_for(self, key) -> dict:
        out = {}
        for spec, store in zip(self.specs, self.acc):
            got = store.get(key)
            if got is None:
                out[spec.name] = _metric_partial(
                    spec.kind, 0, 0.0, None, None
                )
            else:
                out[spec.name] = _metric_partial(spec.kind, *got)
        return out


def _compile_subs(ex, node: AggNode, mappings) -> List[_MetricSpec]:
    """A bucket node's collected subs must all be supported metric
    leaves (one nesting level); pipeline subs collect nothing and pass
    through to the reduce."""
    specs = []
    for sub in node.subs:
        if sub.type in PIPELINE_TYPES:
            continue
        if sub.type not in _METRIC_KINDS or sub.type == "percentiles":
            raise DeviceAggUnsupported(
                f"sub-agg [{sub.name}] of type [{sub.type}] under "
                f"[{node.name}]"
            )
        specs.append(_MetricSpec(ex, sub, mappings, root=False))
    return specs


# ---------------------------------------------------------------------------
# bucket nodes
# ---------------------------------------------------------------------------


class _TermsSpec:
    """terms over a keyword (ordinal CSR) or numeric (value ordinal)
    column; metric subs scatter into the same bucket-id space."""

    def __init__(self, ex, node: AggNode, mappings):
        self.name = node.name
        self.field = _req(node, "field")
        self.size = _int_param(node, "size", 10)
        self.shard_size = _int_param(
            node, "shard_size", max(int(self.size * 1.5) + 10, self.size)
        )
        self.order = _norm_order(node.params.get("order", {"_count": "desc"}))
        okey = next(iter(self.order)) if self.order else "_count"
        if okey not in ("_count", "_key"):
            raise DeviceAggUnsupported(f"terms order [{okey}]")
        mf = mappings.get(self.field)
        if mf is not None and mf.type == TEXT:
            raise DeviceAggUnsupported("terms over a text field")
        self.keyword = mf is not None and mf.type == KEYWORD
        self.ftype = None if mf is None else mf.type
        if not self.keyword:
            if mf is None:
                raise DeviceAggUnsupported("terms over an unmapped field")
            for si in range(len(ex.reader.segments)):
                _space_num(ex, si, self.field)  # raises on cardinality
        else:
            for si in range(len(ex.reader.segments)):
                of = ex.reader.segments[si].ordinals.get(self.field)
                if of is not None and len(of.ord_terms) > MAX_DEVICE_BUCKETS:
                    raise DeviceAggUnsupported(
                        "keyword terms cardinality over the device cap"
                    )
        self.subs = _compile_subs(ex, node, mappings)

    @property
    def sig(self) -> tuple:
        return (
            "terms", self.field, self.keyword, self.size, self.shard_size,
            tuple(self.order.items()), tuple(s.sig for s in self.subs),
        )

    def dispatch(self, ex, si: int, mask):
        if self.keyword:
            space = _space_kw(ex, si, self.field)
            skey = ("kw", self.field)
        else:
            got = _space_num(ex, si, self.field)
            if got is None:
                return None
            space, _uniq = got
            skey = ("num", self.field)
        if space is None:
            return None
        lay = counts_layout(ex, si, skey, space)
        counts = agg_kernels.sorted_bucket_counts(
            mask, lay["map"], lay["gate"], lay["bounds"]
        )
        sub_outs = [
            sp.dispatch_sorted(ex, si, mask, skey, space)
            for sp in self.subs
        ]
        return ("kw" if self.keyword else "num", si, counts, sub_outs)

    def _num_key(self, raw: float):
        key = float(raw)
        if self.ftype == BOOLEAN:
            return bool(key)
        if self.ftype in _INT_KEY_TYPES:
            return int(key)
        return key

    def collect(self, ex, pends) -> dict:
        counts: Dict[Any, int] = {}
        accum = _SubAccum(self.subs)
        for item in pends:
            if item is None:
                continue
            kind, si, dev_counts, sub_outs = item
            host_counts = _host(dev_counts)
            nz = np.nonzero(host_counts)[0]
            if kind == "kw":
                terms = ex.reader.segments[si].ordinals[self.field].ord_terms
                keys_of_idx = [(int(o), terms[int(o)]) for o in nz]
            else:
                uniq = _space_num(ex, si, self.field)[1]
                keys_of_idx = [
                    (int(o), self._num_key(uniq[int(o)])) for o in nz
                ]
            for o, key in keys_of_idx:
                counts[key] = counts.get(key, 0) + int(host_counts[o])
            if self.subs:
                accum.add_arrays(sub_outs, keys_of_idx)
        total = sum(counts.values())
        top = _order_buckets(counts, self.order)[: self.shard_size]
        shard_error = (
            top[-1][1] if len(counts) > self.shard_size and top else 0
        )
        buckets = {}
        for key, cnt in top:
            subs = accum.subs_for(key) if self.subs else {}
            buckets[_bkey(key)] = {
                "key": key, "doc_count": cnt, "subs": subs,
            }
        return {
            "t": "terms",
            "buckets": buckets,
            "sum_docs": total,
            "size": self.size,
            "order": self.order,
            "shard_error": shard_error,
        }


class _HistoSpec:
    """histogram / date_histogram via exact integer floor-division on
    the offset column. Per-segment bases; the host merges by key."""

    def __init__(self, ex, node: AggNode, mappings, date: bool):
        self.name = node.name
        self.field = _req(node, "field")
        self.date = date
        if date:
            interval_ms, calendar_unit = _parse_dh_interval(node.params)
            if calendar_unit is not None:
                raise DeviceAggUnsupported(
                    f"calendar interval [{calendar_unit}]"
                )
            self.interval = int(interval_ms)
            self.offset = 0
        else:
            interval = float(node.params.get("interval", 0))
            offset = float(node.params.get("offset", 0))
            if interval <= 0:
                raise AggParseError("interval must be > 0")
            if interval != int(interval) or offset != int(offset):
                raise DeviceAggUnsupported(
                    "non-integer histogram interval/offset"
                )
            self.interval = int(interval)
            self.offset = int(offset)
        # bucket-id columns are exact int64 host floor-divisions cached
        # per (segment, field, interval, offset); building them at
        # compile time surfaces cardinality/HBM breaches as host routing
        for si in range(len(ex.reader.segments)):
            p = col_profile(ex, si, self.field)
            if not p.present or p.n_exist == 0:
                continue
            if not p.integer_valued:
                raise DeviceAggUnsupported(
                    f"[{self.field}] is not an integer-valued column"
                )
            _space_hist(ex, si, self.field, self.interval, self.offset)
        self.subs = _compile_subs(ex, node, mappings)

    @property
    def sig(self) -> tuple:
        return (
            "date_histogram" if self.date else "histogram",
            self.field, self.interval, self.offset,
            tuple(s.sig for s in self.subs),
        )

    def dispatch(self, ex, si: int, mask):
        got = _space_hist(
            ex, si, self.field, self.interval, self.offset
        )
        if got is None:
            return None
        space, qmin = got
        skey = ("hist", self.field, self.interval, self.offset)
        lay = counts_layout(ex, si, skey, space)
        counts = agg_kernels.sorted_bucket_counts(
            mask, lay["map"], lay["gate"], lay["bounds"]
        )
        sub_outs = [
            sp.dispatch_sorted(ex, si, mask, skey, space)
            for sp in self.subs
        ]
        return (si, qmin, counts, sub_outs)

    def collect(self, ex, pends) -> dict:
        counts: Dict[Any, int] = {}
        accum = _SubAccum(self.subs)
        for item in pends:
            if item is None:
                continue
            si, qmin, dev_counts, sub_outs = item
            host_counts = _host(dev_counts)
            nz = np.nonzero(host_counts)[0]
            keys_of_idx = []
            for rel in nz:
                raw = (qmin + int(rel)) * self.interval + self.offset
                key = int(raw) if self.date else float(raw)
                keys_of_idx.append((int(rel), key))
                counts[key] = counts.get(key, 0) + int(host_counts[rel])
            if self.subs:
                accum.add_arrays(sub_outs, keys_of_idx)
        buckets = {}
        for k in sorted(counts):
            subs = accum.subs_for(k) if self.subs else {}
            buckets[k] = {"key": k, "doc_count": counts[k], "subs": subs}
        return {
            "t": "date_histogram" if self.date else "histogram",
            "buckets": buckets,
        }


class _RangeSpec:
    """range / date_range as exact int32 comparisons in offset space."""

    def __init__(self, ex, node: AggNode, mappings, date: bool):
        self.name = node.name
        self.field = _req(node, "field")
        self.date = date
        self.keyed = node.params.get("keyed", False)
        ranges = node.params.get("ranges", [])
        if not isinstance(ranges, list):
            raise DeviceAggUnsupported("malformed ranges")
        self.ranges = []
        for r in ranges:
            frm_raw = r.get("from")
            to_raw = r.get("to")
            if date:
                frm = parse_date_millis(frm_raw) if frm_raw is not None else None
                to = parse_date_millis(to_raw) if to_raw is not None else None
            else:
                frm = float(frm_raw) if frm_raw is not None else None
                to = float(to_raw) if to_raw is not None else None
            key = r.get("key")
            if key is None:
                fs = _range_key_part(frm_raw, date, frm)
                ts = _range_key_part(to_raw, date, to)
                key = f"{fs}-{ts}"
            self.ranges.append((frm, to, key))
        for si in range(len(ex.reader.segments)):
            p = col_profile(ex, si, self.field)
            if p.present and p.n_exist and not p.integer_valued:
                raise DeviceAggUnsupported(
                    f"[{self.field}] is not an integer-valued column"
                )
        self.subs = _compile_subs(ex, node, mappings)

    @property
    def sig(self) -> tuple:
        return (
            "date_range" if self.date else "range", self.field, self.keyed,
            tuple((f, t, k) for f, t, k in self.ranges),
            tuple(s.sig for s in self.subs),
        )

    def dispatch(self, ex, si: int, mask):
        got = wide_col(ex, si, self.field)
        if got is None:
            return None
        hi_w, lo_w, e, base, dmax = got
        out = []
        for frm, to, _key in self.ranges:
            # v >= frm  ⟺  Δ >= ceil(frm) − base  (v integer-valued);
            # v < to    ⟺  Δ < ceil(to) − base — compared as two int32
            # words (divmod by 2**24, floor semantics matching the
            # column split). Bounds clamp into the observed span first
            # so the word decomposition can never overflow int32.
            lo_b = -1 if frm is None else math.ceil(frm) - base
            hi_b = dmax + 2 if to is None else math.ceil(to) - base
            lo_b = max(-1, min(lo_b, dmax + 2))
            hi_b = max(-1, min(hi_b, dmax + 2))
            lhi, llo = divmod(lo_b, 1 << WIDE_SHIFT)
            hhi, hlo = divmod(hi_b, 1 << WIDE_SHIFT)
            rmask = agg_kernels.wide_range_mask(
                hi_w, lo_w, e,
                np.int32(lhi), np.int32(llo),
                np.int32(hhi), np.int32(hlo),
            )
            sel = mask & rmask
            cnt = sel.sum()
            sub_outs = [
                sp.dispatch_sub_masked(ex, si, sel)
                for sp in self.subs
            ]
            out.append((cnt, sub_outs))
        return out

    def collect(self, ex, pends) -> dict:
        n_ranges = len(self.ranges)
        counts = [0] * n_ranges
        accums = [_SubAccum(self.subs) for _ in range(n_ranges)]
        for item in pends:
            if item is None:
                continue
            for ri, (cnt, sub_outs) in enumerate(item):
                counts[ri] += int(_host(cnt))
                if self.subs:
                    accums[ri].add_arrays(sub_outs, [(0, 0)])
        out = []
        for ri, (frm, to, key) in enumerate(self.ranges):
            entry = {
                "key": key,
                "doc_count": counts[ri],
                "subs": accums[ri].subs_for(0) if self.subs else {},
            }
            if frm is not None:
                entry["from"] = frm
            if to is not None:
                entry["to"] = to
            out.append(entry)
        return {
            "t": "date_range" if self.date else "range",
            "buckets": out,
            "keyed": self.keyed,
        }


def _ZERO_IDS(ex, si: int):
    """Cached device int32 zeros([n_docs]) — the int32 sum operand of
    metric kinds that never sum (their sum output is discarded)."""
    key = ("zero", si)
    cached = ex._agg_cols.get(key)
    if cached is None:
        n = ex.reader.segments[si].num_docs
        cached = torch.zeros(n, dtype=torch.int32, device=ex.device)
        ex._agg_cols[key] = cached
    return cached


class _FilterSpec:
    """filter / filters riding the filter-bitset cache: the bucket's
    bitset ANDs into the query mask on the device."""

    def __init__(self, ex, node: AggNode, mappings, multi: bool):
        self.name = node.name
        self.multi = multi
        self.items: List[Tuple[str, object]] = []
        try:
            if multi:
                specs = node.params.get("filters", {})
                if isinstance(specs, dict):
                    self.keyed = True
                    items = specs.items()
                else:
                    self.keyed = False
                    items = ((str(i), s) for i, s in enumerate(specs))
                for key, qjson in items:
                    self.items.append((key, dsl.parse_query(qjson)))
            else:
                self.keyed = True
                self.items.append((node.name, dsl.parse_query(node.params)))
        except dsl.QueryParseError as e:
            raise DeviceAggUnsupported(f"filter parse: {e}")
        self.subs = _compile_subs(ex, node, mappings)

    @property
    def sig(self) -> tuple:
        return (
            "filters" if self.multi else "filter",
            tuple(dsl.canonical_key(q) for _k, q in self.items),
            self.keyed, tuple(s.sig for s in self.subs),
        )

    def dispatch(self, ex, si: int, mask):
        out = []
        for _key, q in self.items:
            sel = mask & ex.filter_mask(q, si)
            cnt = sel.sum()
            sub_outs = [
                sp.dispatch_sub_masked(ex, si, sel)
                for sp in self.subs
            ]
            out.append((cnt, sub_outs))
        return out

    def collect(self, ex, pends) -> dict:
        n = len(self.items)
        counts = [0] * n
        accums = [_SubAccum(self.subs) for _ in range(n)]
        for item in pends:
            if item is None:
                continue
            for fi, (cnt, sub_outs) in enumerate(item):
                counts[fi] += int(_host(cnt))
                if self.subs:
                    accums[fi].add_arrays(sub_outs, [(0, 0)])
        if not self.multi:
            return {
                "t": "filter",
                "doc_count": counts[0],
                "subs": accums[0].subs_for(0) if self.subs else {},
            }
        buckets = {}
        for fi, (key, _q) in enumerate(self.items):
            buckets[key] = {
                "key": key,
                "doc_count": counts[fi],
                "subs": accums[fi].subs_for(0) if self.subs else {},
            }
        return {"t": "filters", "buckets": buckets, "keyed": self.keyed}


# ---------------------------------------------------------------------------
# tree compilation + the shard-level plan (the batcher's agg job plan)
# ---------------------------------------------------------------------------


def _compile_node(ex, node: AggNode, mappings):
    t = node.type
    if t in _METRIC_KINDS:
        if node.subs:
            raise DeviceAggUnsupported("metric with subs")
        return _MetricSpec(ex, node, mappings, root=True)
    if t == "terms":
        return _TermsSpec(ex, node, mappings)
    if t == "histogram":
        return _HistoSpec(ex, node, mappings, date=False)
    if t == "date_histogram":
        return _HistoSpec(ex, node, mappings, date=True)
    if t == "range":
        return _RangeSpec(ex, node, mappings, date=False)
    if t == "date_range":
        return _RangeSpec(ex, node, mappings, date=True)
    if t == "filter":
        return _FilterSpec(ex, node, mappings, multi=False)
    if t == "filters":
        return _FilterSpec(ex, node, mappings, multi=True)
    raise DeviceAggUnsupported(f"agg type [{t}]")


class DeviceAggPlan:
    """A compiled shard-level device agg request: the QueryBatcher's
    ``agg`` job family dispatches it (device segment-sum passes) and
    collects it (compact downloads → host partials). The result is
    (TopDocs, partials) with partials wire-identical to AggCollector's."""

    def __init__(self, ex, nodes: Sequence[AggNode], specs, index: str,
                 sid: int, query, k: int):
        self.ex = ex
        self.nodes = nodes
        self.specs = specs  # name → spec for non-pipeline root nodes
        self.index = index
        self.sid = sid
        self.query = query
        self.k = int(k)
        self.sig = tuple(sp.sig for _name, sp in specs)

    def flops_estimate(self) -> int:
        n_docs = sum(s.num_docs for s in self.ex.reader.segments)
        return agg_kernels.agg_flops(n_docs, max(len(self.specs), 1))

    def dispatch(self) -> dict:
        """Launches all device work (query masks + bucket scatters)
        WITHOUT host sync; ``collect`` downloads and builds partials.
        The ``aggs.collect`` fault site fires here so an injected error
        surfaces through the batcher to the shard's host route. A script
        query node is evaluated by the executor's host oracle and
        uploaded, as in the reference."""
        faults.check("aggs.collect", index=self.index, shard=self.sid)
        ex = self.ex
        t0 = time.perf_counter()
        q = self.query if self.query is not None else dsl.MatchAllQuery()
        seg_items = []
        for si, seg in enumerate(ex.reader.segments):
            n = seg.num_docs
            if n == 0:
                continue
            mask, scores = ex._exec(q, si)
            live = ex.live_mask(si)
            if live is not None:
                mask = mask & live
            tot, mx = agg_kernels.masked_total_and_max(mask, scores)
            topk = None
            if self.k > 0:
                topk = scoring.topk_hits(scores, mask, min(self.k, n))
            spec_outs = [
                sp.dispatch(ex, si, mask)
                if not isinstance(sp, _MetricSpec)
                else sp.dispatch_root(ex, si, mask)
                for _name, sp in self.specs
            ]
            seg_items.append((si, tot, mx, topk, spec_outs))
        return {"segs": seg_items, "t0": t0}

    def collect(self, pend: dict):
        ex = self.ex
        seg_items = pend["segs"]
        total = 0
        max_score = None
        cands: List[Tuple[float, int, int]] = []
        per_spec_pends: List[list] = [[] for _ in self.specs]
        for si, tot, mx, topk, spec_outs in seg_items:
            total += int(_host(tot))
            mxf = float(_host(mx))
            if np.isfinite(mxf):
                max_score = (
                    mxf if max_score is None else max(max_score, mxf)
                )
            if topk is not None:
                s, d = (_host(x) for x in topk)
                finite = np.isfinite(s)
                for sc, doc in zip(s[finite], d[finite]):
                    cands.append((float(sc), si, int(doc)))
            for pi, out in enumerate(spec_outs):
                per_spec_pends[pi].append(out)
        partials = {}
        for (name, sp), pends in zip(self.specs, per_spec_pends):
            if isinstance(sp, _MetricSpec):
                partials[name] = sp.collect_root(pends)
            else:
                partials[name] = sp.collect(ex, pends)
        cands.sort(key=lambda c: (-c[0], c[1], c[2]))
        page = cands[: self.k]
        hits = [
            Hit(
                score=s,
                segment=si,
                local_doc=d,
                doc_id=ex.reader.segments[si].doc_ids[d],
            )
            for s, si, d in page
        ]
        td = TopDocs(
            total=total,
            hits=hits,
            max_score=(hits[0].score if hits else max_score),
            relation="eq",
        )
        note_kernel_ms((time.perf_counter() - pend["t0"]) * 1000.0)
        return td, partials


def try_compile(ex, nodes: Sequence[AggNode], mappings, index: str,
                sid: int, query, k: int) -> Optional[DeviceAggPlan]:
    """Compiles the tree to a device plan, or None when any node routes
    to the host (``ES_TPU_DEVICE_AGGS=force`` raises the reason instead
    so CI can assert device routing)."""
    from ..common.settings import device_aggs_mode

    mode = device_aggs_mode()
    if mode == "off":
        return None
    try:
        specs = [
            (n.name, _compile_node(ex, n, mappings))
            for n in nodes
            if n.type not in PIPELINE_TYPES
        ]
    except DeviceAggUnsupported:
        if mode == "force":
            raise
        return None
    except AggParseError:
        return None  # the host collector raises the user-facing error
    return DeviceAggPlan(ex, nodes, specs, index, sid, query, k)
