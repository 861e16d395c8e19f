"""Aggregations: vectorized bucketing + metrics over columnar doc values.

Reference analog: org.elasticsearch.search.aggregations (SURVEY.md §2.1)
— AggregatorFactories parses the "aggs" tree, per-shard Aggregator
collectors run during the query phase, and InternalAggregation.reduce
merges shard partials at the coordinator. The TPU-native redesign drops
doc-at-a-time Collector callbacks entirely: a query produces a dense
per-segment match mask, every bucketing rule is a vectorized transform
of the doc-value columns (np.bincount / searchsorted — the MXU/VPU-ready
formulation), and sub-aggregations recurse with bucket-refined masks.

Collect/reduce split mirrors the reference: ``collect(shard) → partial``
(InternalAggregation), ``reduce([partials]) → response JSON``; the terms
agg keeps per-shard top ``shard_size`` buckets and reduces like
`InternalTerms.reduce` (sum_other_doc_count accounting included).

Supported (round 1): metrics avg/sum/min/max/value_count/stats/
cardinality/percentiles; buckets terms (keyword/numeric/boolean),
histogram, date_histogram (fixed + calendar), range, date_range,
filter, filters, missing — all with arbitrary sub-agg nesting.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..index.mapping import BOOLEAN, DATE, KEYWORD, TEXT, parse_date_millis
from . import dsl

METRIC_TYPES = {
    "avg",
    "sum",
    "min",
    "max",
    "value_count",
    "stats",
    "extended_stats",
    "cardinality",
    "percentiles",
    "median_absolute_deviation",
    "weighted_avg",
    "top_hits",
}

# pipeline aggs run at REDUCE time over sibling/parent buckets
# (PipelineAggregationBuilder): parent pipelines are declared inside a
# bucket agg and walk its ordered buckets; sibling pipelines sit next to
# a multi-bucket agg and summarize a buckets_path into one value
PARENT_PIPELINE_TYPES = {
    "derivative",
    "cumulative_sum",
    "serial_diff",
    "moving_fn",
    "bucket_script",
    "bucket_selector",
    "bucket_sort",
}
SIBLING_PIPELINE_TYPES = {
    "avg_bucket",
    "max_bucket",
    "min_bucket",
    "sum_bucket",
    "stats_bucket",
}
PIPELINE_TYPES = PARENT_PIPELINE_TYPES | SIBLING_PIPELINE_TYPES
BUCKET_TYPES = {
    "terms",
    "significant_terms",
    "histogram",
    "date_histogram",
    "range",
    "date_range",
    "filter",
    "filters",
    "missing",
    "composite",
    "global",
    "geo_distance",
    "sampler",
}


class AggParseError(ValueError):
    pass


@dataclass
class AggNode:
    name: str
    type: str
    params: dict
    subs: List["AggNode"] = dc_field(default_factory=list)


def parse_aggs(body: Any) -> List[AggNode]:
    """Parses the request's "aggs"/"aggregations" object into a tree."""
    if not isinstance(body, dict):
        raise AggParseError("aggs must be an object")
    nodes = []
    for name, spec in body.items():
        if not isinstance(spec, dict):
            raise AggParseError(f"agg [{name}] must be an object")
        subs: List[AggNode] = []
        agg_type = None
        params: dict = {}
        for key, value in spec.items():
            if key in ("aggs", "aggregations"):
                subs = parse_aggs(value)
            elif key == "meta":
                continue
            else:
                if agg_type is not None:
                    raise AggParseError(
                        f"agg [{name}] defines multiple types "
                        f"[{agg_type}, {key}]"
                    )
                agg_type = key
                params = value if isinstance(value, dict) else {}
        if agg_type is None:
            raise AggParseError(f"agg [{name}] has no type")
        if agg_type not in METRIC_TYPES | BUCKET_TYPES | PIPELINE_TYPES:
            raise AggParseError(f"unknown aggregation type [{agg_type}]")
        if subs and agg_type in METRIC_TYPES | PIPELINE_TYPES:
            raise AggParseError(
                f"metric agg [{name}] cannot have sub-aggregations"
            )
        if agg_type in PIPELINE_TYPES and agg_type != "bucket_sort" and (
            "buckets_path" not in params
        ):
            raise AggParseError(
                f"pipeline agg [{name}] requires [buckets_path]"
            )
        nodes.append(AggNode(name, agg_type, params, subs))
    return nodes


# ----------------------------------------------------------------------
# per-shard collection
# ----------------------------------------------------------------------


class AggCollector:
    """Runs an agg tree over one shard (all its segments) given the
    query's per-segment match masks. Uses the executor for filter
    sub-queries so filter/filters buckets see identical query semantics."""

    def __init__(self, executor):
        self.ex = executor  # NumpyExecutor (oracle semantics)
        self.reader = executor.reader
        self._entry_docs_cache: Dict[tuple, np.ndarray] = {}
        self._ord_index_cache: Dict[tuple, Dict[str, int]] = {}

    # ---- doc-value access helpers ----

    def _numeric_values(self, si: int, field: str):
        seg = self.reader.segments[si]
        nf = seg.numerics.get(field)
        if nf is None:
            n = seg.num_docs
            return np.zeros(n), np.zeros(n, bool)
        return nf.values, nf.exists

    def _keyword_ords(self, si: int, field: str):
        seg = self.reader.segments[si]
        of = seg.ordinals.get(field)
        if of is None:
            return None
        return of

    # ---- entry ----

    def collect(self, nodes: Sequence[AggNode], masks: List[np.ndarray]) -> dict:
        """masks: per-segment boolean match arrays (query+live filtered).
        Pipeline aggs collect nothing — they run at reduce time."""
        return {
            n.name: self._collect_node(n, masks)
            for n in nodes
            if n.type not in PIPELINE_TYPES
        }

    def _collect_node(self, node: AggNode, masks: List[np.ndarray]) -> dict:
        fn = getattr(self, f"_collect_{node.type}", None)
        if fn is None:
            raise AggParseError(f"unknown aggregation type [{node.type}]")
        return fn(node, masks)

    def _entry_docs(self, si: int, of) -> np.ndarray:
        """doc index per multi-value ordinal entry, cached per segment."""
        key = (si, id(of))
        cached = self._entry_docs_cache.get(key)
        if cached is None:
            n = self.reader.segments[si].num_docs
            cached = np.repeat(np.arange(n), np.diff(of.mv_offsets))
            self._entry_docs_cache[key] = cached
        return cached

    # ---- metrics ----

    def _metric_values(
        self, node: AggNode, masks, numeric_only: bool = True
    ) -> np.ndarray:
        f = node.params.get("field")
        if f is None:
            if "script" in node.params:
                raise AggParseError("scripts not supported in this build")
            raise AggParseError(f"agg [{node.name}] requires a field")
        mf = self.reader.mappings.get(f)
        vals = []
        for si, mask in enumerate(masks):
            if mf is not None and mf.type in (KEYWORD, TEXT):
                if numeric_only:
                    raise AggParseError(
                        f"Field [{f}] of type [{mf.type}] is not supported "
                        f"for aggregation [{node.type}]"
                    )
                of = self._keyword_ords(si, f)
                if of is None:
                    continue
                sel = mask[self._entry_docs(si, of)]
                vals.append(of.mv_ords[sel].astype(np.float64))  # count only
            else:
                v, e = self._numeric_values(si, f)
                m = mask & e
                vals.append(v[m])
        return np.concatenate(vals) if vals else np.zeros(0)

    def _collect_avg(self, node, masks):
        v = self._metric_values(node, masks)
        return {"t": "avg", "sum": float(v.sum()), "count": int(len(v))}

    def _collect_sum(self, node, masks):
        v = self._metric_values(node, masks)
        return {"t": "sum", "sum": float(v.sum())}

    def _collect_min(self, node, masks):
        v = self._metric_values(node, masks)
        return {"t": "min", "min": float(v.min()) if len(v) else None}

    def _collect_max(self, node, masks):
        v = self._metric_values(node, masks)
        return {"t": "max", "max": float(v.max()) if len(v) else None}

    def _collect_value_count(self, node, masks):
        v = self._metric_values(node, masks, numeric_only=False)
        return {"t": "value_count", "count": int(len(v))}

    def _collect_stats(self, node, masks):
        v = self._metric_values(node, masks)
        return {
            "t": "stats",
            "count": int(len(v)),
            "sum": float(v.sum()),
            "min": float(v.min()) if len(v) else None,
            "max": float(v.max()) if len(v) else None,
        }

    def _collect_cardinality(self, node, masks):
        """Exact distinct count; partials are numpy arrays so
        cross-segment/shard union needs no boxing. Keyword terms hash
        with a 64-bit murmur3 combination (stable across processes —
        Python hash() is PYTHONHASHSEED-randomized — and wide enough
        that birthday collisions stay negligible, unlike a single
        32-bit hash); term hashes and numeric bit patterns live in
        separate partial keys so they can never collide when reduced
        together. Round 3: HLL++ sketch for sublinear partials."""
        from ..utils.murmur3 import murmurhash3_x86_32

        def _hash64(term: str) -> int:
            b = term.encode("utf-8")
            # mask both halves unsigned BEFORE combining: murmur3_x86_32
            # returns Java-signed ints, and a negative low word would
            # sign-extend over (and erase) the high word
            hi = murmurhash3_x86_32(b, seed=0) & 0xFFFFFFFF
            lo = murmurhash3_x86_32(b, seed=0x9747B28C) & 0xFFFFFFFF
            v = (hi << 32) | lo
            return v - (1 << 64) if v >= (1 << 63) else v  # wrap to int64

        f = node.params.get("field")
        if f is None:
            raise AggParseError(f"agg [{node.name}] requires a field")
        mf = self.reader.mappings.get(f)
        term_parts = []
        num_parts = []
        for si, mask in enumerate(masks):
            if mf is not None and mf.type in (KEYWORD, TEXT):
                of = self._keyword_ords(si, f)
                if of is None:
                    continue
                sel_ords = np.unique(of.mv_ords[mask[self._entry_docs(si, of)]])
                # hash terms so segments with different ord spaces merge
                term_parts.append(
                    np.fromiter(
                        (_hash64(of.ord_terms[o]) for o in sel_ords),
                        np.int64,
                        count=len(sel_ords),
                    )
                )
            else:
                v, e = self._numeric_values(si, f)
                num_parts.append(np.unique(v[mask & e]).view(np.int64))
        return {
            "t": "cardinality",
            # JSON-serializable: partials ride the transport cross-node
            "terms": (
                np.unique(np.concatenate(term_parts)).tolist()
                if term_parts
                else []
            ),
            "nums": (
                np.unique(np.concatenate(num_parts)).tolist()
                if num_parts
                else []
            ),
        }

    def _collect_percentiles(self, node, masks):
        # exact percentiles: the partial keeps matched values as one numpy
        # array (no boxing); t-digest sketching is the round-2 upgrade
        v = self._metric_values(node, masks)
        return {
            "t": "percentiles",
            # JSON-serializable: partials ride the transport cross-node
            "values": v.tolist(),
            "percents": node.params.get(
                "percents", [1, 5, 25, 50, 75, 95, 99]
            ),
        }

    def _collect_extended_stats(self, node, masks):
        v = self._metric_values(node, masks)
        return {
            "t": "extended_stats",
            "count": int(len(v)),
            "sum": float(v.sum()),
            "sum_sq": float((v * v).sum()),
            "min": float(v.min()) if len(v) else None,
            "max": float(v.max()) if len(v) else None,
            "sigma": float(node.params.get("sigma", 2.0)),
        }

    def _collect_median_absolute_deviation(self, node, masks):
        # exact MAD from retained values (the reference approximates
        # with a t-digest; exactness beats sketching at this scale).
        # Partials must be JSON-serializable: they ride the transport
        # to remote coordinators.
        v = self._metric_values(node, masks)
        return {"t": "median_absolute_deviation", "values": v.tolist()}

    def _collect_weighted_avg(self, node, masks):
        vspec = node.params.get("value") or {}
        wspec = node.params.get("weight") or {}
        vf, wf = vspec.get("field"), wspec.get("field")
        if vf is None or wf is None:
            raise AggParseError(
                "[weighted_avg] requires [value.field] and [weight.field]"
            )
        vsum = 0.0
        wsum = 0.0
        for si, mask in enumerate(masks):
            v, ve = self._numeric_values(si, vf)
            w, we = self._numeric_values(si, wf)
            m = mask & ve & we
            vsum += float((v[m] * w[m]).sum())
            wsum += float(w[m].sum())
        return {"t": "weighted_avg", "vsum": vsum, "wsum": wsum}

    def _collect_top_hits(self, node, masks):
        """Per-bucket hit materialization (TopHitsAggregator). Sort:
        numeric/date doc-value fields and `_doc`; the default is `_doc`
        (query scores are not available in the agg phase — documented
        deviation from the reference's score default)."""
        size = _int_param(node, "size", 3)
        sort_spec = node.params.get("sort") or ["_doc"]
        if isinstance(sort_spec, (str, dict)):
            sort_spec = [sort_spec]
        specs = []
        for s in sort_spec:
            if isinstance(s, str):
                specs.append((s, "asc"))
            elif isinstance(s, dict) and len(s) == 1:
                fld, spec = next(iter(s.items()))
                order = (
                    spec.get("order", "asc")
                    if isinstance(spec, dict)
                    else str(spec)
                )
                specs.append((fld, order))
            else:
                raise AggParseError("[top_hits] malformed sort")
        source_spec = node.params.get("_source", True)
        entries = []
        total = 0
        for si, mask in enumerate(masks):
            seg = self.reader.segments[si]
            idx = np.nonzero(mask)[0]
            total += len(idx)
            for d in idx:
                keys = []
                raws = []
                for fld, order in specs:
                    if fld == "_doc":
                        v = float(si * 10**9 + int(d))
                        have = True
                    else:
                        col, e = self._numeric_values(si, fld)
                        have = bool(e[d])
                        v = float(col[d]) if have else None
                    raws.append(v)
                    if not have:
                        # missing sorts LAST in either direction
                        keys.append(float("inf"))
                    else:
                        keys.append(-v if order == "desc" else v)
                entries.append((tuple(keys), raws, si, int(d)))
        entries.sort(key=lambda e: e[0])
        from .executor import filter_source

        hits = []
        for keys, raws, si, d in entries[:size]:
            seg = self.reader.segments[si]
            src = seg.sources[d]
            # _k: internal order keys for the cross-shard merge (stripped
            # at reduce); sort: the raw public values
            h = {"_id": seg.doc_ids[d], "_score": None, "sort": raws,
                 "_k": list(keys)}
            filtered = filter_source(src, source_spec)
            if filtered is not None and source_spec is not False:
                h["_source"] = filtered
            hits.append(h)
        return {"t": "top_hits", "hits": hits, "total": total, "size": size}

    # ---- bucket helpers ----

    def _bucket_result(self, doc_count: int, sub_partial: dict) -> dict:
        return {"doc_count": doc_count, "subs": sub_partial}

    def _sub_collect(self, node: AggNode, bucket_masks: List[np.ndarray]) -> dict:
        if not node.subs:
            return {}
        return self.collect(node.subs, bucket_masks)

    # ---- terms ----

    def _collect_terms(self, node, masks):
        f = node.params.get("field")
        if f is None:
            raise AggParseError("terms agg requires a field")
        size = _int_param(node, "size", 10)
        shard_size = _int_param(node, "shard_size", max(int(size * 1.5) + 10, size))
        mf = self.reader.mappings.get(f)
        if mf is not None and mf.type == TEXT:
            raise AggParseError(
                f"Text fields are not optimised for aggregations [{f}]; "
                "use a keyword sub-field"
            )
        counts: Dict[Any, int] = {}
        is_keyword = mf is not None and mf.type == KEYWORD
        for si, mask in enumerate(masks):
            if is_keyword:
                of = self._keyword_ords(si, f)
                if of is None:
                    continue
                sel = of.mv_ords[mask[self._entry_docs(si, of)]]
                bc = np.bincount(sel, minlength=len(of.ord_terms))
                for o in np.nonzero(bc)[0]:
                    key = of.ord_terms[o]
                    counts[key] = counts.get(key, 0) + int(bc[o])
            else:
                v, e = self._numeric_values(si, f)
                m = mask & e
                u, c = np.unique(v[m], return_counts=True)
                for key, cnt in zip(u.tolist(), c.tolist()):
                    if mf is not None and mf.type == BOOLEAN:
                        key = bool(key)
                    elif mf is not None and mf.type in ("integer", "long", "short", "byte", DATE):
                        key = int(key)
                    counts[key] = counts.get(key, 0) + cnt
        total = sum(counts.values())
        order = _norm_order(node.params.get("order", {"_count": "desc"}))
        top = _order_buckets(counts, order)[:shard_size]
        # this shard's contribution to doc_count_error_upper_bound: the
        # last kept bucket's count if we truncated, else 0 (InternalTerms)
        shard_error = top[-1][1] if len(counts) > shard_size and top else 0
        buckets = {}
        for key, cnt in top:
            subs = {}
            if node.subs:  # bucket masks only needed for sub-aggs
                bucket_masks = [
                    self._term_bucket_mask(si, f, key, mask, is_keyword)
                    for si, mask in enumerate(masks)
                ]
                subs = self._sub_collect(node, bucket_masks)
            buckets[_bkey(key)] = {"key": key, "doc_count": cnt, "subs": subs}
        return {
            "t": "terms",
            "buckets": buckets,
            "sum_docs": total,
            "size": size,
            "order": order,
            "shard_error": shard_error,
        }

    def _term_bucket_mask(self, si, f, key, mask, is_keyword) -> np.ndarray:
        seg = self.reader.segments[si]
        n = seg.num_docs
        if is_keyword:
            of = self._keyword_ords(si, f)
            if of is None:
                return np.zeros(n, bool)
            ord_index = self._ord_index_cache.get((si, f))
            if ord_index is None:
                ord_index = {t: i for i, t in enumerate(of.ord_terms)}
                self._ord_index_cache[(si, f)] = ord_index
            o = ord_index.get(key)
            if o is None:
                return np.zeros(n, bool)
            entry_docs = self._entry_docs(si, of)
            has = np.zeros(n, bool)
            has[entry_docs[of.mv_ords == o]] = True
            return mask & has
        v, e = self._numeric_values(si, f)
        return mask & e & (v == float(key))

    def _collect_global(self, node, masks):
        """global bucket: the whole shard's LIVE docs regardless of the
        query (GlobalAggregator)."""
        full = []
        for si, seg in enumerate(self.reader.segments):
            live = self.reader.live_docs[si]
            full.append(
                np.ones(seg.num_docs, bool) if live is None else live.copy()
            )
        return {
            "t": "global",
            "doc_count": int(sum(m.sum() for m in full)),
            "subs": self._sub_collect(node, full),
        }

    def _collect_significant_terms(self, node, masks):
        """Foreground (query) vs background (whole shard) term counts;
        scoring happens at reduce with the summed stats
        (SignificantTermsAggregatorFactory, JLH heuristic). Background
        counts are mask-independent and cached per (segment, field) so
        nesting under a 1000-bucket terms agg doesn't rescan the shard
        1000 times."""
        f = _req(node, "field")
        mf = self.reader.mappings.get(f)
        if mf is None or mf.type != KEYWORD:
            raise AggParseError(
                f"[significant_terms] requires a keyword field, got [{f}]"
            )
        if not hasattr(self, "_sig_bg_cache"):
            self._sig_bg_cache: Dict[tuple, tuple] = {}
        fg: Dict[str, int] = {}
        bg: Dict[str, int] = {}
        fg_total = 0
        bg_total = 0
        for si, mask in enumerate(masks):
            of = self._keyword_ords(si, f)
            seg = self.reader.segments[si]
            live = self.reader.live_docs[si]
            full = np.ones(seg.num_docs, bool) if live is None else live
            fg_total += int(mask.sum())
            if of is None:
                bg_total += int(full.sum())
                continue
            entry_docs = self._entry_docs(si, of)
            cached = self._sig_bg_cache.get((si, f))
            if cached is None:
                sel = of.mv_ords[full[entry_docs]]
                bc = np.bincount(sel, minlength=len(of.ord_terms))
                bg_counts = {
                    of.ord_terms[o]: int(bc[o]) for o in np.nonzero(bc)[0]
                }
                cached = (bg_counts, int(full.sum()))
                self._sig_bg_cache[(si, f)] = cached
            for key, cnt in cached[0].items():
                bg[key] = bg.get(key, 0) + cnt
            bg_total += cached[1]
            sel = of.mv_ords[mask[entry_docs]]
            bc = np.bincount(sel, minlength=len(of.ord_terms))
            for o in np.nonzero(bc)[0]:
                key = of.ord_terms[o]
                fg[key] = fg.get(key, 0) + int(bc[o])
        return {
            "t": "significant_terms",
            "fg": fg,
            "bg": bg,
            "fg_total": fg_total,
            "bg_total": bg_total,
            "size": _int_param(node, "size", 10),
        }

    def _collect_composite(self, node, masks):
        """Composite: multi-source bucket tuples, paginated at reduce
        via after_key (CompositeAggregator). Sources: terms, histogram,
        date_histogram (fixed_interval). Multi-valued keywords use the
        first value."""
        sources = node.params.get("sources")
        if not isinstance(sources, list) or not sources:
            raise AggParseError("[composite] requires [sources]")
        specs = []
        for s in sources:
            if not isinstance(s, dict) or len(s) != 1:
                raise AggParseError("[composite] malformed source")
            sname, body = next(iter(s.items()))
            if not isinstance(body, dict) or len(body) != 1:
                raise AggParseError("[composite] malformed source")
            stype, params = next(iter(body.items()))
            if stype not in ("terms", "histogram", "date_histogram"):
                raise AggParseError(
                    f"[composite] unsupported source type [{stype}]"
                )
            specs.append((sname, stype, params))
        buckets: Dict[tuple, dict] = {}
        for si, mask in enumerate(masks):
            n = self.reader.segments[si].num_docs
            cols = []
            ok = mask.copy()
            for sname, stype, params in specs:
                f = params.get("field")
                if f is None:
                    raise AggParseError("[composite] source requires [field]")
                mf = self.reader.mappings.get(f)
                if stype == "terms" and mf is not None and mf.type == KEYWORD:
                    of = self._keyword_ords(si, f)
                    if of is None:
                        col = np.full(n, None, object)
                        have = np.zeros(n, bool)
                    else:
                        col = np.full(n, None, object)
                        have = of.ords >= 0
                        idx = np.nonzero(have)[0]
                        col[idx] = [of.ord_terms[o] for o in of.ords[idx]]
                else:
                    v, e = self._numeric_values(si, f)
                    have = e
                    if stype == "histogram":
                        interval = _float_param(
                            _req_param(params, "interval", node), node,
                            "interval",
                        )
                        col = np.floor(v / interval) * interval
                    elif stype == "date_histogram":
                        iv = params.get("fixed_interval") or params.get(
                            "calendar_interval"
                        )
                        ms = _parse_dh_interval({"fixed_interval": iv})[0] if iv else None
                        if ms is None:
                            raise AggParseError(
                                "[composite] date_histogram needs "
                                "fixed_interval"
                            )
                        col = np.floor(v / ms) * ms
                    else:
                        if mf is not None and mf.type in (
                            "integer", "long", "short", "byte",
                        ):
                            col = v.astype(np.int64)
                        else:
                            col = v
                ok &= have
                cols.append(col)
            idx = np.nonzero(ok)[0]
            track_docs = bool(node.subs)  # per-bucket docs only feed subs
            for d in idx:
                key = tuple(
                    c[d] if isinstance(c[d], str) else
                    (int(c[d]) if float(c[d]).is_integer() else float(c[d]))
                    for c in cols
                )
                cur = buckets.get(key)
                if cur is None:
                    buckets[key] = {
                        "count": 1,
                        "docs": [(si, int(d))] if track_docs else [],
                    }
                else:
                    cur["count"] += 1
                    if track_docs:
                        cur["docs"].append((si, int(d)))
        # sub-agg collection per composite bucket
        out_buckets = {}
        for key, info in buckets.items():
            subs = {}
            if node.subs:
                bucket_masks = [
                    np.zeros(self.reader.segments[si].num_docs, bool)
                    for si in range(len(masks))
                ]
                for si, d in info["docs"]:
                    bucket_masks[si][d] = True
                subs = self._sub_collect(node, bucket_masks)
            out_buckets[json.dumps(list(key))] = {
                "key_values": list(key),
                "doc_count": info["count"],
                "subs": subs,
            }
        return {
            "t": "composite",
            "buckets": out_buckets,
            "source_names": [s[0] for s in specs],
            "size": _int_param(node, "size", 10),
            "after": node.params.get("after"),
        }

    def _collect_geo_distance(self, node, masks):
        """geo_distance rings around an origin (GeoDistanceAggregator):
        haversine over the geo_point's lat/lon doc-value columns. The
        bucket/key/keyed machinery is the range agg's (same partial
        shape, same reduce branch, same '50.0-100.0' key format)."""
        from ..search.dsl import _geo_point, parse_distance_meters
        from ..search.executor import _haversine_m

        f = _req(node, "field")
        origin_lat, origin_lon = _geo_point(_req(node, "origin"))
        unit = str(node.params.get("unit", "m"))
        unit_m = parse_distance_meters(f"1{unit}")
        ranges = node.params.get("ranges")
        if not isinstance(ranges, list) or not ranges:
            raise AggParseError("[geo_distance] requires [ranges]")
        # per-segment distances (and field presence), computed once
        seg_dist = []
        seg_base = []
        for si, mask in enumerate(masks):
            lat, le = self._numeric_values(si, f"{f}.lat")
            lon, loe = self._numeric_values(si, f"{f}.lon")
            seg_dist.append(
                _haversine_m(origin_lat, origin_lon, lat, lon) / unit_m
            )
            seg_base.append(mask & le & loe)
        out = []
        for r in ranges:
            frm = float(r["from"]) if r.get("from") is not None else None
            to = float(r["to"]) if r.get("to") is not None else None
            bucket_masks = []
            cnt = 0
            for si in range(len(masks)):
                m = seg_base[si]
                if frm is not None:
                    m = m & (seg_dist[si] >= frm)
                if to is not None:
                    m = m & (seg_dist[si] < to)
                bucket_masks.append(m)
                cnt += int(m.sum())
            key = r.get("key")
            if key is None:
                fs = _range_key_part(r.get("from"), False, frm)
                ts = _range_key_part(r.get("to"), False, to)
                key = f"{fs}-{ts}"
            entry = {
                "key": key,
                "doc_count": cnt,
                "subs": self._sub_collect(node, bucket_masks),
            }
            if frm is not None:
                entry["from"] = frm
            if to is not None:
                entry["to"] = to
            out.append(entry)
        return {
            "t": "geo_distance",
            "buckets": out,
            "keyed": node.params.get("keyed", False),
        }

    def _collect_sampler(self, node, masks):
        """sampler: sub-aggs see only the first shard_size matching docs
        per shard (SamplerAggregator's best-docs simplification: our
        masks carry no scores, so document order stands in for rank)."""
        shard_size = _int_param(node, "shard_size", 100)
        remaining = shard_size
        sampled = []
        for mask in masks:
            m = np.zeros_like(mask)
            if remaining > 0:
                idx = np.nonzero(mask)[0][:remaining]
                m[idx] = True
                remaining -= len(idx)
            sampled.append(m)
        return {
            "t": "sampler",
            "doc_count": int(sum(int(m.sum()) for m in sampled)),
            "subs": self._sub_collect(node, sampled),
        }

    # ---- histogram family ----

    def _collect_histogram(self, node, masks):
        f = _req(node, "field")
        interval = _float_param(_req(node, "interval"), node, "interval")
        if interval <= 0:
            raise AggParseError("interval must be > 0")
        offset = _float_param(node.params.get("offset", 0), node, "offset")
        counts: Dict[float, int] = {}
        per_seg_keys = []
        for si, mask in enumerate(masks):
            v, e = self._numeric_values(si, f)
            keys = np.floor((v - offset) / interval) * interval + offset
            per_seg_keys.append(keys)
            m = mask & e
            u, c = np.unique(keys[m], return_counts=True)
            for k, cnt in zip(u.tolist(), c.tolist()):
                counts[k] = counts.get(k, 0) + cnt
        buckets = {}
        for k in sorted(counts):
            subs = {}
            if node.subs:
                bucket_masks = []
                for si, mask in enumerate(masks):
                    _, e = self._numeric_values(si, f)
                    bucket_masks.append(mask & e & (per_seg_keys[si] == k))
                subs = self._sub_collect(node, bucket_masks)
            buckets[k] = {"key": k, "doc_count": counts[k], "subs": subs}
        return {"t": "histogram", "buckets": buckets}

    def _collect_date_histogram(self, node, masks):
        f = _req(node, "field")
        interval_ms, calendar_unit = _parse_dh_interval(node.params)
        counts: Dict[int, int] = {}
        per_seg_keys = []
        for si, mask in enumerate(masks):
            v, e = self._numeric_values(si, f)
            keys = _date_bucket_keys(v, calendar_unit, interval_ms)
            per_seg_keys.append(keys)
            m = mask & e
            u, c = np.unique(keys[m], return_counts=True)
            for k, cnt in zip(u.tolist(), c.tolist()):
                counts[int(k)] = counts.get(int(k), 0) + cnt
        buckets = {}
        for k in sorted(counts):
            subs = {}
            if node.subs:
                bucket_masks = []
                for si, mask in enumerate(masks):
                    _, e = self._numeric_values(si, f)
                    bucket_masks.append(mask & e & (per_seg_keys[si] == k))
                subs = self._sub_collect(node, bucket_masks)
            buckets[k] = {"key": k, "doc_count": counts[k], "subs": subs}
        return {"t": "date_histogram", "buckets": buckets}

    # ---- range family ----

    def _collect_range(self, node, masks, is_date=False):
        f = _req(node, "field")
        ranges = node.params.get("ranges", [])
        out = []
        for r in ranges:
            frm = r.get("from")
            to = r.get("to")
            if is_date:
                frm = parse_date_millis(frm) if frm is not None else None
                to = parse_date_millis(to) if to is not None else None
            else:
                frm = float(frm) if frm is not None else None
                to = float(to) if to is not None else None
            bucket_masks = []
            cnt = 0
            for si, mask in enumerate(masks):
                v, e = self._numeric_values(si, f)
                m = mask & e
                if frm is not None:
                    m = m & (v >= frm)
                if to is not None:
                    m = m & (v < to)
                bucket_masks.append(m)
                cnt += int(m.sum())
            key = r.get("key")
            if key is None:
                fs = _range_key_part(r.get("from"), is_date, frm)
                ts = _range_key_part(r.get("to"), is_date, to)
                key = f"{fs}-{ts}"
            entry = {
                "key": key,
                "doc_count": cnt,
                "subs": self._sub_collect(node, bucket_masks),
            }
            if frm is not None:
                entry["from"] = frm
            if to is not None:
                entry["to"] = to
            out.append(entry)
        return {"t": "range", "buckets": out, "keyed": node.params.get("keyed", False)}

    def _collect_date_range(self, node, masks):
        r = self._collect_range(node, masks, is_date=True)
        r["t"] = "date_range"
        return r

    # ---- filter / filters / missing ----

    def _query_masks(self, query_json: dict, masks) -> List[np.ndarray]:
        # agg filter contexts ride the node-level bitset cache (the
        # reference caches agg `filter`/`filters` bitsets the same way)
        q = dsl.parse_query(query_json)
        out = []
        for si, mask in enumerate(masks):
            seg = self.reader.segments[si]
            if hasattr(self.ex, "filter_mask"):
                m = self.ex.filter_mask(q, seg)
            else:
                m, _ = self.ex._exec(q, seg)
            out.append(mask & m)
        return out

    def _collect_filter(self, node, masks):
        # the filter *is* the params object itself ({"term": ...})
        fmasks = self._query_masks(node.params, masks)
        return {
            "t": "filter",
            "doc_count": int(sum(m.sum() for m in fmasks)),
            "subs": self._sub_collect(node, fmasks),
        }

    def _collect_filters(self, node, masks):
        specs = node.params.get("filters", {})
        buckets = {}
        if isinstance(specs, dict):
            items = specs.items()
            keyed = True
        else:
            items = ((str(i), s) for i, s in enumerate(specs))
            keyed = False
        for key, qjson in items:
            fmasks = self._query_masks(qjson, masks)
            buckets[key] = {
                "key": key,
                "doc_count": int(sum(m.sum() for m in fmasks)),
                "subs": self._sub_collect(node, fmasks),
            }
        return {"t": "filters", "buckets": buckets, "keyed": keyed}

    def _collect_missing(self, node, masks):
        f = node.params.get("field")
        mf = self.reader.mappings.get(f) if f else None
        mmasks = []
        for si, mask in enumerate(masks):
            seg = self.reader.segments[si]
            n = seg.num_docs
            if mf is not None and mf.type in (KEYWORD, TEXT):
                of = self._keyword_ords(si, f)
                if of is None:
                    have = np.zeros(n, bool)
                else:
                    have = of.ords >= 0
            else:
                _, have = self._numeric_values(si, f)
            mmasks.append(mask & ~have)
        return {
            "t": "missing",
            "doc_count": int(sum(m.sum() for m in mmasks)),
            "subs": self._sub_collect(node, mmasks),
        }


# ----------------------------------------------------------------------
# coordinator reduce (InternalAggregation.reduce analog)
# ----------------------------------------------------------------------


def reduce_aggs(
    nodes: Sequence[AggNode],
    shard_partials: List[dict],
    in_bucket: bool = False,
) -> dict:
    """Coordinator reduce. Pipeline aggs run here: sibling pipelines
    after their targets; parent pipelines are applied by the PARENT
    bucket agg over its reduced bucket list (in_bucket marks sub-level
    reduces, where parent-pipeline nodes are handled by the caller via
    _apply_parent_pipelines)."""
    out = {}
    for node in nodes:
        if node.type in PIPELINE_TYPES:
            continue
        parts = [p[node.name] for p in shard_partials if node.name in p]
        reduced = _reduce_node(node, parts)
        out[node.name] = _apply_parent_pipelines(node, reduced)
    for node in nodes:
        if node.type in SIBLING_PIPELINE_TYPES:
            out[node.name] = _sibling_pipeline(node, out)
        elif node.type in PARENT_PIPELINE_TYPES and not in_bucket:
            raise AggParseError(
                f"pipeline agg [{node.name}] of type [{node.type}] must be "
                "declared inside a multi-bucket aggregation"
            )
    return out


def _reduce_node(node: AggNode, parts: List[dict]) -> dict:
    t = node.type
    if t == "avg":
        s = sum(p["sum"] for p in parts)
        c = sum(p["count"] for p in parts)
        return {"value": (s / c) if c else None}
    if t == "sum":
        return {"value": sum(p["sum"] for p in parts)}
    if t == "min":
        vals = [p["min"] for p in parts if p["min"] is not None]
        return {"value": min(vals) if vals else None}
    if t == "max":
        vals = [p["max"] for p in parts if p["max"] is not None]
        return {"value": max(vals) if vals else None}
    if t == "value_count":
        return {"value": sum(p["count"] for p in parts)}
    if t == "stats":
        c = sum(p["count"] for p in parts)
        s = sum(p["sum"] for p in parts)
        mins = [p["min"] for p in parts if p["min"] is not None]
        maxs = [p["max"] for p in parts if p["max"] is not None]
        return {
            "count": c,
            "min": min(mins) if mins else None,
            "max": max(maxs) if maxs else None,
            "avg": (s / c) if c else None,
            "sum": s,
        }
    if t == "extended_stats":
        c = sum(p["count"] for p in parts)
        s = sum(p["sum"] for p in parts)
        sq = sum(p["sum_sq"] for p in parts)
        mins = [p["min"] for p in parts if p["min"] is not None]
        maxs = [p["max"] for p in parts if p["max"] is not None]
        sigma = parts[0]["sigma"] if parts else 2.0
        avg = (s / c) if c else None
        variance = max(sq / c - avg * avg, 0.0) if c else None
        std = float(np.sqrt(variance)) if variance is not None else None
        out = {
            "count": c,
            "min": min(mins) if mins else None,
            "max": max(maxs) if maxs else None,
            "avg": avg,
            "sum": s,
            "sum_of_squares": sq if c else None,
            "variance": variance,
            "std_deviation": std,
        }
        if std is not None:
            out["std_deviation_bounds"] = {
                "upper": avg + sigma * std,
                "lower": avg - sigma * std,
            }
        return out
    if t == "median_absolute_deviation":
        vals = (
            np.concatenate([np.asarray(p["values"]) for p in parts])
            if parts
            else np.zeros(0)
        )
        if not len(vals):
            return {"value": None}
        med = np.median(vals)
        return {"value": float(np.median(np.abs(vals - med)))}
    if t == "weighted_avg":
        vsum = sum(p["vsum"] for p in parts)
        wsum = sum(p["wsum"] for p in parts)
        return {"value": (vsum / wsum) if wsum else None}
    if t == "top_hits":
        size = parts[0]["size"] if parts else 3
        merged_hits = [h for p in parts for h in p["hits"]]
        merged_hits.sort(key=lambda h: tuple(h.get("_k", [])))
        total = sum(p["total"] for p in parts)
        return {
            "hits": {
                "total": {"value": total, "relation": "eq"},
                "max_score": None,
                "hits": [
                    {k: v for k, v in h.items() if k != "_k"}
                    for h in merged_hits[:size]
                ],
            }
        }
    if t == "global":
        return {
            "doc_count": sum(p["doc_count"] for p in parts),
            **_reduce_subs(node, [p["subs"] for p in parts]),
        }
    if t == "significant_terms":
        fg: Dict[str, int] = {}
        bg: Dict[str, int] = {}
        fg_total = sum(p["fg_total"] for p in parts)
        bg_total = sum(p["bg_total"] for p in parts)
        for p in parts:
            for k, v in p["fg"].items():
                fg[k] = fg.get(k, 0) + v
            for k, v in p["bg"].items():
                bg[k] = bg.get(k, 0) + v
        size = parts[0]["size"] if parts else 10
        scored = []
        for k, f_cnt in fg.items():
            b_cnt = bg.get(k, f_cnt)
            if fg_total == 0 or bg_total == 0:
                continue
            fg_rate = f_cnt / fg_total
            bg_rate = b_cnt / bg_total
            if fg_rate <= bg_rate or bg_rate == 0:
                continue  # only terms MORE common in the foreground
            # JLH: (fg% - bg%) * (fg% / bg%) — SignificantTermsHeuristic
            score = (fg_rate - bg_rate) * (fg_rate / bg_rate)
            scored.append((score, k, f_cnt, b_cnt))
        scored.sort(key=lambda x: (-x[0], x[1]))
        return {
            "doc_count": fg_total,
            "bg_count": bg_total,
            "buckets": [
                {
                    "key": k,
                    "doc_count": f_cnt,
                    "score": score,
                    "bg_count": b_cnt,
                }
                for score, k, f_cnt, b_cnt in scored[:size]
            ],
        }
    if t == "composite":
        merged: Dict[str, dict] = {}
        for p in parts:
            for bk, b in p["buckets"].items():
                cur = merged.get(bk)
                if cur is None:
                    merged[bk] = {
                        "key_values": b["key_values"],
                        "doc_count": b["doc_count"],
                        "subs": [b["subs"]],
                    }
                else:
                    cur["doc_count"] += b["doc_count"]
                    cur["subs"].append(b["subs"])
        source_names = parts[0]["source_names"] if parts else []
        size = parts[0]["size"] if parts else 10
        after = parts[0].get("after") if parts else None

        def kkey(b):
            return tuple(_sort_key(v) for v in b["key_values"])

        ordered = sorted(merged.values(), key=kkey)
        if after:
            after_tuple = tuple(
                _sort_key(after.get(nm)) for nm in source_names
            )
            ordered = [b for b in ordered if kkey(b) > after_tuple]
        page = ordered[:size]
        buckets = []
        for b in page:
            buckets.append(
                {
                    "key": dict(zip(source_names, b["key_values"])),
                    "doc_count": b["doc_count"],
                    **_reduce_subs(node, b["subs"]),
                }
            )
        out = {"buckets": buckets}
        if buckets and len(ordered) > size:
            out["after_key"] = buckets[-1]["key"]
        return out
    if t == "cardinality":
        n = 0
        for key in ("terms", "nums"):
            arrays = [np.asarray(p[key]) for p in parts if len(p[key])]
            n += len(np.unique(np.concatenate(arrays))) if arrays else 0
        return {"value": n}
    if t == "percentiles":
        vals = np.concatenate([np.asarray(p["values"]) for p in parts]) if parts else np.zeros(0)
        percents = parts[0]["percents"] if parts else [1, 5, 25, 50, 75, 95, 99]
        values = {}
        for pc in percents:
            values[f"{float(pc)}"] = (
                float(np.percentile(vals, pc)) if len(vals) else None
            )
        return {"values": values}
    if t == "terms":
        merged: Dict[Any, dict] = {}
        total = 0
        size = _int_param(node, "size", 10)
        error_bound = 0
        for p in parts:
            total += p["sum_docs"]
            error_bound += p.get("shard_error", 0)
            for bk, b in p["buckets"].items():
                cur = merged.get(bk)
                if cur is None:
                    merged[bk] = {
                        "key": b["key"],
                        "doc_count": b["doc_count"],
                        "subs": [b["subs"]],
                    }
                else:
                    cur["doc_count"] += b["doc_count"]
                    cur["subs"].append(b["subs"])
        order = _norm_order(node.params.get("order", {"_count": "desc"}))
        counts = {b["key"]: b["doc_count"] for b in merged.values()}
        ordered = _order_buckets(counts, order)[:size]
        buckets = []
        top_total = 0
        for key, cnt in ordered:
            b = merged[_bkey(key)]
            top_total += cnt
            entry = {"key": key, "doc_count": cnt}
            if isinstance(key, bool):
                entry["key"] = int(key)
                entry["key_as_string"] = "true" if key else "false"
            entry.update(_reduce_subs(node, b["subs"]))
            buckets.append(entry)
        return {
            "doc_count_error_upper_bound": error_bound,
            "sum_other_doc_count": max(total - top_total, 0),
            "buckets": buckets,
        }
    if t in ("histogram", "date_histogram"):
        merged = {}
        for p in parts:
            for bk, b in p["buckets"].items():
                cur = merged.get(bk)
                if cur is None:
                    merged[bk] = {
                        "key": b["key"],
                        "doc_count": b["doc_count"],
                        "subs": [b["subs"]],
                    }
                else:
                    cur["doc_count"] += b["doc_count"]
                    cur["subs"].append(b["subs"])
        # min_doc_count applies post-merge (a bucket may clear the bar
        # only once all shards' counts are summed)
        min_count = int(node.params.get("min_doc_count", 0))
        buckets = []
        for bk in sorted(merged):
            b = merged[bk]
            if b["doc_count"] < min_count:
                continue
            entry = {"key": b["key"], "doc_count": b["doc_count"]}
            if t == "date_histogram":
                entry["key_as_string"] = _millis_iso(b["key"])
            entry.update(_reduce_subs(node, b["subs"]))
            buckets.append(entry)
        return {"buckets": buckets}
    if t in ("range", "date_range", "geo_distance"):
        keyed = parts[0]["keyed"] if parts else False
        by_key: Dict[str, dict] = {}
        order: List[str] = []
        for p in parts:
            for b in p["buckets"]:
                cur = by_key.get(b["key"])
                if cur is None:
                    by_key[b["key"]] = {
                        **{k: v for k, v in b.items() if k != "subs"},
                        "subs": [b["subs"]],
                    }
                    order.append(b["key"])
                else:
                    cur["doc_count"] += b["doc_count"]
                    cur["subs"].append(b["subs"])
        buckets = []
        for key in order:
            b = by_key[key]
            entry = {k: v for k, v in b.items() if k != "subs"}
            if t == "date_range":
                if "from" in entry:
                    entry["from_as_string"] = _millis_iso(entry["from"])
                if "to" in entry:
                    entry["to_as_string"] = _millis_iso(entry["to"])
            entry.update(_reduce_subs(node, b["subs"]))
            buckets.append(entry)
        if keyed:
            return {
                "buckets": {
                    b["key"]: {k: v for k, v in b.items() if k != "key"}
                    for b in buckets
                }
            }
        return {"buckets": buckets}
    if t in ("filter", "missing", "sampler"):
        return {
            "doc_count": sum(p["doc_count"] for p in parts),
            **_reduce_subs(node, [p["subs"] for p in parts]),
        }
    if t == "filters":
        keyed = parts[0]["keyed"] if parts else True
        merged = {}
        for p in parts:
            for key, b in p["buckets"].items():
                cur = merged.get(key)
                if cur is None:
                    merged[key] = {
                        "key": b["key"],
                        "doc_count": b["doc_count"],
                        "subs": [b["subs"]],
                    }
                else:
                    cur["doc_count"] += b["doc_count"]
                    cur["subs"].append(b["subs"])
        if keyed:
            return {
                "buckets": {
                    key: {
                        "doc_count": m["doc_count"],
                        **_reduce_subs(node, m["subs"]),
                    }
                    for key, m in merged.items()
                }
            }
        return {
            "buckets": [
                {"doc_count": m["doc_count"], **_reduce_subs(node, m["subs"])}
                for _, m in sorted(merged.items(), key=lambda kv: int(kv[0]))
            ]
        }
    raise AggParseError(f"unknown aggregation type [{t}]")


def _reduce_subs(node: AggNode, sub_partials: List[dict]) -> dict:
    if not node.subs:
        return {}
    return reduce_aggs(
        node.subs, [p for p in sub_partials if p], in_bucket=True
    )


# ----------------------------------------------------------------------
# pipeline aggregations (reduce-time)
# ----------------------------------------------------------------------


def _bucket_path_value(bucket: dict, path: str):
    """Resolves a buckets_path tail inside ONE bucket: `_count`, a
    metric agg name, or `name.prop` (e.g. stats.avg, percentiles.50)."""
    if path == "_count":
        return bucket.get("doc_count")
    name, _, prop = path.partition(".")
    node = bucket.get(name)
    if node is None:
        return None
    if prop:
        if "values" in node and prop in node["values"]:
            return node["values"][prop]
        return node.get(prop)
    if isinstance(node, dict):
        return node.get("value")
    return node


def _sibling_pipeline(node: AggNode, reduced: dict) -> dict:
    """avg/max/min/sum/stats_bucket over a sibling multi-bucket agg
    (BucketMetricsPipelineAggregator)."""
    path = str(_req(node, "buckets_path"))
    head, _, tail = path.partition(">")
    target = reduced.get(head)
    while target is not None and ">" in tail:
        nxt, _, tail = tail.partition(">")
        target = (target or {}).get(nxt)
    if target is None or "buckets" not in target:
        raise AggParseError(
            f"buckets_path [{path}] of [{node.name}] does not point at a "
            "multi-bucket aggregation"
        )
    buckets = target["buckets"]
    if isinstance(buckets, dict):
        buckets = list(buckets.values())
    gap = node.params.get("gap_policy", "skip")
    vals = []
    for b in buckets:
        v = _bucket_path_value(b, tail or "_count")
        if v is None:
            if gap == "insert_zeros":
                vals.append(0.0)
            continue
        vals.append(float(v))
    t = node.type
    if t == "avg_bucket":
        return {"value": (sum(vals) / len(vals)) if vals else None}
    if t == "max_bucket":
        m = max(vals) if vals else None
        keys = [
            b.get("key")
            for b in buckets
            if _bucket_path_value(b, tail or "_count") == m
        ] if m is not None else []
        return {"value": m, "keys": keys}
    if t == "min_bucket":
        m = min(vals) if vals else None
        keys = [
            b.get("key")
            for b in buckets
            if _bucket_path_value(b, tail or "_count") == m
        ] if m is not None else []
        return {"value": m, "keys": keys}
    if t == "sum_bucket":
        return {"value": float(sum(vals))}
    if t == "stats_bucket":
        return {
            "count": len(vals),
            "min": min(vals) if vals else None,
            "max": max(vals) if vals else None,
            "avg": (sum(vals) / len(vals)) if vals else None,
            "sum": float(sum(vals)),
        }
    raise AggParseError(f"unknown sibling pipeline [{t}]")


def _run_pipeline_script(script, bindings: dict):
    from ..script import ScriptError, script_service

    try:
        compiled = script_service.compile(script, "field")
        return compiled.run(bindings)
    except ScriptError as e:
        raise AggParseError(str(e))


def _apply_parent_pipelines(node: AggNode, reduced: dict) -> dict:
    """Runs the node's parent-pipeline subs over its ordered reduced
    buckets (derivative, cumulative_sum, serial_diff, moving_fn,
    bucket_script, bucket_selector, bucket_sort)."""
    pipes = [s for s in node.subs if s.type in PARENT_PIPELINE_TYPES]
    if not pipes or not isinstance(reduced.get("buckets"), list):
        return reduced
    buckets: List[dict] = reduced["buckets"]
    for pipe in pipes:
        t = pipe.type
        gap = pipe.params.get("gap_policy", "skip")

        def series(path):
            out = []
            for b in buckets:
                v = _bucket_path_value(b, path)
                if v is None and gap == "insert_zeros":
                    v = 0.0
                out.append(None if v is None else float(v))
            return out

        if t in ("derivative", "cumulative_sum", "serial_diff", "moving_fn"):
            vals = series(str(_req(pipe, "buckets_path")))
            if t == "derivative":
                prev = None
                for b, v in zip(buckets, vals):
                    if prev is not None and v is not None:
                        b[pipe.name] = {"value": v - prev}
                    prev = v if v is not None else prev
            elif t == "cumulative_sum":
                run = 0.0
                for b, v in zip(buckets, vals):
                    run += v or 0.0
                    b[pipe.name] = {"value": run}
            elif t == "serial_diff":
                lag = int(pipe.params.get("lag", 1))
                for i, b in enumerate(buckets):
                    if i >= lag and vals[i] is not None and vals[i - lag] is not None:
                        b[pipe.name] = {"value": vals[i] - vals[i - lag]}
            else:  # moving_fn
                window = int(_req(pipe, "window"))
                script = _req(pipe, "script")
                shift = int(pipe.params.get("shift", 0))
                for i, b in enumerate(buckets):
                    lo = i - window + shift
                    hi = i + shift
                    win = [
                        v for v in vals[max(0, lo):max(0, hi)]
                        if v is not None
                    ]
                    out = _run_pipeline_script(
                        script,
                        {"values": win, "MovingFunctions": _MovingFunctions},
                    )
                    if out is not None:
                        b[pipe.name] = {"value": float(out)}
        elif t in ("bucket_script", "bucket_selector"):
            paths = _req(pipe, "buckets_path")
            if not isinstance(paths, dict):
                raise AggParseError(
                    f"[{t}] buckets_path must be an object of name → path"
                )
            script = _req(pipe, "script")
            kept = []
            for b in buckets:
                bindings = {}
                missing = False
                for var, path in paths.items():
                    v = _bucket_path_value(b, str(path))
                    if v is None:
                        if gap == "insert_zeros":
                            v = 0.0
                        else:
                            missing = True
                            break
                    bindings[var] = float(v)
                if missing:
                    if t == "bucket_selector":
                        continue  # gap skip drops the bucket from selection
                    kept.append(b)
                    continue
                out = _run_pipeline_script(script, bindings)
                if t == "bucket_script":
                    if out is not None:
                        b[pipe.name] = {"value": float(out)}
                    kept.append(b)
                else:  # bucket_selector
                    if bool(out):
                        kept.append(b)
            if t == "bucket_selector":
                buckets[:] = kept
        elif t == "bucket_sort":
            sort = pipe.params.get("sort") or []
            frm = int(pipe.params.get("from", 0))
            size = pipe.params.get("size")

            def sort_key(b):
                keys = []
                for s in sort:
                    if isinstance(s, str):
                        path, order = s, "asc"
                    else:
                        path, spec = next(iter(s.items()))
                        order = (
                            spec.get("order", "asc")
                            if isinstance(spec, dict)
                            else str(spec)
                        )
                    v = _bucket_path_value(b, path)
                    v = float("-inf") if v is None else float(v)
                    keys.append(-v if order == "desc" else v)
                return tuple(keys)

            if sort:
                buckets.sort(key=sort_key)
            end = None if size is None else frm + int(size)
            buckets[:] = buckets[frm:end]
    return reduced


class _MovingFunctions:
    """MovingFunctions surface for moving_fn scripts."""

    @staticmethod
    def max(values):
        return max(values) if values else None

    @staticmethod
    def min(values):
        return min(values) if values else None

    @staticmethod
    def sum(values):
        return float(sum(values)) if values else 0.0

    @staticmethod
    def unweightedAvg(values):
        return (float(sum(values)) / len(values)) if values else None

    @staticmethod
    def stdDev(values, avg=None):
        if not values:
            return None
        m = avg if avg is not None else sum(values) / len(values)
        return float(np.sqrt(sum((v - m) ** 2 for v in values) / len(values)))


# ----------------------------------------------------------------------
# shared helpers
# ----------------------------------------------------------------------


def _bkey(key: Any) -> str:
    return f"{type(key).__name__}:{key}"


def _order_buckets(counts: Dict[Any, int], order: dict) -> List[tuple]:
    (okey, direction), *_ = list(order.items()) or [("_count", "desc")]
    if okey not in ("_count", "_key"):
        raise AggParseError(
            f"ordering by [{okey}] is not supported "
            "(only _count and _key in this build)"
        )
    reverse = direction == "desc"
    items = list(counts.items())
    if okey == "_key":
        items.sort(key=lambda kv: _sort_key(kv[0]), reverse=reverse)
    else:  # _count, tie-break key asc (Lucene order)
        items.sort(key=lambda kv: _sort_key(kv[0]))
        items.sort(key=lambda kv: kv[1], reverse=reverse)
    return items


def _req_param(params: dict, name: str, node: AggNode):
    v = params.get(name)
    if v is None:
        raise AggParseError(
            f"[{node.type}] agg [{node.name}] source requires [{name}]"
        )
    return v


def _req(node: AggNode, name: str):
    v = node.params.get(name)
    if v is None:
        raise AggParseError(f"[{node.type}] agg [{node.name}] requires [{name}]")
    return v


def _int_param(node: AggNode, name: str, default: int) -> int:
    try:
        return int(node.params.get(name, default))
    except (TypeError, ValueError):
        raise AggParseError(
            f"[{node.type}] agg [{node.name}]: [{name}] must be an integer"
        )


def _float_param(value, node: AggNode, name: str) -> float:
    try:
        return float(value)
    except (TypeError, ValueError):
        raise AggParseError(
            f"[{node.type}] agg [{node.name}]: [{name}] must be numeric"
        )


def _norm_order(order) -> dict:
    """ES accepts both {"_count": "desc"} and [{"_count": "desc"}, ...];
    multi-criteria lists use the first criterion (tie-breaks beyond it
    are fixed: key asc)."""
    if isinstance(order, list):
        if not order or not isinstance(order[0], dict):
            raise AggParseError("order list must contain objects")
        return order[0]
    if not isinstance(order, dict):
        raise AggParseError("order must be an object or list of objects")
    return order


def _sort_key(k: Any):
    # normalize mixed bool/int/float keys; strings sort as strings
    if isinstance(k, bool):
        return (0, int(k))
    if isinstance(k, (int, float)):
        return (0, float(k))
    return (1, str(k))


_CAL_UNITS = {
    "minute": 60_000,
    "1m": 60_000,
    "hour": 3_600_000,
    "1h": 3_600_000,
    "day": 86_400_000,
    "1d": 86_400_000,
    "week": 7 * 86_400_000,
    "1w": 7 * 86_400_000,
}
_FIXED_SUFFIX = {
    "ms": 1,
    "s": 1000,
    "m": 60_000,
    "h": 3_600_000,
    "d": 86_400_000,
}


def _parse_dh_interval(params: dict):
    """Returns (interval_ms or None, calendar_unit or None)."""
    cal = params.get("calendar_interval")
    if cal is not None:
        if cal in ("month", "1M"):
            return None, "month"
        if cal in ("quarter", "1q"):
            return None, "quarter"
        if cal in ("year", "1y"):
            return None, "year"
        if cal in _CAL_UNITS:
            return _CAL_UNITS[cal], None
        raise AggParseError(f"unknown calendar interval [{cal}]")
    fixed = params.get("fixed_interval") or params.get("interval")
    if fixed is None:
        raise AggParseError("date_histogram requires an interval")
    s = str(fixed)
    for suffix in ("ms", "s", "m", "h", "d"):
        if s.endswith(suffix):
            try:
                return int(s[: -len(suffix)]) * _FIXED_SUFFIX[suffix], None
            except ValueError:
                break
    raise AggParseError(f"unparsable interval [{fixed}]")


def _date_bucket_keys(
    millis: np.ndarray, calendar_unit: Optional[str], interval_ms: Optional[int]
) -> np.ndarray:
    if calendar_unit is None:
        assert interval_ms is not None
        return (np.floor(millis / interval_ms) * interval_ms).astype(np.int64)
    # calendar month/quarter/year: bucket start at UTC boundary
    out = np.zeros(len(millis), np.int64)
    for i, ms in enumerate(millis):
        dt = datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)
        if calendar_unit == "month":
            b = dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        elif calendar_unit == "quarter":
            b = dt.replace(
                month=((dt.month - 1) // 3) * 3 + 1,
                day=1,
                hour=0,
                minute=0,
                second=0,
                microsecond=0,
            )
        else:  # year
            b = dt.replace(
                month=1, day=1, hour=0, minute=0, second=0, microsecond=0
            )
        out[i] = int(b.timestamp() * 1000)
    return out


def _millis_iso(ms: float) -> str:
    dt = datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


def _range_key_part(raw, is_date: bool, parsed) -> str:
    if raw is None:
        return "*"
    if is_date:
        return str(raw)
    return f"{float(parsed)}"
