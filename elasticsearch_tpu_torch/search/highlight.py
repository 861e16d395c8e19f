"""Highlighting: query-term fragments over stored _source text.

Reference analog: the highlight fetch sub-phase
(server/.../search/fetch/subphase/highlight/ — HighlightPhase with the
`unified` highlighter default, UnifiedHighlighter via Lucene). The
TPU-native engine stores no term vectors; like the unified highlighter's
re-analysis mode, the field's stored text is re-analyzed at fetch time,
matching tokens are located by their character offsets, and fragments of
~fragment_size characters are cut around match runs.

Term extraction walks the parsed query tree per field (the
WeightedSpanTermExtractor analog), including multi-term expansions
(prefix/wildcard/regexp/fuzzy are expanded against the segment term
dictionary by the caller's executor, so here we accept plain term sets).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from . import dsl
from .executor import expand_match_fields


def extract_highlight_terms(
    query: Optional[dsl.Query], mappings, analysis
) -> Dict[str, Set[str]]:
    """field → analyzed query terms that should highlight."""
    out: Dict[str, Set[str]] = {}

    def add(field: str, terms) -> None:
        out.setdefault(field, set()).update(terms)

    def analyzed(field: str, text: str) -> List[str]:
        mf = mappings.get(field)
        name = (mf.search_analyzer or mf.analyzer) if mf is not None else "standard"
        try:
            return analysis.get(name).terms(str(text))
        except ValueError:
            return [str(text)]

    def walk(q: Optional[dsl.Query]) -> None:
        if q is None:
            return
        if isinstance(q, dsl.MatchQuery):
            add(q.field, analyzed(q.field, q.query))
        elif isinstance(q, dsl.MatchPhraseQuery):
            add(q.field, analyzed(q.field, q.query))
        elif isinstance(q, dsl.TermQuery):
            add(q.field, [str(q.value).lower() if isinstance(q.value, str) else str(q.value)])
        elif isinstance(q, dsl.TermsQuery):
            add(q.field, [str(v) for v in q.values])
        elif isinstance(q, dsl.MultiMatchQuery):
            for fname, _ in expand_match_fields(mappings, q.fields):
                add(fname, analyzed(fname, q.query))
        elif isinstance(q, (dsl.PrefixQuery, dsl.WildcardQuery, dsl.RegexpQuery, dsl.FuzzyQuery)):
            # marker: caller may expand against the dictionary; highlight
            # the raw value as a best effort
            add(q.field, [q.value.lower()])
        elif isinstance(q, dsl.BoolQuery):
            for sub in list(q.must) + list(q.should):
                walk(sub)
            # filter/must_not clauses don't contribute highlights (ES:
            # only scoring clauses are extracted by default)
        elif isinstance(q, dsl.DisMaxQuery):
            for sub in q.queries:
                walk(sub)
        elif isinstance(q, dsl.BoostingQuery):
            walk(q.positive)
        elif isinstance(q, dsl.ConstantScoreQuery):
            walk(q.filter_query)
        elif isinstance(q, dsl.FunctionScoreQuery):
            walk(q.query)
        elif isinstance(q, dsl.QueryStringQuery):
            from .executor import rewrite_query_string

            walk(rewrite_query_string(q, mappings))

    walk(query)
    return out


def parse_highlight(body: dict) -> dict:
    """Normalizes the request's "highlight" object."""
    fields = body.get("fields")
    if not isinstance(fields, dict):
        raise dsl.QueryParseError("[highlight] requires [fields]")
    defaults = {
        "pre_tags": body.get("pre_tags", ["<em>"]),
        "post_tags": body.get("post_tags", ["</em>"]),
        "fragment_size": int(body.get("fragment_size", 100)),
        "number_of_fragments": int(body.get("number_of_fragments", 5)),
    }
    specs = {}
    for fname, cfg in fields.items():
        cfg = cfg or {}
        specs[fname] = {
            "pre": (cfg.get("pre_tags") or defaults["pre_tags"])[0],
            "post": (cfg.get("post_tags") or defaults["post_tags"])[0],
            "fragment_size": int(
                cfg.get("fragment_size", defaults["fragment_size"])
            ),
            "number_of_fragments": int(
                cfg.get("number_of_fragments", defaults["number_of_fragments"])
            ),
        }
    return specs


def highlight_field(
    text: str,
    terms: Set[str],
    analyzer,
    pre: str,
    post: str,
    fragment_size: int,
    number_of_fragments: int,
) -> List[str]:
    """Highlighted fragments for one field value (unified-style)."""
    if not text or not terms:
        return []
    tokens = analyzer.analyze(text)
    matches = [t for t in tokens if t.text in terms]
    if not matches:
        return []
    if number_of_fragments == 0:
        # whole-field highlighting
        return [_tag(text, matches, pre, post)]
    # group matches into fragments of ~fragment_size characters
    fragments: List[List] = []
    for m in matches:
        if fragments and m.start_offset - fragments[-1][0].start_offset < fragment_size:
            fragments[-1].append(m)
        else:
            fragments.append([m])
    out = []
    for group in fragments[:number_of_fragments]:
        first, last = group[0], group[-1]
        # expand the window to fragment_size, snapping to whitespace
        lo = max(0, first.start_offset - max(0, (fragment_size - (last.end_offset - first.start_offset)) // 2))
        hi = min(len(text), lo + max(fragment_size, last.end_offset - lo))
        if lo > 0:
            ws = text.rfind(" ", 0, lo + 1)
            lo = ws + 1 if ws >= 0 and lo - ws <= 20 else lo
        if hi < len(text):
            ws = text.find(" ", hi - 1)
            hi = ws if ws >= 0 and ws - hi <= 20 else hi
        frag = text[lo:hi]
        shifted = [
            t._replace(start_offset=t.start_offset - lo, end_offset=t.end_offset - lo)
            for t in group
            if t.start_offset >= lo and t.end_offset <= hi
        ]
        out.append(_tag(frag, shifted, pre, post))
    return out


def _tag(text: str, matches, pre: str, post: str) -> str:
    out = []
    cursor = 0
    for m in sorted(matches, key=lambda t: t.start_offset):
        if m.start_offset < cursor:
            continue  # overlapping token (ngrams); skip
        out.append(text[cursor : m.start_offset])
        out.append(pre)
        out.append(text[m.start_offset : m.end_offset])
        out.append(post)
        cursor = m.end_offset
    out.append(text[cursor:])
    return "".join(out)
