"""The port's sorted collection against the JAX package's, on the CPU.

The same documents go into the port's `IndexService` (`device="cpu"`),
the JAX package's with `search.backend: jax` and with `numpy`. A single
numeric, date or bool sort key collects through
`TorchExecutor.execute_sorted_device` (rank columns, one top-k per
segment, one packed download); every other sort (multi-key, keyword,
`_id`, `_score`, a `missing` override) takes the oracle's
`execute_sorted`, as the reference routes it. Pages must be equal id
for id, with the same sort values and the same totals. Date sorts at
millisecond boundaries are held to the numpy backend (the reference's
`JaxExecutor` keeps date doc values in float32; its sort ranks are built
from the host's float64 values, so it agrees there too, but the
millisecond cases are the numpy oracle's to decide).
"""

import json
import urllib.request

import numpy as np
import pytest

from elasticsearch_tpu.cluster.indices import IndexService as JIndexService

from elasticsearch_tpu_torch.cluster.indices import IndexService
from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
COLORS = ["red", "green", "blue", "black"]
DAY0 = 1_700_000_000_000
MAPPING = {
    "properties": {
        "body": {"type": "text"},
        "rank": {"type": "integer"},
        "ts": {"type": "date"},
        "score_f": {"type": "float"},
        "flag": {"type": "boolean"},
        "color": {"type": "keyword"},
    }
}


def make_docs(n_docs, seed):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n_docs):
        doc = {
            "body": " ".join(rng.choice(WORDS, size=int(rng.integers(2, 6)))),
            "color": str(rng.choice(COLORS)),
            "flag": bool(rng.random() < 0.5),
            "score_f": float(np.round(rng.random() * 10, 3)),
        }
        if rng.random() > 0.1:  # some docs miss the sort fields
            doc["rank"] = int(rng.integers(0, 500))  # ties across docs
            # date millis beyond float32 precision
            doc["ts"] = int(DAY0 + rng.integers(0, 10**10))
        docs.append((str(i), doc))
    return docs


def fill(svc, docs, deletes=()):
    half = len(docs) // 2
    for part in (docs[:half], docs[half:]):  # two segments per shard
        for doc_id, src in part:
            svc.index_doc(doc_id, dict(src))
        svc.refresh()
    for doc_id in deletes:
        svc.delete_doc(doc_id)
    if deletes:
        svc.refresh()
    return svc


@pytest.fixture(scope="module")
def services():
    docs = make_docs(400, seed=5)
    dels = [str(i) for i in range(0, 400, 23)]
    settings = {"number_of_shards": 2}
    port = fill(IndexService("srt", settings=settings, mappings_json=MAPPING, device="cpu"), docs, dels)
    jx = fill(JIndexService("srt-j", settings={**settings, "search.backend": "jax"}, mappings_json=MAPPING),
              docs, dels)
    nps = fill(JIndexService("srt-n", settings={**settings, "search.backend": "numpy"}, mappings_json=MAPPING),
               docs, dels)
    yield port, jx, nps
    for s in (port, jx, nps):
        s.close()


@pytest.fixture
def device_route(monkeypatch):
    """Records what each execute_sorted_device call returned (None: the
    body took the oracle's route)."""
    seen = []
    plain = TorchExecutor.execute_sorted_device

    def spy(self, *a, **kw):
        out = plain(self, *a, **kw)
        seen.append(out is not None)
        return out

    monkeypatch.setattr(TorchExecutor, "execute_sorted_device", spy)
    return seen


def page(svc, body):
    r = svc.search(json.loads(json.dumps(body)))
    return [(h["_id"], h.get("sort")) for h in r["hits"]["hits"]], r["hits"]["total"]


DEVICE_BODIES = {
    "rank_asc": {"query": {"match": {"body": "alpha"}}, "sort": [{"rank": {"order": "asc"}}], "size": 15},
    "rank_desc": {"query": {"match": {"body": "alpha"}}, "sort": [{"rank": {"order": "desc"}}], "size": 15},
    "ts_desc": {"query": {"match_all": {}}, "sort": [{"ts": {"order": "desc"}}], "size": 20},
    "ts_asc": {"query": {"match_all": {}}, "sort": [{"ts": "asc"}], "size": 20},
    "no_query": {"sort": [{"rank": "asc"}], "size": 25},
    "float_desc": {"query": {"term": {"color": "red"}}, "sort": [{"score_f": "desc"}], "size": 12},
    "bool_asc": {"query": {"match": {"body": "beta gamma"}}, "sort": [{"flag": "asc"}], "size": 30},
    "missing_last": {"query": {"match": {"body": "zeta"}}, "sort": [{"rank": {"order": "asc", "missing": "_last"}}],
                     "size": 400},
    "bool_filter": {"query": {"bool": {"must": [{"match": {"body": "delta"}}],
                                        "filter": [{"range": {"rank": {"gte": 100}}}]}},
                    "sort": [{"ts": "desc"}], "size": 10},
}
ORACLE_BODIES = {
    "multi_key": {"query": {"match_all": {}}, "sort": [{"rank": "asc"}, {"ts": "desc"}], "size": 10},
    "keyword": {"query": {"match": {"body": "alpha"}}, "sort": [{"color": "asc"}], "size": 10},
    "id": {"query": {"match": {"body": "alpha"}}, "sort": [{"_id": "asc"}], "size": 10},
    "score": {"query": {"match": {"body": "alpha beta"}}, "sort": ["_score"], "size": 10},
    "missing_first": {"query": {"match_all": {}}, "sort": [{"rank": {"order": "desc", "missing": "_first"}}],
                      "size": 50},
}


@pytest.mark.parametrize("name", sorted(DEVICE_BODIES))
def test_device_sort_matches_both_references(services, device_route, name):
    port, jx, nps = services
    body = DEVICE_BODIES[name]
    got = page(port, body)
    assert got == page(nps, body)
    assert got == page(jx, body)
    assert device_route and all(device_route), "a single numeric key left the device route"


@pytest.mark.parametrize("name", sorted(ORACLE_BODIES))
def test_other_sorts_take_the_oracle_route(services, device_route, name):
    port, jx, nps = services
    body = ORACLE_BODIES[name]
    got = page(port, body)
    assert got == page(nps, body)
    if name != "score":  # _score values are float32 on jax, float64 on the oracle
        assert got == page(jx, body)
    assert not any(device_route)


@pytest.mark.parametrize("field,order", [("ts", "desc"), ("ts", "asc"), ("rank", "asc"), ("rank", "desc")])
def test_search_after_pagination(services, field, order):
    """Pages through search_after in value space (ties with the cursor
    skipped, as the oracle does); every page's total is the full match
    count."""
    port, jx, nps = services
    body = {"query": {"match_all": {}}, "sort": [{field: {"order": order}}], "size": 37}
    after = {"p": None, "j": None, "n": None}
    seen = []
    for _ in range(15):
        pages = {}
        for key, svc in (("p", port), ("j", jx), ("n", nps)):
            b = dict(body)
            if after[key] is not None:
                b["search_after"] = after[key]
            pages[key] = page(svc, b)
        assert pages["p"] == pages["n"] == pages["j"]
        hits = pages["p"][0]
        if not hits or hits[-1][1] == [None]:
            break
        seen.extend(h for h, _ in hits)
        for key in after:
            after[key] = pages[key][0][-1][1]
    assert len(seen) == len(set(seen)) and len(seen) > 37


def test_date_sort_at_millisecond_boundaries(device_route):
    """Dates 1 ms apart (float32 spacing near 1.7e12 ms is 131,072 ms):
    the order, the sort values and a search_after cursor at an odd
    millisecond all equal the numpy oracle's."""
    mapping = {"properties": {"day": {"type": "date"}, "body": {"type": "text"}}}
    rng = np.random.default_rng(3)
    offsets = rng.permutation(np.arange(0, 90, 3))
    docs = [(f"m{i}", {"day": int(DAY0 + 86_400_000 + o), "body": "alpha" if i % 3 else "alpha beta"})
            for i, o in enumerate(offsets)]
    docs.append(("nod", {"body": "alpha"}))  # a doc without the field
    port = fill(IndexService("ms", mappings_json=mapping, device="cpu"), docs)
    nps = fill(JIndexService("ms-n", settings={"search.backend": "numpy"}, mappings_json=mapping), docs)
    try:
        for order in ("asc", "desc"):
            for after in (None, [DAY0 + 86_400_000 + 31], [DAY0 + 86_400_000 + 45]):
                body = {"query": {"match": {"body": "alpha"}}, "sort": [{"day": order}], "size": 12}
                if after is not None:
                    body["search_after"] = after
                got = page(port, body)
                assert got == page(nps, body)
                vals = [s[0] for _, s in got[0] if s[0] is not None]
                assert vals == sorted(vals, reverse=order == "desc") and len(set(vals)) == len(vals)
        assert all(device_route)
    finally:
        port.close()
        nps.close()


def test_numeric_sort_serves_over_rest():
    """A numeric `sort` on the torch backend answers 200 with the sort
    values, where it used to be a 501."""
    from elasticsearch_tpu_torch.rest.server import ElasticsearchTpuServer

    srv = ElasticsearchTpuServer(port=0, device="cpu")
    srv.start_background()
    try:
        def call(method, path, body=None, ndjson=None):
            data = (json.dumps(body).encode() if ndjson is None
                    else "".join(json.dumps(x) + "\n" for x in ndjson).encode())
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}{path}", data=data if (body or ndjson) else None,
                method=method, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())

        call("PUT", "/s", {"mappings": MAPPING})
        lines = []
        for doc_id, src in make_docs(60, seed=9):
            lines += [{"index": {"_id": doc_id}}, src]
        call("POST", "/s/_bulk?refresh=true", ndjson=lines)
        status, out = call("POST", "/s/_search", {"query": {"match_all": {}}, "sort": [{"rank": "desc"}], "size": 5})
        assert status == 200
        vals = [h["sort"][0] for h in out["hits"]["hits"]]
        assert len(vals) == 5 and vals == sorted(vals, reverse=True)
        assert out["hits"]["total"]["value"] == 60
    finally:
        srv.close()
