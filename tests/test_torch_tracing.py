"""The port's request tracing (`common/tracing.py`): one `_search` over
HTTP is one span tree, from the body read to the response's last byte,
unbroken across the batcher's worker thread, on CLOCK_MONOTONIC; the
`_nodes/stats` `pipeline` counters `host_syncs` and `host_stall_ms`
count the downloads the workers wait in (`ops/scoring.py` `download`).

Every test runs on the CPU and, with the `cuda` marker, on the card
(skipped without one). The module imports neither jax nor the JAX
package: on the card, `python -m pytest --noconftest -m cuda
tests/test_torch_tracing.py`.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import scoring
from elasticsearch_tpu_torch.rest.server import ElasticsearchTpuServer

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
N_DOCS = 300
DIMS = 8
# "common" is in every doc, so it is a hot term of the segment's one
# block; totals capped at 5 let the chunked path defer it to the
# threshold round (two downloads: threshold, merge_topk)
MATCH = {"query": {"match": {"body": "common rare3"}}, "track_total_hits": 5}
KNN = {"knn": {"field": "vec", "query_vector": [0.5, -1.0, 0.25, 2.0, 0.0, 1.0, -0.5, 0.75],
               "k": 5, "num_candidates": 20}}


def call(srv, method, path, body=None, raw=None):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=data, method=method,
        headers={"Content-Type": "application/x-ndjson" if raw else "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def make_index(srv, name):
    call(srv, "PUT", f"/{name}", {
        "settings": {"number_of_shards": 1, "search.backend": "torch"},
        "mappings": {"properties": {
            "body": {"type": "text"},
            "vec": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"}}}})
    rng = np.random.default_rng(7)
    lines = []
    for i in range(N_DOCS):
        lines.append(json.dumps({"index": {"_index": name, "_id": str(i)}}))
        lines.append(json.dumps({"body": f"common w{i % 7} rare{i}",
                                 "vec": rng.standard_normal(DIMS).round(3).tolist()}))
    call(srv, "POST", "/_bulk?refresh=true", raw=("\n".join(lines) + "\n").encode())
    b = srv.cluster.get_index(name)._batcher
    # bucket warm-up launches run after a group's waiters wake: none here
    b.warmup_enabled = False
    return b


@pytest.fixture(scope="module", params=DEVICES)
def srv(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    s = ElasticsearchTpuServer(port=0, device=request.param)
    s.start_background()
    make_index(s, "tr")
    # the first searches build the executor and its scorers
    call(s, "POST", "/tr/_search", MATCH)
    call(s, "POST", "/tr/_search", KNN)
    yield s
    s.close()


def pipeline(srv):
    node = next(iter(call(srv, "GET", "/_nodes/stats")["nodes"].values()))
    return node["pipeline"], node["thread_pool"]["search"]


def traced(srv, body, index="tr"):
    """(response, its one trace, monotonic_ns marks: before the request,
    when the response is held, after the trace was found)."""
    call(srv, "DELETE", "/_internal/traces")
    t0 = time.monotonic_ns()
    resp = call(srv, "POST", f"/{index}/_search", body)
    t1 = time.monotonic_ns()
    # the server closes `http.write` and `http` and enters the trace after
    # the response's last byte is written, so the client may hold the
    # response first: wait for the trace
    deadline = time.monotonic() + 5.0
    out = call(srv, "GET", "/_internal/traces")
    while out["count"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
        out = call(srv, "GET", "/_internal/traces")
    t2 = time.monotonic_ns()
    assert out["clock"] == "CLOCK_MONOTONIC"
    assert out["count"] == 1, [t["name"] for t in out["traces"]]
    return resp, out["traces"][0], (t0, t1, t2)


def by_name(trace, name):
    return [s for s in trace["spans"] if s["name"] == name]


def one(trace, name):
    spans = by_name(trace, name)
    assert len(spans) == 1, (name, spans)
    return spans[0]


def end(s):
    return s["start_ns"] + s["duration_ns"]


# the spans that close after the response's last byte is written
AFTER_WRITE = ("http", "http.write")


def check_tree(trace, marks):
    """One root, `http`; every span inside its parent and inside the
    call's own monotonic marks: it starts after the request was sent and
    ends before the client held the response, or, for AFTER_WRITE, before
    the trace was found."""
    t0, t1, t2 = marks
    spans = {s["id"]: s for s in trace["spans"]}
    assert trace["dropped_spans"] == 0
    roots = [s for s in spans.values() if s["parent_id"] is None]
    assert [s["name"] for s in roots] == ["http"]
    for s in spans.values():
        assert t0 <= s["start_ns"] <= end(s) <= (t2 if s["name"] in AFTER_WRITE else t1), s
        if s["parent_id"] is not None:
            p = spans[s["parent_id"]]
            assert p["start_ns"] <= s["start_ns"] and end(s) <= end(p), (s, p)
    return spans


def hits(resp):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


def test_chunked_match_is_one_tree_across_the_worker(srv):
    resp, tr, marks = traced(srv, MATCH)
    assert hits(resp) and tr["name"] == "search" and tr["tags"]["index"] == "tr"
    spans = check_tree(tr, marks)
    http = one(tr, "http")
    for name in ("http.read", "http.decode", "search", "http.encode", "http.write"):
        assert one(tr, name)["parent_id"] == http["id"]
    assert one(tr, "http.write")["tags"]["writes"] == 2
    search = one(tr, "search")
    coord = one(tr, "coordinator")
    assert coord["parent_id"] == search["id"]
    fan = one(tr, "fan_out")
    shard = one(tr, "shard_search")
    assert fan["parent_id"] == coord["id"] and shard["parent_id"] == fan["id"]
    # the fan-out pool's handoffs, before and after the shard
    queued, woken = one(tr, "fanout.queue"), one(tr, "fanout.wake")
    assert queued["parent_id"] == fan["id"] == woken["parent_id"]
    assert end(queued) <= shard["start_ns"] and end(shard) <= woken["start_ns"]
    for name in ("batcher.queue", "batcher.dispatch", "batcher.wake"):
        assert one(tr, name)["parent_id"] == shard["id"]
    assert one(tr, "batcher.queue")["tags"]["worker"].startswith("query-batcher-")
    dispatch = one(tr, "batcher.dispatch")
    assert dispatch["tags"] == {"jobs": 1, "family": "text", "route": "chunked", "rows": 1}
    for name in ("chunked.plan", "chunked.survive", "batcher.hits"):
        assert one(tr, name)["parent_id"] == dispatch["id"]
    assert [s["parent_id"] for s in by_name(tr, "chunked.score")] == [dispatch["id"]] * 2
    waits = by_name(tr, "device.wait")
    assert sorted(w["tags"]["site"] for w in waits) == ["merge_topk", "threshold"]
    assert all(w["parent_id"] == dispatch["id"] and w["tags"]["bytes"] > 0 for w in waits)
    # the worker's spans come in order: queued, dispatched, woken
    assert end(one(tr, "batcher.queue")) <= dispatch["start_ns"]
    assert end(dispatch) <= one(tr, "batcher.wake")["start_ns"]
    assert len(spans) == len(tr["spans"])


def test_chunked_pass_is_one_call(srv, monkeypatch):
    """A pass of more than 512 tiles (520 one-tile terms) makes one call
    to the shared pass body `tile_pass` with the BM25 source;
    `chunked_launches` counts its launches (the plain version's one pass
    on the CPU, the kernel's windows on the card) and the pass's
    `chunked.score` span carries them."""
    from elasticsearch_tpu_torch.ops import ordered_scatter as osc

    n = 600
    if "wide" not in srv.cluster.indices:
        call(srv, "PUT", "/wide", {"settings": {"number_of_shards": 1, "search.backend": "torch"},
                                   "mappings": {"properties": {"body": {"type": "text"}}}})
        lines = []
        for i in range(n):
            lines.append(json.dumps({"index": {"_index": "wide", "_id": str(i)}}))
            lines.append(json.dumps({"body": f"u{i} filler"}))
        call(srv, "POST", "/_bulk?refresh=true", raw=("\n".join(lines) + "\n").encode())
        srv.cluster.get_index("wide")._batcher.warmup_enabled = False
    body = {"query": {"match": {"body": " ".join(f"u{i}" for i in range(520))}}}
    call(srv, "POST", "/wide/_search", body)  # builds the executor and its scorers
    real, calls = scoring.tile_pass, []

    def spy(source, acc, cnt, planes, tile_lists, weight_lists):
        calls.append((source, acc.device.type, acc.shape[-1], [len(t) for t in tile_lists]))
        return real(source, acc, cnt, planes, tile_lists, weight_lists)

    monkeypatch.setattr(scoring, "tile_pass", spy)
    _, s0 = pipeline(srv)
    resp, tr, _ = traced(srv, body, index="wide")
    _, s1 = pipeline(srv)
    assert resp["hits"]["total"]["value"] == 520
    (score,) = by_name(tr, "chunked.score")
    (source, device, cells, lens), = calls
    assert source is scoring.BM25_TILES
    assert score["tags"]["tiles"] == 520 and lens == [520] and cells == n + 1
    want = 1 if device == "cpu" else osc.tile_layout(cells, lens).windows
    assert score["tags"]["launches"] == want
    assert s1["chunked_jobs"] - s0["chunked_jobs"] == 1
    assert s1["chunked_launches"] - s0["chunked_launches"] == want


def test_knn_collect_and_wake(srv):
    resp, tr, marks = traced(srv, KNN)
    assert len(hits(resp)) == 5
    check_tree(tr, marks)
    shard = one(tr, "shard_search")
    dispatch, collect = one(tr, "batcher.dispatch"), one(tr, "batcher.collect")
    assert dispatch["parent_id"] == shard["id"] == collect["parent_id"]
    assert dispatch["tags"]["family"] == "knn" and collect["tags"] == {"jobs": 1, "family": "knn"}
    assert end(dispatch) <= collect["start_ns"]
    (wait,) = by_name(tr, "device.wait")
    assert wait["tags"]["site"] == "knn_merge_topk" and wait["parent_id"] == collect["id"]
    assert one(tr, "batcher.hits")["parent_id"] == collect["id"]
    assert end(collect) <= one(tr, "batcher.wake")["start_ns"]


def test_tracing_off_records_nothing_and_answers_the_same(srv, monkeypatch):
    on = [call(srv, "POST", "/tr/_search", b) for b in (MATCH, KNN)]
    call(srv, "DELETE", "/_internal/traces")
    monkeypatch.setenv("ES_TPU_TRACING", "off")
    off = [call(srv, "POST", "/tr/_search", b) for b in (MATCH, KNN)]
    out = call(srv, "GET", "/_internal/traces")
    assert out["enabled"] is False and out["count"] == 0
    assert [hits(r) for r in off] == [hits(r) for r in on]
    assert [r["hits"]["total"] for r in off] == [r["hits"]["total"] for r in on]


def test_host_syncs_per_job(srv):
    p0, s0 = pipeline(srv)
    call(srv, "POST", "/tr/_search", MATCH)
    p1, s1 = pipeline(srv)
    call(srv, "POST", "/tr/_search", KNN)
    p2, s2 = pipeline(srv)
    assert s1["completed"] - s0["completed"] == 1 and s2["completed"] - s1["completed"] == 1
    assert s1["chunked_jobs"] - s0["chunked_jobs"] == 1
    assert p1["host_syncs"] - p0["host_syncs"] == 2
    assert p2["host_syncs"] - p1["host_syncs"] == 1


def test_host_stall_is_the_device_waits(srv, monkeypatch):
    """`host_stall_ms` sums the `device.wait` spans, and time spent in a
    merge call outside its download is no stall."""
    merge = scoring._merge_segments

    def slow_merge(*a, **kw):
        time.sleep(0.05)
        return merge(*a, **kw)

    monkeypatch.setattr(scoring, "_merge_segments", slow_merge)
    p0, _ = pipeline(srv)
    _, tr, _ = traced(srv, MATCH)
    p1, _ = pipeline(srv)
    waits = by_name(tr, "device.wait")
    assert p1["host_syncs"] - p0["host_syncs"] == len(waits) == 2
    stall_ms = p1["host_stall_ms"] - p0["host_stall_ms"]
    assert stall_ms == pytest.approx(sum(w["duration_ns"] for w in waits) * 1e-6, abs=3e-3)
    assert stall_ms < 50.0 <= one(tr, "batcher.dispatch")["duration_ns"] * 1e-6


def test_profile_entries_are_the_span_durations(srv):
    resp, tr, _ = traced(srv, dict(MATCH, profile=True))
    fam = resp["profile"]["shards"][0]["families"]["match"]
    assert fam["queue_wait_ns"] == one(tr, "batcher.queue")["duration_ns"]
    assert fam["dispatch_ns"] == one(tr, "batcher.dispatch")["duration_ns"]
    assert fam["collect_ns"] == 0
    resp, tr, _ = traced(srv, dict(KNN, profile=True))
    fam = resp["profile"]["shards"][0]["families"]["knn"]
    assert fam["queue_wait_ns"] == one(tr, "batcher.queue")["duration_ns"]
    assert fam["dispatch_ns"] == one(tr, "batcher.dispatch")["duration_ns"]
    assert fam["collect_ns"] == one(tr, "batcher.collect")["duration_ns"]


def test_shared_group_span_in_every_member_trace(srv, monkeypatch):
    """Four kNN requests queued before the one worker starts share one
    group: its dispatch and collect spans, tagged jobs=4, are in each
    request's trace."""
    n = 4
    b = make_index(srv, "grp")
    start = b._ensure_thread
    monkeypatch.setattr(b, "_ensure_thread", lambda: None)
    b.workers = 1
    call(srv, "DELETE", "/_internal/traces")
    out = [None] * n

    def one_request(i):
        out[i] = call(srv, "POST", "/grp/_search", KNN)

    threads = [threading.Thread(target=one_request, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while b._queue.qsize() < n:
        assert time.monotonic() < deadline, "the requests never queued"
        time.sleep(0.01)
    start()
    for t in threads:
        t.join(120)
    assert all(len(hits(r)) == 5 for r in out)
    traces = call(srv, "GET", "/_internal/traces")["traces"]
    assert len(traces) == n
    for name in ("batcher.dispatch", "batcher.collect"):
        spans = [one(tr, name) for tr in traces]
        assert all(s["tags"]["jobs"] == n for s in spans)
        assert len({(s["start_ns"], s["duration_ns"]) for s in spans}) == 1
    assert all(one(tr, "batcher.queue")["tags"]["batch"] == n for tr in traces)


def test_sparse_vector_stages_are_spans_of_the_dispatch(srv):
    """A bare `sparse_vector` query rides the batcher's `sparse` family:
    its host stages are spans of the group's `batcher.dispatch` (the
    plans, each scoring pass with its phase, tiles and launches, the
    survival test), and `sparse_launches` counts the passes' launches."""
    if "sp" not in srv.cluster.indices:
        call(srv, "PUT", "/sp", {
            "settings": {"number_of_shards": 1, "search.backend": "torch",
                         "sparse.quantization": "none"},
            "mappings": {"properties": {"ml": {"type": "sparse_vector"}}}})
        lines = []
        for i in range(N_DOCS):
            lines.append(json.dumps({"index": {"_index": "sp", "_id": str(i)}}))
            # "common" in every doc: three tiles, so phase A runs
            lines.append(json.dumps({"ml": {"common": 0.5 + (i % 97) / 50, f"t{i % 5}": 1.0}}))
        call(srv, "POST", "/_bulk?refresh=true", raw=("\n".join(lines) + "\n").encode())
        srv.cluster.get_index("sp")._batcher.warmup_enabled = False
    body = {"query": {"sparse_vector": {"field": "ml",
                                        "query_vector": {"common": 1.0, "t1": 0.5}}}}
    call(srv, "POST", "/sp/_search", body)  # builds the executor and its scorers
    node = lambda: next(iter(call(srv, "GET", "/_nodes/stats")["nodes"].values()))  # noqa: E731
    n0 = node()
    resp, tr, marks = traced(srv, body, index="sp")
    n1 = node()
    assert len(hits(resp)) == 10
    check_tree(tr, marks)
    dispatch = one(tr, "batcher.dispatch")
    assert dispatch["tags"]["family"] == "sparse"
    for name in ("sparse.plan", "sparse.survive"):
        assert one(tr, name)["parent_id"] == dispatch["id"]
    scores = by_name(tr, "sparse.score")
    assert [s["parent_id"] for s in scores] == [dispatch["id"]] * 2
    assert [s["tags"]["phase"] for s in scores] == ["a", "kept"]
    # phase A scores each token's first tile; the kept pass the four
    # tiles less those the block-max bounds dropped
    pruned = n1["sparse"]["tiles_pruned"] - n0["sparse"]["tiles_pruned"]
    assert [s["tags"]["tiles"] for s in scores] == [2, 4 - pruned]
    assert all(s["tags"]["launches"] == 1 for s in scores)
    plan, survive = one(tr, "sparse.plan"), one(tr, "sparse.survive")
    assert end(plan) <= scores[0]["start_ns"] and end(scores[0]) <= survive["start_ns"]
    assert end(survive) <= scores[1]["start_ns"]
    launched = (n1["thread_pool"]["search"]["sparse_launches"]
                - n0["thread_pool"]["search"]["sparse_launches"])
    assert launched == 2


def test_impact_score_pass_counts_its_chunks():
    """`ImpactScorer.score_pass` adds into the accumulators in place and
    returns its launches: one a pass on the CPU (the plain version; on
    the card the impact tile add's windows), whatever the longest row's
    length; `score_into` returns the same accumulators, and a pass with
    no tiles launches nothing."""
    from elasticsearch_tpu_torch.ops import impact

    rng = np.random.default_rng(3)
    doc_ids = rng.integers(-1, 50, (6, 128)).astype(np.int32)
    values = rng.uniform(0.1, 2.0, (6, 128)).astype(np.float32)
    sc = impact.ImpactScorer(doc_ids, values, 50, device="cpu")
    lists = [rng.integers(0, 6, 1100), rng.integers(0, 6, 7)]
    weights = [rng.uniform(0.5, 1.5, len(t)).astype(np.float32) for t in lists]
    acc, cnt = sc.new_acc(2)
    assert sc.score_pass(acc, cnt, lists, weights) == 1
    want_acc, want_cnt = sc.score_into(*sc.new_acc(2), lists, weights)
    assert torch.equal(acc, want_acc) and torch.equal(cnt, want_cnt) and acc.abs().sum() > 0
    assert sc.score_pass(*sc.new_acc(2), [np.zeros(0, np.int64)] * 2, [np.zeros(0, np.float32)] * 2) == 0
