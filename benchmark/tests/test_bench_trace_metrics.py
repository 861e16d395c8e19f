"""The readers of the program's spans and sync counters on synthetic
`traces` and `stats`: each reading, and None where there is nothing to
read (a program without the spans or counters, as the parent of the
change that brought them)."""

import json

import pytest

from benchmark.harness import spec
from benchmark.tests.conftest import ROOT

BENCH = ROOT / "benchmark"
NEW = ("http_self_ms", "batcher_handoff_ms", "host_syncs_per_job",
       "device_wait_ms_per_job", "chunked_host_ms_per_job")


def reader(name):
    return spec.load_reader(BENCH, name)


def span(id, parent, name, ms):
    return {"id": id, "parent_id": parent, "name": name, "start_ns": 0,
            "duration_ns": int(ms * 1e6), "tags": {}}


def chunked_trace():
    return {"spans": [
        span(1, None, "http", 20.0),
        span(2, 1, "http.read", 0.1),
        span(3, 1, "search", 17.0),
        span(4, 3, "coordinator", 16.5),
        span(5, 4, "fan_out", 16.0),
        span(6, 5, "shard_search", 15.5),
        span(7, 6, "batcher.queue", 0.25),
        span(8, 6, "batcher.dispatch", 14.0),
        span(9, 8, "chunked.plan", 1.0),
        span(10, 8, "chunked.score", 2.0),
        span(11, 8, "device.wait", 4.0),
        span(12, 8, "chunked.survive", 3.0),
        span(13, 8, "chunked.score", 0.5),
        span(14, 6, "batcher.wake", 0.5),
        span(15, 1, "http.write", 2.5),
    ]}


def knn_trace():
    return {"spans": [
        span(1, None, "http", 12.0),
        span(2, 1, "search", 8.0),
        span(3, 2, "shard_search", 7.0),
        span(4, 3, "batcher.queue", 0.5),
        span(5, 3, "batcher.dispatch", 0.5),
        span(6, 3, "batcher.collect", 5.5),
        span(7, 3, "batcher.wake", 0.25),
    ]}


# the ring as the program before these spans left it: a trace rooted
# at `search` holding `coordinator` and `shard_search`
OLD = {"spans": [span(1, None, "coordinator", 10.0), span(2, 1, "fan_out", 9.0),
                 span(3, None, "shard_search", 8.5)]}


def node(completed, syncs=None, stall=0.0):
    pipe = {"host_stall_ms": stall}
    if syncs is not None:
        pipe["host_syncs"] = syncs
    return {"thread_pool": {"search": {"completed": completed}}, "pipeline": pipe}


def test_http_self_ms():
    ctx = {"traces": [chunked_trace(), knn_trace()]}
    assert reader("http_self_ms")(ctx) == pytest.approx((3.0 + 4.0) / 2)
    assert reader("http_self_ms")({"traces": [OLD]}) is None
    assert reader("http_self_ms")({"traces": []}) is None
    assert reader("http_self_ms")({}) is None


def test_batcher_handoff_ms():
    ctx = {"traces": [chunked_trace(), knn_trace(), OLD]}
    assert reader("batcher_handoff_ms")(ctx) == pytest.approx((0.75 + 0.75) / 2)
    assert reader("batcher_handoff_ms")({"traces": [OLD]}) is None


def test_chunked_host_ms_per_job_reads_chunked_traces_only():
    ctx = {"traces": [chunked_trace(), knn_trace(), chunked_trace()]}
    assert reader("chunked_host_ms_per_job")(ctx) == pytest.approx(1.0 + 2.0 + 3.0 + 0.5)
    assert reader("chunked_host_ms_per_job")({"traces": [knn_trace(), OLD]}) is None


def test_counters_per_job():
    ctx = {"stats": (node(100, syncs=150, stall=40.0), node(300, syncs=550, stall=1040.0))}
    assert reader("host_syncs_per_job")(ctx) == pytest.approx(2.0)
    assert reader("device_wait_ms_per_job")(ctx) == pytest.approx(5.0)
    idle = {"stats": (node(100, syncs=150), node(100, syncs=150))}
    assert reader("host_syncs_per_job")(idle) is None
    assert reader("device_wait_ms_per_job")(idle) is None
    # a program without the counter (its `pipeline` has no host_syncs)
    old = {"stats": (node(100), node(300, stall=10.0))}
    assert reader("host_syncs_per_job")(old) is None
    assert reader("device_wait_ms_per_job")(old) == pytest.approx(0.05)
    assert reader("host_syncs_per_job")({}) is None


def test_entries_and_the_cells_that_report_them():
    entries = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    assert entries["chunked_host_ms_per_job"]["workloads"] == ["msmarco-passage-bm25.match.c1"]
    both = ["msmarco-passage-bm25.match.c1", "nq-openai-1536-exact.knn.c1"]
    assert all(entries[n]["workloads"] == both for n in NEW[:4])
    assert all(entries[n]["moves"] == "p50_ms" for n in NEW)
    bm25 = {m.name for m in spec.resolve(ROOT, "msmarco-passage-bm25.match.c1").per_layer}
    knn = {m.name for m in spec.resolve(ROOT, "nq-openai-1536-exact.knn.c1").per_layer}
    assert set(NEW) <= bm25
    assert set(NEW) - knn == {"chunked_host_ms_per_job"}
