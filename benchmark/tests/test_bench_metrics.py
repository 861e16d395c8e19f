"""The per-layer readers on recorded stats, spans and profiler events."""

import pytest

from benchmark.harness import spec
from benchmark.harness.profile import breakdown, busy_intervals, idle_gaps, label_gap
from benchmark.tests.conftest import ROOT

BENCH = ROOT / "benchmark"


def reader(name):
    return spec.load_reader(BENCH, name)


def node(completed, launches, chunked, occ_jobs, occ_slots):
    return {"thread_pool": {"search": {"completed": completed, "launches": launches,
                                       "chunked_jobs": chunked}},
            "pipeline": {"batching": {"occupancy_jobs": occ_jobs, "occupancy_slots": occ_slots}}}


STATS = (node(100, 40, 10, 100, 160), node(400, 100, 160, 400, 560))
EVENTS = [
    ("chunk_kernel", "kernel", 1000.0, 1010.0),
    ("apply_kernel", "kernel", 1010.0, 1030.0),
    ("void at::native::sbtopk::gatherTopK<float>", "kernel", 1040.0, 1100.0),
    ("ampere_sgemm_128x64_tn", "kernel", 1100.0, 1600.0),
    ("Memcpy DtoH (Device -> Pinned)", "memcpy", 1590.0, 1700.0),
    ("elementwise_kernel", "kernel", 1800.0, 1900.0),
]
SLICE = {"events": EVENTS, "lo": 1000.0, "hi": 3000.0, "requests": 4,
         "stats": (node(0, 0, 0, 0, 0), node(6, 2, 0, 6, 8))}


def test_counter_ratios():
    ctx = {"stats": STATS}
    assert reader("jobs_per_launch")(ctx) == pytest.approx(300 / 60)
    assert reader("chunked_job_share")(ctx) == pytest.approx(150 / 300)
    assert reader("jobs_per_launch")({"stats": (STATS[0], STATS[0])}) is None


def test_host_cpu_and_spans():
    assert reader("host_cpu_ms_per_req")({"host": {"cpu_s": 1.5, "requests": 500}}) \
        == pytest.approx(3.0)
    assert reader("host_cpu_ms_per_req")({"host": {"cpu_s": 1.5, "requests": 0}}) is None
    trace = {"spans": [
        {"id": 1, "parent_id": None, "name": "shard_search", "duration_ns": 9_000_000},
        {"id": 2, "parent_id": None, "name": "coordinator", "duration_ns": 10_000_000},
        {"id": 3, "parent_id": 2, "name": "parse", "duration_ns": 100_000},
        {"id": 6, "parent_id": 2, "name": "fan_out", "duration_ns": 9_500_000},
    ]}
    other = {"spans": [{"id": 1, "parent_id": None, "name": "coordinator", "duration_ns": 2_000_000}]}
    assert reader("coord_self_ms")({"traces": [trace, other]}) == pytest.approx((0.5 + 2.0) / 2)
    assert reader("coord_self_ms")({"traces": []}) is None


def test_device_families_and_idle():
    ctx = {"slice": SLICE, "config": {"kind": "text"}}
    assert reader("scatter_add_ms_per_req")(ctx) == pytest.approx(30e-3 / 4)
    assert reader("topk_ms_per_req")(ctx) == pytest.approx(60e-3 / 4)
    # busy: 1000-1030, 1040-1700, 1800-1900 -> 790 us of 2000
    assert reader("device_idle_share")(ctx) == pytest.approx(1 - 790 / 2000)
    none = {"slice": dict(SLICE, events=[]), "config": {"kind": "text"}}
    assert reader("scatter_add_ms_per_req")(none) is None
    assert reader("topk_ms_per_req")(none) is None


def test_knn_roofline_arithmetic():
    cfg = {"kind": "vectors", "rows": 1_000_000, "dims": 1000, "precision": "float32"}
    ctx = {"slice": SLICE, "config": cfg}
    # 2 launches, 3 jobs each: bytes 4e9 / 3.35e12 = 1.194 ms; flops
    # 2*3*1e9 / 67e12 = 0.0896 ms; gemm time 0.5 ms
    want = 100 * 2 * (4e9 / 3.35e12) / 500e-6
    assert reader("knn_gemm_roofline")(ctx) == pytest.approx(want)
    assert reader("knn_gemm_roofline")({"slice": SLICE, "config": {"kind": "text"}}) is None
    assert reader("knn_gemm_roofline")({"slice": dict(SLICE, events=EVENTS[:3]), "config": cfg}) is None


def test_gaps_and_breakdown():
    busy = busy_intervals(EVENTS, 1000.0, 3000.0)
    assert busy == [[1000.0, 1030.0], [1040.0, 1700.0], [1800.0, 1900.0]]
    assert idle_gaps(busy, 1000.0, 3000.0) == [(1030.0, 1040.0), (1700.0, 1800.0), (1900.0, 3000.0)]
    samples = [(0.5, "http", "actions.py:search", True), (0.6, "batcher", "queue.py:get", False),
               (0.7, "http", "actions.py:search", True), (5.0, "http", "x.py:y", True)]
    assert label_gap(samples, 0.0, 1.0) == "http actions.py:search"
    assert label_gap(samples, 2.0, 3.0) == "no server thread running Python"

    class Sl:
        events = EVENTS
        window_us = (1000.0, 3000.0)
        offset_us = 0.0

    b = breakdown(Sl, samples)
    assert b["device_ops"][0] == ["ampere_sgemm_128x64_tn", pytest.approx(500e-6)]
    assert b["idle_gaps"][0][1] == pytest.approx(1100e-6) and len(b["idle_gaps"]) == 3

