#!/usr/bin/env python3
"""The benchmark of `elasticsearch_tpu_torch`: one cell, run once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (`BENCHMARK.json`'s `workloads`)
names a configuration and a traffic mix. The run makes the corpus on the
card from the seed, starts the port's REST server in this process with
the corpus installed as one force-merged segment, drives it from
closed-loop clients in processes of their own, warms up, measures for
`--seconds`, then checks a sample of the answers served in the window
against the plain reference (`reference/`). The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones,
read from counters, spans and a `torch.profiler` slice at the window's
end), `device`, with `--trace 1` `breakdown`, and last `check`: each
number compared with its limit (also the last lines of standard error).

Exits non-zero with no result where no CUDA card is found (it never
falls back to the CPU), where the cell asks for more cards than there
are, and where `jax`, `jaxlib`, `flax` or `elasticsearch_tpu` got
loaded. Only the standard library is imported at the top: the client
processes are spawned and import this file again.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import tempfile
import sys
import time
from pathlib import Path

T_START = time.monotonic()
ROOT = Path(__file__).resolve().parent.parent
BANNED = frozenset({"jax", "jaxlib", "flax", "elasticsearch_tpu"})
TRACE_SLICE_S = 3.0
# how long the clients of a traced run may go on past its window while
# the profiler starts
CLIENT_GRACE_S = 60.0
# the client number of the set-up's first request, outside every mix
SETUP_CLIENT = 1_000_000


def banned_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is a
    banned one, compared whole: `elasticsearch_tpu_torch` is not
    `elasticsearch_tpu`."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & BANNED)


def set_env(root: Path) -> None:
    """Before the port is imported: admission off (a closed-loop
    measurement), no Flax through any library, and the compile caches at
    fixed paths inside the checkout."""
    os.environ["ES_TPU_ADMISSION"] = "off"
    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(root / ".bench_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / ".bench_cache" / "torch_extensions")


def split_cpus(cpus=None):
    """(the server's CPUs, the clients' CPU) out of those this process
    may run on: the clients take the highest, the server the rest; None
    where fewer than two are allowed or affinity cannot be set."""
    if cpus is None:
        if not hasattr(os, "sched_setaffinity"):
            return None
        cpus = os.sched_getaffinity(0)
    cpus = sorted(cpus)
    return (cpus[:-1], cpus[-1:]) if len(cpus) > 1 else None


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def _sleep_until(t: float) -> None:
    while True:
        d = t - time.monotonic()
        if d <= 0:
            return
        time.sleep(min(d, 0.05))


def _node(stats: dict) -> dict:
    return next(iter(stats["nodes"].values()))


def _quantile(xs: list, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = T_START, log=print, client_cpus=None) -> dict:
    """One run of `cell`, its clients on `client_cpus`; returns the
    result object (before printing)."""
    import torch

    from benchmark.harness import check, corpus, profile, spec, system
    from benchmark.harness.clients import ClientPool
    from benchmark.harness.traffic import QueryMaker

    cfg, tr, bench = cell.config, cell.traffic, cell.bench_dir
    cuda = torch.device(device).type == "cuda"

    marks = [("imports", time.monotonic())]

    def mark(what):
        if cuda:
            torch.cuda.synchronize()
        marks.append((what, time.monotonic()))

    corp = corpus.make(cfg, seed, device, bench)
    mark("corpus")
    context = corpus.client_context(cfg, corp, bench)
    seg = system.segment(cfg, corp, bench)
    del corp
    mark("segment")
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sut = system.System(cfg, seg, device, bench)
    pool = None
    try:
        maker = QueryMaker(tr, cfg, context, seed, bench)
        mark("server")
        sut.prewarm()
        mark("prewarm")
        # the first request starts the batcher's warm-up of every launch
        # width of its family
        sut.search(maker.body(SETUP_CLIENT, 0))
        mark("first_request")
        sut.wait_warm()
        mark("bucket_warmup")
        pool = ClientPool(sut.port, sut.path, tr, cfg, context, seed, bench, client_cpus)
        mark("clients")
        t0 = time.monotonic() + float(tr["warmup_s"])
        t1 = t0 + seconds
        # a traced run ends when its profiled slice has lasted its length
        pool.start(t1 + CLIENT_GRACE_S if trace else t1)
        _sleep_until(t0)
        setup_s = t0 - t_start
        marks.append(("warmup_traffic", t0))
        prev = t_start
        split = []
        for what, t in marks:
            split.append(f"{what} {t - prev:.3f}")
            prev = t
        log("set-up s: " + ", ".join(split), file=sys.stderr)
        s0 = _node(sut.stats())
        cpu0 = time.process_time()
        ctx = {"config": cfg, "traffic": tr, "cell": cell.name}
        if trace:
            slice_s = min(TRACE_SLICE_S, seconds / 3)
            t_prof = t1 - slice_s
            _sleep_until(t_prof)
            cpu1 = time.process_time()
            ctx["traces"] = sut.traces()
            with profile.HostSampler() as hs, profile.Slice(tempfile.gettempdir(), cuda) as sl:
                # the slice's counters bracket the profiled time exactly
                s_mid = _node(sut.stats())
                _sleep_until(sl.t_start + slice_s)
                s1 = _node(sut.stats())
            pool.stop()
            t1 = sl.t_end
        else:
            _sleep_until(t1)
            s1 = _node(sut.stats())
        records = pool.collect()
        pool = None
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        if pool is not None:
            pool.close()
        sut.close()
    del sut, seg
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    loaded = banned_modules()
    if loaded:
        raise ImportError(f"banned modules loaded: {loaded}")

    window = [r for r in records if t0 <= r[3] <= t1]
    ok = [r for r in window if r[4]]
    failed = len(window) - len(ok)
    in_flight = sum(1 for r in records if r[2] < t1 < r[3])
    out = {"correct": False, "attempted": len(window) + in_flight, "failed": failed}
    per_s = [0] * (int(t1 - t0) + 1)
    for r in ok:
        per_s[int(r[3] - t0)] += 1
    log(f"completed per second of the window: {per_s}", file=sys.stderr)
    for r in window:
        if not r[4]:
            log(f"failed request (client {r[0]}, #{r[1]}): {r[5].get('error')}", file=sys.stderr)
            break

    if trace:
        ctx["stats"] = (s0, s1)
        before = [r for r in ok if r[3] <= t_prof]
        ctx["host"] = {"cpu_s": cpu1 - cpu0, "requests": len(before)}
        lo, hi = sl.window_us
        ctx["slice"] = {"events": sl.events, "lo": lo, "hi": hi, "stats": (s_mid, s1),
                        "requests": sum(1 for r in ok if r[3] >= sl.t_start)}
        out["metrics"] = spec.read_layer_metrics(cell, ctx)
        busy = profile.busy_intervals(sl.events, lo, hi)
        out["breakdown"] = profile.breakdown(sl, hs.samples)
    else:
        lat = [(r[3] - r[2]) * 1e3 for r in ok]
        vals = {"qps": len(ok) / seconds, "setup_s": setup_s}
        if lat:
            vals["p50_ms"] = _quantile(lat, 50)
        out["metrics"] = {m.name: {"value": vals[m.name], "unit": m.unit}
                          for m in cell.end_to_end if m.name in vals}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power"] = power_limit()
    if trace:
        dev["busy_s"] = sum(b - a for a, b in busy) * 1e-6
        dev["window_s"] = (hi - lo) * 1e-6
    out["device"] = dev

    # the reference, once the program's state is freed
    t_ref = time.monotonic()
    sampled = check.sample(ok, int(tr["check_sample"]), seed)
    # the corpus goes to the kind's check alone, which may free it
    readings = spec.kind(cfg, bench).judge(cfg, corpus.make(cfg, seed, device, bench), maker,
                                           sampled, int(tr["size"]))
    readings["failed"] = failed
    out["correct"], compared = check.verdict(readings, cfg["limits"], bool(ok))
    log(f"checked {len(sampled)} of {len(ok)} answers in {time.monotonic() - t_ref:.1f} s",
        file=sys.stderr)
    out["check"] = {name: {"value": v, "limit": lim} for name, v, lim, _ in compared}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the server's threads (all started after this) and the clients on
    # CPUs apart, so that neither takes the other's cores
    cpus = split_cpus()
    if cpus:
        os.sched_setaffinity(0, cpus[0])
    sys.path.insert(0, str(ROOT))
    set_env(ROOT)
    from benchmark.harness import spec

    cell = spec.resolve(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       client_cpus=cpus[1] if cpus else None)
    except ImportError as e:
        print(str(e), file=sys.stderr)
        return 3
    loaded = banned_modules()
    if loaded:
        print(f"banned modules loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
