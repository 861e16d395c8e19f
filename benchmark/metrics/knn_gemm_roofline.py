"""`ops/scoring.py` `knn_scores`, the exact-kNN matmul: its share of the
roofline in the profiled slice, in percent.

Each launch reads the N x d float32 rows once (N d 4 bytes at the peak
bandwidth) and does 2 B N d operations for its B jobs (float32 at the
peak of the precision the port runs, `config["precision"]`); the least
time of a launch is the larger of the two. Launches and jobs are the
slice's counter differences; the time is the device time of the matmul
kernels there."""

from _common import PEAK_BYTES_PER_S, PEAK_FLOPS, delta, device_s


def read(ctx):
    sl = ctx.get("slice")
    cfg = ctx["config"]
    if not sl or not sl["stats"] or cfg.get("kind") != "vectors":
        return None
    launches = delta(sl["stats"], "thread_pool.search.launches")
    jobs = delta(sl["stats"], "thread_pool.search.completed")
    t = device_s(sl, "gemm")
    if launches <= 0 or t <= 0:
        return None
    n, d = float(cfg["rows"]), float(cfg["dims"])
    per_launch_bytes = n * d * 4 / PEAK_BYTES_PER_S
    rows = jobs / launches
    per_launch_flops = 2 * rows * n * d / PEAK_FLOPS[cfg["precision"]]
    return 100.0 * launches * max(per_launch_bytes, per_launch_flops) / t
