"""The traced run's device view: a `torch.profiler` slice of the window
(CUDA activity), and a sampler of the server threads' Python stacks, so
that each idle gap of the device can be named by what the host was
doing then.

`Slice` yields the device intervals of the slice: (name, kind, start_us,
end_us), kind `kernel`, `memcpy` or `memset`, in the profiler's clock,
with the offset that maps `time.monotonic()` onto that clock (from a
marker the main thread records at a known host time).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path

# innermost frames of a thread that is blocked, not running Python
WAIT_FRAMES = {
    ("threading.py", "wait"), ("queue.py", "get"), ("socket.py", "readinto"),
    ("socket.py", "accept"), ("selectors.py", "select"),
    ("threading.py", "_wait_for_tstate_lock"), ("thread.py", "_worker"),
}
MARK = "bench.mark"


def thread_role(name: str):
    if name.startswith("query-batcher"):
        return "batcher"
    if name.startswith("search-fanout"):
        return "fanout"
    if "process_request_thread" in name:
        return "http"
    return None


class HostSampler:
    """Samples the innermost Python frame of every HTTP, fan-out and
    batcher thread of this process every `period` seconds, from a thread
    of its own: [(monotonic, role, "file:function", running)]."""

    def __init__(self, period: float = 0.001):
        self.period = period
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="host-sampler", daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)

    def _run(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.period)
            t = time.monotonic()
            names = {th.ident: th.name for th in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                role = thread_role(names.get(ident, ""))
                if role is None:
                    continue
                where = (Path(frame.f_code.co_filename).name, frame.f_code.co_name)
                self.samples.append((t, role, f"{where[0]}:{where[1]}", where not in WAIT_FRAMES))


class Slice:
    """Profiles the CUDA activity of this process while open."""

    def __init__(self, tmpdir: str, cuda: bool = True):
        self.tmpdir = tmpdir
        self.cuda = cuda
        self.events: list = []
        self.offset_us = 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t_host0 = time.monotonic()
        with record_function(MARK):
            if self.cuda:
                torch.cuda.synchronize()
        self.t_start = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.t_end = time.monotonic()
        self.prof.__exit__(*exc)
        fd, path = tempfile.mkstemp(suffix=".json", dir=self.tmpdir)
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        evs = trace.get("traceEvents", [])
        mark = [e for e in evs if e.get("name") == MARK and e.get("ph") == "X"]
        if mark:
            self.offset_us = float(mark[0]["ts"]) - self.t_host0 * 1e6
        kinds = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
        for e in evs:
            kind = kinds.get(e.get("cat"))
            if kind and e.get("ph") == "X":
                t0 = float(e["ts"])
                self.events.append((e.get("name", "?"), kind, t0, t0 + float(e.get("dur", 0.0))))
        self.events.sort(key=lambda x: x[2])
        return False

    @property
    def window_us(self):
        """(start, end) of the slice in the profiler's clock."""
        return (self.t_start * 1e6 + self.offset_us, self.t_end * 1e6 + self.offset_us)


def busy_intervals(events: list, lo: float, hi: float) -> list:
    """The union of the device intervals, clipped to [lo, hi]."""
    out: list = []
    for _n, _k, a, b in events:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(busy: list, lo: float, hi: float) -> list:
    """[(start, end)] of the device's idle time inside [lo, hi]."""
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def label_gap(samples: list, a_host: float, b_host: float) -> str:
    """What the server's running threads did most in a gap."""
    c = Counter(f"{role} {where}" for t, role, where, running in samples
                if running and a_host <= t <= b_host)
    if not c:
        return "no server thread running Python"
    return c.most_common(1)[0][0]


def breakdown(sl: Slice, samples: list, top: int = 10) -> dict:
    lo, hi = sl.window_us
    by_name: Counter = Counter()
    for name, _k, a, b in sl.events:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by_name[name] += (b - a) * 1e-6
    gaps = sorted(idle_gaps(busy_intervals(sl.events, lo, hi), lo, hi),
                  key=lambda g: g[0] - g[1])[:top]
    off = sl.offset_us
    return {
        "device_ops": [[n, s] for n, s in by_name.most_common(top)],
        "idle_gaps": [[label_gap(samples, (a - off) * 1e-6, (b - off) * 1e-6), (b - a) * 1e-6]
                      for a, b in gaps],
    }
