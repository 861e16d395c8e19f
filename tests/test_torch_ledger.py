"""The port's device-memory ledger under a finalizer.

`ops/wand.py` registers `weakref.finalize(tiling, hbm_ledger.release,
...)` for every postings tiling. The collector can run that callback on
any thread, at any allocation, including one made while the same thread
holds the ledger inside `add` (which sums the per-category dict). The
release must then neither block on the ledger's lock nor change the dict
under the sum, and the totals must stay exact.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import weakref

from elasticsearch_tpu_torch.common.memory import HbmLedger


class _Cyclic:
    """Kept alive by its own cycle until `gc.collect()` runs."""

    def __init__(self):
        self.me = self


class _CollectingDict(dict):
    """A `_by_category` whose `values()` runs the collector, as an
    allocation inside `HbmLedger.add`'s sum may."""

    def values(self):
        gc.collect()
        return super().values()

    def items(self):
        gc.collect()
        return super().items()


def _armed_ledger(nbytes: int) -> HbmLedger:
    ledger = HbmLedger(budget=1 << 40)
    ledger.add("postings", nbytes)
    ledger._by_category = _CollectingDict(ledger._by_category)
    obj = _Cyclic()
    weakref.finalize(obj, ledger.release, "postings", nbytes)
    del obj  # only the cycle holds it now: the collector frees it
    return ledger


def _run_in_thread(fn, timeout: float = 20.0) -> dict:
    out: dict = {}

    def body():
        try:
            fn()
            out["done"] = True
        except BaseException as exc:  # reported by the assertion below
            out["error"] = exc

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout)
    out["alive"] = t.is_alive()
    return out


def test_finalizer_release_inside_add_does_not_deadlock():
    """The collector fires the finalizer inside `add`'s locked sum: the
    thread must finish, and the release must still be counted."""
    ledger = _armed_ledger(1000)
    out = _run_in_thread(lambda: ledger.add("norms", 24))
    assert not out["alive"], "HbmLedger.add deadlocked on a finalizer's release"
    assert out.get("done"), out.get("error")
    ledger._by_category = dict(ledger._by_category)
    assert ledger.used == 24
    assert ledger.stats()["by_category"] == {"norms": 24}


def test_finalizer_release_inside_used_and_stats_does_not_deadlock():
    for reader in ("used", "stats", "child_breakers", "note_degraded"):
        ledger = _armed_ledger(512)

        def read(ledger=ledger, reader=reader):
            attr = getattr(ledger, reader)
            if callable(attr):
                attr()

        out = _run_in_thread(read)
        assert not out["alive"], f"HbmLedger.{reader} deadlocked"
        assert out.get("done"), out.get("error")
        ledger._by_category = dict(ledger._by_category)
        gc.collect()
        assert ledger.used == 0, reader


def test_totals_exact_after_concurrent_adds_and_releases():
    """Many threads add and release while finalizers release too: after
    everything is released the ledger reads 0 in every category."""
    ledger = HbmLedger(budget=1 << 40)
    # more threads than cores, switching often: a lost update shows
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 300

    def worker(i: int):
        keep = []
        for j in range(per_thread):
            cat = ("postings", "norms", "dense")[j % 3]
            ledger.add(cat, j + 1)
            obj = _Cyclic()
            weakref.finalize(obj, ledger.release, cat, j + 1)
            keep.append(obj)
            if j % 50 == 0:
                gc.collect()
        keep.clear()
        gc.collect()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    gc.collect()
    assert ledger.used == 0
    assert ledger.stats()["by_category"] == {}
    assert ledger.child_breakers() == {}


def test_release_below_zero_drops_the_category():
    ledger = HbmLedger(budget=1000)
    ledger.add("vectors", 10)
    ledger.release("vectors", 25)
    assert ledger.used == 0
    assert "vectors" not in ledger.stats()["by_category"]
    ledger.add("vectors", 990)
    assert ledger.would_fit(10) and not ledger.would_fit(11)
