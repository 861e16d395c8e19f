"""Deterministic fault-injection harness for the serving path.

Reference analog: org.elasticsearch.test.transport.MockTransportService
+ the DisruptionScheme family (NetworkDisruption, SlowClusterStateProcessing)
— ES's integration suites wrap the real transport/search services with
rule-driven fault injectors so failure-handling code is exercised
deterministically in CI. Here the production code itself carries named
injection *sites* (`faults.check(site, **ctx)` — a no-op when no
schedule is armed) and a process-wide registry holds the armed rules.

Schedule shape (env `ES_TPU_FAULTS`, or `POST /_internal/faults`):

    {"seed": 42, "rules": [
        {"site": "shard.search", "match": {"index": "books", "shard": 1},
         "kind": "error", "prob": 1.0, "times": 1},
        {"site": "shard.search", "kind": "stall", "delay_ms": 2000,
         "match": {"shard": 3}},
        {"site": "transport.send", "kind": "drop", "prob": 0.1}
    ]}

* ``site``: fnmatch pattern over the site name. Known sites:
  - ``transport.send``      (every outbound transport request)
  - ``shard.search``        (per-shard query-phase call in the fan-out)
  - ``shard.count``         (per-shard count call)
  - ``batcher.dispatch``    (QueryBatcher device-dispatch of one group)
  - ``batcher.collect``     (QueryBatcher host-collect of one group)
  - ``knn.collect``         (kNN group device→host collect)
  - ``admission.acquire``   (per-request admission gate)
  - ``aggs.collect``        (device-aggregation plan dispatch — ctx
    carries index/shard; an injected error here exercises the
    device→host AggCollector fallback deterministically)
  - ``ann.probe``           (IVF ANN probe path, per segment — ctx
    carries field/segment; error kind proves the deterministic
    IVF→exact brute-force fallback, delay kind the slow-not-wrong
    contract)
  - ``rerank.score``        (second-stage maxsim rescore dispatch —
    ctx carries field (+ mesh=1 on the SPMD path); error kind proves
    the deterministic rerank→first-stage-order fallback (the request
    keeps its first-stage ranking bit-for-bit and the `fallbacks`
    counter increments), delay kind the slow-not-wrong contract)
  - ``sparse.score``        (learned-sparse impact-tile scoring — per
    segment on the batcher path with ctx field/segment, mesh=1 on the
    SPMD path; error kind proves the deterministic impact→dense-host-
    oracle fallback (exact answers, `fallbacks` bump), delay kind the
    slow-not-wrong contract — the ann.probe recipe for the third
    retrieval family)

  Write-path sites (the durability mirror of the read-path list; the
  crash-matrix harness in index/crashpoints.py + tests/test_durability.py
  drives every one of them with the ``crash`` kind):
  - ``translog.append``     (per WAL record, BEFORE the bytes reach the
    log — ctx carries shard/gen/seq_no/op; a ``crash`` rule here with
    ``"torn": true`` leaves a PARTIAL record on disk, the torn-tail
    shape recovery must truncate)
  - ``translog.fsync``      (inside Translog.sync, BEFORE the pending
    tail is written+fsynced — a crash here loses exactly the
    acked-but-unsynced window of `async` durability)
  - ``engine.refresh``      (segment build from the indexing buffer —
    fires at refresh BEGIN, before any state moves; on the
    double-buffered path (ShardEngine.refresh_concurrent) an error
    keeps the old generation serving and the ops buffered)
  - ``build.device``        (device segment-build dispatch,
    index/segment_build.py — ctx carries shard; an injected error
    proves the deterministic device→host-build fallback (same
    bit-identical columns, counted `fallbacks`), delay the
    slow-not-wrong contract, ``crash`` a power loss mid-build)
  - ``engine.flush``        (durable commit — ctx carries shard and a
    ``stage`` of start | pre_manifest | post_manifest, bracketing the
    segment-persist / manifest-replace / translog-trim windows)
  - ``engine.merge``        (segment-count merge rebuild)
  - ``replica.replicate``   (primary→replica write fan-out, per target —
    ctx index/shard/target; error kind proves the failed copy leaves
    the in-sync set instead of silently diverging)
  - ``recovery.transfer``   (peer-recovery phase 1 file copy, target
    side — ctx index/shard/node)
  - ``recovery.finalize``   (peer-recovery phase 2 ops replay, target
    side — ctx index/shard/node)
  - ``relocation.start``    (shard relocation kicking off — fires on
    BOTH endpoints with ctx index/shard/node/role: role=target before
    the target's peer recovery begins, role=source when the source
    receives the recovery/start request for its relocation target;
    error/crash abort the attempt cleanly — the source keeps serving,
    the recovery retry loop or a fresh reroute re-runs the move)
  - ``relocation.transfer`` (the bulk transfer leg — role=target after
    phase 1 returns, role=source inside recovery/finalize when the
    requester is the relocation target; the same
    abort-and-retry-cleanly contract as recovery.transfer)
  - ``relocation.handoff``  (the cutover handoff — role=target before
    the target asks the source to drain, role=source at the top of the
    drain handler BEFORE any permit state changes, so an injected
    error/crash leaves the source still serving writes; tests drive
    error + crash + delay at every site × both roles)
* ``match``: exact-equality filters over the ctx kwargs the site passes
  (string-compared, so {"shard": 1} matches shard=1).
* ``kind``: ``error`` (raise InjectedFault, 500-shaped), ``drop``
  (raise InjectedFault shaped like a connect_transport_exception),
  ``delay`` / ``stall`` (sleep ``delay_ms`` then proceed — ``stall``
  is the slow-kernel simulation; both behave identically, the name
  documents intent), ``load`` (no sleep, no raise: ``delay_ms`` is
  returned to the caller as a SYNTHETIC queue-pressure sample —
  `check` returns ``{"load_ms": N}`` — so overload schedules replay
  deterministically without real queue contention; only the
  admission site consumes it today), ``crash`` (raise SimulatedCrash —
  a BaseException, so no production `except Exception` handler can
  "handle" a power loss; the harness catches it, tears the
  engine/node down WITHOUT running close/flush paths, and reopens
  from disk. ``"torn": true`` on the rule additionally asks the site
  to leave a partial write of the in-flight record behind — only
  ``translog.append`` honors it today).
* ``prob``: trip probability (default 1.0). Draws are a pure hash of
  (seed, rule index, site, ctx, per-ctx attempt counter) — NOT a
  sequential RNG — so the schedule is deterministic regardless of
  thread interleaving across the fan-out, and a replica retry of the
  same shard re-draws with attempt+1 instead of being auto-doomed.
* ``times``: cap on total trips for the rule (unlimited when absent).
* ``skip``: deterministic onset — the first N matching draws do not
  trip (with ``times: 1`` this reads "crash exactly at the (N+1)th
  append/fsync/flush", the lever the crash matrix steers with).

The registry is intentionally process-global (like the settings
registries): tests and the `/_internal/faults` hook arm/clear it.
"""

from __future__ import annotations

import fnmatch
import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

FAULTS_ENV = "ES_TPU_FAULTS"


class InjectedFault(Exception):
    """A fault raised by the harness. Carries a REST-ish status/err_type
    so failure accounting can report it like a real exception class."""

    def __init__(
        self,
        reason: str,
        err_type: str = "injected_fault_exception",
        status: int = 500,
    ):
        super().__init__(reason)
        self.reason = reason
        self.err_type = err_type
        self.status = status


class SimulatedCrash(BaseException):
    """Deterministic power loss injected by a ``crash`` rule.

    Deliberately a BaseException: production code paths catch Exception
    liberally (fallbacks, retries, recovery loops) and none of them may
    "survive" a power loss — the crash must unwind all the way to the
    harness, which tears the engine/node down without running any
    close/flush path and then reopens from disk. ``torn`` asks the
    injection site to leave a partial write of the in-flight record
    behind (a torn tail) before unwinding."""

    def __init__(self, reason: str, torn: bool = False):
        super().__init__(reason)
        self.reason = reason
        self.torn = torn


class _Rule:
    __slots__ = (
        "index", "site", "match", "kind", "prob", "times", "delay_ms",
        "torn", "skip", "trips", "attempts",
    )

    def __init__(self, index: int, spec: dict):
        self.index = index
        self.site = str(spec.get("site", "*"))
        self.match = {
            str(k): str(v) for k, v in (spec.get("match") or {}).items()
        }
        kind = str(spec.get("kind", "error"))
        if kind not in ("error", "drop", "delay", "stall", "load", "crash"):
            raise ValueError(f"unknown fault kind [{kind}]")
        self.kind = kind
        self.prob = float(spec.get("prob", 1.0))
        self.times = spec.get("times")
        if self.times is not None:
            self.times = int(self.times)
        self.delay_ms = float(spec.get("delay_ms", 100.0))
        self.torn = bool(spec.get("torn", False))
        # deterministic onset: the first `skip` matching (and
        # probability-passing) draws do NOT trip — "crash at the Nth
        # append", the lever the write-path crash matrix steers with
        self.skip = int(spec.get("skip", 0))
        self.trips = 0
        self.attempts = 0

    def matches(self, site: str, ctx: Dict[str, Any]) -> bool:
        if not fnmatch.fnmatch(site, self.site):
            return False
        for k, v in self.match.items():
            if str(ctx.get(k)) != v:
                return False
        return True

    def info(self) -> dict:
        return {
            "site": self.site,
            "match": dict(self.match),
            "kind": self.kind,
            "prob": self.prob,
            "times": self.times,
            "delay_ms": self.delay_ms,
            "torn": self.torn,
            "skip": self.skip,
            "trips": self.trips,
            "attempts": self.attempts,
        }


def _ctx_sig(ctx: Dict[str, Any]) -> str:
    return "|".join(f"{k}={ctx[k]}" for k in sorted(ctx))


class FaultRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[_Rule] = []
        self._seed = 0
        # per-(rule, ctx) attempt counters: a retry of the same shard on
        # another copy draws independently from the first attempt
        self._attempts: Dict[tuple, int] = {}

    @property
    def active(self) -> bool:
        return bool(self._rules)

    def configure(self, config: Optional[dict]) -> dict:
        """Replaces the schedule atomically; None/{} clears it."""
        config = config or {}
        rules = [
            _Rule(i, spec) for i, spec in enumerate(config.get("rules") or [])
        ]
        with self._lock:
            self._seed = int(config.get("seed", 0))
            self._rules = rules
            self._attempts.clear()
        return self.describe()

    def clear(self) -> None:
        with self._lock:
            self._rules = []
            self._attempts.clear()

    def describe(self) -> dict:
        with self._lock:
            return {
                "active": bool(self._rules),
                "seed": self._seed,
                "rules": [r.info() for r in self._rules],
            }

    def _draw(self, rule: _Rule, site: str, sig: str, attempt: int) -> float:
        key = f"{self._seed}|{rule.index}|{site}|{sig}|{attempt}"
        h = hashlib.sha256(key.encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0**64

    def check(self, site: str, **ctx) -> Optional[dict]:
        """Injection point. Raises InjectedFault (error/drop rules),
        sleeps (delay/stall rules), or returns an effects dict (load
        rules: ``{"load_ms": N}`` — a synthetic queue-pressure sample
        the admission site feeds into its congestion signal); a no-op
        returning None when nothing is armed."""
        if not self._rules:  # fast path: unarmed in production
            return None
        sleep_ms = 0.0
        load_ms = 0.0
        boom: Optional[BaseException] = None
        with self._lock:
            sig = _ctx_sig(ctx)
            for rule in self._rules:
                if not rule.matches(site, ctx):
                    continue
                if rule.times is not None and rule.trips >= rule.times:
                    continue
                akey = (rule.index, sig)
                attempt = self._attempts.get(akey, 0)
                self._attempts[akey] = attempt + 1
                rule.attempts += 1
                if rule.prob < 1.0 and (
                    self._draw(rule, site, sig, attempt) >= rule.prob
                ):
                    continue
                if rule.skip > 0:
                    rule.skip -= 1
                    continue
                rule.trips += 1
                if rule.kind in ("delay", "stall"):
                    sleep_ms = max(sleep_ms, rule.delay_ms)
                elif rule.kind == "load":
                    load_ms = max(load_ms, rule.delay_ms)
                elif rule.kind == "crash":
                    boom = SimulatedCrash(
                        f"simulated crash at [{site}] ({sig})",
                        torn=rule.torn,
                    )
                    break
                elif rule.kind == "drop":
                    boom = InjectedFault(
                        f"injected connection drop at [{site}] ({sig})",
                        err_type="connect_transport_exception",
                    )
                    break
                else:
                    boom = InjectedFault(
                        f"injected error at [{site}] ({sig})"
                    )
                    break
        if sleep_ms > 0.0:
            time.sleep(sleep_ms / 1000.0)
        if boom is not None:
            raise boom
        return {"load_ms": load_ms} if load_ms > 0.0 else None


faults = FaultRegistry()

# env-armed schedule (read once at import, like the other ES_TPU_* knobs)
_raw = os.environ.get(FAULTS_ENV, "")
if _raw:
    try:
        faults.configure(json.loads(_raw))
    except (ValueError, TypeError):
        pass  # a malformed schedule must never take the node down
