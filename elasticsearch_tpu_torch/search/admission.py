"""Per-node admission control: weighted fair queueing, adaptive
concurrency, deadline shedding, brownout serving, retry budgets.

Reference analogs: upstream Elasticsearch treats overload as a
first-class capability — bounded thread-pool queues rejecting with
EsRejectedExecutionException (429), HierarchyCircuitBreakerService,
and the 8.x SearchBackpressure / adaptive replica selection machinery.
This module is the TPU-serving shape of that substrate, sitting in
FRONT of the QueryBatcher:

* **Weighted fair queueing** (stride scheduling): each index/tenant
  owns a FIFO of waiting requests; when a slot frees, the tenant with
  the lowest virtual pass dequeues and its pass advances by
  ``STRIDE_BASE / weight`` — an index carrying weight 2 drains twice
  as often as a weight-1 peer under contention, and an idle tenant's
  pass snaps forward on arrival so it cannot hoard credit.
* **Adaptive concurrency (AIMD)**: the limit tracks actual device
  capacity instead of a static queue bound. The congestion signal is
  the measured wait between batcher enqueue and device dispatch
  (QueryBatcher reports every batch's worst wait here): sustained
  waits above ``target_delay_ms`` multiplicatively decrease the limit
  (×0.7, at most once per limit-many observations); sustained waits
  under half the target additively recover (+1 per limit-many calm
  observations).
* **Deadline-aware shedding**: a queued request whose ``timeout``
  budget expired is dropped AT DEQUEUE — never dispatched dead — and
  the batcher applies the same rule to its own queue (a job past its
  shard deadline fails its waiter instead of launching kernels).
* **Brownout degraded modes**: pressure (queue-delay ratio × queue
  occupancy) maps to tiers; each tier sheds progressively more work
  (see ``apply_brownout``) and every degraded response carries the
  tier in its ``_overload`` metadata. Tier 4 rejects outright.
* **Retry budget**: a token bucket fed by live admitted traffic
  (``retry_budget_ratio`` tokens per admitted request, SRE-style)
  caps replica-retry amplification — during an incident, retry
  traffic cannot exceed ~ratio of live traffic.

Every rejection raises :class:`EsOverloadedError` → HTTP 429 with a
computed ``Retry-After`` and an ``es.overloaded`` body block, and the
whole layer is deterministic-testable: the ``admission.acquire`` fault
site accepts the ``load`` kind, whose ``delay_ms`` is injected as a
synthetic queue-delay observation (seeded pure-hash draws, no sleep),
so a replayed overload schedule yields the same shed/brownout
decisions.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from ..common.faults import faults

# env knobs (process start); the cluster-settings consumers in
# ClusterService re-configure() dynamically (search.admission.*)
ADMISSION_ENV = "ES_TPU_ADMISSION"  # "on" (default) | "off"
TARGET_DELAY_ENV = "ES_TPU_ADMISSION_TARGET_MS"
MAX_QUEUE_ENV = "ES_TPU_ADMISSION_MAX_QUEUE"

TARGET_DELAY_MS_DEFAULT = 75.0
MIN_LIMIT_DEFAULT = 4
MAX_LIMIT_DEFAULT = 256
INITIAL_LIMIT_DEFAULT = 64
MAX_QUEUE_DEFAULT = 1024
RETRY_BUDGET_RATIO_DEFAULT = 0.1
RETRY_BUDGET_CAP_DEFAULT = 32.0

STRIDE_BASE = 1 << 16

# brownout tier names, indexed by tier number
TIER_NAMES = ("normal", "shed_optional", "shrink_window", "cache_only",
              "reject")


class EsOverloadedError(Exception):
    """Admission/overload rejection → HTTP 429 with Retry-After.

    Deliberately NOT a RuntimeError (the shard path treats RuntimeError
    as 'batcher closed'), and deliberately its own class: the REST
    layer renders it with the es.overloaded body block; the fan-out
    treats it as request-scoped (a 429 keeps its contract — never
    retried on a replica)."""

    status = 429
    err_type = "es_rejected_execution_exception"

    def __init__(
        self,
        reason: str,
        retry_after_s: float = 1.0,
        tier: int = 4,
        shed: str = "rejected",
    ):
        super().__init__(reason)
        self.reason = reason
        self.retry_after = max(1, int(math.ceil(retry_after_s)))
        self.tier = tier
        self.shed = shed

    def overload_info(self) -> dict:
        """The ``es.overloaded`` block carried in the 429 body."""
        return {
            "reason": self.shed,
            "pressure_tier": self.tier,
            "pressure_mode": TIER_NAMES[min(self.tier, len(TIER_NAMES) - 1)],
            "retry_after_s": self.retry_after,
        }


def overload_body(exc: BaseException, retry_after: int) -> dict:
    """Structured 429 body for ANY rejection path (admission, batcher
    queue-full, HBM breaker): the standard ES error envelope plus an
    ``es.overloaded`` block with the computed backoff hint — callers
    that only read the envelope see es_rejected_execution_exception /
    circuit_breaking_exception exactly as before."""
    err_type = getattr(exc, "err_type", "es_rejected_execution_exception")
    reason = str(exc)
    info = (
        exc.overload_info()
        if isinstance(exc, EsOverloadedError)
        else {"reason": err_type, "retry_after_s": retry_after}
    )
    return {
        "error": {
            "root_cause": [{"type": err_type, "reason": reason}],
            "type": err_type,
            "reason": reason,
        },
        "status": 429,
        "es.overloaded": info,
    }


class _Waiter:
    __slots__ = ("tenant", "event", "granted", "shed", "deadline", "t_enq")

    def __init__(self, tenant: str, deadline: Optional[float]):
        self.tenant = tenant
        self.event = threading.Event()
        self.granted = False
        self.shed: Optional[str] = None  # set when dropped at dequeue
        self.deadline = deadline
        self.t_enq = time.monotonic()


class Ticket:
    """One admitted request: carries the brownout tier decided at
    acquire time and the release bookkeeping."""

    __slots__ = ("tenant", "tier", "t_grant", "released", "counted")

    def __init__(self, tenant: str, tier: int, counted: bool = True):
        self.tenant = tenant
        self.tier = tier
        self.t_grant = time.monotonic()
        self.released = False
        # False for tickets minted while admission was disabled: they
        # hold no inflight slot, so release() must not return one
        self.counted = counted

    @property
    def mode(self) -> str:
        return TIER_NAMES[min(self.tier, len(TIER_NAMES) - 1)]


class _TenantState:
    __slots__ = ("queue", "vpass", "weight", "active", "admitted")

    def __init__(self):
        self.queue: Deque[_Waiter] = deque()
        self.vpass = 0.0
        self.weight = 1.0
        self.active = 0
        self.admitted = 0


class AdmissionController:
    """The per-node admission layer. One instance fronts every index's
    search entry on this node (process-global ``admission`` below)."""

    def __init__(
        self,
        enabled: Optional[bool] = None,
        target_delay_ms: Optional[float] = None,
        min_limit: int = MIN_LIMIT_DEFAULT,
        max_limit: int = MAX_LIMIT_DEFAULT,
        initial_limit: int = INITIAL_LIMIT_DEFAULT,
        max_queue: Optional[int] = None,
        retry_budget_ratio: float = RETRY_BUDGET_RATIO_DEFAULT,
        retry_budget_cap: float = RETRY_BUDGET_CAP_DEFAULT,
    ):
        if enabled is None:
            enabled = os.environ.get(ADMISSION_ENV, "on").lower() not in (
                "off", "false", "0",
            )
        if target_delay_ms is None:
            raw = os.environ.get(TARGET_DELAY_ENV, "")
            try:
                target_delay_ms = float(raw) if raw else TARGET_DELAY_MS_DEFAULT
            except ValueError:
                target_delay_ms = TARGET_DELAY_MS_DEFAULT
        if max_queue is None:
            raw = os.environ.get(MAX_QUEUE_ENV, "")
            try:
                max_queue = int(raw) if raw else MAX_QUEUE_DEFAULT
            except ValueError:
                max_queue = MAX_QUEUE_DEFAULT
        self._lock = threading.Lock()
        self.enabled = bool(enabled)
        self.target_delay_s = max(target_delay_ms, 1.0) / 1000.0
        self.min_limit = max(1, int(min_limit))
        self.max_limit = max(self.min_limit, int(max_limit))
        self.limit = float(
            min(max(initial_limit, self.min_limit), self.max_limit)
        )
        self.max_queue = max(1, int(max_queue))
        self._tenants: Dict[str, _TenantState] = {}
        self._inflight = 0
        self._queued = 0
        # AIMD bookkeeping: observations since the last decrease /
        # increase — one window = `limit` observations, so the limit
        # moves at most once per round trip's worth of signal
        self._delay_ewma = 0.0
        self._obs_since_decrease = 0
        self._calm_obs = 0
        # service-time EWMA feeds the Retry-After computation
        self._service_ewma = 0.05
        # retry budget (token bucket fed by admitted live traffic)
        self.retry_budget_ratio = float(retry_budget_ratio)
        self.retry_budget_cap = float(retry_budget_cap)
        self._retry_tokens = float(retry_budget_cap)
        self.stats_counters = {
            "admitted": 0,
            "queued_total": 0,
            "shed_deadline": 0,
            "shed_queue_full": 0,
            "shed_rejected": 0,
            "brownouts": 0,
            "limit_decreases": 0,
            "limit_increases": 0,
            "retries_granted": 0,
            "retries_denied": 0,
            # brownout tier-1 stripped a "profile": true request — the
            # shed profiling is attributable, not silent
            "profiles_shed": 0,
        }
        # per-tier grant counts (index = tier)
        self._tier_grants = [0] * len(TIER_NAMES)

    # ---- configuration ----------------------------------------------

    def configure(self, **kw) -> None:
        """Dynamic re-configuration (cluster settings consumers)."""
        with self._lock:
            if "enabled" in kw and kw["enabled"] is not None:
                self.enabled = bool(kw["enabled"])
            if "target_delay_ms" in kw and kw["target_delay_ms"] is not None:
                self.target_delay_s = max(float(kw["target_delay_ms"]), 1.0) / 1000.0
            if "max_queue" in kw and kw["max_queue"] is not None:
                self.max_queue = max(1, int(kw["max_queue"]))
            if "retry_budget_ratio" in kw and kw["retry_budget_ratio"] is not None:
                self.retry_budget_ratio = float(kw["retry_budget_ratio"])
            if "min_limit" in kw and kw["min_limit"] is not None:
                self.min_limit = max(1, int(kw["min_limit"]))
            if "max_limit" in kw and kw["max_limit"] is not None:
                self.max_limit = max(self.min_limit, int(kw["max_limit"]))
            self.limit = float(
                min(max(self.limit, self.min_limit), self.max_limit)
            )

    def reset(self) -> None:
        """Back to process-start state (tests; mirrors faults.clear)."""
        self.__init__()

    # ---- pressure / tiers -------------------------------------------

    def _pressure_ratio_locked(self) -> float:
        r = self._delay_ewma / self.target_delay_s
        # queue occupancy escalates brownout pressure even while the
        # delay EWMA is still catching up — but saturates at tier 3:
        # actual overflow sheds via the dedicated queue_full bound, and
        # tier-4 reject stays reserved for the congestion signal itself
        occ = self._queued / self.max_queue
        if occ >= 0.5:
            r = max(r, 2.0 + 3.8 * (min(occ, 1.0) - 0.5))
        return r

    @staticmethod
    def _tier_of(ratio: float) -> int:
        if ratio < 0.5:
            return 0
        if ratio < 1.0:
            return 1
        if ratio < 2.0:
            return 2
        if ratio < 4.0:
            return 3
        return 4

    def pressure_tier(self) -> int:
        with self._lock:
            return self._tier_of(self._pressure_ratio_locked())

    def retry_after_s(self) -> int:
        """Computed backoff hint: the time for the current backlog to
        drain at the observed service rate (bounded 1..30s)."""
        with self._lock:
            return self._retry_after_locked()

    def _retry_after_locked(self) -> int:
        backlog = self._queued + self._inflight + 1
        drain = backlog * self._service_ewma / max(self.limit, 1.0)
        return int(min(max(math.ceil(drain), 1), 30))

    # ---- AIMD signal (fed by the batcher's enqueue→dispatch waits) ---

    def observe_queue_delay(self, seconds: float) -> None:
        """One congestion-signal sample: the measured wait between a
        job entering the batcher queue and its device dispatch (or a
        synthetic sample injected by the `load` fault kind)."""
        s = max(float(seconds), 0.0)
        with self._lock:
            self._delay_ewma += 0.3 * (s - self._delay_ewma)
            self._obs_since_decrease += 1
            window = max(int(self.limit), 1)
            if s > self.target_delay_s:
                self._calm_obs = 0
                if self._obs_since_decrease >= window:
                    self.limit = max(self.limit * 0.7, float(self.min_limit))
                    self._obs_since_decrease = 0
                    self.stats_counters["limit_decreases"] += 1
            elif self._delay_ewma < 0.5 * self.target_delay_s:
                self._calm_obs += 1
                if self._calm_obs >= window:
                    if self.limit < self.max_limit:
                        self.limit = min(
                            self.limit + 1.0, float(self.max_limit)
                        )
                        self.stats_counters["limit_increases"] += 1
                    self._calm_obs = 0

    # ---- retry budget ------------------------------------------------

    def retry_allowed(self) -> bool:
        """Spend one retry token (replica retry of a failed shard call).
        Tokens accrue at retry_budget_ratio per admitted request, so
        retry traffic is capped at ~ratio of live traffic."""
        with self._lock:
            if not self.enabled:
                self.stats_counters["retries_granted"] += 1
                return True
            # epsilon absorbs float accrual drift (10 × 0.1 ≠ 1.0)
            if self._retry_tokens >= 1.0 - 1e-9:
                self._retry_tokens = max(self._retry_tokens - 1.0, 0.0)
                self.stats_counters["retries_granted"] += 1
                return True
            self.stats_counters["retries_denied"] += 1
            return False

    # ---- acquire / release ------------------------------------------

    def acquire(
        self,
        tenant: str,
        weight: float = 1.0,
        deadline: Optional[float] = None,
        block: bool = True,
    ) -> Ticket:
        """Admit one request for `tenant` (index name). Returns a
        Ticket carrying the brownout tier, or raises EsOverloadedError
        (429 + Retry-After). Blocks in the tenant's fair queue while
        the node is at its concurrency limit."""
        # fault site: `error` rules raise as usual; `load` rules inject
        # their delay_ms as a synthetic congestion sample (deterministic
        # seeded draws — the replay-test substrate)
        eff = faults.check("admission.acquire", tenant=tenant)
        if eff and eff.get("load_ms"):
            self.observe_queue_delay(eff["load_ms"] / 1000.0)
        if not self.enabled:
            return Ticket(tenant, 0, counted=False)
        with self._lock:
            ts = self._tenants.get(tenant)
            if ts is None:
                ts = self._tenants[tenant] = _TenantState()
            ts.weight = max(float(weight), 1e-3)
            ratio = self._pressure_ratio_locked()
            tier = self._tier_of(ratio)
            if tier >= 4:
                self.stats_counters["shed_rejected"] += 1
                raise EsOverloadedError(
                    f"node overloaded (pressure {ratio:.2f}): rejecting "
                    f"[{tenant}] search",
                    retry_after_s=self._retry_after_locked(),
                    tier=4,
                    shed="pressure_reject",
                )
            free = self._inflight < int(self.limit)
            if free and not self._queued:
                return self._grant_locked(tenant, ts, tier)
            # at the limit (or fairness: earlier waiters exist) — queue
            if not block or self._queued >= self.max_queue:
                self.stats_counters["shed_queue_full"] += 1
                raise EsOverloadedError(
                    f"admission queue full [{self._queued}/"
                    f"{self.max_queue}]: rejecting [{tenant}] search",
                    retry_after_s=self._retry_after_locked(),
                    tier=max(tier, 3),
                    shed="queue_full",
                )
            w = _Waiter(tenant, deadline)
            if not ts.queue:
                # an idle tenant's pass snaps forward to the current
                # minimum so it cannot bank credit while away (stride
                # scheduling's lag bound)
                floor = min(
                    (t.vpass for t in self._tenants.values() if t.queue),
                    default=ts.vpass,
                )
                ts.vpass = max(ts.vpass, floor)
            ts.queue.append(w)
            self._queued += 1
            self.stats_counters["queued_total"] += 1
        # wait outside the lock; release() hands the slot over
        wait_s = None
        if deadline is not None:
            wait_s = max(deadline - time.monotonic(), 0.0) + 0.05
        if not w.event.wait(wait_s):
            # deadline expired while queued: withdraw (shed, not
            # served). release() pops AND grants under one lock hold,
            # so under our lock the waiter is either still queued
            # (withdraw wins) or already granted (grant wins) — no
            # in-between state.
            with self._lock:
                if not w.granted:
                    try:
                        ts.queue.remove(w)
                    except ValueError:  # pragma: no cover - shed race
                        pass
                    else:
                        self._queued -= 1
                        w.shed = "deadline"
                        self.stats_counters["shed_deadline"] += 1
        if w.granted:
            with self._lock:
                tier = self._tier_of(self._pressure_ratio_locked())
                return self._grant_locked(
                    tenant, self._tenants[tenant], tier, counted=True
                )
        raise EsOverloadedError(
            f"search request to [{tenant}] shed "
            f"({w.shed or 'deadline'}) after "
            f"{(time.monotonic() - w.t_enq) * 1000:.0f}ms in the "
            "admission queue",
            retry_after_s=self.retry_after_s(),
            tier=self.pressure_tier(),
            shed=w.shed or "deadline",
        )

    def _grant_locked(
        self, tenant: str, ts: _TenantState, tier: int,
        counted: bool = False,
    ) -> Ticket:
        # `counted`: release() already took the inflight slot when it
        # granted the waiter; immediate grants take it here
        if not counted:
            self._inflight += 1
        ts.active += 1
        ts.admitted += 1
        self.stats_counters["admitted"] += 1
        self._retry_tokens = min(
            self._retry_tokens + self.retry_budget_ratio,
            self.retry_budget_cap,
        )
        self._tier_grants[min(tier, len(TIER_NAMES) - 1)] += 1
        if tier > 0:
            self.stats_counters["brownouts"] += 1
        return Ticket(tenant, tier)

    def release(self, ticket: Ticket) -> None:
        """Completes one admitted request and hands freed slots to the
        fair queue — dropping dead (deadline-expired) waiters at
        dequeue instead of dispatching them."""
        if ticket is None or ticket.released or not ticket.counted:
            return
        ticket.released = True
        grants: List[_Waiter] = []
        now = time.monotonic()
        with self._lock:
            self._service_ewma += 0.1 * (
                max(now - ticket.t_grant, 0.0) - self._service_ewma
            )
            ts = self._tenants.get(ticket.tenant)
            if ts is not None and ts.active > 0:
                ts.active -= 1
            if self._inflight > 0:
                self._inflight -= 1
            # hand freed capacity to waiting tenants: lowest virtual
            # pass first; a dequeued waiter whose deadline already
            # passed is shed right here — never dispatched dead
            while self._inflight < int(self.limit):
                cand = None
                for t in self._tenants.values():
                    if t.queue and (cand is None or t.vpass < cand.vpass):
                        cand = t
                if cand is None:
                    break
                w = cand.queue.popleft()
                self._queued -= 1
                cand.vpass += STRIDE_BASE / cand.weight
                if w.deadline is not None and now > w.deadline:
                    w.shed = "deadline"
                    self.stats_counters["shed_deadline"] += 1
                    w.event.set()
                    continue
                w.granted = True
                self._inflight += 1
                grants.append(w)
        for w in grants:
            w.event.set()

    # ---- observability ----------------------------------------------

    def stats(self) -> dict:
        """The `admission` block in `_nodes/stats`."""
        with self._lock:
            ratio = self._pressure_ratio_locked()
            tier = self._tier_of(ratio)
            return {
                "enabled": self.enabled,
                "limit": int(self.limit),
                "min_limit": self.min_limit,
                "max_limit": self.max_limit,
                "inflight": self._inflight,
                "queued": self._queued,
                "max_queue": self.max_queue,
                "queue_delay_ewma_ms": round(self._delay_ewma * 1000.0, 3),
                "target_delay_ms": round(self.target_delay_s * 1000.0, 3),
                "pressure": round(ratio, 4),
                "pressure_tier": tier,
                "pressure_mode": TIER_NAMES[tier],
                "retry_after_s": self._retry_after_locked(),
                "retry_tokens": round(self._retry_tokens, 3),
                "tier_grants": {
                    TIER_NAMES[i]: n
                    for i, n in enumerate(self._tier_grants)
                },
                "tenants": {
                    name: {
                        "queued": len(t.queue),
                        "active": t.active,
                        "admitted": t.admitted,
                        "weight": t.weight,
                    }
                    for name, t in sorted(self._tenants.items())
                },
                **self.stats_counters,
            }


# ---------------------------------------------------------------------
# brownout degraded modes: progressively shed work as pressure rises
# ---------------------------------------------------------------------


def degradable(body: dict) -> bool:
    """Per-request brownout opt-out: `"allow_degraded": false` pins the
    request to full-fidelity execution (it still pays admission and can
    still be shed outright)."""
    return bool(body.get("allow_degraded", True))


def apply_brownout(body: dict, tier: int) -> tuple:
    """Returns (possibly-rewritten body, [action strings]) for one
    admitted request at `tier`. Tier semantics:

      1 shed_optional — skip work a degraded answer doesn't need: the
        DFS global-stats round and exact total tracking (capped at the
        ES default 10_000), profile output.
      2 shrink_window — halve retriever rank_window_size, halve kNN
        num_candidates (floor k), halve the rescore window_size (floor
        the requested page), cap terms-agg cardinality at 16.
      3 cache_only — agg-only (size:0) bodies must answer from the
        shard request cache; a miss is shed instead of computed.
        Non-agg requests keep their tier-2 degradation.

    Tier 4 never reaches here (acquire rejects)."""
    if tier <= 0 or not degradable(body):
        return body, []
    actions: List[str] = []
    out = dict(body)
    # tier >= 1: shed can_match-skippable / optional work
    if out.get("search_type") == "dfs_query_then_fetch":
        out.pop("search_type")
        actions.append("dfs_skipped")
    if out.get("track_total_hits") is True:
        out["track_total_hits"] = 10_000
        actions.append("total_hits_capped")
    if out.get("profile"):
        out.pop("profile")
        actions.append("profile_dropped")
        with admission._lock:
            admission.stats_counters["profiles_shed"] += 1
    if tier >= 2:
        def shrink_knn(sec):
            k = int(sec.get("k", 10))
            nc = int(sec.get("num_candidates", max(k, 10)))
            if nc > k:
                actions.append("num_candidates_halved")
                return {**sec, "num_candidates": max(nc // 2, k)}
            return sec

        if "knn" in out:
            knn = out["knn"]
            out["knn"] = (
                [shrink_knn(s) for s in knn]
                if isinstance(knn, list)
                else shrink_knn(knn)
            )
        resc = out.get("rescore")
        if isinstance(resc, dict):
            # shrink the second-stage rerank window (never below the
            # requested page, which would 400 at parse)
            floor = int(out.get("size", 10)) + int(out.get("from", 0))
            win = int(resc.get("window_size", 10))
            if win > max(floor, 1) and win > 10:
                resc = {**resc, "window_size": max(win // 2, floor, 10)}
                out["rescore"] = resc
                actions.append("rescore_window_halved")
        ret = out.get("retriever")
        if isinstance(ret, dict) and "rrf" in ret:
            rrf = dict(ret["rrf"])
            win = int(rrf.get("rank_window_size", 100))
            if win > 20:
                rrf["rank_window_size"] = max(win // 2, 20)
                ret = {**ret, "rrf": rrf}
                out["retriever"] = ret
                actions.append("rank_window_halved")
        aggs = out.get("aggs") or out.get("aggregations")
        if isinstance(aggs, dict):
            shrunk, hit = _shrink_agg_sizes(aggs, cap=16)
            if hit:
                out["aggs" if "aggs" in out else "aggregations"] = shrunk
                actions.append("agg_cardinality_capped")
    if tier >= 3:
        aggs = out.get("aggs") or out.get("aggregations")
        if aggs is not None and int(out.get("size", 10)) == 0:
            out["_cache_only"] = True
            actions.append("request_cache_only")
    return out, actions


def _shrink_agg_sizes(node: Any, cap: int) -> tuple:
    """Caps every terms-agg `size` in an agg tree at `cap`."""
    hit = False
    if not isinstance(node, dict):
        return node, False
    out = {}
    for k, v in node.items():
        if k == "terms" and isinstance(v, dict) and int(v.get("size", 10)) > cap:
            v = {**v, "size": cap}
            hit = True
        elif isinstance(v, dict):
            v, h = _shrink_agg_sizes(v, cap)
            hit = hit or h
        out[k] = v
    return out, hit


class RequestCacheOnlyMiss(EsOverloadedError):
    """Tier-3 brownout: an agg body that missed the request cache is
    shed instead of computed (the cache-only degraded mode)."""

    def __init__(self, index: str, shard: int, retry_after_s: float = 2.0):
        super().__init__(
            f"shard [{index}][{shard}] is serving cached-only responses "
            "under overload and this request missed the cache",
            retry_after_s=retry_after_s,
            tier=3,
            shed="cache_only_miss",
        )


# process-wide controller (one node per process in this deployment
# shape — the analog of the process-wide hbm_ledger / faults registry)
admission = AdmissionController()
