"""Shard-allocation deciders, relocation accounting, and the rebalance
planner.

Reference analogs: the `cluster/routing/allocation` package —
EnableAllocationDecider (`cluster.routing.allocation.enable`),
FilterAllocationDecider (`cluster.routing.allocation.exclude._name`),
SameShardAllocationDecider, DiskThresholdDecider (here: the HBM ledger's
utilisation against `cluster.routing.allocation.watermark.high`), plus
BalancedShardsAllocator's rebalance pass and the per-node recovery /
relocation counters surfaced by `_nodes/stats`.

Everything here is pure planning over a cluster-state snapshot: the
master calls into this module under its state lock and turns the
returned move commands into relocation state-machine transitions
(cluster/node.py).  Decisions are returned with per-decider
explanations so `GET /_cluster/allocation/explain` can show *why* a
drain "does nothing".
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ..common.memory import hbm_ledger

# Error-message marker for writes refused by a source shard that has
# completed its relocation handoff (ES: ShardNotInPrimaryModeException,
# a retryable condition — the coordinator re-resolves the owner).
RELOCATED_MARKER = "shard_not_in_primary_mode"

ENABLE_SETTING = "cluster.routing.allocation.enable"
EXCLUDE_SETTING = "cluster.routing.allocation.exclude._name"
CONCURRENT_SETTING = "cluster.routing.allocation.cluster_concurrent_rebalance"
WATERMARK_SETTING = "cluster.routing.allocation.watermark.high"


# ---------------------------------------------------------------------------
# relocation stats (process-global counters; bump_durability_stat pattern)
# ---------------------------------------------------------------------------

_RELOC_LOCK = threading.Lock()
_RELOC_STATS: Dict[str, float] = {
    "started": 0,
    "completed": 0,
    "cancelled": 0,
    "failed": 0,
    "bytes": 0,
    "handoffs": 0,
    "handoff_time_in_millis": 0.0,
}


def bump_relocation_stat(key: str, n: float = 1) -> None:
    with _RELOC_LOCK:
        _RELOC_STATS[key] = _RELOC_STATS.get(key, 0) + n


def relocation_stats_snapshot() -> Dict[str, Any]:
    with _RELOC_LOCK:
        snap = dict(_RELOC_STATS)
    snap["handoff_time_in_millis"] = int(snap["handoff_time_in_millis"])
    for k in ("started", "completed", "cancelled", "failed", "bytes",
              "handoffs"):
        snap[k] = int(snap[k])
    return snap


def reset_relocation_stats() -> None:
    with _RELOC_LOCK:
        for k in _RELOC_STATS:
            _RELOC_STATS[k] = 0


# ---------------------------------------------------------------------------
# state-shape helpers
# ---------------------------------------------------------------------------

def iter_routing(state: dict):
    """Yields (index_name, sid_str, entry) over every routing entry."""
    for name, meta in (state.get("indices") or {}).items():
        for sid, entry in (meta.get("routing") or {}).items():
            yield name, sid, entry


def entry_copies(entry: dict) -> List[str]:
    """Every node holding (or receiving) a copy of this shard entry."""
    copies = []
    if entry.get("primary"):
        copies.append(entry["primary"])
    copies.extend(entry.get("replicas") or [])
    return copies


def relocations_in_flight(state: dict) -> List[Tuple[str, str, dict]]:
    out = []
    for name, sid, entry in iter_routing(state):
        rel = entry.get("relocating")
        if rel:
            out.append((name, sid, rel))
    return out


def shard_counts(state: dict) -> Dict[str, int]:
    """Copies per live node.  Relocation targets count toward their new
    home (they already consume resources there); sources still count
    until retired."""
    counts = {n: 0 for n in (state.get("nodes") or {})}
    for _name, _sid, entry in iter_routing(state):
        for node in entry_copies(entry):
            if node in counts:
                counts[node] += 1
    return counts


def excluded_nodes(settings) -> List[str]:
    raw = settings.get(EXCLUDE_SETTING) or ""
    return [n.strip() for n in str(raw).split(",") if n.strip()]


# ---------------------------------------------------------------------------
# deciders
# ---------------------------------------------------------------------------

def decide_allocation(
    settings,
    state: dict,
    entry: dict,
    node: str,
    *,
    copy: str = "replica",
    explicit: bool = False,
    moving_from: Optional[str] = None,
) -> List[dict]:
    """Runs every decider for placing one copy of `entry` on `node`.

    `copy` is "primary" or "replica" (what is being placed), `explicit`
    marks an operator reroute command (bypasses only the enable
    decider — ES's RoutingAllocation.ignoreDisabled), `moving_from`
    names the relocation source so the same-shard decider does not
    count the copy that is leaving.
    """
    decisions: List[dict] = []

    enable = settings.get(ENABLE_SETTING) or "all"
    if explicit:
        decisions.append({
            "decider": "enable", "decision": "YES",
            "explanation": "explicit reroute command bypasses the "
                           f"enable decider (setting is [{enable}])",
        })
    elif enable == "none":
        decisions.append({
            "decider": "enable", "decision": "NO",
            "explanation": f"[{ENABLE_SETTING}] is [none]: no shard "
                           "allocation or relocation is allowed",
        })
    elif enable == "primaries" and copy != "primary":
        decisions.append({
            "decider": "enable", "decision": "NO",
            "explanation": f"[{ENABLE_SETTING}] is [primaries]: replica "
                           "copies may not allocate or relocate",
        })
    else:
        decisions.append({
            "decider": "enable", "decision": "YES",
            "explanation": f"[{ENABLE_SETTING}] is [{enable}]",
        })

    excluded = excluded_nodes(settings)
    if node in excluded:
        decisions.append({
            "decider": "filter", "decision": "NO",
            "explanation": f"node [{node}] matches "
                           f"[{EXCLUDE_SETTING}]: {','.join(excluded)}",
        })
    else:
        decisions.append({
            "decider": "filter", "decision": "YES",
            "explanation": "node matches no exclude filter",
        })

    holders = set(entry_copies(entry))
    rel = entry.get("relocating") or {}
    if rel.get("to"):
        holders.add(rel["to"])
    if moving_from:
        holders.discard(moving_from)
    if node in holders:
        decisions.append({
            "decider": "same_shard", "decision": "NO",
            "explanation": f"node [{node}] already holds a copy of this "
                           "shard",
        })
    else:
        decisions.append({
            "decider": "same_shard", "decision": "YES",
            "explanation": "no other copy of this shard on the node",
        })

    watermark = float(settings.get(WATERMARK_SETTING) or 0.9)
    budget = max(1, hbm_ledger.budget)
    utilisation = hbm_ledger.used / budget
    if utilisation > watermark:
        decisions.append({
            "decider": "watermark", "decision": "NO",
            "explanation": f"HBM ledger utilisation {utilisation:.2f} "
                           f"exceeds [{WATERMARK_SETTING}]={watermark}",
        })
    else:
        decisions.append({
            "decider": "watermark", "decision": "YES",
            "explanation": f"HBM ledger utilisation {utilisation:.2f} "
                           f"within watermark {watermark}",
        })

    return decisions


def can_allocate(settings, state, entry, node, **kw) -> Tuple[bool, List[dict]]:
    decisions = decide_allocation(settings, state, entry, node, **kw)
    return all(d["decision"] == "YES" for d in decisions), decisions


def pick_allocation_node(
    settings,
    state: dict,
    entry: dict,
    counts: Dict[str, int],
    *,
    copy: str = "replica",
    moving_from: Optional[str] = None,
    explicit: bool = False,
) -> Optional[str]:
    """Least-loaded live node every decider accepts (None when blocked
    everywhere)."""
    best = None
    for node in sorted(counts, key=lambda n: (counts[n], n)):
        ok, _ = can_allocate(settings, state, entry, node, copy=copy,
                             explicit=explicit, moving_from=moving_from)
        if ok:
            best = node
            break
    return best


# ---------------------------------------------------------------------------
# allocation explain
# ---------------------------------------------------------------------------

def explain_allocation(settings, state: dict, index: str, sid: str) -> dict:
    """`GET /_cluster/allocation/explain` payload for one shard: the
    current copies, any in-flight relocation, and the per-node decider
    verdicts for placing one more copy."""
    meta = (state.get("indices") or {}).get(index) or {}
    entry = (meta.get("routing") or {}).get(str(sid))
    if entry is None:
        raise KeyError(f"no routing entry for [{index}][{sid}]")
    rel = entry.get("relocating")
    copy = "replica"
    if entry.get("primary") is None:
        copy = "primary"
    elif rel:
        copy = rel.get("copy", "replica")
    node_decisions = []
    for node in sorted(state.get("nodes") or {}):
        decisions = decide_allocation(
            settings, state, entry, node, copy=copy,
            moving_from=(rel or {}).get("from"))
        verdict = ("yes" if all(d["decision"] == "YES" for d in decisions)
                   else "no")
        node_decisions.append({
            "node_name": node,
            "node_decision": verdict,
            "deciders": decisions,
        })
    current_state = "started"
    if entry.get("primary") is None:
        current_state = "unassigned"
    elif rel:
        current_state = "relocating"
    return {
        "index": index,
        "shard": int(sid),
        "primary": copy == "primary",
        "current_state": current_state,
        "current_node": {"name": entry.get("primary")}
        if entry.get("primary") else None,
        "relocating": rel,
        "can_allocate": ("yes" if any(
            d["node_decision"] == "yes" for d in node_decisions) else "no"),
        "node_allocation_decisions": node_decisions,
    }


# ---------------------------------------------------------------------------
# rebalance planning
# ---------------------------------------------------------------------------

def plan_rebalance(settings, state: dict) -> List[dict]:
    """Plans `move` commands for one rebalancer tick: drain moves (copies
    sitting on excluded nodes) first, then count-balancing moves while
    the spread between the most- and least-loaded nodes is >= 2.  Spends
    at most `cluster_concurrent_rebalance` minus in-flight relocations.
    Every move goes through the same deciders as an allocation."""
    enable = settings.get(ENABLE_SETTING) or "all"
    if enable == "none":
        return []
    budget = int(settings.get(CONCURRENT_SETTING) or 2)
    budget -= len(relocations_in_flight(state))
    if budget <= 0:
        return []

    counts = shard_counts(state)
    if not counts:
        return []
    excluded = set(excluded_nodes(settings))
    moves: List[dict] = []
    # track shards already planned this tick so we never double-move
    planned = set()

    def copy_kind(entry, node):
        return "primary" if entry.get("primary") == node else "replica"

    def plan_move(name, sid, entry, from_node):
        kind = copy_kind(entry, from_node)
        if enable == "primaries" and kind != "primary":
            return False
        target = pick_allocation_node(
            settings, state, entry, counts, copy=kind,
            moving_from=from_node)
        if target is None or target == from_node:
            return False
        moves.append({"move": {
            "index": name, "shard": int(sid),
            "from_node": from_node, "to_node": target,
        }})
        planned.add((name, sid))
        counts[from_node] -= 1
        counts[target] += 1
        return True

    # 1. drain: get copies off excluded nodes
    for name, sid, entry in iter_routing(state):
        if len(moves) >= budget:
            return moves
        if entry.get("relocating") or (name, sid) in planned:
            continue
        for node in entry_copies(entry):
            if node in excluded and plan_move(name, sid, entry, node):
                break

    # 2. balance: shrink the max-min spread (excluded nodes can't receive,
    #    so they are not balance candidates as targets; as sources they
    #    were handled above)
    while len(moves) < budget:
        live = {n: c for n, c in counts.items() if n not in excluded}
        if len(live) < 2:
            break
        hi = max(live, key=lambda n: (live[n], n))
        lo = min(live, key=lambda n: (live[n], n))
        if live[hi] - live[lo] < 2:
            break
        moved = False
        for name, sid, entry in iter_routing(state):
            if entry.get("relocating") or (name, sid) in planned:
                continue
            if hi in entry_copies(entry) and plan_move(name, sid, entry, hi):
                moved = True
                break
        if not moved:
            break
    return moves
