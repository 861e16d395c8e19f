"""Live shard relocation and allocation of the port against the JAX
package's, on the CPU.

tests/test_relocation.py run twice (`twin`): on JAX package nodes as the
reference test builds them and on the port's `TpuNode(device="cpu")`,
each package with its own fault registry and relocation counters (both
process-wide, reset around every run). Each run asserts the reference
test's invariants (no acknowledged write lost, surviving copies
checksum-identical, the relocation state machine's outcome); the port's
run is held to the JAX package's: the routing table after the move,
the reroute and explain answers, the relocation counters, totals and
pages. Runs that race a background writer against the move compare
what the race cannot change (the final table, the counters' outcome,
every acknowledged write present), not the count of acknowledged
writes.
"""

from __future__ import annotations

import threading
import time

import pytest

from test_torch_multinode import (  # noqa: F401  (multinode_harness is autouse)
    JAX,
    PORT,
    assert_same_response,
    make_cluster,
    multinode_harness,
    routing_table,
    time_limit,
    twin,
    wait_until,
)

FD = {"fd_interval": 0.1, "fd_retries": 2}
SITES = ["relocation.start", "relocation.transfer", "relocation.handoff"]


def routing(node, index, sid=0):
    return node.state["indices"][index]["routing"][str(sid)]


def copies_of(entry):
    return [entry["primary"]] + list(entry["replicas"])


def move_body(index, sid, src, dst):
    return {"commands": [{"move": {"index": index, "shard": sid,
                                   "from_node": src, "to_node": dst}}]}


def assert_copies_converged(p, nodes, index, sid=0):
    entry = routing(nodes[0], index, sid)
    by_name = {n.name: n for n in nodes}
    sums = {c: p.checksum(by_name[c].indices[index].local_shards[sid])
            for c in copies_of(entry)}
    assert len(set(sums.values())) == 1, f"copies diverged: {sums}"
    return next(iter(sums.values()))


def wait_relocation_done(node, index, sid=0, timeout=30.0):
    wait_until(lambda: not routing(node, index, sid).get("relocating"),
               timeout=timeout, msg="relocation marker to clear")
    wait_until(lambda: node.cluster.health()["status"] == "green",
               timeout=timeout, msg="green health after relocation")


def hit_ids(node, index, size=500):
    node.refresh(index)
    resp = node.search(index, {"query": {"match_all": {}}, "size": size})
    return {h["_id"] for h in resp["hits"]["hits"]}


def reloc(p):
    return p.allocation.relocation_stats_snapshot()


class LiveWriter:
    """Background indexer recording which writes were acknowledged."""

    def __init__(self, node, index, prefix="w"):
        self.node, self.index, self.prefix = node, index, prefix
        self.acked: set = set()
        self.errors: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        i = 0
        while not self._stop.is_set():
            doc_id = f"{self.prefix}{i}"
            try:
                r = self.node.index_doc(self.index, doc_id,
                                        {"body": f"live doc {i}", "n": i})
                if r.get("result") in ("created", "updated"):
                    self.acked.add(doc_id)
            except Exception as e:  # unacked: allowed to be lost
                self.errors.append(str(e))
            i += 1
            time.sleep(0.01)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5.0)


def seed_index(master, index, docs=20, shards=1, replicas=1):
    master.create_index(index, {"settings": {"number_of_shards": shards,
                                             "number_of_replicas": replicas}})
    for i in range(docs):
        master.index_doc(index, f"d{i}", {"body": f"doc {i}", "n": i})
    master.refresh(index)
    wait_until(lambda: master.cluster.health()["status"] == "green",
               msg="initial green")


def outsider(nodes, entry):
    return next(n.name for n in nodes if n.name not in copies_of(entry))


class TestRerouteMove:
    def test_move_replica_to_empty_node(self):
        def run(p):
            nodes = make_cluster(p, 3, **FD)
            a = nodes[0]
            seed_index(a, "mv")
            entry = routing(a, "mv")
            src, dst = entry["replicas"][0], outsider(nodes, entry)
            r = a.cluster.reroute(move_body("mv", 0, src, dst))
            assert r["acknowledged"] and not r["dry_run"]
            assert r["explanations"][0]["copy"] == "replica"
            wait_relocation_done(a, "mv")
            after = routing(a, "mv")
            assert src not in copies_of(after)
            assert dst in after["replicas"] and dst in after["in_sync"]
            assert after["primary"] == entry["primary"]
            assert after["primary_term"] == entry["primary_term"]
            ck = assert_copies_converged(p, nodes, "mv")
            stats = reloc(p)
            assert stats["started"] == stats["completed"] == 1
            return {"reroute": r, "after": after, "sum": ck,
                    "stats": {k: stats[k] for k in ("started", "completed",
                                                    "cancelled", "failed")}}

        ref, got = twin(run)
        assert got == ref

    def test_move_primary_bumps_term_and_retires_source(self):
        def run(p):
            nodes = make_cluster(p, 3, **FD)
            a = nodes[0]
            seed_index(a, "mvp")
            entry = routing(a, "mvp")
            src, dst = entry["primary"], outsider(nodes, entry)
            r = a.cluster.reroute(move_body("mvp", 0, src, dst))
            assert r["explanations"][0]["copy"] == "primary"
            wait_relocation_done(a, "mvp")
            after = routing(a, "mvp")
            assert after["primary"] == dst
            assert src not in copies_of(after) and src not in after["in_sync"]
            assert after["primary_term"] == entry["primary_term"] + 1
            w = a.index_doc("mvp", "post-move", {"body": "after cutover"})
            assert w["result"] in ("created", "updated")
            ck = assert_copies_converged(p, nodes, "mvp")
            return {"reroute": r, "after": after, "write": w, "sum": ck}

        ref, got = twin(run)
        assert got == ref

    def test_dry_run_changes_nothing(self):
        def run(p):
            nodes = make_cluster(p, 3, **FD)
            a = nodes[0]
            seed_index(a, "dry")
            before = routing(a, "dry")
            src, dst = before["primary"], outsider(nodes, before)
            r = a.cluster.reroute(move_body("dry", 0, src, dst), dry_run=True)
            assert r["dry_run"] is True
            assert r["explanations"][0]["to_node"] == dst
            time.sleep(0.3)
            assert routing(a, "dry") == before
            assert reloc(p)["started"] == 0
            return r, before

        ref, got = twin(run)
        assert got == ref

    def test_move_validation_errors(self):
        def run(p):
            nodes = make_cluster(p, 3, **FD)
            a = nodes[0]
            seed_index(a, "val")
            entry = routing(a, "val")
            seen = []
            cases = [
                ("unknown target node",
                 move_body("val", 0, entry["primary"], "node-99")),
                ("already holds a copy",
                 move_body("val", 0, entry["primary"], entry["replicas"][0])),
                ("holds no copy",
                 move_body("val", 0, outsider(nodes, entry), entry["replicas"][0])),
            ]
            for match, body in cases:
                with pytest.raises(p.ClusterError, match=match) as ei:
                    a.cluster.reroute(body)
                seen.append((ei.value.status, str(ei.value)))
            return seen

        ref, got = twin(run)
        assert got == ref

    def test_cancel_mid_transfer(self):
        def run(p):
            nodes = make_cluster(p, 3, **FD)
            a = nodes[0]
            seed_index(a, "cx", docs=30)
            entry = routing(a, "cx")
            src, dst = entry["primary"], outsider(nodes, entry)
            p.faults.configure({"seed": 11, "rules": [
                {"site": "relocation.transfer", "kind": "delay",
                 "delay_ms": 3000, "times": 1, "match": {"role": "target"}},
            ]})
            a.cluster.reroute(move_body("cx", 0, src, dst))
            wait_until(lambda: routing(a, "cx").get("relocating"),
                       msg="relocation marker to appear")
            r = a.cluster.reroute({"commands": [{"cancel": {"index": "cx",
                                                            "shard": 0}}]})
            assert r["explanations"][0]["cancelled"]["to"] == dst
            after = routing(a, "cx")
            assert not after.get("relocating")
            assert dst not in after["replicas"] and dst not in after["in_sync"]
            assert after["primary"] == src
            p.faults.clear()
            time.sleep(0.5)
            assert dst not in copies_of(routing(a, "cx"))
            wait_until(lambda: a.cluster.health()["status"] == "green",
                       msg="green after cancel")
            assert a.count("cx")["count"] == 30
            assert reloc(p)["cancelled"] == 1
            return {"cancel": r, "after": after,
                    "final": routing_table(a, "cx")}

        ref, got = twin(run)
        assert got == ref


class TestChaosMatrix:
    """Faults at every relocation site, on both endpoints: an `error`
    is retried to completion; a `crash` kills the faulted thread, the
    test kills the node, and the cluster heals on the survivors with no
    acknowledged write lost."""

    @pytest.mark.parametrize("site", SITES)
    @pytest.mark.parametrize("role", ["source", "target"])
    def test_error_fault_retried_to_completion(self, site, role):
        def run(p):
            nodes = make_cluster(p, 3, **FD)
            a = nodes[0]
            seed_index(a, "chaos", docs=25)
            entry = routing(a, "chaos")
            src, dst = entry["primary"], outsider(nodes, entry)
            p.faults.configure({"seed": 7, "rules": [
                {"site": site, "kind": "error", "times": 1,
                 "match": {"role": role}},
            ]})
            with LiveWriter(a, "chaos") as writer:
                a.cluster.reroute(move_body("chaos", 0, src, dst))
                wait_relocation_done(a, "chaos")
            trips = p.faults.describe()["rules"][0]["trips"]
            p.faults.clear()
            wait_until(lambda: a.cluster.health()["status"] == "green",
                       msg="green after fault retry")
            after = routing(a, "chaos")
            assert after["primary"] == dst and src not in copies_of(after)
            ids = hit_ids(a, "chaos")
            missing = writer.acked - ids
            assert not missing, f"acked writes lost: {sorted(missing)}"
            assert_copies_converged(p, nodes, "chaos")
            stats = reloc(p)
            assert stats["completed"] >= 1
            seeded = {f"d{i}" for i in range(25)}
            assert seeded <= ids
            return {"copies": sorted(copies_of(after)), "primary": after["primary"],
                    "trips": trips, "completed": stats["completed"] >= 1}

        ref, got = twin(run)
        assert got == ref

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    @pytest.mark.parametrize("site", SITES)
    @pytest.mark.parametrize("role", ["source", "target"])
    def test_crash_fault_node_death_heals(self, site, role):
        def run(p):
            nodes = make_cluster(p, 3, **FD)
            a = nodes[0]
            seed_index(a, "boom", docs=25)
            entry = routing(a, "boom")
            src, dst = entry["primary"], outsider(nodes, entry)
            victim_name = src if role == "source" else dst
            victim = next(n for n in nodes if n.name == victim_name)
            survivors = [n for n in nodes if n.name != victim_name]
            coordinator = survivors[0]
            p.faults.configure({"seed": 13, "rules": [
                {"site": site, "kind": "crash", "times": 1,
                 "match": {"role": role}},
            ]})
            with LiveWriter(coordinator, "boom") as writer:
                a.cluster.reroute(move_body("boom", 0, src, dst))
                wait_until(lambda: p.faults.describe()["rules"][0]["trips"] >= 1,
                           timeout=20.0, msg=f"crash fault at {site}/{role}")
                victim.crash()
                p.faults.clear()
                wait_until(lambda: victim_name not in coordinator.state["nodes"],
                           timeout=30.0, msg="victim removed from cluster state")
                wait_until(lambda: (coordinator.cluster.health()["status"] == "green"
                                    and not routing(coordinator, "boom")
                                    .get("relocating")),
                           timeout=30.0, msg="green convergence after crash")
            after = routing(coordinator, "boom")
            assert victim_name not in copies_of(after)
            ids = hit_ids(coordinator, "boom")
            missing = writer.acked - ids
            assert not missing, f"acked writes lost: {sorted(missing)}"
            assert {f"d{i}" for i in range(25)} <= ids
            assert_copies_converged(p, survivors, "boom")
            return {"victim": victim_name, "copies": sorted(copies_of(after)),
                    "nodes": sorted(coordinator.state["nodes"])}

        ref, got = twin(run)
        assert got == ref


class TestDrainAndRebalance:
    @time_limit(180)
    def test_drain_node_to_empty(self):
        def run(p):
            nodes = make_cluster(p, 3, **FD)
            a = nodes[0]
            seed_index(a, "drain", docs=15, shards=2, replicas=1)
            target = "node-2"
            a.cluster.update_cluster_settings({"transient": {
                "cluster.routing.allocation.exclude._name": target}})

            def held_by_target():
                return sum(1 for e in a.state["indices"]["drain"]["routing"].values()
                           if target in copies_of(e))

            def drained():
                for _ in range(3):
                    a.rebalance_tick()
                h = a.cluster.health()
                return (held_by_target() == 0 and h["relocating_shards"] == 0
                        and h["status"] == "green")

            wait_until(drained, timeout=60.0, interval=0.2,
                       msg="excluded node to drain to empty")
            assert a.count("drain")["count"] == 15
            rest = [n for n in nodes if n.name != target]
            sums = [assert_copies_converged(p, rest, "drain", sid=s) for s in (0, 1)]
            return {"sums": sums, "count": a.count("drain")}

        ref, got = twin(run)
        assert got == ref

    @time_limit(180)
    def test_rebalance_converges_skewed_layout(self):
        def run(p):
            nodes = make_cluster(p, 2, **FD)
            a = nodes[0]
            seed_index(a, "bal", docs=12, shards=4, replicas=0)
            p.node("node-2", seeds=[a.address], **FD)
            wait_until(lambda: "node-2" in a.state["nodes"],
                       msg="third node to join")

            def counts():
                per = {n: 0 for n in a.state["nodes"]}
                for e in a.state["indices"]["bal"]["routing"].values():
                    for copy in copies_of(e):
                        per[copy] += 1
                return per

            def balanced():
                for _ in range(3):
                    a.rebalance_tick()
                h = a.cluster.health()
                per = counts()
                return (max(per.values()) - min(per.values()) <= 1
                        and h["relocating_shards"] == 0 and h["status"] == "green")

            wait_until(balanced, timeout=60.0, interval=0.2,
                       msg="rebalance to even the shard spread")
            assert a.count("bal")["count"] == 12
            resp = a.search("bal", {"query": {"match": {"body": "doc"}},
                                    "size": 20})
            return {"spread": sorted(counts().values()), "resp": resp}

        ref, got = twin(run)
        assert got["spread"] == ref["spread"]
        assert_same_response(got["resp"], ref["resp"])

    @time_limit(180)
    def test_background_rebalancer_thread(self):
        def run(p):
            nodes = make_cluster(p, 2, rebalance_interval=0.2, **FD)
            a = nodes[0]
            seed_index(a, "auto", docs=8, shards=4, replicas=0)
            p.node("node-2", seeds=[a.address], rebalance_interval=0.2, **FD)

            def spread():
                per = {n: 0 for n in a.state["nodes"]}
                for e in a.state["indices"]["auto"]["routing"].values():
                    for copy in copies_of(e):
                        per[copy] += 1
                return max(per.values()) - min(per.values())

            wait_until(lambda: spread() <= 1
                       and a.cluster.health()["status"] == "green",
                       timeout=60.0, interval=0.2,
                       msg="background rebalancer to converge unaided")
            return {"spread": spread(), "count": a.count("auto")}

        ref, got = twin(run)
        assert got == ref


class TestAllocationEnableSetting:
    def test_invalid_value_rejected(self):
        def run(p):
            a = make_cluster(p, 2, **FD)[0]
            with pytest.raises(p.ClusterError) as ei:
                a.cluster.update_cluster_settings({"transient": {
                    "cluster.routing.allocation.enable": "sometimes"}})
            return ei.value.status, str(ei.value)

        ref, got = twin(run)
        assert got == ref

    def test_none_freezes_rebalancer_but_not_explicit_reroute(self):
        def run(p):
            nodes = make_cluster(p, 3, **FD)
            a = nodes[0]
            seed_index(a, "frz", docs=6, shards=4, replicas=0)
            a.cluster.update_cluster_settings({"transient": {
                "cluster.routing.allocation.enable": "none"}})
            frozen = a.rebalance_tick()
            assert frozen == []
            entry = routing(a, "frz")
            src, dst = entry["primary"], outsider(nodes, entry)
            r = a.cluster.reroute(move_body("frz", 0, src, dst))
            assert r["acknowledged"]
            wait_relocation_done(a, "frz")
            a.cluster.update_cluster_settings({"transient": {
                "cluster.routing.allocation.enable": "all"}})
            a.rebalance_tick()
            return {"reroute": r, "after": routing(a, "frz")}

        ref, got = twin(run)
        assert got == ref

    def test_setting_propagates_to_all_nodes(self):
        def run(p):
            nodes = make_cluster(p, 3, **FD)
            nodes[0].cluster.update_cluster_settings({"persistent": {
                "cluster.routing.allocation.enable": "primaries"}})
            key = "cluster.routing.allocation.enable"
            wait_until(lambda: all(n.cluster.cluster_settings.get(key)
                                   == "primaries" for n in nodes),
                       msg="setting to propagate through cluster state")
            return [n.cluster.cluster_settings.get(key) for n in nodes]

        ref, got = twin(run)
        assert got == ref


class TestAllocationExplain:
    def test_explain_shape_and_decider_verdicts(self):
        def run(p):
            nodes = make_cluster(p, 3, **FD)
            a = nodes[0]
            seed_index(a, "exp")
            a.cluster.update_cluster_settings({"transient": {
                "cluster.routing.allocation.exclude._name": "node-2"}})
            r = a.cluster.allocation_explain({"index": "exp", "shard": 0})
            assert r["index"] == "exp" and r["shard"] == 0
            assert r["current_state"] == "started"
            decisions = {d["node_name"]: d for d in r["node_allocation_decisions"]}
            excluded = decisions["node-2"]
            assert excluded["node_decision"] == "no"
            assert any(dec["decider"] == "filter" and dec["decision"] == "NO"
                       for dec in excluded["deciders"])
            for d in decisions.values():
                assert {"node_name", "node_decision", "deciders"} <= set(d)
            return r

        ref, got = twin(run)
        assert got == ref

    def test_explain_missing_index_404(self):
        def run(p):
            a = make_cluster(p, 2, **FD)[0]
            with pytest.raises(p.ClusterError) as ei:
                a.cluster.allocation_explain({"index": "nope", "shard": 0})
            return ei.value.status, ei.value.err_type

        ref, got = twin(run)
        assert got == ref


class TestHealthWaitParams:
    def test_wait_for_no_relocating_shards_times_out_then_succeeds(self):
        def run(p):
            nodes = make_cluster(p, 3, **FD)
            a = nodes[0]
            seed_index(a, "hw", docs=10)
            entry = routing(a, "hw")
            src, dst = entry["primary"], outsider(nodes, entry)
            p.faults.configure({"seed": 21, "rules": [
                {"site": "relocation.transfer", "kind": "delay",
                 "delay_ms": 2500, "times": 1, "match": {"role": "target"}},
            ]})
            a.cluster.reroute(move_body("hw", 0, src, dst))
            wait_until(lambda: routing(a, "hw").get("relocating"),
                       msg="relocation to be in flight")
            h = a.cluster.health({"wait_for_no_relocating_shards": "true",
                                  "timeout": "200ms"})
            assert h["timed_out"] is True and h["relocating_shards"] >= 1
            h2 = a.cluster.health({"wait_for_no_relocating_shards": "true",
                                   "timeout": "30s"})
            assert h2["timed_out"] is False and h2["relocating_shards"] == 0
            return {"during": (h["timed_out"], h["relocating_shards"]), "after": h2}

        ref, got = twin(run)
        assert got == ref

    def test_wait_for_status_and_invalid_param(self):
        def run(p):
            a = make_cluster(p, 2, **FD)[0]
            seed_index(a, "hs", docs=4)
            h = a.cluster.health({"wait_for_status": "green", "timeout": "10s"})
            assert h["status"] == "green" and h["timed_out"] is False
            errs = []
            for params in ({"wait_for_status": "chartreuse"},
                           {"wait_for_status": "green", "timeout": "bogus"}):
                with pytest.raises(p.ClusterError) as ei:
                    a.cluster.health(params)
                errs.append((ei.value.status, str(ei.value)))
            return h, errs

        ref, got = twin(run)
        assert got == ref


class TestRelocatingCopyQueryParity:
    def test_search_results_float_exact_during_relocation(self):
        def run(p):
            nodes = make_cluster(p, 3, **FD)
            a = nodes[0]
            seed_index(a, "par", docs=40)
            body = {"query": {"match": {"body": "doc"}}, "size": 50}
            baseline = a.search("par", body)
            entry = routing(a, "par")
            src, dst = entry["primary"], outsider(nodes, entry)
            p.faults.configure({"seed": 31, "rules": [
                {"site": "relocation.transfer", "kind": "delay",
                 "delay_ms": 2000, "times": 1, "match": {"role": "target"}},
            ]})
            a.cluster.reroute(move_body("par", 0, src, dst))
            wait_until(lambda: routing(a, "par").get("relocating"),
                       msg="relocation to be in flight")

            def key(hits):
                return [(h["_id"], h["_score"]) for h in hits["hits"]]

            for _ in range(10):
                during = a.search("par", body)["hits"]
                assert during["total"] == baseline["hits"]["total"]
                assert key(during) == key(baseline["hits"])
                time.sleep(0.05)
            p.faults.clear()
            wait_relocation_done(a, "par")
            after = a.search("par", body)
            assert key(after["hits"]) == key(baseline["hits"])
            return baseline, after

        ref, got = twin(run)
        for g, r in zip(got, ref):
            assert_same_response(g, r)


class TestRelocationStats:
    def test_nodes_stats_relocation_block(self):
        def run(p):
            nodes = make_cluster(p, 3, **FD)
            a = nodes[0]
            seed_index(a, "st", docs=8)
            entry = routing(a, "st")
            src, dst = entry["primary"], outsider(nodes, entry)
            a.cluster.reroute(move_body("st", 0, src, dst))
            wait_relocation_done(a, "st")
            stats = reloc(p)
            assert stats["started"] == 1 and stats["completed"] == 1
            assert stats["failed"] == 0 and stats["handoffs"] == 1
            assert stats["handoff_time_in_millis"] >= 0
            return {k: v for k, v in stats.items()
                    if k not in ("handoff_time_in_millis",)}

        ref, got = twin(run)
        assert got == ref
        assert set(PORT.allocation.relocation_stats_snapshot()) == set(
            JAX.allocation.relocation_stats_snapshot())
