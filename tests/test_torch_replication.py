"""Replication, failover and peer recovery of the port against the JAX
package's, on the CPU.

tests/test_replication.py, tests/test_durability.py's
`TestReplicaConvergence` and the peer-recovery half of its torn-transfer
test, each run twice (`twin`): on JAX package nodes as the reference
tests build them and on the port's `TpuNode(device="cpu")`. Each run
asserts the reference test's invariants; the port's run is held to the
JAX package's: routing tables (primary, replicas, in-sync set, primary
term), doc counts, totals and pages, and `engine_state_checksum` of
every copy (live ids, versions, seq_nos and sources), which is the same
string in both packages for the same writes. Then the port's own
contract: every engine a replica, a peer recovery or a promotion opens
stays on the index's device, and the recovery's build runs there.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from elasticsearch_tpu_torch.index import segment_build

from test_torch_multinode import (  # noqa: F401  (multinode_harness is autouse)
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


def shard_checksums(p, node, index):
    idx = node.indices[index]
    return {sid: p.checksum(eng) for sid, eng in sorted(idx.local_shards.items())}


def copies_converged(p, nodes, index):
    """Every copy of every shard holds the same logical state; returns
    {sid: checksum}."""
    sums: dict = {}
    for n in nodes:
        for sid, ck in shard_checksums(p, n, index).items():
            sums.setdefault(sid, set()).add(ck)
    assert all(len(v) == 1 for v in sums.values()), sums
    return {sid: v.pop() for sid, v in sorted(sums.items())}


def dstats(p):
    return p.translog.durability_stats_snapshot()


# ---------------------------------------------------------------------------
# tests/test_replication.py
# ---------------------------------------------------------------------------


class TestReplicaWrites:
    def test_replicas_allocated_on_distinct_nodes(self):
        def run(p):
            a, b = make_cluster(p, 2, **FD)
            a.create_index("rep", {"settings": {"number_of_shards": 2,
                                                "number_of_replicas": 1}})
            for sid, raw in a.state["indices"]["rep"]["routing"].items():
                assert raw["primary"] != raw["replicas"][0]
                assert set(raw["in_sync"]) == {raw["primary"], raw["replicas"][0]}
            assert set(a.indices["rep"].local_shards) == {0, 1}
            assert set(b.indices["rep"].local_shards) == {0, 1}
            return routing_table(a, "rep")

        ref, got = twin(run)
        assert got == ref

    def test_writes_fan_out_to_replicas(self):
        def run(p):
            a, b = make_cluster(p, 2, **FD)
            a.create_index("fan", {"settings": {"number_of_shards": 2,
                                                "number_of_replicas": 1}})
            acks = [a.index_doc("fan", f"d{i}", {"n": i}) for i in range(20)]
            a.refresh("fan")
            for node in (a, b):
                idx = node.indices["fan"]
                assert sum(e.num_docs for e in idx.local_shards.values()) == 20
            for sid in (0, 1):
                assert (a.indices["fan"].local_shards[sid].max_seq_no
                        == b.indices["fan"].local_shards[sid].max_seq_no)
            return {"acks": acks, "sums": copies_converged(p, [a, b], "fan")}

        ref, got = twin(run)
        assert got == ref

    def test_delete_and_update_replicate(self):
        def run(p):
            a, b = make_cluster(p, 2, **FD)
            a.create_index("mut", {"settings": {"number_of_shards": 1,
                                                "number_of_replicas": 1}})
            a.index_doc("mut", "x", {"v": 1})
            a.index_doc("mut", "x", {"v": 2})
            a.index_doc("mut", "y", {"v": 1})
            a.delete_doc("mut", "y")
            a.refresh("mut")
            for node in (a, b):
                eng = node.indices["mut"].local_shards[0]
                assert eng.num_docs == 1
                assert eng.get("x")["_source"]["v"] == 2
                assert eng.get("y") is None
            return copies_converged(p, [a, b], "mut")

        ref, got = twin(run)
        assert got == ref

    def test_health_green_with_replicas(self):
        def run(p):
            a, _ = make_cluster(p, 2, **FD)
            a.create_index("h", {"settings": {"number_of_shards": 2,
                                              "number_of_replicas": 1}})
            h = a.cluster.health()
            assert h["status"] == "green" and h["active_shards"] == 4
            return h

        ref, got = twin(run)
        assert got == ref

    def test_health_yellow_when_replica_unallocatable(self):
        def run(p):
            a = p.node("node-0", **FD)
            a.create_index("solo", {"settings": {"number_of_shards": 1,
                                                 "number_of_replicas": 1}})
            h = a.cluster.health()
            assert h["status"] == "yellow"
            return h

        ref, got = twin(run)
        assert got == ref


class TestFailover:
    def test_node_death_promotes_replicas_no_data_loss(self):
        def run(p):
            a, b = make_cluster(p, 2, **FD)
            a.create_index("fo", {"settings": {"number_of_shards": 4,
                                               "number_of_replicas": 1}})
            a.bulk("fo", [{"op": "index", "id": f"d{i}",
                           "source": {"body": f"payload number {i}"}}
                          for i in range(30)])
            a.refresh("fo")
            b.close()
            wait_until(lambda: set(a.state["nodes"]) == {"node-0"},
                       msg="master to notice node-1 died")
            for raw in a.state["indices"]["fo"]["routing"].values():
                assert raw["primary"] == "node-0"
            h = a.cluster.health()
            assert h["status"] == "yellow"
            resp = a.search("fo", {"query": {"match": {"body": "payload"}},
                                   "size": 50})
            assert resp["hits"]["total"]["value"] == 30
            assert a.index_doc("fo", "post-mortem", {"body": "payload after"})
            a.refresh("fo")
            assert a.count("fo")["count"] == 31
            return {"routing": routing_table(a, "fo"), "health": h,
                    "resp": resp, "sums": shard_checksums(p, a, "fo")}

        ref, got = twin(run)
        assert got["routing"] == ref["routing"]
        assert got["health"] == ref["health"]
        assert got["sums"] == ref["sums"]
        assert_same_response(got["resp"], ref["resp"])

    def test_master_death_triggers_reelection(self):
        def run(p):
            a, b = make_cluster(p, 2, **FD)
            b.create_index("m", {"settings": {"number_of_shards": 2,
                                              "number_of_replicas": 1}})
            for i in range(10):
                b.index_doc("m", f"d{i}", {"body": f"doc {i}"})
            b.refresh("m")
            a.close()
            wait_until(lambda: b.is_master(), msg="node-1 to take over")
            assert set(b.state["nodes"]) == {"node-1"}
            for raw in b.state["indices"]["m"]["routing"].values():
                assert raw["primary"] == "node-1"
            resp = b.search("m", {"query": {"match": {"body": "doc"}},
                                  "size": 20})
            assert resp["hits"]["total"]["value"] == 10
            b.index_doc("m", "new", {"body": "doc eleven"})
            b.refresh("m")
            assert b.count("m")["count"] == 11
            return {"routing": routing_table(b, "m"), "resp": resp,
                    "sums": shard_checksums(p, b, "m")}

        ref, got = twin(run)
        assert got["routing"] == ref["routing"]
        assert got["sums"] == ref["sums"]
        assert_same_response(got["resp"], ref["resp"])


class TestPeerRecovery:
    def test_late_joiner_recovers_replicas_to_green(self, tmp_path):
        def run(p):
            a = p.node("node-0", data_path=str(tmp_path / p.name / "node-0"), **FD)
            a.create_index("pr", {"settings": {"number_of_shards": 2,
                                               "number_of_replicas": 1}})
            for i in range(25):
                a.index_doc("pr", f"d{i}", {"body": f"doc number {i}"})
            a.refresh("pr")
            assert a.cluster.health()["status"] == "yellow"
            b = p.node("node-1", seeds=[a.address],
                       data_path=str(tmp_path / p.name / "node-1"), **FD)
            wait_until(lambda: a.cluster.health()["status"] == "green",
                       msg="peer recovery to bring the cluster green")
            idx_b = b.indices["pr"]
            assert sum(e.num_docs for e in idx_b.local_shards.values()) == 25
            resp = b.search("pr", {"query": {"match": {"body": "doc"}},
                                   "size": 50})
            assert resp["hits"]["total"]["value"] == 25
            return {"routing": routing_table(a, "pr"), "resp": resp,
                    "sums": copies_converged(p, [a, b], "pr")}

        ref, got = twin(run)
        assert got["routing"] == ref["routing"]
        assert got["sums"] == ref["sums"]
        assert_same_response(got["resp"], ref["resp"])

    def test_bounce_node_recovers_missed_writes(self, tmp_path):
        def run(p):
            a, b = make_cluster(p, 2, tmp_path, **FD)
            a.create_index("bounce", {"settings": {"number_of_shards": 2,
                                                   "number_of_replicas": 1}})
            for i in range(10):
                a.index_doc("bounce", f"pre{i}", {"body": f"pre doc {i}"})
            a.refresh("bounce")
            b.close()
            wait_until(lambda: set(a.state["nodes"]) == {"node-0"},
                       msg="node-1 removal")
            for i in range(10):
                a.index_doc("bounce", f"mid{i}", {"body": f"mid doc {i}"})
            a.refresh("bounce")
            b2 = p.node("node-1", seeds=[a.address],
                        data_path=str(tmp_path / p.name / "node-1"), **FD)
            wait_until(lambda: a.cluster.health()["status"] == "green",
                       msg="re-replication after bounce")
            idx_b = b2.indices["bounce"]
            assert sum(e.num_docs for e in idx_b.local_shards.values()) == 20
            resp = b2.search("bounce", {"query": {"match": {"body": "mid"}},
                                        "size": 50})
            assert resp["hits"]["total"]["value"] == 10
            return {"routing": routing_table(a, "bounce"), "resp": resp,
                    "sums": copies_converged(p, [a, b2], "bounce")}

        ref, got = twin(run)
        assert got["routing"] == ref["routing"]
        assert got["sums"] == ref["sums"]
        assert_same_response(got["resp"], ref["resp"])

    def test_fast_rejoin_demotes_stale_copies(self, tmp_path):
        def run(p):
            a, b = make_cluster(p, 2, tmp_path, fd_interval=30.0, fd_retries=2)
            a.create_index("fr", {"settings": {"number_of_shards": 2,
                                               "number_of_replicas": 1}})
            for i in range(8):
                a.index_doc("fr", f"d{i}", {"body": f"doc {i}"})
            b.close()
            b2 = p.node("node-1", seeds=[a.address],
                        data_path=str(tmp_path / p.name / "node-1"),
                        fd_interval=0.1, fd_retries=2)
            wait_until(
                lambda: all("node-1" in e["in_sync"]
                            for e in a.state["indices"]["fr"]["routing"].values()),
                msg="bounced node to re-validate via peer recovery")
            assert a.cluster.health()["status"] == "green"
            idx_b = b2.indices["fr"]
            assert sum(e.num_docs for e in idx_b.local_shards.values()) == 8
            return {"routing": routing_table(a, "fr"),
                    "sums": copies_converged(p, [a, b2], "fr")}

        ref, got = twin(run)
        assert got == ref

    def test_in_sync_set_excludes_failed_copy_until_recovered(self, tmp_path):
        def run(p):
            a, b = make_cluster(p, 2, tmp_path, **FD)
            a.create_index("sync", {"settings": {"number_of_shards": 1,
                                                 "number_of_replicas": 1}})
            a.index_doc("sync", "one", {"body": "first"})
            b.close()
            wait_until(lambda: set(a.state["nodes"]) == {"node-0"},
                       msg="node-1 removal")
            entry = a.state["indices"]["sync"]["routing"]["0"]
            assert entry["in_sync"] == ["node-0"]
            assert entry["primary"] == "node-0"
            return entry

        ref, got = twin(run)
        assert got == ref


class TestAdaptiveReplicaSelection:
    def test_remote_hops_feed_ewma(self):
        def run(p):
            a, b, c = make_cluster(p, 3, fd_interval=5.0, fd_retries=2)
            a.create_index("ars", {"settings": {"number_of_shards": 6,
                                                "number_of_replicas": 0}})
            for i in range(12):
                a.index_doc("ars", str(i), {"body": f"doc {i}"})
            a.refresh("ars")
            pages = [b.search("ars", {"query": {"match": {"body": "doc"}}})
                     for _ in range(3)]
            assert b.response_ewma, "remote search hops were not measured"
            assert all(v > 0 for v in b.response_ewma.values())
            return {"measured": sorted(b.response_ewma), "pages": pages}

        ref, got = twin(run)
        assert got["measured"] == ref["measured"]
        for g, r in zip(got["pages"], ref["pages"]):
            assert_same_response(g, r)

    def test_selection_prefers_fastest_measured_copy(self):
        def run(p):
            def no_call(*a, **k):  # pragma: no cover
                raise AssertionError("not dispatched in this test")

            times: dict = {}
            idx = p.index_service(
                "ars-unit",
                settings={"number_of_shards": 1, "number_of_replicas": 2},
                routing={0: {"primary": "n1", "replicas": ["n2", "n3"],
                             "in_sync": ["n1", "n2", "n3"], "primary_term": 1}},
                local_node="n0",
                remote_call=no_call,
                response_times=times,
            )
            try:
                first = [idx._search_node(0) for _ in range(6)]
                assert set(first) <= {"n1", "n2", "n3"} and len(set(first)) >= 2
                times["n1"] = 0.5
                partial = [idx._search_node(0) for _ in range(6)]
                assert any(x in ("n2", "n3") for x in partial)
                times.update({"n2": 0.001, "n3": 2.0})
                full = [idx._search_node(0) for _ in range(16)]
                assert full.count("n2") >= 10 and len(set(full)) >= 2
                return first, partial, full
            finally:
                idx.close()

        ref, got = twin(run)
        assert got == ref


# ---------------------------------------------------------------------------
# tests/test_durability.py: TestReplicaConvergence and the torn transfer
# ---------------------------------------------------------------------------


class TestReplicaConvergence:
    def test_replica_failure_mid_replication_leaves_in_sync(self, tmp_path):
        def run(p):
            a, b = make_cluster(p, 2, tmp_path, **FD)
            a.create_index("conv", {"settings": {"number_of_shards": 1,
                                                 "number_of_replicas": 1}})
            a.index_doc("conv", "pre", {"body": "pre fault"})
            p.faults.configure({"seed": 3, "rules": [
                {"site": "replica.replicate", "kind": "error", "times": 1,
                 "match": {"target": "node-1"}},
            ]})
            r = a.index_doc("conv", "during", {"body": "during fault"})
            assert r["result"] in ("created", "updated")
            p.faults.clear()
            wait_until(lambda: a.cluster.health()["status"] == "green",
                       msg="re-replication after the injected replica failure")
            wait_until(lambda: shard_checksums(p, a, "conv")
                       == shard_checksums(p, b, "conv"),
                       msg="primary/replica checksum convergence")
            assert a.count("conv")["count"] == b.count("conv")["count"]
            return {"ack": r, "sums": shard_checksums(p, a, "conv"),
                    "routing": routing_table(a, "conv")}

        ref, got = twin(run)
        assert got == ref

    def test_recovery_transfer_fault_retried_to_green(self, tmp_path):
        def run(p):
            a = p.node("node-0", data_path=str(tmp_path / p.name / "node-0"), **FD)
            a.create_index("rt", {"settings": {"number_of_shards": 2,
                                               "number_of_replicas": 1}})
            for i in range(10):
                a.index_doc("rt", f"d{i}", {"body": f"doc {i}"})
            a.refresh("rt")
            before = dstats(p)["recovery_retries"]
            p.faults.configure({"seed": 5, "rules": [
                {"site": "recovery.transfer", "kind": "error", "times": 1},
            ]})
            b = p.node("node-1", seeds=[a.address],
                       data_path=str(tmp_path / p.name / "node-1"), **FD)
            wait_until(lambda: a.cluster.health()["status"] == "green",
                       msg="peer recovery to retry through the fault")
            retries = dstats(p)["recovery_retries"] - before
            assert retries > 0
            wait_until(lambda: shard_checksums(p, a, "rt")
                       == shard_checksums(p, b, "rt"),
                       msg="post-recovery checksum convergence")
            return {"retries": retries, "sums": shard_checksums(p, b, "rt"),
                    "routing": routing_table(a, "rt")}

        ref, got = twin(run)
        assert got == ref

    def test_recovery_finalize_redelivery_idempotent(self, tmp_path):
        def run(p):
            a, b = make_cluster(p, 2, tmp_path, **FD)
            a.create_index("fin", {"settings": {"number_of_shards": 1,
                                                "number_of_replicas": 1}})
            for i in range(6):
                a.index_doc("fin", f"d{i}", {"body": f"doc {i}"})
            wait_until(lambda: a.cluster.health()["status"] == "green",
                       msg="initial green")
            owner = a if a.indices["fin"]._owner(0) == "node-0" else b
            target = "node-1" if owner is a else "node-0"
            tnode = b if owner is a else a
            payload = {"index": "fin", "shard": 0, "target": target,
                       "local_seq": -1}
            before = dstats(p)["finalize_redelivered"]
            handler = owner.transport._handlers["internal:recovery/finalize"]
            fin1, fin2 = handler(payload), handler(payload)
            assert fin1["ops"] == fin2["ops"], "finalize must be idempotent"
            assert dstats(p)["finalize_redelivered"] > before
            eng = tnode.indices["fin"].local_shards[0]
            cks = p.checksum(eng)
            results = []
            for op in fin2["ops"]:
                if op["op"] == "index":
                    r = eng.index_replica(op["id"], op["source"], op["version"],
                                          op["seq_no"])
                else:
                    r = eng.delete_replica(op["id"], op["version"], op["seq_no"])
                assert r.result == "noop"
                results.append(r.result)
            assert p.checksum(eng) == cks
            return {"ops": fin2["ops"], "results": results, "sum": cks}

        ref, got = twin(run)
        assert got == ref

    def test_node_crash_restart_no_acked_loss(self, tmp_path):
        def run(p):
            path = str(tmp_path / p.name / "node-0")
            a = p.node("node-0", data_path=path, **FD)
            a.create_index("crashy", {"settings": {"number_of_shards": 2,
                                                   "number_of_replicas": 0}})
            for i in range(25):
                assert a.index_doc("crashy", f"d{i}",
                                   {"body": f"payload {i}"})["result"] == "created"
            a.crash()
            a2 = p.node("node-0", data_path=path, **FD)
            assert a2.count("crashy")["count"] == 25
            resp = a2.search("crashy", {"query": {"match": {"body": "payload"}},
                                        "size": 50})
            assert resp["hits"]["total"]["value"] == 25
            a2.index_doc("crashy", "post", {"body": "payload post"})
            a2.refresh("crashy")
            assert a2.count("crashy")["count"] == 26
            return {"resp": resp, "sums": shard_checksums(p, a2, "crashy")}

        ref, got = twin(run)
        assert got["sums"] == ref["sums"]
        assert_same_response(got["resp"], ref["resp"])

    def test_primary_crash_promotes_then_reconverges(self, tmp_path):
        def run(p):
            a, b = make_cluster(p, 2, tmp_path, **FD)
            a.create_index("pc", {"settings": {"number_of_shards": 2,
                                               "number_of_replicas": 1}})
            for i in range(20):
                a.index_doc("pc", f"d{i}", {"body": f"doc number {i}"})
            b.crash()
            wait_until(lambda: set(a.state["nodes"]) == {"node-0"},
                       msg="crashed node removal")
            a.refresh("pc")
            assert a.count("pc")["count"] == 20
            for i in range(20, 30):
                a.index_doc("pc", f"d{i}", {"body": f"doc number {i}"})
            b2 = p.node("node-1", seeds=[a.address],
                        data_path=str(tmp_path / p.name / "node-1"), **FD)
            wait_until(lambda: a.cluster.health()["status"] == "green",
                       msg="re-replication after crash restart")
            wait_until(lambda: shard_checksums(p, a, "pc")
                       == shard_checksums(p, b2, "pc"),
                       msg="post-crash checksum convergence")
            assert b2.count("pc")["count"] == 30
            return {"routing": routing_table(a, "pc"),
                    "sums": shard_checksums(p, b2, "pc")}

        ref, got = twin(run)
        assert got == ref


def test_torn_transfer_is_re_run_by_peer_recovery(tmp_path):
    """The peer-recovery half of test_durability.py's torn-transfer test:
    a replica whose shard dir still holds the `_recovering` marker stays
    shut and stays a recovery target; the recovery's wipe clears the
    torn files and `finish_peer_recovery` installs a fresh engine (on
    the index's device in the port)."""
    def run(p):
        base = str(tmp_path / p.name / "idx")
        shard_dir = os.path.join(base, "0")
        os.makedirs(shard_dir)
        with open(os.path.join(shard_dir, "_recovering"), "w") as f:
            f.write("node-1")
        with open(os.path.join(shard_dir, "manifest.json"), "w") as f:
            json.dump({"format_version": 2, "generation": 1,
                       "segments": [{"name": "seg_0_0", "live_gen": None}],
                       "max_seq_no": 4, "primary_term": 1}, f)
        idx = p.index_service(
            "torn",
            settings={"number_of_shards": 1, "number_of_replicas": 1},
            base_path=base,
            routing={0: {"primary": "node-0", "replicas": ["node-1"],
                         "in_sync": ["node-0"], "primary_term": 1}},
            local_node="node-1",
            remote_call=lambda *a, **k: (_ for _ in ()).throw(
                AssertionError("no dispatch in this test")),
        )
        try:
            assert 0 not in idx.local_shards
            assert idx.recovery_needed() == [0]
            path = idx.begin_peer_recovery(0)
            assert os.path.exists(os.path.join(path, "_recovering"))
            assert not os.path.exists(os.path.join(path, "manifest.json"))
            eng = idx.finish_peer_recovery(0)
            assert not os.path.exists(os.path.join(path, "_recovering"))
            assert eng.num_docs == 0
            if p is PORT:
                assert eng.device == torch.device("cpu")
            return sorted(os.listdir(path)), sorted(idx.local_shards)
        finally:
            idx.close()

    ref, got = twin(run)
    assert got == ref


# ---------------------------------------------------------------------------
# the port's device contract on the replication paths
# ---------------------------------------------------------------------------


@pytest.fixture
def device_build_auto(monkeypatch):
    """The suite pins `ES_TPU_DEVICE_BUILD=off`; these tests build on
    the index's device as a torch index does by default."""
    monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "auto")


@time_limit(90)
def test_replica_recovery_and_promotion_build_on_the_device(tmp_path, device_build_auto):
    """A restarted replica peer-recovers: phase 1 ships the primary's
    files, phase 2's ops refresh through a build on the index's device
    (never the host); a promoted copy keeps its engine and device."""
    a, b = make_cluster(PORT, 2, tmp_path, **FD)
    a.create_index("dv", {"settings": {"number_of_shards": 2,
                                       "number_of_replicas": 1}})
    for i in range(12):
        a.index_doc("dv", f"d{i}", {"body": f"doc number {i}"})
    a.refresh("dv")
    for node in (a, b):
        for eng in node.indices["dv"].local_shards.values():
            eng.flush()
    b.close()
    wait_until(lambda: set(a.state["nodes"]) == {"node-0"})
    for i in range(12, 20):
        a.index_doc("dv", f"d{i}", {"body": f"doc number {i}"})
    for eng in a.indices["dv"].local_shards.values():
        assert eng.device == torch.device("cpu")
    before = dict(segment_build.INGEST_STATS)
    files_before = dstats(PORT)["recovered_files"]
    b2 = PORT.node("node-1", seeds=[a.address],
                   data_path=str(tmp_path / "port" / "node-1"), **FD)
    wait_until(lambda: a.cluster.health()["status"] == "green", timeout=30)
    after = segment_build.INGEST_STATS
    assert dstats(PORT)["recovered_files"] > files_before
    assert after["device_builds"] > before["device_builds"]
    assert after["host_builds"] == before["host_builds"]
    assert after["fallbacks"] == before["fallbacks"]
    for eng in b2.indices["dv"].local_shards.values():
        assert eng.device == torch.device("cpu")
    assert sum(e.num_docs for e in b2.indices["dv"].local_shards.values()) == 20
    copies_converged(PORT, [a, b2], "dv")
