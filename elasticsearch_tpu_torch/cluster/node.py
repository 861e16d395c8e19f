"""Multi-node cluster: membership, master, state publication, routing.

Reference analogs (SURVEY.md §2.7, §3.5): `Coordinator`/Zen2 election +
`PublicationTransportHandler` state publication, `PeerFinder` seed-host
discovery, `ShardRouting`/`AllocationService` shard→node assignment,
`TransportSearchAction` scatter/gather and `TransportShardBulkAction`
write routing. Per SURVEY §2.7's prescription for a fixed-topology TPU
pod, consensus is simplified to a deterministic single-writer design:
the master is the lowest node id among discovered peers, cluster state
is a versioned JSON snapshot published over the transport, and nodes
apply states monotonically by version.

The round-5 unification: each node fronts a full
:class:`DistributedClusterService` — the same `ClusterService` the
single-node REST tier uses, whose `IndexService` objects run in
*distributed mode* (``routing``/``local_node``/``remote_call``). Every
shard-level operation (full query phase with aggs/sort/knn/highlight,
scroll/PIT reader contexts, counts, stats, write batches) executes on
the shard's owning node over the transport, and the coordinator merges
exactly as the local path does (SearchService.executeQueryPhase +
SearchPhaseController, SURVEY §3.3). Metadata mutations (index CRUD,
mappings, settings, aliases, templates) route to the master, which
publishes the new cluster state to every node.

Data plane vs control plane: scoring stays on-device per node
(executor_torch), only metadata/doc blobs ride this DCN path.

PyTorch port: a node serves every index on its ``device`` ("cuda"
unless the caller passes another; no card → the constructor raises, as
the port's `ClusterService` does). Several in-process nodes share the
one card and the process-wide state (the device-memory ledger, the
fault registry, the durability and relocation counters).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid as _uuidlib
from typing import Any, Dict, List, Optional, Tuple

from ..common import deep_merge
from ..common.faults import InjectedFault, faults
from ..common.settings import SettingsError, validate_index_settings
from ..index.translog import bump_durability_stat
from ..index.mapping import MappingParseError, Mappings
from .allocation import RELOCATED_MARKER, bump_relocation_stat
from .indices import (
    ACTION_CTX_CLOSE,
    ACTION_CTX_OPEN,
    ACTION_SHARD_COUNT,
    ACTION_SHARD_CAN_MATCH,
    ACTION_SHARD_DFS,
    ACTION_SHARD_FLUSH,
    ACTION_SHARD_GET,
    ACTION_SHARD_OPS,
    ACTION_SHARD_REFRESH,
    ACTION_SHARD_REPLICA_OPS,
    ACTION_SHARD_SEARCH,
    ACTION_SHARD_STATS,
    ACTION_SNAPSHOT_SHARD,
    IndexService,
    apply_shard_ops,
    norm_shard_routing,
    _flatten_settings,
)
from .service import ClusterError, ClusterService, IndexNotFoundError, _validate_index_name
from ..transport.service import TransportError, TransportService
from ..utils.murmur3 import shard_id as route_shard_id


class NodeError(Exception):
    pass


class NotMasterError(NodeError):
    pass


# Reader-context TTL when the opener does not specify one (SearchService
# DEFAULT_KEEPALIVE is 5 minutes).
DEFAULT_CTX_KEEPALIVE = 300.0

# Marker a replica puts in its rejection when the SENDER's primary term
# is stale; the sender recognizes it (possibly re-hydrated into another
# error type by the transport) and does not report the replica failed.
STALE_PRIMARY_MARKER = "stale_primary_term"

# actions whose response times feed adaptive replica selection
# (ResponseCollectorService records search-phase responses only)
_ARS_ACTIONS = {ACTION_SHARD_SEARCH, ACTION_SHARD_COUNT}


class DistributedClusterService(ClusterService):
    """`ClusterService` whose metadata mutations ride through the master
    and whose `IndexService` objects run in distributed mode.

    Reads (search/count/scroll/PIT/resolve/aliases) are inherited
    unchanged — they operate on ``self.indices``, and the distributed
    `IndexService` routes per-shard work to owning nodes itself."""

    def __init__(self, node: "TpuNode"):
        super().__init__(
            data_path=None,
            cluster_name=node.cluster_name,
            node_name=node.name,
            device=node.device,
        )
        self.node = node
        # base path for local shard storage; cluster-state persistence is
        # handled by the node (_persist_state), not ClusterService._persist
        self.data_path = node.data_path

    # metadata persistence rides the node's published-state snapshot
    def _persist(self) -> None:
        pass

    def _recover(self) -> None:
        pass

    # ---- master round-trip mutations (TransportMasterNodeAction) ----

    def create_index(self, name: str, body: Optional[dict] = None) -> dict:
        return self.node.master_request(
            "indices:admin/create", {"name": name, "body": body or {}}
        )

    def delete_index(self, name: str) -> dict:
        return self.node.master_request("indices:admin/delete", {"name": name})

    def put_mapping(self, name: str, body: dict) -> dict:
        return self.node.master_request(
            "cluster:mapping/update", {"index": name, "mappings": body or {}}
        )

    def update_settings(self, name: str, body: dict) -> dict:
        return self.node.master_request(
            "indices:admin/settings", {"index": name, "settings": body or {}}
        )

    def update_aliases(self, body: dict) -> dict:
        return self.node.master_request("indices:admin/aliases", body or {})

    def put_template(self, name: str, body: dict) -> dict:
        return self.node.master_request(
            "indices:admin/template/put", {"name": name, "body": body or {}}
        )

    def delete_template(self, name: str) -> dict:
        return self.node.master_request(
            "indices:admin/template/delete", {"name": name}
        )

    def put_repository(self, name: str, body: dict) -> dict:
        return self.node.master_request(
            "cluster:repository/put", {"name": name, "body": body or {}}
        )

    def delete_repository(self, name: str) -> dict:
        return self.node.master_request(
            "cluster:repository/delete", {"name": name}
        )

    def put_pipeline(self, pid: str, body: dict) -> dict:
        return self.node.master_request(
            "cluster:pipeline/put", {"id": pid, "body": body or {}}
        )

    def delete_pipeline(self, pid: str) -> dict:
        return self.node.master_request("cluster:pipeline/delete", {"id": pid})

    def update_cluster_settings(self, body: dict) -> dict:
        """Dynamic cluster settings ride the master and publish with the
        state, so every node's deciders/rebalancer see the same values
        (ClusterUpdateSettingsAction → state publication)."""
        return self.node.master_request("cluster:settings/update", body or {})

    def reroute(self, body: Optional[dict] = None, dry_run: bool = False) -> dict:
        """POST /_cluster/reroute: explicit move / cancel /
        allocate_replica commands against the master's routing table."""
        payload = dict(body or {})
        payload["dry_run"] = bool(dry_run)
        return self.node.master_request("cluster:reroute", payload)

    def allocation_explain(self, body: Optional[dict] = None) -> dict:
        """GET /_cluster/allocation/explain: per-node decider verdicts
        for an unassigned or relocating shard."""
        return self.node.master_request(
            "cluster:allocation/explain", body or {}
        )

    def get_or_autocreate(self, name: str) -> IndexService:
        """Unlike the single-node base, this must NOT hold the service
        lock across the master round-trip (the publish-apply thread
        takes it)."""
        idx = self.indices.get(name)
        if idx is None:
            if not self.cluster_settings.get("action.auto_create_index"):
                raise IndexNotFoundError(name)
            try:
                self.create_index(name)
            except ClusterError as e:
                if e.err_type != "resource_already_exists_exception":
                    raise
            idx = self.indices.get(name)
            if idx is None:
                raise IndexNotFoundError(name)
        return idx

    # ---- state application (ClusterApplierService.applyClusterState) ----

    def apply_state(self, state: dict) -> None:
        """Reconciles local services with a freshly-applied cluster
        state: creates/updates/removes IndexService instances, replaces
        alias and template metadata, and kicks off peer recoveries for
        newly-assigned out-of-sync replica copies."""
        cs = state.get("cluster_settings")
        if cs is not None:
            # dynamic cluster settings ride the published state so every
            # node's deciders see the same values; load_layers only fires
            # consumers for keys whose effective value changed
            self.cluster_settings.load_layers(
                cs.get("persistent") or {}, cs.get("transient") or {}
            )
        self.aliases = state.get("aliases", {})
        self.templates = state.get("templates", {})
        self.repositories = state.get("repositories", {})
        self.ingest.load(state.get("pipelines", {}))
        recoveries: Dict[str, List[int]] = {}
        for name, meta in state.get("indices", {}).items():
            idx = self.indices.get(name)
            routing = {int(k): v for k, v in meta.get("routing", {}).items()}
            if idx is None:
                idx = IndexService(
                    name,
                    settings=meta.get("settings"),
                    mappings_json=meta.get("mappings"),
                    base_path=self._index_path(name),
                    routing=routing,
                    local_node=self.node.name,
                    remote_call=self.node.remote_call,
                    response_times=self.node.response_ewma,
                    device=self.device,
                )
                idx.uuid = meta.get("uuid", idx.uuid)
                idx.creation_date = meta.get("creation_date", idx.creation_date)
                # a copy that fails a search leaves the in-sync set the
                # same way a failed write replica does
                idx.on_shard_failure = self.node._report_shard_failed
                self.indices[name] = idx
            else:
                new_mappings = meta.get("mappings") or {}
                if new_mappings != idx.mappings.to_json():
                    idx.mappings.merge(new_mappings)
                settings = meta.get("settings") or {}
                flat = {
                    k: v
                    for k, v in _flatten_settings(settings).items()
                    if not k.startswith("analysis.")
                }
                idx.settings.update(flat)
                idx.apply_translog_settings()
                idx.apply_refresh_settings()
                idx.apply_slowlog_settings()
                idx.apply_routing(routing)
            needs = idx.recovery_needed()
            if needs:
                recoveries[name] = needs
        for name in list(self.indices):
            if name not in state.get("indices", {}):
                idx = self.indices.pop(name)
                idx.close()
                path = self._index_path(name)
                if path and os.path.isdir(path):
                    import shutil

                    shutil.rmtree(path, ignore_errors=True)
        self.version = state.get("version", self.version)
        for name, sids in recoveries.items():
            self.node.schedule_recoveries(name, sids)

    def _restore_index(
        self, repository, snap: str, entry: dict, source_name: str, target: str
    ) -> None:
        """Distributed restore: index creation rides the master (so the
        routing table allocates copies cluster-wide), then shards replay
        through the routed write path. History (versions/seqnos) is
        fresh — the restored CONTENT is exact."""
        from .service import _docs_from_snapshot_files

        imeta = entry["indices"][source_name]
        num_shards = int(imeta["num_shards"])
        settings = dict(imeta.get("settings") or {})
        self.create_index(
            target, {"settings": settings, "mappings": imeta.get("mappings")}
        )
        idx = self.indices[target]
        for sid in range(num_shards):
            docs = repository.shard_docs(snap, source_name, sid)
            if docs is None:
                files = repository.shard_files(snap, source_name, sid)
                if files is None:
                    continue
                docs = _docs_from_snapshot_files(
                    files, imeta.get("mappings"), imeta.get("settings")
                )
            if docs:
                idx._shard_ops(
                    sid,
                    [
                        {"op": "index", "id": d["id"], "source": d["source"]}
                        for d in docs
                    ],
                )
        idx.refresh()

    def _health_snapshot(self) -> dict:
        """Shard-level red/yellow/green from the routing table
        (TransportClusterHealthAction): red = a shard with no live
        primary, yellow = desired replicas missing or out of sync.
        A relocation target counts as `relocating_shards` — NOT as
        initializing or missing, so a drain keeps the cluster green
        (the source copy is still active and serving)."""
        state = self.node.state
        n_nodes = len(state.get("nodes", {}))
        active_primaries = 0
        active_shards = 0
        unassigned = 0
        initializing = 0
        relocating = 0
        status = "green"
        for meta in state.get("indices", {}).values():
            desired = int(
                (meta.get("settings") or {}).get("number_of_replicas", 1)
            )
            for raw in meta.get("routing", {}).values():
                entry = norm_shard_routing(raw)
                if entry["primary"] is None:
                    unassigned += 1 + desired
                    status = "red"
                    continue
                active_primaries += 1
                active_shards += 1
                in_sync_replicas = [
                    n for n in entry["replicas"] if n in entry["in_sync"]
                ]
                active_shards += len(in_sync_replicas)
                out_of_sync = [
                    n for n in entry["replicas"] if n not in entry["in_sync"]
                ]
                rel_target = (entry.get("relocating") or {}).get("to")
                if rel_target in out_of_sync:
                    relocating += 1
                    out_of_sync.remove(rel_target)
                recovering = len(out_of_sync)
                initializing += recovering
                missing = desired - len(in_sync_replicas)
                if missing > 0:
                    unassigned += max(0, missing - recovering)
                    if status != "red":
                        status = "yellow"
        total = active_shards + unassigned + initializing
        return {
            "cluster_name": self.cluster_name,
            "status": status,
            "timed_out": False,
            "number_of_nodes": n_nodes,
            "number_of_data_nodes": n_nodes,
            "active_primary_shards": active_primaries,
            "active_shards": active_shards,
            "relocating_shards": relocating,
            "initializing_shards": initializing,
            "unassigned_shards": unassigned,
            "delayed_unassigned_shards": 0,
            "number_of_pending_tasks": 0,
            "number_of_in_flight_fetch": 0,
            "task_max_waiting_in_queue_millis": 0,
            "active_shards_percent_as_number": (
                100.0 if total == 0 else round(100.0 * active_shards / total, 1)
            ),
        }


class TpuNode:
    """One cluster node: transport endpoint + distributed cluster
    service + coordinator.

    Every public document/search method can be called on ANY node (the
    coordinating-node model): the call routes to owning nodes over the
    transport, exactly `TransportBulkAction`/`TransportSearchAction`."""

    def __init__(
        self,
        name: str,
        seeds: Optional[List[Tuple[str, int]]] = None,
        data_path: Optional[str] = None,
        cluster_name: str = "elasticsearch-tpu",
        port: int = 0,
        fd_interval: float = 1.0,
        fd_retries: int = 3,
        rebalance_interval: Optional[float] = None,
        device="cuda",
    ):
        import torch

        # every index of this node serves on this device; the CPU only
        # when the caller asks for it (no fallback)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"TpuNode [{name}]: device 'cuda' was asked for and no CUDA "
                "device is available (pass device='cpu' to run on the CPU)"
            )
        self.name = name
        self.seeds = [tuple(s) for s in (seeds or [])]
        self.data_path = data_path
        self.cluster_name = cluster_name
        # failure detection (FollowersChecker/LeaderChecker cadence)
        self.fd_interval = fd_interval
        self.fd_retries = fd_retries
        self._fd_stop = threading.Event()
        self._fd_thread: Optional[threading.Thread] = None
        self._fd_failures: Dict[str, int] = {}
        # background rebalancer cadence (BalancedShardsAllocator): only
        # the elected master acts on a tick. Opt-in — when None, tests
        # and operators drive rebalance_tick() / reroute explicitly.
        self.rebalance_interval = rebalance_interval
        self._rebalance_thread: Optional[threading.Thread] = None
        # fresh per process start — the allocation-id analog that lets
        # the master tell a restarted node from a live one on re-join
        self.incarnation = _uuidlib.uuid4().hex[:12]
        self.transport = TransportService(name, cluster_name, port=port)
        self.state: dict = {
            "version": 0,
            "master": None,
            "nodes": {},
            "indices": {},
            "aliases": {},
            "templates": {},
        }
        self._state_lock = threading.RLock()
        self.cluster = DistributedClusterService(self)
        # pinned reader contexts held for remote scroll/PIT coordinators
        # (SearchService.createAndPutReaderContext registry)
        self._ctxs: Dict[str, dict] = {}
        self._ctx_lock = threading.Lock()
        # in-flight peer recoveries, keyed (index, shard) — repeated
        # state applications must not start duplicate recoveries
        self._recovering: set = set()
        self._recovery_lock = threading.Lock()
        # adaptive replica selection: EWMA response seconds per node
        # (ResponseCollectorService) fed by remote_call timings
        self.response_ewma: Dict[str, float] = {}
        # quorum tracking: a master that loses contact with a majority
        # of the last-known node set steps down — it keeps serving
        # reads but refuses metadata mutations until quorum returns
        # (the Zen2 voting-majority rule, single-phase approximation)
        self._quorum_lost = False
        self._closed = False
        self._register_handlers()

    # expose the index registry (tests + REST introspection)
    @property
    def indices(self) -> Dict[str, IndexService]:
        return self.cluster.indices

    # ------------------------------------------------------------------
    # lifecycle, discovery, election (PeerFinder + simplified Zen2)
    # ------------------------------------------------------------------

    def start(self) -> "TpuNode":
        self.transport.start()
        peers: Dict[str, Tuple[str, int]] = {self.name: self.transport.address}
        for addr in self.seeds:
            if addr == self.transport.address:
                continue
            nid = self.transport.ping(addr)
            if nid is not None:
                peers[nid] = addr
        master = min(peers)  # deterministic: lowest node id wins
        if master == self.name:
            # GatewayMetaState analog: a restarting master recovers its
            # persisted index metadata. The recovered state is built as a
            # NEW dict with a version bump so the monotonic check in
            # _apply_state sees a genuine increase.
            persisted = self._load_persisted_state()
            recovered = {
                "version": (persisted or {}).get("version", 0) + 1,
                "master": self.name,
                "nodes": {
                    self.name: {
                        "address": list(self.transport.address),
                        "uuid": self.incarnation,
                    }
                },
                "indices": (persisted or {}).get("indices", {}),
                "aliases": (persisted or {}).get("aliases", {}),
                "templates": (persisted or {}).get("templates", {}),
                "repositories": (persisted or {}).get("repositories", {}),
                "pipelines": (persisted or {}).get("pipelines", {}),
            }
            self._apply_state(recovered)
        else:
            state = self.transport.send(
                peers[master],
                "cluster:join",
                {
                    "node": self.name,
                    "address": list(self.transport.address),
                    "uuid": self.incarnation,
                },
            )
            self._apply_state(state)
        self._fd_thread = threading.Thread(
            target=self._fd_loop, name=f"fd-{self.name}", daemon=True
        )
        self._fd_thread.start()
        if self.rebalance_interval:
            self._rebalance_thread = threading.Thread(
                target=self._rebalance_loop,
                name=f"rebalance-{self.name}",
                daemon=True,
            )
            self._rebalance_thread.start()
        return self

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._fd_stop.set()
        if self._fd_thread is not None:
            self._fd_thread.join(timeout=5.0)
        if self._rebalance_thread is not None:
            self._rebalance_thread.join(timeout=5.0)
        self.cluster.close()
        self.transport.close()

    def crash(self):
        """Simulated power loss: the counterpart of close() for the
        durability harness. Engines are abandoned WITHOUT flush/close
        (their translogs drop any acked-but-unfsynced tail, no manifest
        is written, no WAL is trimmed), while the process-local pieces a
        dead box takes with it anyway — transport, fd loop, batcher
        threads, device ledger charges — are torn down so the surviving
        test process stays hermetic. Restarting a node on the same
        data_path afterwards exercises the real recovery path."""
        if self._closed:
            return
        self._closed = True
        self._fd_stop.set()
        if self._fd_thread is not None:
            self._fd_thread.join(timeout=5.0)
        if self._rebalance_thread is not None:
            self._rebalance_thread.join(timeout=5.0)
        self.transport.close()
        for idx in list(self.cluster.indices.values()):
            try:
                idx.crash()
            except Exception:
                pass

    @property
    def address(self) -> Tuple[str, int]:
        return self.transport.address

    def is_master(self) -> bool:
        return self.state.get("master") == self.name

    # ------------------------------------------------------------------
    # routing helpers
    # ------------------------------------------------------------------

    def remote_call(self, node_id: str, action: str, payload, timeout: float = 30.0):
        """Dispatch to a node by id: local shortcut or transport hop
        (the `NodeClient` pattern). This is the `remote_call` seam the
        distributed IndexService rides. Response times feed the ARS
        EWMA (ResponseCollectorService)."""
        if node_id == self.name:
            return self.transport._handlers[action](payload)
        info = self.state["nodes"].get(node_id)
        if info is None:
            raise NodeError(f"unknown node [{node_id}]")
        if action not in _ARS_ACTIONS:
            # only search-phase responses feed the routing signal —
            # recovery chunks / replication would pollute it
            return self._send(tuple(info["address"]), action, payload, timeout)
        t0 = time.perf_counter()
        try:
            out = self._send(tuple(info["address"]), action, payload, timeout)
        except BaseException:
            # a fast failure must NOT look like a fast response: blend
            # in the full timeout as a penalty so dead/misbehaving
            # copies deprioritize instead of attracting traffic
            prev = self.response_ewma.get(node_id)
            self.response_ewma[node_id] = (
                timeout if prev is None else 0.7 * prev + 0.3 * timeout
            )
            raise
        dt = time.perf_counter() - t0
        prev = self.response_ewma.get(node_id)
        self.response_ewma[node_id] = (
            dt if prev is None else 0.7 * prev + 0.3 * dt
        )
        return out

    def master_request(self, action: str, payload, timeout: float = 30.0):
        """Route a metadata mutation to the master
        (TransportMasterNodeAction)."""
        if self.is_master():
            return self.transport._handlers[action](payload)
        m = self.state.get("master")
        info = self.state["nodes"].get(m)
        if info is None:
            raise NodeError("no known master")
        return self._send(tuple(info["address"]), action, payload, timeout)

    def _send(self, address: Tuple[str, int], action: str, payload, timeout: float):
        """transport.send + re-hydration of ClusterError-shaped remote
        failures so REST status codes survive the hop."""
        from ..transport.service import RemoteTransportError

        try:
            return self.transport.send(address, action, payload, timeout)
        except RemoteTransportError as e:
            if e.status is not None and e.err_type is not None:
                raise ClusterError(e.status, str(e), e.err_type)
            raise

    # ------------------------------------------------------------------
    # handlers
    # ------------------------------------------------------------------

    def _register_handlers(self):
        t = self.transport
        t.register_handler("internal:ping", lambda p: {"node": self.name})
        t.register_handler("cluster:join", self._handle_join)
        t.register_handler("cluster:state/publish", self._handle_publish)
        t.register_handler("cluster:state/get", lambda p: self.state)
        t.register_handler("cluster:mapping/update", self._handle_mapping_update)
        t.register_handler("indices:admin/create", self._handle_create_index)
        t.register_handler("indices:admin/delete", self._handle_delete_index)
        t.register_handler("indices:admin/settings", self._handle_update_settings)
        t.register_handler("indices:admin/aliases", self._handle_update_aliases)
        t.register_handler("indices:admin/template/put", self._handle_put_template)
        t.register_handler(
            "indices:admin/template/delete", self._handle_delete_template
        )
        t.register_handler(ACTION_SHARD_REFRESH, self._handle_refresh_shards)
        t.register_handler(ACTION_SHARD_FLUSH, self._handle_flush_shards)
        t.register_handler(ACTION_SHARD_STATS, self._handle_shard_stats)
        t.register_handler(ACTION_SHARD_OPS, self._handle_shard_ops)
        t.register_handler(ACTION_SHARD_GET, self._handle_get)
        t.register_handler(ACTION_SHARD_SEARCH, self._handle_search_shard)
        t.register_handler(ACTION_SHARD_COUNT, self._handle_count_shard)
        t.register_handler(ACTION_SHARD_DFS, self._handle_dfs_shard)
        t.register_handler(ACTION_SHARD_CAN_MATCH, self._handle_can_match)
        t.register_handler(ACTION_CTX_OPEN, self._handle_ctx_open)
        t.register_handler(ACTION_CTX_CLOSE, self._handle_ctx_close)
        t.register_handler(ACTION_SHARD_REPLICA_OPS, self._handle_replica_ops)
        t.register_handler("internal:fd/ping", self._handle_fd_ping)
        t.register_handler("internal:recovery/start", self._handle_recovery_start)
        t.register_handler(
            "internal:recovery/finalize", self._handle_recovery_finalize
        )
        t.register_handler("cluster:shard/failed", self._handle_shard_failed)
        t.register_handler("cluster:shard/started", self._handle_shard_started)
        t.register_handler(ACTION_SNAPSHOT_SHARD, self._handle_snapshot_shard)
        t.register_handler("cluster:repository/put", self._handle_repo_put)
        t.register_handler("cluster:repository/delete", self._handle_repo_delete)
        t.register_handler("cluster:pipeline/put", self._handle_pipeline_put)
        t.register_handler(
            "cluster:pipeline/delete", self._handle_pipeline_delete
        )
        t.register_handler("cluster:reroute", self._handle_reroute)
        t.register_handler(
            "cluster:allocation/explain", self._handle_allocation_explain
        )
        t.register_handler(
            "cluster:settings/update", self._handle_settings_update
        )
        t.register_handler(
            "internal:relocation/handoff", self._handle_relocation_handoff
        )

    # ---- membership + publication ----

    def _handle_join(self, p: dict) -> dict:
        with self._state_lock:
            self._require_master()
            new = _copy_state(self.state)
            prev = new["nodes"].get(p["node"])
            new["nodes"][p["node"]] = {
                "address": p["address"],
                "uuid": p.get("uuid"),
            }
            if prev is not None and prev.get("uuid") != p.get("uuid"):
                # a RESTARTED incarnation: its copies may have missed
                # acked writes, so they leave every in-sync set and
                # peer-recover back in (the allocation-id freshness check
                # of IndexMetadata.inSyncAllocationIds). A shard whose
                # only copy it holds keeps it as primary — whatever is on
                # its disk is all the data that exists.
                _demote_node_copies(new, p["node"])
            # a (re)joining node is a fresh allocation target for any
            # under-replicated shard (AllocationService.reroute on join)
            _fill_replicas(new, self.cluster.cluster_settings)
            new["version"] += 1
            self._publish(new)
            return self.state

    def _handle_publish(self, p: dict) -> dict:
        self._apply_state(p)
        return {"ack": True, "node": self.name, "version": p.get("version")}

    def _publish(self, new_state: dict):
        """Master applies locally then pushes to every other node
        (PublicationTransportHandler; single-phase). A node that misses
        a publish is NOT forgotten: the per-node retry here plus the
        failure-detector's version re-sync (`_check_followers` resends
        the current state whenever a ping reports a stale version) keep
        every reachable node converged (LagDetector analog)."""
        self._apply_state(new_state)
        for nid, info in new_state["nodes"].items():
            if nid == self.name:
                continue
            for attempt in (0, 1):
                try:
                    self.transport.send(
                        tuple(info["address"]), "cluster:state/publish", new_state
                    )
                    break
                except TransportError:
                    if attempt == 1:
                        # lag repair happens in the fd loop
                        pass

    def _apply_state(self, state: dict):
        """ClusterApplierService.onNewClusterState: monotonic by version;
        reconciles the local service registry to the routing table."""
        with self._state_lock:
            if state["version"] <= self.state.get("version", 0):
                return
            self.state = state
            self.cluster.apply_state(state)
            self._persist_state()

    def _require_master(self):
        if not self.is_master():
            raise NotMasterError(f"[{self.name}] is not the master")
        if self._quorum_lost:
            # stepped down: a partitioned master must not accept
            # metadata mutations its majority side could contradict
            raise NotMasterError(
                f"[{self.name}] is master but cannot reach a majority of "
                "the last-known node set; refusing metadata mutations "
                "until quorum returns"
            )

    # ---- persisted cluster state (PersistedClusterStateService) ----

    def _state_path(self) -> Optional[str]:
        if self.data_path is None:
            return None
        return os.path.join(self.data_path, "_cluster_state.json")

    def _persist_state(self):
        path = self._state_path()
        if path is None:
            return
        os.makedirs(self.data_path, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _load_persisted_state(self) -> Optional[dict]:
        path = self._state_path()
        if path is None:
            return None
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    # ------------------------------------------------------------------
    # failure detection + elastic recovery (FollowersChecker /
    # LeaderChecker / NodeLeftExecutor, SURVEY §5)
    # ------------------------------------------------------------------

    def _handle_fd_ping(self, p: dict) -> dict:
        return {"node": self.name, "version": self.state.get("version", 0)}

    def _fd_loop(self):
        while not self._fd_stop.wait(self.fd_interval):
            if self._closed:
                return
            try:
                if self.is_master():
                    self._check_followers()
                else:
                    self._check_master()
            except Exception:
                pass  # the checker must survive anything a tick throws
            try:
                # recoveries are normally scheduled when a routing
                # change applies; when one fails its in-place retries
                # (injected faults, a source briefly unreachable) no
                # further routing change may ever come — a relocation
                # target stuck out of the in-sync set would also pin
                # the rebalance budget forever. Re-offer needed
                # recoveries every tick; schedule_recoveries dedupes
                # against the ones already running.
                for name, idx in list(self.cluster.indices.items()):
                    needs = idx.recovery_needed()
                    if needs:
                        self.schedule_recoveries(name, needs)
            except Exception:
                pass

    def _check_followers(self):
        """Master pings every follower; a stale version gets the current
        state re-sent (lag repair); `fd_retries` consecutive failures
        remove the node from the cluster.

        Quorum bookkeeping (ADVICE r5): the master counts how many of
        the last-known node set it can still reach. Below a majority it
        steps down — `_require_master` rejects metadata mutations until
        contact returns. A ping response advertising a NEWER state
        version means the other side elected past us while we were
        partitioned: adopt that state (monotonic apply) instead of
        running a second divergent master."""
        with self._state_lock:
            nodes = {
                nid: tuple(info["address"])
                for nid, info in self.state["nodes"].items()
                if nid != self.name
            }
            version = self.state.get("version", 0)
        reachable = 1  # self
        newer: Optional[Tuple[str, int]] = None  # (nid, version)
        for nid, addr in nodes.items():
            try:
                resp = self.transport.send(
                    addr, "internal:fd/ping", {}, timeout=self.fd_interval * 5
                )
                reachable += 1
                self._fd_failures[nid] = 0
                rv = resp.get("version", 0)
                if rv < version:
                    with self._state_lock:
                        state = self.state
                    self.transport.send(addr, "cluster:state/publish", state)
                elif rv > version and (newer is None or rv > newer[1]):
                    newer = (nid, rv)
            except TransportError:
                n = self._fd_failures.get(nid, 0) + 1
                self._fd_failures[nid] = n
                if n >= self.fd_retries:
                    self._fd_failures.pop(nid, None)
                    self._node_left(nid)
        if newer is not None:
            # superseded (healed partition): step down by adopting the
            # majority side's state — monotonic apply handles ordering
            try:
                state = self.transport.send(
                    nodes[newer[0]], "cluster:state/get", {},
                    timeout=self.fd_interval * 5,
                )
                self._apply_state(state)
            except TransportError:
                pass
            if not self.is_master():
                self._quorum_lost = False
                return
        # recompute against the CURRENT node set: _node_left above may
        # have shrunk it (removing a confirmed-dead node is what brings
        # quorum back for the survivors)
        with self._state_lock:
            total = len(self.state["nodes"])
        self._quorum_lost = reachable < (total // 2 + 1)

    def _check_master(self):
        """Follower pings the master; on sustained failure the lowest
        surviving node id takes over (deterministic re-election)."""
        with self._state_lock:
            master = self.state.get("master")
            info = self.state["nodes"].get(master)
        if master is None or master == self.name or info is None:
            return
        try:
            self.transport.send(
                tuple(info["address"]),
                "internal:fd/ping",
                {},
                timeout=self.fd_interval * 5,
            )
            self._fd_failures[master] = 0
        except TransportError:
            n = self._fd_failures.get(master, 0) + 1
            self._fd_failures[master] = n
            if n >= self.fd_retries:
                self._fd_failures.pop(master, None)
                self._elect_after_master_loss(master)

    def _elect_after_master_loss(self, dead_master: str):
        """Deterministic takeover, quorum-gated (ADVICE r5): the lowest
        surviving node id may only self-elect after confirming it can
        reach a majority of the surviving last-known node set — the
        minority side of a symmetric partition therefore never elects,
        so two active masters cannot coexist. The confirmed-dead master
        (fd_retries consecutive failed pings) is excluded from the
        candidate set, the same shrink that keeps a 2-node cluster
        recoverable (ES's auto-shrinking voting configuration)."""
        with self._state_lock:
            if self.state.get("master") != dead_master:
                return  # someone already took over
            survivors = [n for n in self.state["nodes"] if n != dead_master]
            if not survivors or min(survivors) != self.name:
                return  # not our job; wait for the new master's publish
            peers = {
                nid: tuple(info["address"])
                for nid, info in self.state["nodes"].items()
                if nid != self.name and nid != dead_master
            }
        # majority probe OUTSIDE the state lock (pings must not block
        # publish application)
        reachable = 1  # self
        for nid, addr in peers.items():
            try:
                self.transport.send(
                    addr, "internal:ping", {}, timeout=self.fd_interval * 5
                )
                reachable += 1
            except TransportError:
                pass
        if reachable < (len(survivors) // 2 + 1):
            return  # minority side of a partition: never self-elect
        with self._state_lock:
            if self.state.get("master") != dead_master:
                return  # lost the race while probing
            new = _copy_state(self.state)
            new["master"] = self.name
            _remove_node_from_state(new, dead_master)
            _fill_replicas(new, self.cluster.cluster_settings)
            new["version"] += 1
            self._publish(new)

    def _node_left(self, nid: str):
        """Master removes a dead node: promote in-sync replicas for its
        primaries, drop its copies, re-allocate missing replicas (which
        peer-recover from the new primaries)."""
        with self._state_lock:
            if not self.is_master() or nid not in self.state["nodes"]:
                return
            new = _copy_state(self.state)
            _remove_node_from_state(new, nid)
            _fill_replicas(new, self.cluster.cluster_settings)
            new["version"] += 1
            self._publish(new)

    # ---- replication lifecycle (master side) ----

    def _handle_shard_failed(self, p: dict) -> dict:
        """A primary reports a replica that failed to ack a write (or a
        node reports a broken copy): drop it from the in-sync set so
        reads never see stale data (ReplicationOperation →
        ShardStateAction.shardFailed)."""
        with self._state_lock:
            self._require_master()
            name, sid, node = p["index"], str(p["shard"]), p["node"]
            meta = self.state["indices"].get(name)
            if meta is None:
                return {"acknowledged": True}
            new = _copy_state(self.state)
            entry = norm_shard_routing(new["indices"][name]["routing"][sid])
            changed = False
            if node in entry["in_sync"]:
                entry["in_sync"].remove(node)
                changed = True
            if node in entry["replicas"]:
                entry["replicas"].remove(node)
                changed = True
            if entry["primary"] == node:
                entry["primary"] = None
                promote = [n for n in entry["in_sync"] if n in entry["replicas"]]
                if promote:
                    entry["primary"] = promote[0]
                    entry["replicas"].remove(promote[0])
                    entry["primary_term"] += 1
                changed = True
            rel = entry.get("relocating") or {}
            if node in (rel.get("from"), rel.get("to")):
                # the relocation lost an endpoint: abandon it. A failed
                # TARGET leaves the still-serving source untouched; a
                # failed SOURCE leaves the target as a plain initializing
                # replica that recovers from the promoted primary.
                entry.pop("relocating", None)
                bump_relocation_stat("failed")
                changed = True
            if not changed:
                return {"acknowledged": True}
            new["indices"][name]["routing"][sid] = entry
            _fill_replicas(new, self.cluster.cluster_settings)
            new["version"] += 1
            self._publish(new)
            return {"acknowledged": True}

    def _handle_shard_started(self, p: dict) -> dict:
        """A peer-recovered copy reports readiness
        (ShardStateAction.shardStarted). A plain replica joins the
        in-sync set; a relocation TARGET triggers the atomic cutover:
        ONE publish joins it in-sync and retires the source — never a
        serving gap, never two writable copies (the source already
        drained its write permits during the handoff)."""
        with self._state_lock:
            self._require_master()
            name, sid, node = p["index"], str(p["shard"]), p["node"]
            meta = self.state["indices"].get(name)
            if meta is None:
                raise IndexNotFoundError(name)
            new = _copy_state(self.state)
            entry = norm_shard_routing(new["indices"][name]["routing"][sid])
            if node not in entry["replicas"] and entry["primary"] != node:
                # stale report: the copy was cancelled / failed out of
                # the routing table while its recovery thread was still
                # running — re-adding it would resurrect a retired copy
                return {"acknowledged": False, "reason": "not an assigned copy"}
            rel = entry.get("relocating") or {}
            if rel.get("to") == node:
                src = rel.get("from")
                if node not in entry["in_sync"]:
                    entry["in_sync"].append(node)
                if rel.get("copy") == "primary" and entry["primary"] == src:
                    # the target becomes the primary under a new term;
                    # the drained source retires entirely
                    entry["primary"] = node
                    entry["replicas"].remove(node)
                    entry["primary_term"] += 1
                if src in entry["replicas"]:
                    entry["replicas"].remove(src)
                if src in entry["in_sync"]:
                    entry["in_sync"].remove(src)
                entry.pop("relocating", None)
                bump_relocation_stat("completed")
            elif node not in entry["in_sync"]:
                entry["in_sync"].append(node)
            new["indices"][name]["routing"][sid] = entry
            new["version"] += 1
            self._publish(new)
            return {"acknowledged": True}

    def _report_shard_failed(self, index: str, sid: int, node: str):
        try:
            self.master_request(
                "cluster:shard/failed",
                {"index": index, "shard": sid, "node": node},
            )
        except (TransportError, NodeError, ClusterError):
            pass  # fd loop will catch a dead master; retried on next write

    # ---- peer recovery (RecoverySourceHandler on the primary,
    # RecoveryTarget driven by schedule_recoveries on the target) ----

    def _handle_recovery_start(self, p: dict) -> dict:
        """Phase 1: the primary flushes and streams its shard files
        (RecoverySourceHandler.phase1). Diskless primaries skip phase 1
        entirely — phase 2's seqno-gated replay carries everything."""
        idx = self._index_service(p["index"])
        sid = int(p["shard"])
        eng = idx._local.get(sid)
        if eng is None or idx._owner(sid) != self.name:
            raise NodeError(
                f"[{self.name}] is not the primary for [{p['index']}][{sid}]"
            )
        rel = (idx._entry(sid) or {}).get("relocating") or {}
        if rel.get("to") == p.get("target"):
            # relocation phase 1 kicking off on the SOURCE: chaos site
            faults.check("relocation.start", index=p["index"], shard=sid,
                         node=self.name, role="source")
        if eng.path is None:
            return {"mode": "ops"}
        import base64

        with eng._lock:
            eng.flush()
            files: Dict[str, str] = {}
            for root, _, fnames in os.walk(eng.path):
                for fn in fnames:
                    full = os.path.join(root, fn)
                    rel = os.path.relpath(full, eng.path)
                    try:
                        with open(full, "rb") as f:
                            files[rel] = base64.b64encode(f.read()).decode("ascii")
                    except OSError:
                        pass
            return {"mode": "files", "files": files, "max_seq_no": eng.max_seq_no}

    def _handle_recovery_finalize(self, p: dict) -> dict:
        """Phase 2: under the primary's engine lock, start tracking the
        target for write fan-out and hand back every op newer than the
        target's local checkpoint (version-map diff — the ops-replay of
        RecoverySourceHandler.phase2). At-least-once delivery composes
        with the replica's seqno dedup."""
        idx = self._index_service(p["index"])
        sid = int(p["shard"])
        eng = idx._local.get(sid)
        if eng is None or idx._owner(sid) != self.name:
            raise NodeError(
                f"[{self.name}] is not the primary for [{p['index']}][{sid}]"
            )
        rel = (idx._entry(sid) or {}).get("relocating") or {}
        if rel.get("to") == p.get("target"):
            # relocation ops-diff transfer on the SOURCE: chaos site
            faults.check("relocation.transfer", index=p["index"], shard=sid,
                         node=self.name, role="source")
        local_seq = int(p["local_seq"])
        with eng._lock:
            # at-least-once delivery: a re-delivered finalize (the target
            # retried after a dropped ack) is answered idempotently — the
            # tracked set is a set, the ops diff is recomputed, and the
            # target's seqno dedup no-ops the replay. Count it so the
            # stats block makes redeliveries visible.
            if p["target"] in idx._tracked.get(sid, set()):
                bump_durability_stat("finalize_redelivered")
            idx.add_tracked(sid, p["target"])
            ops: List[dict] = []
            for doc_id, ve in eng._versions.items():
                if ve.seq_no <= local_seq:
                    continue
                if ve.deleted:
                    ops.append(
                        {"op": "delete", "id": doc_id, "version": ve.version,
                         "seq_no": ve.seq_no}
                    )
                else:
                    doc = eng.get(doc_id)
                    if doc is None:
                        continue
                    ops.append(
                        {"op": "index", "id": doc_id, "source": doc["_source"],
                         "version": ve.version, "seq_no": ve.seq_no}
                    )
            ops.sort(key=lambda o: o["seq_no"])
        return {"ops": ops}

    def schedule_recoveries(self, index_name: str, sids: List[int]):
        """Runs peer recoveries in the background — apply_state must not
        block (the master is waiting on the publish ack, and shard
        started/failed reports need the master's state lock)."""
        if not sids or self._closed:
            return
        with self._recovery_lock:
            todo = [
                sid for sid in sids if (index_name, sid) not in self._recovering
            ]
            self._recovering.update((index_name, sid) for sid in todo)
        if not todo:
            return
        threading.Thread(
            target=self._run_recoveries,
            args=(index_name, todo),
            name=f"recovery-{self.name}-{index_name}",
            daemon=True,
        ).start()

    def _run_recoveries(self, index_name: str, sids: List[int]):
        for sid in sids:
            try:
                # a transient failure (primary briefly unreachable, an
                # injected recovery.transfer fault) used to strand the
                # copy out of the in-sync set until the NEXT routing
                # change; retry in place first
                for attempt in range(3):
                    try:
                        self._recover_shard(index_name, sid,
                                            first_attempt=attempt == 0)
                        break
                    except Exception:
                        if attempt == 2 or self._closed:
                            bump_durability_stat("recoveries_failed")
                            break
                        bump_durability_stat("recovery_retries")
                        time.sleep(0.2)
            finally:
                with self._recovery_lock:
                    self._recovering.discard((index_name, sid))

    def _recover_shard(self, index_name: str, sid: int,
                       first_attempt: bool = True):
        idx = self.cluster.indices.get(index_name)
        if idx is None:
            return
        entry = idx._entry(sid)
        if (
            entry is None
            or entry["primary"] in (None, self.name)
            or self.name in entry["in_sync"]
            or self.name not in entry["replicas"]
        ):
            # the last clause: a cancelled relocation (or a copy failed
            # out of the table) must not resurrect through a recovery
            # thread that was already in flight
            return
        rel = entry.get("relocating") or {}
        relocating_here = rel.get("to") == self.name
        primary = entry["primary"]
        if first_attempt:
            # retries of the same recovery are counted in
            # recovery_retries, not as fresh starts — so the lifecycle
            # invariant started == completed + failed holds
            bump_durability_stat("recoveries_started")
        if relocating_here:
            faults.check("relocation.start", index=index_name, shard=sid,
                         node=self.name, role="target")
        # phase-1 transfer failing (network, primary mid-restart, an
        # injected fault) must leave the copy OUT of the in-sync set —
        # the retry loop / next routing change re-runs the whole phase
        faults.check("recovery.transfer", index=index_name, shard=sid,
                     node=self.name)
        out = self.remote_call(
            primary,
            "internal:recovery/start",
            {"index": index_name, "shard": sid, "target": self.name},
        )
        if relocating_here:
            faults.check("relocation.transfer", index=index_name, shard=sid,
                         node=self.name, role="target")
        shard_path = idx.begin_peer_recovery(sid)
        if out.get("mode") == "files" and shard_path is not None:
            import base64

            nbytes = 0
            for relpath, b64 in out["files"].items():
                full = os.path.join(shard_path, relpath)
                os.makedirs(os.path.dirname(full), exist_ok=True)
                data = base64.b64decode(b64)
                with open(full, "wb") as f:
                    f.write(data)
                nbytes += len(data)
            bump_durability_stat("recovered_files", len(out["files"]))
            if relocating_here:
                bump_relocation_stat("bytes", nbytes)
        eng = idx.finish_peer_recovery(sid)
        faults.check("recovery.finalize", index=index_name, shard=sid,
                     node=self.name)
        fin = self.remote_call(
            primary,
            "internal:recovery/finalize",
            {
                "index": index_name,
                "shard": sid,
                "target": self.name,
                "local_seq": eng.max_seq_no,
            },
        )
        for op in fin["ops"]:
            if op["op"] == "index":
                eng.index_replica(
                    op["id"], op["source"], op["version"], op["seq_no"]
                )
            else:
                eng.delete_replica(op["id"], op["version"], op["seq_no"])
        bump_durability_stat("recovered_ops", len(fin["ops"]))
        eng.refresh()
        if relocating_here:
            # ES-style handoff: before reporting started, ask the source
            # to drain its write permits — between this call returning
            # and the cutover publish there is exactly one writable copy
            # (this already-tracked target). Writes reaching the drained
            # source get a retryable shard_not_in_primary_mode and
            # re-resolve to the new owner.
            faults.check("relocation.handoff", index=index_name, shard=sid,
                         node=self.name, role="target")
            self.remote_call(
                rel.get("from") or primary,
                "internal:relocation/handoff",
                {"index": index_name, "shard": sid, "target": self.name},
            )
        bump_durability_stat("recoveries_completed")
        # the started report must land — a swallowed failure would strand
        # a fully-recovered copy out of the in-sync set forever (the fd
        # loop's lag repair resends the same version, which the monotonic
        # apply skips). Retry across master elections.
        for attempt in range(10):
            try:
                self.master_request(
                    "cluster:shard/started",
                    {"index": index_name, "shard": sid, "node": self.name},
                )
                return
            except (TransportError, NodeError, NotMasterError, ClusterError):
                if self._closed:
                    return
                time.sleep(0.5)

    # ------------------------------------------------------------------
    # master-side metadata mutations
    # ------------------------------------------------------------------

    def _handle_create_index(self, p: dict) -> dict:
        with self._state_lock:
            self._require_master()
            name = p["name"]
            body = p.get("body") or {}
            _validate_index_name(name)
            if name in self.state["indices"]:
                raise ClusterError(
                    400,
                    f"index [{name}] already exists",
                    "resource_already_exists_exception",
                )
            if name in self.state.get("aliases", {}):
                raise ClusterError(
                    400,
                    f"an alias with the same name as the index [{name}] "
                    "already exists",
                    "invalid_index_name_exception",
                )
            settings = body.get("settings") or {}
            mappings = body.get("mappings") or {}
            template = _template_for(self.state.get("templates", {}), name)
            if template is not None:
                t = template.get("template", {})
                settings = deep_merge(t.get("settings") or {}, settings)
                mappings = deep_merge(t.get("mappings") or {}, mappings)
            flat = _flatten_settings(settings)
            analysis_cfg = {
                k: v for k, v in flat.items() if k.startswith("analysis.")
            }
            flat = {k: v for k, v in flat.items() if not k.startswith("analysis.")}
            try:
                validated = validate_index_settings(flat, creating=True)
                Mappings(mappings)  # parse check
            except SettingsError as e:
                raise ClusterError(400, str(e), "illegal_argument_exception")
            except (MappingParseError, ValueError) as e:
                raise ClusterError(400, str(e), "mapper_parsing_exception")
            num_shards = int(validated.get("number_of_shards", 1))
            num_replicas = int(validated.get("number_of_replicas", 1))
            nodes = sorted(self.state["nodes"])
            # primaries round-robin over the sorted node set; replicas on
            # the following distinct nodes (BalancedShardsAllocator,
            # radically simplified). At creation every copy is empty, so
            # replicas are born in-sync.
            routing: Dict[str, dict] = {}
            for s in range(num_shards):
                primary = nodes[s % len(nodes)]
                reps: List[str] = []
                for r in range(1, len(nodes)):
                    if len(reps) >= num_replicas:
                        break
                    cand = nodes[(s + r) % len(nodes)]
                    if cand != primary and cand not in reps:
                        reps.append(cand)
                routing[str(s)] = {
                    "primary": primary,
                    "replicas": reps,
                    "in_sync": [primary] + reps,
                    "primary_term": 1,
                }
            meta_settings: Dict[str, Any] = dict(validated)
            meta_settings["number_of_shards"] = num_shards
            if analysis_cfg:
                # re-nest the analysis group for AnalysisRegistry
                nested: dict = {}
                for k, v in analysis_cfg.items():
                    parts = k.split(".")
                    node = nested
                    for part in parts[:-1]:
                        node = node.setdefault(part, {})
                    node[parts[-1]] = v
                meta_settings["analysis"] = nested["analysis"]
            creation_date = int(time.time() * 1000)
            new = _copy_state(self.state)
            new["indices"][name] = {
                "settings": meta_settings,
                "mappings": mappings,
                "num_shards": num_shards,
                "routing": routing,
                "uuid": _uuidlib.uuid4().hex[:22],
                "creation_date": creation_date,
            }
            new["version"] += 1
            self._publish(new)
            return {
                "acknowledged": True,
                "shards_acknowledged": True,
                "index": name,
                # sid → primary (the pre-replication response shape)
                "routing": {s: e["primary"] for s, e in routing.items()},
                "replicas": {s: e["replicas"] for s, e in routing.items()},
            }

    def _handle_delete_index(self, p: dict) -> dict:
        with self._state_lock:
            self._require_master()
            name = p["name"]
            if name not in self.state["indices"]:
                raise IndexNotFoundError(name)
            new = _copy_state(self.state)
            del new["indices"][name]
            for alias in list(new.get("aliases", {})):
                new["aliases"][alias].pop(name, None)
                if not new["aliases"][alias]:
                    del new["aliases"][alias]
            new["version"] += 1
            self._publish(new)
            return {"acknowledged": True}

    def _handle_mapping_update(self, p: dict) -> dict:
        """Explicit PUT _mapping and dynamic-mapping round-trips both
        land here (SURVEY.md §3.2 'may round-trip to MASTER')."""
        with self._state_lock:
            self._require_master()
            name = p["index"]
            if name not in self.state["indices"]:
                raise IndexNotFoundError(name)
            new = _copy_state(self.state)
            try:
                merged = Mappings(new["indices"][name].get("mappings") or {})
                merged.merge(p["mappings"])
            except MappingParseError as e:
                raise ClusterError(400, str(e), "illegal_argument_exception")
            new["indices"][name]["mappings"] = merged.to_json()
            new["version"] += 1
            self._publish(new)
            return {"acknowledged": True}

    def _handle_update_settings(self, p: dict) -> dict:
        with self._state_lock:
            self._require_master()
            name = p["index"]
            if name not in self.state["indices"]:
                raise IndexNotFoundError(name)
            flat = _flatten_settings(p.get("settings") or {})
            try:
                validated = validate_index_settings(flat, creating=False)
            except SettingsError as e:
                raise ClusterError(400, str(e), "illegal_argument_exception")
            new = _copy_state(self.state)
            new["indices"][name]["settings"].update(validated)
            new["version"] += 1
            self._publish(new)
            return {"acknowledged": True}

    def _handle_update_aliases(self, p: dict) -> dict:
        with self._state_lock:
            self._require_master()
            new = _copy_state(self.state)
            aliases = new.setdefault("aliases", {})
            for entry in (p or {}).get("actions", []):
                if not isinstance(entry, dict) or len(entry) != 1:
                    raise ClusterError(
                        400, "malformed alias action", "illegal_argument_exception"
                    )
                op, spec = next(iter(entry.items()))
                indices = spec.get("indices") or (
                    [spec["index"]] if "index" in spec else []
                )
                names = spec.get("aliases") or (
                    [spec["alias"]] if "alias" in spec else []
                )
                if not indices:
                    raise ClusterError(
                        400,
                        "Validation Failed: 1: index is missing;",
                        "action_request_validation_exception",
                    )
                if not names and op != "remove_index":
                    raise ClusterError(
                        400,
                        "Validation Failed: 1: alias is missing;",
                        "action_request_validation_exception",
                    )
                if op == "add":
                    for index in indices:
                        if index not in new["indices"]:
                            raise IndexNotFoundError(index)
                        for alias in names:
                            if alias in new["indices"]:
                                raise ClusterError(
                                    400,
                                    "an index exists with the same name as "
                                    f"the alias [{alias}]",
                                    "invalid_alias_name_exception",
                                )
                            aliases.setdefault(alias, {})[index] = {
                                "filter": spec.get("filter"),
                                "is_write_index": bool(
                                    spec.get("is_write_index", False)
                                ),
                            }
                elif op == "remove":
                    for index in indices:
                        for alias in names:
                            entry2 = aliases.get(alias)
                            if entry2 is None or index not in entry2:
                                raise ClusterError(
                                    404,
                                    f"aliases [{alias}] missing",
                                    "aliases_not_found_exception",
                                )
                            entry2.pop(index, None)
                            if not entry2:
                                aliases.pop(alias, None)
                elif op == "remove_index":
                    for index in indices:
                        if index in new["indices"]:
                            del new["indices"][index]
                else:
                    raise ClusterError(
                        400,
                        f"unknown alias action [{op}]",
                        "illegal_argument_exception",
                    )
            new["version"] += 1
            self._publish(new)
            return {"acknowledged": True}

    def _handle_repo_put(self, p: dict) -> dict:
        with self._state_lock:
            self._require_master()
            # reuse the single-node validation + write probe, then ride
            # the registry through state publication
            ClusterService.put_repository(self.cluster, p["name"], p["body"])
            new = _copy_state(self.state)
            new["repositories"] = dict(self.cluster.repositories)
            new["version"] += 1
            self._publish(new)
            return {"acknowledged": True}

    def _handle_repo_delete(self, p: dict) -> dict:
        with self._state_lock:
            self._require_master()
            ClusterService.delete_repository(self.cluster, p["name"])
            new = _copy_state(self.state)
            new["repositories"] = dict(self.cluster.repositories)
            new["version"] += 1
            self._publish(new)
            return {"acknowledged": True}

    def _handle_pipeline_put(self, p: dict) -> dict:
        with self._state_lock:
            self._require_master()
            ClusterService.put_pipeline(self.cluster, p["id"], p["body"])
            new = _copy_state(self.state)
            new["pipelines"] = self.cluster.ingest.bodies()
            new["version"] += 1
            self._publish(new)
            return {"acknowledged": True}

    def _handle_pipeline_delete(self, p: dict) -> dict:
        with self._state_lock:
            self._require_master()
            ClusterService.delete_pipeline(self.cluster, p["id"])
            new = _copy_state(self.state)
            new["pipelines"] = self.cluster.ingest.bodies()
            new["version"] += 1
            self._publish(new)
            return {"acknowledged": True}

    def _handle_put_template(self, p: dict) -> dict:
        with self._state_lock:
            self._require_master()
            body = p.get("body") or {}
            patterns = body.get("index_patterns")
            if not patterns:
                raise ClusterError(
                    400,
                    "index template must have at least one index pattern",
                    "illegal_argument_exception",
                )
            new = _copy_state(self.state)
            new.setdefault("templates", {})[p["name"]] = {
                "index_patterns": patterns
                if isinstance(patterns, list)
                else [patterns],
                "template": body.get("template", {}),
                "priority": int(body.get("priority", 0)),
            }
            new["version"] += 1
            self._publish(new)
            return {"acknowledged": True}

    def _handle_delete_template(self, p: dict) -> dict:
        with self._state_lock:
            self._require_master()
            if p["name"] not in self.state.get("templates", {}):
                raise ClusterError(
                    404,
                    f"index template matching [{p['name']}] not found",
                    "resource_not_found_exception",
                )
            new = _copy_state(self.state)
            del new["templates"][p["name"]]
            new["version"] += 1
            self._publish(new)
            return {"acknowledged": True}

    # ------------------------------------------------------------------
    # cluster elasticity: reroute commands, allocation explain, dynamic
    # cluster settings, relocation handoff, background rebalancer
    # ------------------------------------------------------------------

    def _handle_settings_update(self, p: dict) -> dict:
        """PUT /_cluster/settings on the master: validate + update the
        store, embed both layers in the state, publish — every node's
        store reloads in apply_state (ClusterUpdateSettingsAction)."""
        with self._state_lock:
            self._require_master()
            try:
                out = self.cluster.cluster_settings.update(p or {})
            except SettingsError as e:
                raise ClusterError(400, str(e), "illegal_argument_exception")
            store = self.cluster.cluster_settings
            new = _copy_state(self.state)
            new["cluster_settings"] = {
                "persistent": dict(store.persistent),
                "transient": dict(store.transient),
            }
            new["version"] += 1
            self._publish(new)
            return out

    def _routing_entry(self, state: dict, name, sid: str) -> dict:
        meta = (state.get("indices") or {}).get(name)
        if meta is None:
            raise IndexNotFoundError(str(name))
        raw = (meta.get("routing") or {}).get(sid)
        if raw is None:
            raise ClusterError(
                400,
                f"no shard [{sid}] in index [{name}]",
                "illegal_argument_exception",
            )
        entry = norm_shard_routing(raw)
        meta["routing"][sid] = entry
        return entry

    def _handle_reroute(self, p: dict) -> dict:
        """POST /_cluster/reroute: move / cancel / allocate_replica.
        Explicit operator commands run the deciders with the enable
        decider bypassed (RoutingAllocation.ignoreDisabled); the
        background rebalancer calls in with explicit=False so
        `cluster.routing.allocation.enable` is honored."""
        with self._state_lock:
            self._require_master()
            p = p or {}
            dry_run = bool(p.get("dry_run"))
            explicit = bool(p.get("explicit", True))
            commands = p.get("commands") or []
            if not isinstance(commands, list) or not commands:
                raise ClusterError(
                    400,
                    "reroute requires a non-empty [commands] list",
                    "illegal_argument_exception",
                )
            new = _copy_state(self.state)
            explanations: List[dict] = []
            for cmd in commands:
                if not isinstance(cmd, dict) or len(cmd) != 1:
                    raise ClusterError(
                        400,
                        "malformed reroute command",
                        "illegal_argument_exception",
                    )
                op, spec = next(iter(cmd.items()))
                if op == "move":
                    explanations.append(self._cmd_move(
                        new, spec or {}, explicit=explicit, dry_run=dry_run))
                elif op == "cancel":
                    explanations.append(self._cmd_cancel(
                        new, spec or {}, dry_run=dry_run))
                elif op == "allocate_replica":
                    explanations.append(self._cmd_allocate_replica(
                        new, spec or {}, explicit=explicit, dry_run=dry_run))
                else:
                    raise ClusterError(
                        400,
                        f"unknown reroute command [{op}]",
                        "illegal_argument_exception",
                    )
            if not dry_run:
                new["version"] += 1
                self._publish(new)
            return {
                "acknowledged": True,
                "dry_run": dry_run,
                "explanations": explanations,
                "state_version": self.state["version"],
            }

    def _cmd_move(self, new: dict, spec: dict, *, explicit: bool,
                  dry_run: bool) -> dict:
        from . import allocation as alloc

        name, sid = spec.get("index"), str(spec.get("shard"))
        src, dst = spec.get("from_node"), spec.get("to_node")
        entry = self._routing_entry(new, name, sid)
        if dst not in new["nodes"]:
            raise ClusterError(
                400, f"unknown target node [{dst}]",
                "illegal_argument_exception",
            )
        if entry.get("relocating"):
            raise ClusterError(
                400,
                f"[move] shard [{name}][{sid}] is already relocating",
                "illegal_argument_exception",
            )
        if entry["primary"] == src:
            kind = "primary"
        elif src in entry["replicas"]:
            if src not in entry["in_sync"]:
                raise ClusterError(
                    400,
                    f"[move] copy of [{name}][{sid}] on [{src}] is still "
                    "initializing; cancel it or wait for recovery",
                    "illegal_argument_exception",
                )
            kind = "replica"
        else:
            raise ClusterError(
                400,
                f"[move] node [{src}] holds no copy of [{name}][{sid}]",
                "illegal_argument_exception",
            )
        ok, decisions = alloc.can_allocate(
            self.cluster.cluster_settings, new, entry, dst, copy=kind,
            explicit=explicit, moving_from=src)
        if not ok:
            blockers = "; ".join(
                d["explanation"] for d in decisions if d["decision"] == "NO")
            raise ClusterError(
                400,
                f"[move] cannot place [{name}][{sid}] on [{dst}]: {blockers}",
                "illegal_argument_exception",
            )
        # the target joins as an out-of-sync replica and peer-recovers
        # off the normal transfer path; the marker drives the cutover
        entry["replicas"].append(dst)
        entry["relocating"] = {"from": src, "to": dst, "copy": kind}
        new["indices"][name]["routing"][sid] = entry
        if not dry_run:
            bump_relocation_stat("started")
        return {"command": "move", "index": name, "shard": int(sid),
                "from_node": src, "to_node": dst, "copy": kind,
                "decisions": decisions}

    def _cmd_cancel(self, new: dict, spec: dict, *, dry_run: bool) -> dict:
        name, sid = spec.get("index"), str(spec.get("shard"))
        entry = self._routing_entry(new, name, sid)
        rel = entry.get("relocating")
        if not rel:
            raise ClusterError(
                400,
                f"[cancel] shard [{name}][{sid}] is not relocating",
                "illegal_argument_exception",
            )
        entry.pop("relocating", None)
        tgt = rel.get("to")
        if tgt in entry["replicas"]:
            entry["replicas"].remove(tgt)
        if tgt in entry["in_sync"]:
            entry["in_sync"].remove(tgt)
        new["indices"][name]["routing"][sid] = entry
        if not dry_run:
            bump_relocation_stat("cancelled")
        return {"command": "cancel", "index": name, "shard": int(sid),
                "cancelled": rel}

    def _cmd_allocate_replica(self, new: dict, spec: dict, *,
                              explicit: bool, dry_run: bool) -> dict:
        from . import allocation as alloc

        name, sid = spec.get("index"), str(spec.get("shard"))
        node = spec.get("node")
        entry = self._routing_entry(new, name, sid)
        if node not in new["nodes"]:
            raise ClusterError(
                400, f"unknown target node [{node}]",
                "illegal_argument_exception",
            )
        if entry["primary"] is None:
            raise ClusterError(
                400,
                f"[allocate_replica] shard [{name}][{sid}] has no live "
                "primary to recover from",
                "illegal_argument_exception",
            )
        ok, decisions = alloc.can_allocate(
            self.cluster.cluster_settings, new, entry, node,
            copy="replica", explicit=explicit)
        if not ok:
            blockers = "; ".join(
                d["explanation"] for d in decisions if d["decision"] == "NO")
            raise ClusterError(
                400,
                f"[allocate_replica] cannot place [{name}][{sid}] on "
                f"[{node}]: {blockers}",
                "illegal_argument_exception",
            )
        entry["replicas"].append(node)
        new["indices"][name]["routing"][sid] = entry
        return {"command": "allocate_replica", "index": name,
                "shard": int(sid), "node": node, "decisions": decisions}

    def _handle_allocation_explain(self, p: dict) -> dict:
        from . import allocation as alloc

        with self._state_lock:
            self._require_master()
            p = p or {}
            name, sid = p.get("index"), p.get("shard")
            if name is None or sid is None:
                # ES explains the first unassigned/relocating/initializing
                # shard when the body names none
                for iname, s, raw in alloc.iter_routing(self.state):
                    entry = norm_shard_routing(raw)
                    if (entry["primary"] is None or entry.get("relocating")
                            or set(entry["replicas"]) - set(entry["in_sync"])):
                        name, sid = iname, s
                        break
                if name is None:
                    raise ClusterError(
                        400,
                        "unable to find any unassigned or relocating "
                        "shards to explain; specify [index] and [shard]",
                        "illegal_argument_exception",
                    )
            try:
                return alloc.explain_allocation(
                    self.cluster.cluster_settings, self.state,
                    name, str(sid))
            except KeyError as e:
                raise ClusterError(
                    404, str(e).strip("'"), "resource_not_found_exception"
                )

    def _handle_relocation_handoff(self, p: dict) -> dict:
        """Source side of the relocation cutover: refuse new writes and
        wait out the in-flight write permits, so between this return and
        the cutover publish there is exactly one writable copy (ES
        IndexShard.relocated() + ShardNotInPrimaryModeException). The
        fault site fires BEFORE the drain — an injected error/crash
        leaves the source still serving writes cleanly."""
        idx = self._index_service(p["index"])
        sid = int(p["shard"])
        faults.check("relocation.handoff", index=p["index"], shard=sid,
                     node=self.name, role="source")
        if idx._owner(sid) != self.name:
            # replica-copy relocation: the primary (elsewhere) keeps
            # fanning ops out to the tracked target — nothing to drain
            return {"drained": True, "handoff_ms": 0.0}
        t0 = time.perf_counter()
        drained = idx.drain_for_handoff(sid)
        ms = (time.perf_counter() - t0) * 1000.0
        bump_relocation_stat("handoffs")
        bump_relocation_stat("handoff_time_in_millis", ms)
        return {"drained": bool(drained), "handoff_ms": ms}

    def _rebalance_loop(self):
        while not self._fd_stop.wait(self.rebalance_interval):
            if self._closed:
                return
            try:
                self.rebalance_tick()
            except Exception:
                pass  # next tick re-plans from fresh state

    def rebalance_tick(self) -> List[dict]:
        """One rebalancer pass (public so tests and the smoke script can
        drive convergence deterministically): plan moves under the
        deciders, then start each through the same reroute state machine
        operators use — with explicit=False, so
        `cluster.routing.allocation.enable` and the exclude filters are
        honored (that is what makes a drain converge and `none` freeze
        the layout)."""
        if not self.is_master() or self._quorum_lost or self._closed:
            return []
        from . import allocation as alloc

        with self._state_lock:
            moves = alloc.plan_rebalance(
                self.cluster.cluster_settings, self.state)
        applied: List[dict] = []
        for mv in moves:
            try:
                self._handle_reroute({"commands": [mv], "explicit": False})
                applied.append(mv)
            except (ClusterError, NodeError):
                continue  # racing topology change; re-planned next tick
        return applied

    # ------------------------------------------------------------------
    # shard-level handlers (the owning-node side of the IndexService
    # remote actions)
    # ------------------------------------------------------------------

    def _index_service(self, name: str) -> IndexService:
        idx = self.cluster.indices.get(name)
        if idx is None:
            raise IndexNotFoundError(name)
        return idx

    def _handle_refresh_shards(self, p: dict) -> dict:
        idx = self._index_service(p["index"])
        n = 0
        for s in idx.shards:  # local shards only — no re-fan-out
            s.refresh()
            n += 1
        return {"refreshed_shards": n}

    def _handle_flush_shards(self, p: dict) -> dict:
        idx = self._index_service(p["index"])
        n = 0
        for s in idx.shards:
            s.flush()
            n += 1
        idx._persist_meta()
        return {"flushed_shards": n}

    def _handle_shard_stats(self, p: dict) -> dict:
        return self._index_service(p["index"]).local_stats()

    def _handle_shard_ops(self, p: dict) -> dict:
        idx = self._index_service(p["index"])
        sid = int(p["shard"])
        eng = idx._local.get(sid)
        if eng is None:
            raise NodeError(
                f"shard [{p['index']}][{sid}] not allocated to [{self.name}]"
            )
        # write permit (IndexShardOperationPermits): the relocation
        # handoff drains these before cutover, so no op can ack on a
        # source that is about to stop being the primary. Raises a
        # retryable 503 once the shard has handed off.
        idx.begin_shard_op(sid)
        try:
            results = apply_shard_ops(eng, p["ops"])
            # ---- replication fan-out (ReplicationOperation.execute): the
            # primary forwards seqno-stamped ops to every in-sync/tracked
            # copy and only acks once they respond; a copy that fails is
            # reported to the master and leaves the in-sync set ----
            rops: List[dict] = []
            for op, r in zip(p["ops"], results):
                if not r.get("ok"):
                    continue
                if op["op"] == "index":
                    rops.append(
                        {"op": "index", "id": r["_id"], "source": op["source"],
                         "version": r["_version"], "seq_no": r["_seq_no"]}
                    )
                elif r.get("result") == "deleted":
                    rops.append(
                        {"op": "delete", "id": r["_id"],
                         "version": r["_version"], "seq_no": r["_seq_no"]}
                    )
            if rops:
                for target in idx.replica_targets(sid):
                    try:
                        # a replica dying mid-replication is indistinguishable
                        # from a dropped connection: InjectedFault here rides
                        # the same handling as a real transport failure (the
                        # copy leaves the in-sync set — never silent divergence)
                        faults.check("replica.replicate", index=p["index"],
                                     shard=sid, target=target)
                        self.remote_call(
                            target,
                            ACTION_SHARD_REPLICA_OPS,
                            {"index": p["index"], "shard": sid, "ops": rops,
                             # primary-term fencing (ReplicationTracker /
                             # IndexShard term checks): replicas reject ops
                             # from a demoted primary that has not yet seen
                             # the promotion's cluster state
                             "primary_term": eng.primary_term},
                        )
                    except (TransportError, NodeError, ClusterError,
                            InjectedFault) as e:
                        if STALE_PRIMARY_MARKER in str(e):
                            ent = idx._entry(sid) or {}
                            if ent.get("relocating") or idx._owner(sid) != self.name:
                                # mid-relocation (or just relocated) the
                                # fence means the target was promoted by
                                # the cutover — acking would lose the op
                                # on the new primary. Fail retryable: the
                                # coordinator re-resolves the owner.
                                raise ClusterError(
                                    503,
                                    f"{RELOCATED_MARKER}: shard "
                                    f"[{p['index']}][{sid}] primary handed "
                                    "off during relocation; retry",
                                    "shard_not_in_primary_mode_exception",
                                )
                            # the REPLICA fenced US as stale: the failure is
                            # ours, not the (likely promoted) target's —
                            # reporting it shard-failed would knock the
                            # healthy new primary out of the in-sync set
                            continue
                        # ClusterError covers re-hydrated remote failures
                        # (e.g. the replica missed the index-creation publish)
                        self._report_shard_failed(p["index"], sid, target)
        finally:
            idx.end_shard_op(sid)
        # dynamic mapping changes must reach the master (and thus every
        # coordinator + the persisted state) before they are lost to a
        # restart — compare against the published metadata and round-trip
        mj = idx.mappings.to_json()
        published = (self.state["indices"].get(p["index"]) or {}).get(
            "mappings"
        ) or {}
        if mj != published:
            try:
                self.master_request(
                    "cluster:mapping/update",
                    {"index": p["index"], "mappings": mj},
                )
            except TransportError:
                pass  # retried on the next write (published stays stale)
        return {"results": results}

    def _handle_replica_ops(self, p: dict) -> dict:
        """Replica side of the write fan-out: apply with the primary's
        version+seqno, no CAS (IndexShard.applyIndexOperationOnReplica).
        Ops are primary-term-FENCED first: a term lower than this
        engine's means the sender was demoted and must not diverge the
        copies — the whole batch is rejected (shard-failed back to the
        stale sender), exactly the reference's term check."""
        idx = self._index_service(p["index"])
        sid = int(p["shard"])
        eng = idx._local.get(sid)
        if eng is None:
            raise NodeError(
                f"replica shard [{p['index']}][{sid}] not on [{self.name}]"
            )
        term = int(p.get("primary_term", 0))
        if term and term < eng.primary_term:
            raise NodeError(
                f"{STALE_PRIMARY_MARKER}: operation primary term [{term}] "
                f"is too old (current [{eng.primary_term}]) for shard "
                f"[{p['index']}][{sid}]"
            )
        for op in p["ops"]:
            if op["op"] == "index":
                eng.index_replica(
                    op["id"], op["source"], op["version"], op["seq_no"]
                )
            else:
                eng.delete_replica(op["id"], op["version"], op["seq_no"])
        return {"acks": len(p["ops"]), "local_checkpoint": eng.max_seq_no}

    def _handle_snapshot_shard(self, p: dict) -> dict:
        """Owning-node side of snapshot collection: b64 files on the
        wire, or the doc dump for diskless engines."""
        import base64

        idx = self._index_service(p["index"])
        payload = idx.snapshot_shard_local(int(p["shard"]))
        if "files" in payload:
            return {
                "files_b64": {
                    rel: base64.b64encode(data).decode("ascii")
                    for rel, data in payload["files"].items()
                }
            }
        return {"docs": payload["docs"]}

    def _handle_get(self, p: dict) -> dict:
        idx = self._index_service(p["index"])
        eng = idx._local.get(int(p["shard"]))
        if eng is None:
            raise NodeError("shard not here")
        doc = eng.get(p["id"])
        return {"found": doc is not None, "doc": doc}

    def _handle_search_shard(self, p: dict) -> dict:
        idx = self._index_service(p["index"])
        sid = int(p["shard"])
        pinned = None
        if p.get("ctx"):
            pinned = self._ctx_executor(p["ctx"])
        return idx.shard_search_local(sid, p.get("body"), pinned_executor=pinned)

    def _handle_count_shard(self, p: dict) -> dict:
        idx = self._index_service(p["index"])
        return idx.shard_count_local(int(p["shard"]), p.get("body"))

    def _handle_dfs_shard(self, p: dict) -> dict:
        idx = self._index_service(p["index"])
        return idx.shard_dfs_local(int(p["shard"]), p.get("spec") or {})

    def _handle_can_match(self, p: dict) -> dict:
        idx = self._index_service(p["index"])
        return {
            "can_match": idx.shard_can_match_local(
                int(p["shard"]), p.get("body")
            )
        }

    # ---- pinned reader contexts (scroll/PIT across nodes) ----

    def _handle_ctx_open(self, p: dict) -> dict:
        idx = self._index_service(p["index"])
        sid = int(p["shard"])
        ex = idx._executor(idx.local_shard(sid))
        ctx_id = _uuidlib.uuid4().hex
        keep_alive = float(p.get("keep_alive", DEFAULT_CTX_KEEPALIVE))
        with self._ctx_lock:
            self._reap_ctxs()
            self._ctxs[ctx_id] = {
                "executor": ex,
                "expires": time.time() + keep_alive,
                "keep_alive": keep_alive,
            }
        return {"ctx": ctx_id}

    def _handle_ctx_close(self, p: dict) -> dict:
        with self._ctx_lock:
            found = self._ctxs.pop(p.get("ctx"), None) is not None
        return {"closed": found}

    def _ctx_executor(self, ctx_id: str):
        with self._ctx_lock:
            entry = self._ctxs.get(ctx_id)
            if entry is None or entry["expires"] < time.time():
                self._ctxs.pop(ctx_id, None)
                raise ClusterError(
                    404,
                    f"No search context found for id [{ctx_id}]",
                    "search_context_missing_exception",
                )
            entry["expires"] = time.time() + entry["keep_alive"]
            return entry["executor"]

    def _reap_ctxs(self):
        now = time.time()
        for cid in [c for c, e in self._ctxs.items() if e["expires"] < now]:
            self._ctxs.pop(cid, None)

    # ------------------------------------------------------------------
    # coordinator facade (callable on any node; NodeClient pattern)
    # ------------------------------------------------------------------

    def create_index(self, name: str, body: Optional[dict] = None) -> dict:
        return self.cluster.create_index(name, body)

    def delete_index(self, name: str) -> dict:
        return self.cluster.delete_index(name)

    def index_doc(
        self, index: str, doc_id: str, source: dict, op_type: str = "index"
    ) -> dict:
        idx = self._index_service(index)
        sid = route_shard_id(doc_id, idx.num_shards)
        out = idx._shard_ops(
            sid, [{"op": "index", "id": doc_id, "source": source, "op_type": op_type}]
        )
        return out[0]

    def delete_doc(self, index: str, doc_id: str) -> dict:
        idx = self._index_service(index)
        sid = route_shard_id(doc_id, idx.num_shards)
        return idx._shard_ops(sid, [{"op": "delete", "id": doc_id}])[0]

    def bulk(self, index: str, ops: List[dict]) -> List[dict]:
        """ops: [{"op": "index"|"delete", "id": ..., "source": ...}];
        grouped by owning shard, one transport hop per shard."""
        idx = self._index_service(index)
        by_shard: Dict[int, List[Tuple[int, dict]]] = {}
        for i, op in enumerate(ops):
            sid = route_shard_id(op["id"], idx.num_shards)
            by_shard.setdefault(sid, []).append((i, op))
        results: List[Optional[dict]] = [None] * len(ops)
        for sid, items in by_shard.items():
            out = idx._shard_ops(sid, [op for _, op in items])
            for (i, _), r in zip(items, out):
                results[i] = r
        return results  # type: ignore[return-value]

    def get_doc(self, index: str, doc_id: str) -> Optional[dict]:
        return self._index_service(index).get_doc(doc_id)

    def refresh(self, index: str) -> None:
        self._index_service(index).refresh()

    def search(self, index: str, body: Optional[dict] = None) -> dict:
        try:
            return self.cluster.search(index, body)
        except IndexNotFoundError as e:
            raise NodeError(str(e))

    def count(self, index: str, body: Optional[dict] = None) -> dict:
        return self.cluster.count(index, body)


def _copy_state(state: dict) -> dict:
    return json.loads(json.dumps(state))


def _remove_node_from_state(state: dict, nid: str) -> None:
    """Drops a node and promotes in-sync replicas for every primary it
    held (NodeLeftExecutor + AllocationService failover). A shard whose
    only copies lived on the dead node keeps primary=None — red, exactly
    the reference's data-loss surface."""
    state["nodes"].pop(nid, None)
    for meta in state.get("indices", {}).values():
        routing = meta.get("routing", {})
        for sid, raw in routing.items():
            entry = norm_shard_routing(raw)
            rel = entry.get("relocating") or {}
            if nid in (rel.get("from"), rel.get("to")):
                # a dead endpoint aborts the relocation; if the TARGET
                # survives it stays behind as a plain initializing
                # replica and recovers from whichever primary remains
                entry.pop("relocating", None)
                bump_relocation_stat("failed")
            if nid in entry["replicas"]:
                entry["replicas"].remove(nid)
            if nid in entry["in_sync"]:
                entry["in_sync"].remove(nid)
            if entry["primary"] == nid:
                promote = [n for n in entry["in_sync"] if n in entry["replicas"]]
                if promote:
                    entry["primary"] = promote[0]
                    entry["replicas"].remove(promote[0])
                    entry["primary_term"] += 1
                else:
                    entry["primary"] = None
            routing[sid] = entry


def _demote_node_copies(state: dict, nid: str) -> None:
    """A restarted node's copies drop out of the in-sync sets (and out
    of any primary slot another in-sync copy can fill) until peer
    recovery re-validates them."""
    for meta in state.get("indices", {}).values():
        routing = meta.get("routing", {})
        for sid, raw in routing.items():
            entry = norm_shard_routing(raw)
            rel = entry.get("relocating") or {}
            if nid in (rel.get("from"), rel.get("to")):
                # a restarted endpoint's relocation is void — its copy
                # lost the in-memory recovery/tracking context
                entry.pop("relocating", None)
                bump_relocation_stat("failed")
            if entry["primary"] == nid:
                promote = [
                    n for n in entry["in_sync"]
                    if n != nid and n in entry["replicas"]
                ]
                if promote:
                    entry["primary"] = promote[0]
                    entry["replicas"].remove(promote[0])
                    entry["replicas"].append(nid)
                    entry["primary_term"] += 1
                else:
                    # sole copy: stays primary, stays in-sync
                    routing[sid] = entry
                    continue
            if nid in entry["in_sync"]:
                entry["in_sync"].remove(nid)
            routing[sid] = entry


def _fill_replicas(state: dict, settings=None) -> None:
    """Allocates missing replica copies onto nodes that hold no copy of
    the shard (BalancedShardsAllocator, radically simplified: spread by
    current copy count). Newly-assigned replicas are NOT in-sync — the
    target node peer-recovers and then reports shard-started.

    With a cluster-settings store, the enable decider and the exclude
    filter gate this auto-allocation path:
    `cluster.routing.allocation.enable` of none/primaries skips replica
    fill entirely, and excluded (draining) nodes never receive copies."""
    excl: set = set()
    if settings is not None:
        from .allocation import ENABLE_SETTING, excluded_nodes

        enable = settings.get(ENABLE_SETTING) or "all"
        if enable in ("none", "primaries"):
            return
        excl = set(excluded_nodes(settings))
    nodes = sorted(n for n in state.get("nodes", {}) if n not in excl)
    if not nodes:
        return
    # total copies per node, for least-loaded placement
    load = {n: 0 for n in nodes}
    for meta in state.get("indices", {}).values():
        for raw in meta.get("routing", {}).values():
            entry = norm_shard_routing(raw)
            for n in ([entry["primary"]] if entry["primary"] else []) + entry["replicas"]:
                if n in load:
                    load[n] += 1
    for meta in state.get("indices", {}).values():
        desired = int(
            (meta.get("settings") or {}).get("number_of_replicas", 1)
        )
        routing = meta.get("routing", {})
        for sid, raw in routing.items():
            entry = norm_shard_routing(raw)
            if entry["primary"] is None:
                # a red shard has no recovery source — allocating
                # replicas would strand phantom initializing copies
                routing[sid] = entry
                continue
            holders = set([entry["primary"]] + entry["replicas"])
            while len(entry["replicas"]) < desired:
                candidates = [n for n in nodes if n not in holders]
                if not candidates:
                    break
                pick = min(candidates, key=lambda n: (load[n], n))
                entry["replicas"].append(pick)
                holders.add(pick)
                load[pick] += 1
            routing[sid] = entry


def _template_for(templates: Dict[str, dict], index_name: str) -> Optional[dict]:
    import fnmatch

    best = None
    for t in templates.values():
        if any(fnmatch.fnmatch(index_name, p) for p in t["index_patterns"]):
            if best is None or t["priority"] > best["priority"]:
                best = t
    return best
