"""REST action handlers: the ES API surface bound to ClusterService.

Reference analogs (server/.../rest/action/): RestSearchAction,
RestBulkAction, RestIndexAction/RestGetAction/RestDeleteAction (document
CRUD), RestCreateIndexAction/RestDeleteIndexAction/RestGetMappingAction/
RestPutMappingAction/RestUpdateSettingsAction (admin/indices),
RestClusterHealthAction, RestNodesStatsAction, cat handlers
(RestIndicesAction). Response JSON mirrors the reference shapes so
existing clients can point at this server unchanged.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..cluster import ClusterError, ClusterService
from ..common import deep_merge
from ..common import tracing
from ..index.engine import VersionConflictError
from ..search.dsl import QueryParseError
from .router import Router, error_body

ES_VERSION = "8.15.0"  # wire-compat generation this API surface mirrors


def _auto_id() -> str:
    """Time-based flake id, URL-safe base64 — RestIndexAction auto-id
    shape (UUIDs.base64UUID)."""
    return (
        base64.urlsafe_b64encode(uuid.uuid4().bytes).decode().rstrip("=")
    )


class RestActions:
    def __init__(self, cluster: ClusterService):
        self.cluster = cluster
        self.router = Router()
        self.started_at = time.time()
        self._register()

    # ------------------------------------------------------------------

    def _register(self):
        add = self.router.add
        # plugin-provided handlers FIRST (ActionPlugin.getRestHandlers):
        # the router dispatches in registration order and the generic
        # /{index} patterns would otherwise shadow _-prefixed plugin
        # paths (ES reserves _ paths ahead of index names the same way)
        from ..plugins import plugins_service

        for method, pattern, handler in plugins_service.rest_handlers:
            add(
                method,
                pattern,
                lambda body, params, qs, h=handler: h(
                    self.cluster, body, params, qs
                ),
            )
        # root & cluster
        add("GET", "/", self.root)
        add("GET", "/_cluster/health", self.cluster_health)
        add("GET", "/_cluster/state", self.cluster_state)
        add("GET", "/_cluster/settings", self.get_cluster_settings)
        add("PUT", "/_cluster/settings", self.put_cluster_settings)
        add("POST", "/_cluster/reroute", self.cluster_reroute)
        add("GET", "/_cluster/allocation/explain", self.allocation_explain)
        add("POST", "/_cluster/allocation/explain", self.allocation_explain)
        add("GET", "/_nodes/stats", self.nodes_stats)
        add("GET", "/_stats", self.all_stats)
        add("GET", "/_cat/indices", self.cat_indices)
        add("GET", "/_cat/shards", self.cat_shards)
        add("GET", "/_cat/health", self.cat_health)
        add("POST", "/_bulk", self.bulk)
        add("POST", "/_cache/clear", self.clear_cache)
        add("POST", "/_refresh", self.refresh_all)
        add("POST", "/_flush", self.flush_all)
        add("POST", "/_msearch", self.msearch)
        add("POST", "/_search", self.search_no_index)
        add("GET", "/_search", self.search_no_index)
        add("POST", "/_search/scroll", self.scroll)
        add("GET", "/_search/scroll", self.scroll)
        add("DELETE", "/_search/scroll", self.delete_scroll)
        add("DELETE", "/_pit", self.close_pit)
        add("POST", "/_analyze", self.analyze)
        add("GET", "/_analyze", self.analyze)
        # deterministic fault-injection test hook (common/faults.py):
        # POST arms a seeded schedule, GET reports trip counters,
        # DELETE disarms — never armed in production unless ES_TPU_FAULTS
        # was set or a client posts a schedule explicitly
        add("POST", "/_internal/faults", self.put_faults)
        add("GET", "/_internal/faults", self.get_faults)
        add("DELETE", "/_internal/faults", self.delete_faults)
        # per-request span-tree ring (common/tracing.py): GET drains
        # recent traces newest-first, DELETE clears the ring
        add("GET", "/_internal/traces", self.get_traces)
        add("DELETE", "/_internal/traces", self.delete_traces)
        # async search (x-pack async-search: submit/get/delete)
        add("POST", "/{index}/_async_search", self.submit_async_search)
        add("GET", "/_async_search/{id}", self.get_async_search)
        add("DELETE", "/_async_search/{id}", self.delete_async_search)
        # tasks + by-scroll actions
        add("GET", "/_tasks", self.list_tasks)
        add("GET", "/_tasks/{task_id}", self.get_task)
        add("POST", "/_tasks/{task_id}/_cancel", self.cancel_task)
        add("POST", "/_reindex", self.reindex)
        add("POST", "/{index}/_update_by_query", self.update_by_query)
        add("POST", "/{index}/_delete_by_query", self.delete_by_query)
        # ingest pipelines
        add("PUT", "/_ingest/pipeline/{id}", self.put_pipeline)
        add("GET", "/_ingest/pipeline", self.get_pipeline)
        add("GET", "/_ingest/pipeline/{id}", self.get_pipeline)
        add("DELETE", "/_ingest/pipeline/{id}", self.delete_pipeline)
        add("POST", "/_ingest/pipeline/{id}/_simulate", self.simulate_pipeline)
        add("POST", "/_ingest/pipeline/_simulate", self.simulate_pipeline)
        # snapshots & repositories
        add("PUT", "/_snapshot/{repo}", self.put_repository)
        add("POST", "/_snapshot/{repo}/_verify", self.verify_repository)
        add("GET", "/_snapshot", self.get_repository)
        add("GET", "/_snapshot/{repo}", self.get_repository)
        add("DELETE", "/_snapshot/{repo}", self.delete_repository)
        add("PUT", "/_snapshot/{repo}/{snap}", self.create_snapshot)
        add("POST", "/_snapshot/{repo}/{snap}", self.create_snapshot)
        add("GET", "/_snapshot/{repo}/{snap}", self.get_snapshot)
        add("DELETE", "/_snapshot/{repo}/{snap}", self.delete_snapshot)
        add("POST", "/_snapshot/{repo}/{snap}/_restore", self.restore_snapshot)
        # aliases & templates
        add("POST", "/_aliases", self.update_aliases)
        add("GET", "/_alias", self.get_alias)
        add("GET", "/_alias/{name}", self.get_alias)
        add("GET", "/{index}/_alias", self.get_index_alias)
        add("PUT", "/{index}/_alias/{name}", self.put_alias)
        add("DELETE", "/{index}/_alias/{name}", self.delete_alias)
        add("PUT", "/_index_template/{name}", self.put_template)
        add("GET", "/_index_template", self.get_template)
        add("GET", "/_index_template/{name}", self.get_template)
        add("DELETE", "/_index_template/{name}", self.delete_template)
        # index admin
        add("PUT", "/{index}", self.create_index)
        add("DELETE", "/{index}", self.delete_index)
        add("GET", "/{index}", self.get_index_meta)
        add("GET", "/{index}/_mapping", self.get_mapping)
        add("PUT", "/{index}/_mapping", self.put_mapping)
        add("GET", "/{index}/_settings", self.get_settings)
        add("PUT", "/{index}/_settings", self.put_settings)
        add("GET", "/{index}/_stats", self.index_stats)
        add("POST", "/{index}/_cache/clear", self.clear_cache)
        add("POST", "/{index}/_refresh", self.refresh_index)
        add("GET", "/{index}/_refresh", self.refresh_index)
        add("POST", "/{index}/_flush", self.flush_index)
        add("POST", "/{index}/_forcemerge", self.forcemerge)
        # search
        add("POST", "/{index}/_search", self.search)
        add("GET", "/{index}/_search", self.search)
        add("POST", "/{index}/_count", self.count)
        add("GET", "/{index}/_count", self.count)
        add("POST", "/{index}/_rank_eval", self.rank_eval)
        add("GET", "/{index}/_rank_eval", self.rank_eval)
        add("POST", "/{index}/_validate/query", self.validate_query)
        add("GET", "/{index}/_validate/query", self.validate_query)
        add("POST", "/{index}/_explain/{id}", self.explain_doc)
        add("GET", "/{index}/_explain/{id}", self.explain_doc)
        add("POST", "/{index}/_rollover", self.rollover)
        add("POST", "/{index}/_rollover/{new_index}", self.rollover)
        add("POST", "/{index}/_msearch", self.msearch)
        add("POST", "/{index}/_bulk", self.bulk)
        add("POST", "/{index}/_pit", self.open_pit)
        add("POST", "/{index}/_analyze", self.analyze)
        add("GET", "/{index}/_analyze", self.analyze)
        # documents
        add("POST", "/{index}/_doc", self.index_doc_auto)
        add("PUT", "/{index}/_doc/{id}", self.index_doc)
        add("POST", "/{index}/_doc/{id}", self.index_doc)
        add("GET", "/{index}/_doc/{id}", self.get_doc)
        add("DELETE", "/{index}/_doc/{id}", self.delete_doc)
        add("PUT", "/{index}/_create/{id}", self.create_doc)
        add("POST", "/{index}/_create/{id}", self.create_doc)
        add("GET", "/{index}/_source/{id}", self.get_source)
        add("POST", "/{index}/_update/{id}", self.update_doc)
        add("POST", "/{index}/_mget", self.mget)
        add("POST", "/_mget", self.mget)

    # ------------------------------------------------------------------
    # root / cluster
    # ------------------------------------------------------------------

    def root(self, body, params, qs):
        return 200, {
            "name": self.cluster.node_name,
            "cluster_name": self.cluster.cluster_name,
            "cluster_uuid": "tpu-native",
            "version": {
                "number": ES_VERSION,
                "build_flavor": "tpu-native",
                "lucene_version": "none (JAX/XLA columnar engine)",
            },
            "tagline": "You Know, for Search",
        }

    def cluster_health(self, body, params, qs):
        # qs carries wait_for_status / wait_for_no_relocating_shards /
        # timeout (TransportClusterHealthAction wait semantics);
        # parse_qs values are lists — flatten to scalars
        flat = {k: v[0] for k, v in (qs or {}).items() if v}
        return 200, self.cluster.health(flat)

    def cluster_reroute(self, body, params, qs):
        dry_run = (qs or {}).get("dry_run", [""])[0].lower() in ("1", "true")
        return 200, self.cluster.reroute(body or {}, dry_run=dry_run)

    def allocation_explain(self, body, params, qs):
        return 200, self.cluster.allocation_explain(body or {})

    def cluster_state(self, body, params, qs):
        return 200, {
            "cluster_name": self.cluster.cluster_name,
            "version": self.cluster.version,
            "metadata": {
                "indices": {
                    name: idx.metadata()
                    for name, idx in self.cluster.indices.items()
                }
            },
        }

    def update_aliases(self, body, params, qs):
        return 200, self.cluster.update_aliases(body or {})

    def get_alias(self, body, params, qs):
        out = self.cluster.get_aliases()
        name = params.get("name")
        if name is not None:
            out = {
                idx: {"aliases": {a: m for a, m in e["aliases"].items() if a == name}}
                for idx, e in out.items()
                if name in e["aliases"]
            }
            if not out:
                return 404, error_body(
                    404, "aliases_not_found_exception", f"alias [{name}] missing"
                )
        return 200, out

    def get_index_alias(self, body, params, qs):
        self.cluster.get_index(params["index"])
        return 200, self.cluster.get_aliases(params["index"])

    def put_alias(self, body, params, qs):
        action = {"index": params["index"], "alias": params["name"]}
        if body:
            if "filter" in body:
                action["filter"] = body["filter"]
            if "is_write_index" in body:
                action["is_write_index"] = body["is_write_index"]
        return 200, self.cluster.update_aliases({"actions": [{"add": action}]})

    def delete_alias(self, body, params, qs):
        return 200, self.cluster.update_aliases(
            {"actions": [{"remove": {"index": params["index"], "alias": params["name"]}}]}
        )

    def put_template(self, body, params, qs):
        return 200, self.cluster.put_template(params["name"], body or {})

    def get_template(self, body, params, qs):
        return 200, self.cluster.get_templates(params.get("name"))

    def delete_template(self, body, params, qs):
        return 200, self.cluster.delete_template(params["name"])

    def get_cluster_settings(self, body, params, qs):
        return 200, self.cluster.cluster_settings.to_json()

    def put_cluster_settings(self, body, params, qs):
        return 200, self.cluster.update_cluster_settings(body or {})

    # ---- fault-injection test hook (POST /_internal/faults) ----

    def put_faults(self, body, params, qs):
        from ..common.faults import faults

        try:
            return 200, faults.configure(body or {})
        except (ValueError, TypeError) as e:
            return 400, error_body(
                400, "illegal_argument_exception",
                f"malformed fault schedule: {e}",
            )

    def get_faults(self, body, params, qs):
        from ..common.faults import faults

        return 200, faults.describe()

    def delete_faults(self, body, params, qs):
        from ..common.faults import faults

        faults.clear()
        return 200, {"acknowledged": True}

    # ---- per-request trace ring (GET /_internal/traces) ----

    def get_traces(self, body, params, qs):
        n = int(qs.get("n", ["50"])[0]) if qs else 50
        traces = tracing.recent(n)
        return 200, {
            "enabled": tracing.enabled(),
            "clock": tracing.CLOCK,
            "count": len(traces),
            "traces": traces,
        }

    def delete_traces(self, body, params, qs):
        tracing.clear()
        return 200, {"acknowledged": True}

    # ---- async search (SubmitAsyncSearchAction and friends) ----

    def _async_response(self, task, status: int = 200):
        out = {
            "id": task.id,
            "is_partial": not task.completed,
            "is_running": not task.completed,
            "start_time_in_millis": task.start_time_in_millis,
            "expiration_time_in_millis": task.start_time_in_millis
            + 5 * 24 * 3600 * 1000,
        }
        if task.response is not None:
            out["response"] = task.response
        if task.error is not None:
            out["error"] = task.error
            out["is_partial"] = False
            out["is_running"] = False
        return status, out

    ASYNC_SEARCH_ACTION = "indices:data/read/async_search"

    def _run_task_background(self, task, fn, done=None):
        """Shared background-task runner: error capture + keep-for-
        pickup unregister (used by async search and the by-scroll
        actions)."""
        import threading

        from ..tasks import TaskCancelledException

        def run():
            try:
                # a cancel landing after the last cooperative check but
                # before fn returns keeps the completed response — the
                # work genuinely finished
                task.response = fn(task)
            except TaskCancelledException as e:
                task.error = {"type": e.err_type, "reason": str(e)}
            except ClusterError as e:
                task.error = {"type": e.err_type, "reason": str(e)}
            except Exception as e:  # keep the task record, not the stack
                task.error = {"type": "exception", "reason": str(e)}
            finally:
                self.cluster.tasks.unregister(task, keep=True)
                if done is not None:
                    done.set()

        threading.Thread(
            target=run, name=f"task-{task.id}", daemon=True
        ).start()

    def submit_async_search(self, body, params, qs):
        import threading

        from ..cluster.service import _parse_keep_alive

        # parse the timeout BEFORE registering/starting anything: a
        # malformed value must 400 without leaking an orphan task
        wait = qs.get("wait_for_completion_timeout", ["1s"])[0]
        timeout_s = _parse_keep_alive(wait)
        index = params["index"]
        task = self.cluster.tasks.register(
            self.ASYNC_SEARCH_ACTION, f"async search [{index}]"
        )
        done = threading.Event()
        self._run_task_background(
            task, lambda t: self.cluster.search(index, body or {}), done
        )
        # default 1s: a fast search returns inline (reference behavior)
        done.wait(timeout_s)
        return self._async_response(task)

    def _async_task(self, task_id):
        task = self.cluster.tasks.get(task_id)
        if task is None or task.action != self.ASYNC_SEARCH_ACTION:
            # only async-search tasks are addressable here — a reindex
            # task id must not be readable/deletable through this API
            return None
        return task

    def get_async_search(self, body, params, qs):
        task = self._async_task(params["id"])
        if task is None:
            return 404, error_body(
                404, "resource_not_found_exception",
                f"async search [{params['id']}] not found",
            )
        return self._async_response(task)

    def delete_async_search(self, body, params, qs):
        if self._async_task(params["id"]) is None:
            return 404, error_body(
                404, "resource_not_found_exception",
                f"async search [{params['id']}] not found",
            )
        self.cluster.tasks.remove(params["id"])
        return 200, {"acknowledged": True}

    # ---- tasks + by-scroll actions (reindex module) ----

    def list_tasks(self, body, params, qs):
        actions = qs.get("actions", [None])[0]
        tasks = self.cluster.tasks.list(actions)
        return 200, {
            "nodes": {
                self.cluster.node_name: {
                    "name": self.cluster.node_name,
                    "tasks": {t.id: t.info() for t in tasks},
                }
            }
        }

    def get_task(self, body, params, qs):
        task = self.cluster.tasks.get(params["task_id"])
        if task is None:
            return 404, error_body(
                404,
                "resource_not_found_exception",
                f"task [{params['task_id']}] isn't running and hasn't stored "
                "its results",
            )
        out = {"completed": task.completed, "task": task.info()}
        if task.response is not None:
            out["response"] = task.response
        if task.error is not None:
            out["error"] = task.error
        return 200, out

    def cancel_task(self, body, params, qs):
        cancelled = self.cluster.tasks.cancel(params["task_id"])
        return 200, {
            "nodes": {
                self.cluster.node_name: {
                    "tasks": {t.id: t.info() for t in cancelled}
                }
            }
        }

    def _by_scroll(self, action: str, description: str, qs, fn):
        """Shared runner: foreground, or background with
        wait_for_completion=false (the task keeps the response)."""
        task = self.cluster.tasks.register(action, description)
        wait = qs.get("wait_for_completion", ["true"])[0] != "false"
        if wait:
            try:
                return 200, fn(task)
            finally:
                self.cluster.tasks.unregister(task)
        self._run_task_background(task, fn)
        return 200, {"task": task.id}

    def reindex(self, body, params, qs):
        from ..reindex import reindex as _reindex

        src = ((body or {}).get("source") or {}).get("index")
        dst = ((body or {}).get("dest") or {}).get("index")
        return self._by_scroll(
            "indices:data/write/reindex",
            f"reindex from [{src}] to [{dst}]",
            qs,
            lambda task: _reindex(self.cluster, body, task),
        )

    def update_by_query(self, body, params, qs):
        from ..reindex import update_by_query as _ubq

        return self._by_scroll(
            "indices:data/write/update/byquery",
            f"update-by-query [{params['index']}]",
            qs,
            lambda task: _ubq(self.cluster, params["index"], body, task),
        )

    def delete_by_query(self, body, params, qs):
        from ..reindex import delete_by_query as _dbq

        return self._by_scroll(
            "indices:data/write/delete/byquery",
            f"delete-by-query [{params['index']}]",
            qs,
            lambda task: _dbq(self.cluster, params["index"], body, task),
        )

    # ---- ingest pipelines ----

    def put_pipeline(self, body, params, qs):
        return 200, self.cluster.put_pipeline(params["id"], body)

    def get_pipeline(self, body, params, qs):
        return 200, self.cluster.get_pipeline(params.get("id"))

    def delete_pipeline(self, body, params, qs):
        return 200, self.cluster.delete_pipeline(params["id"])

    def simulate_pipeline(self, body, params, qs):
        return 200, self.cluster.simulate_pipeline(params.get("id"), body)

    # ---- snapshots ----

    def put_repository(self, body, params, qs):
        return 200, self.cluster.put_repository(params["repo"], body)

    def verify_repository(self, body, params, qs):
        self.cluster.get_repository(params["repo"])  # existence check
        self.cluster.put_repository(
            params["repo"], self.cluster.repositories[params["repo"]]
        )  # re-runs the write probe
        return 200, {"nodes": {self.cluster.node_name: {"name": self.cluster.node_name}}}

    def get_repository(self, body, params, qs):
        return 200, self.cluster.get_repository(params.get("repo"))

    def delete_repository(self, body, params, qs):
        return 200, self.cluster.delete_repository(params["repo"])

    def create_snapshot(self, body, params, qs):
        return 200, self.cluster.create_snapshot(
            params["repo"], params["snap"], body
        )

    def get_snapshot(self, body, params, qs):
        return 200, self.cluster.get_snapshot(params["repo"], params["snap"])

    def delete_snapshot(self, body, params, qs):
        return 200, self.cluster.delete_snapshot(params["repo"], params["snap"])

    def restore_snapshot(self, body, params, qs):
        return 200, self.cluster.restore_snapshot(
            params["repo"], params["snap"], body
        )

    def clear_cache(self, body, params, qs):
        """POST [/{index}]/_cache/clear — drops filter-bitset and/or
        request-cache entries (?query=false / ?request=false narrow it,
        mirroring the reference's clear-cache flags)."""
        do_query = qs.get("query", ["true"])[0] not in ("false", "0")
        do_request = qs.get("request", ["true"])[0] not in ("false", "0")
        index = params.get("index")
        shards = 0
        if index is not None:
            targets = self.cluster.resolve(index)
            for name, _ in targets:
                idx = self.cluster.get_index(name)
                idx.clear_caches(query=do_query, request=do_request)
                shards += idx.num_shards
        else:
            from ..search.query_cache import filter_cache, request_cache

            if do_query:
                filter_cache.clear()
            if do_request:
                request_cache.clear()
            shards = sum(
                i.num_shards for i in self.cluster.indices.values()
            )
        return 200, {
            "_shards": {"total": shards, "successful": shards, "failed": 0}
        }

    def nodes_stats(self, body, params, qs):
        import resource

        from ..common.memory import hbm_ledger

        ru = resource.getrusage(resource.RUSAGE_SELF)
        total_docs = sum(i.num_docs for i in self.cluster.indices.values())
        hbm = hbm_ledger.stats()
        # batcher dispatch counters across indices (threadpool analog:
        # queue/rejected for the `search` pool)
        batch = {
            "jobs": 0, "launches": 0, "rejected": 0, "fused_jobs": 0,
            "pruned_jobs": 0, "fused_overflow_jobs": 0,
            "shed_dead_jobs": 0, "cancelled_jobs": 0, "chunked_jobs": 0,
            "chunked_launches": 0, "sparse_launches": 0,
        }
        # serving-pipeline roofline counters (QueryBatcher.pipeline_stats):
        # depth/in_flight of the dispatch ring, device-busy wall time,
        # estimated useful flops, and MFU over busy time (host wall time
        # against the bf16 peak, not device measures); host_syncs counts
        # the downloads the batcher's workers waited in, host_stall_ms
        # their time (ops/scoring.py `download`)
        pipeline = {
            "depth": 0, "in_flight": 0, "device_busy_ms": 0.0,
            "host_stall_ms": 0.0, "host_syncs": 0, "flops": 0, "mfu": 0.0,
        }
        queue_capacity = 0
        # continuous-batching counters (QueryBatcher.batching_stats):
        # per-bucket launch histogram + occupancy, so padding waste is a
        # measured number; express_lane_hits counts depth-1 lone-query
        # dispatches
        batching = {
            "buckets": [],
            "launches_by_bucket": {},
            "occupancy_jobs": 0,
            "occupancy_slots": 0,
            "express_lane_hits": 0,
        }
        # per-device roofline rows (straggler visibility): busy time and
        # flops merged by device id across every index's batcher
        dev_agg: dict = {}
        # whole-index serving counters (parallel/mesh_executor.py),
        # summed across every index's MeshExecutor
        mesh_stats = {
            "routed": 0, "launches": 0, "jobs": 0, "rebuilds": 0,
            "degraded": 0, "fallbacks": 0,
        }
        for idx in self.cluster.indices.values():
            mex = getattr(idx, "_mesh", None)
            if mex is not None:
                for k in mesh_stats:
                    mesh_stats[k] += mex.stats.get(k, 0)
            b = getattr(idx, "_batcher", None)
            if b is not None:
                for k in batch:
                    batch[k] += b.stats.get(k, 0)
                queue_capacity = max(queue_capacity, b._queue.maxsize)
                ps = b.pipeline_stats()
                pipeline["depth"] = max(pipeline["depth"], ps["depth"])
                pipeline["in_flight"] += ps["in_flight"]
                pipeline["device_busy_ms"] += ps["device_busy_ms"]
                pipeline["host_stall_ms"] += ps["host_stall_ms"]
                pipeline["host_syncs"] += b.host_syncs()
                pipeline["flops"] += ps["flops"]
                for row in b.device_stats():
                    d = dev_agg.setdefault(
                        row["id"], {"id": row["id"],
                                    "device_busy_ms": 0.0, "flops": 0}
                    )
                    d["device_busy_ms"] += row["device_busy_ms"]
                    d["flops"] += row["flops"]
                bs = b.batching_stats()
                if len(bs["buckets"]) > len(batching["buckets"]):
                    batching["buckets"] = bs["buckets"]
                for bk, n in bs["launches_by_bucket"].items():
                    batching["launches_by_bucket"][bk] = (
                        batching["launches_by_bucket"].get(bk, 0) + n
                    )
                batching["occupancy_jobs"] += bs["occupancy_jobs"]
                batching["occupancy_slots"] += bs["occupancy_slots"]
                batching["express_lane_hits"] += bs["express_lane_hits"]
        if pipeline["depth"] == 0:
            from ..common.settings import pipeline_depth

            pipeline["depth"] = pipeline_depth()
        if pipeline["device_busy_ms"] > 0:
            from ..common.settings import peak_flops

            pipeline["mfu"] = pipeline["flops"] / (
                (pipeline["device_busy_ms"] / 1000.0) * peak_flops()
            )
        pipeline["device_busy_ms"] = round(pipeline["device_busy_ms"], 3)
        pipeline["host_stall_ms"] = round(pipeline["host_stall_ms"], 3)
        from ..common.settings import peak_flops as _peak

        pipeline["devices"] = [
            {
                "id": d["id"],
                "device_busy_ms": round(d["device_busy_ms"], 3),
                "flops": int(d["flops"]),
                "mfu": (
                    d["flops"] / ((d["device_busy_ms"] / 1000.0) * _peak())
                    if d["device_busy_ms"] > 0
                    else 0.0
                ),
            }
            for d in sorted(dev_agg.values(), key=lambda r: r["id"])
        ]
        batching["avg_occupancy"] = (
            round(batching["occupancy_jobs"] / batching["occupancy_slots"], 4)
            if batching["occupancy_slots"]
            else 0.0
        )
        if not batching["buckets"]:
            from ..common.settings import batch_buckets
            from ..ops.scoring import BPAD

            batching["buckets"] = list(batch_buckets(BPAD))
        pipeline["batching"] = batching
        pipeline["mesh"] = mesh_stats
        if queue_capacity == 0:
            from ..search.batcher import QUEUE_CAPACITY

            queue_capacity = QUEUE_CAPACITY
        from ..search.admission import admission
        from ..search.query_cache import filter_cache, request_cache

        # per-category child breakers next to the "hbm" parent (per-
        # category bytes were accounted but invisible before)
        category_breakers = hbm_ledger.child_breakers()
        batchers = [
            idx._batcher for idx in self.cluster.indices.values()
            if getattr(idx, "_batcher", None) is not None
        ]
        # device-aggregations engine counters (search/aggs_device.py):
        # device_routed vs host_routed shard collections, injected-fault
        # / breaker fallbacks, dispatch+download wall time, and the
        # `aggs` ledger bytes (int offset / value-ordinal columns)
        from ..search.aggs_device import stats_snapshot as agg_stats

        aggs_block = agg_stats()
        aggs_block["batched_jobs"] = sum(b.stats.get("agg_jobs", 0) for b in batchers)
        # learned-sparse retrieval counters (search/sparse.py):
        # quantized/exact/fallback routings, impact tiles scored vs
        # pruned by the block-max pass, the `impacts` ledger bytes, and
        # the int8-vs-fp32-equivalent upload sizes
        from ..search.sparse import stats_snapshot as sparse_stats

        sparse_block = sparse_stats()
        sparse_block["batched_jobs"] = sum(b.stats.get("sparse_jobs", 0) for b in batchers)
        # IVF ANN tier counters (search/ann.py): probe counts, clusters
        # scanned vs total, exact-fallback/escape-hatch routings, index
        # build wall time, and the `ann` HBM ledger bytes
        from ..search.ann import stats_snapshot as ann_stats

        knn_block = {"ann": ann_stats()}
        # second-stage reranking counters (models/rerank.py):
        # device/host rescores, degrade-to-skip and first-stage
        # fallbacks, maxsim wall time, the window-size histogram, and
        # the `rerank` ledger bytes
        from ..models.rerank import stats_snapshot as rescore_stats

        rescore_block = rescore_stats()
        rescore_block["batched_jobs"] = sum(b.stats.get("rerank_jobs", 0) for b in batchers)
        # write-path durability counters (index/translog.py): live
        # uncommitted WAL state aggregated over local shards, plus the
        # process-wide hygiene/recovery counters (torn tails truncated,
        # orphan checkpoint/manifest cleanup, WAL replays, quarantined
        # segment dirs, peer-recovery lifecycle)
        from ..index.translog import durability_stats_snapshot

        dur = durability_stats_snapshot()
        translog_block = {
            "uncommitted_ops": 0,
            "uncommitted_bytes": 0,
            "pending_unsynced_ops": 0,
            "last_fsync_age_ms": 0.0,
            "fsyncs": dur["translog_fsyncs"],
            "appended_ops": dur["translog_appended_ops"],
            "torn_tails_truncated": dur["torn_tails_truncated"],
            "torn_bytes_dropped": dur["torn_bytes_dropped"],
            "orphan_checkpoints_removed": dur["orphan_checkpoints_removed"],
            "stale_generations_removed": dur["stale_generations_removed"],
        }
        for idx in self.cluster.indices.values():
            for eng in getattr(idx, "_local", {}).values():
                ts = eng.translog_stats()
                translog_block["uncommitted_ops"] += ts["uncommitted_ops"]
                translog_block["uncommitted_bytes"] += ts["uncommitted_bytes"]
                translog_block["pending_unsynced_ops"] += ts["pending_ops"]
                if ts["last_fsync_age_ms"] is not None:
                    translog_block["last_fsync_age_ms"] = max(
                        translog_block["last_fsync_age_ms"],
                        ts["last_fsync_age_ms"],
                    )
        # streaming-ingest counters (index/segment_build.py): refresh
        # count + visibility-lag percentiles, device vs host segment
        # builds (+ degrade/fallback/discard counters), per-column-family
        # build kernel ms, concurrent-build overlap, post-swap prewarm
        # time, and the transient `build` ledger bytes
        from ..index.segment_build import stats_snapshot as ingest_stats

        ingest_block = ingest_stats()
        ingest_block["refreshers_running"] = sum(
            1
            for idx in self.cluster.indices.values()
            if getattr(idx, "_refresher", None) is not None
            and idx._refresher.is_alive()
        )
        recovery_block = {
            "replayed_ops": dur["replayed_ops"],
            "tail_replays": dur["tail_replays"],
            "quarantined_segments": dur["quarantined_segments"],
            "orphan_manifests_removed": dur["orphan_manifests_removed"],
            "peer": {
                "started": dur["recoveries_started"],
                "completed": dur["recoveries_completed"],
                "failed": dur["recoveries_failed"],
                "retries": dur["recovery_retries"],
                "files": dur["recovered_files"],
                "ops": dur["recovered_ops"],
                "finalize_redelivered": dur["finalize_redelivered"],
            },
        }
        from ..cluster.allocation import relocation_stats_snapshot

        relocation_block = relocation_stats_snapshot()
        return 200, {
            "cluster_name": self.cluster.cluster_name,
            "nodes": {
                "node-0": {
                    "name": self.cluster.node_name,
                    "roles": ["master", "data", "ingest"],
                    "indices": {
                        "docs": {"count": total_docs},
                        "query_cache": filter_cache.node_stats(),
                        "request_cache": request_cache.node_stats(),
                    },
                    "jvm": {  # shape parity; values are process RSS
                        "mem": {"heap_used_in_bytes": ru.ru_maxrss * 1024}
                    },
                    "os": {"cpu": {"percent": 0}},
                    "process": {
                        "open_file_descriptors": 0,
                        "max_file_descriptors": 0,
                    },
                    "breakers": {
                        "hbm": {
                            "limit_size_in_bytes": hbm["limit_size_in_bytes"],
                            "estimated_size_in_bytes": hbm[
                                "estimated_size_in_bytes"
                            ],
                            "tripped": hbm["tripped"],
                            "by_category": hbm["by_category"],
                            "degraded_allocations": hbm[
                                "degraded_allocations"
                            ],
                        },
                        **category_breakers,
                    },
                    "pipeline": pipeline,
                    "aggs": aggs_block,
                    "knn": knn_block,
                    "rescore": rescore_block,
                    "sparse": sparse_block,
                    "translog": translog_block,
                    "ingest": ingest_block,
                    "recovery": recovery_block,
                    # relocation lifecycle counters (cluster/allocation.py):
                    # started/completed/cancelled/failed moves, transferred
                    # bytes, handoff drains and their cumulative latency
                    "relocation": relocation_block,
                    # overload-protection block (search/admission.py):
                    # per-tenant queue depths, the adaptive concurrency
                    # limit, pressure tier, shed/brownout/retry-budget
                    # counters
                    "admission": admission.stats(),
                    "thread_pool": {
                        "search": {
                            "queue_capacity": queue_capacity,
                            "completed": batch["jobs"],
                            "rejected": batch["rejected"],
                            "launches": batch["launches"],
                            "fused_jobs": batch["fused_jobs"],
                            "pruned_jobs": batch["pruned_jobs"],
                            "fused_overflow_jobs": batch[
                                "fused_overflow_jobs"
                            ],
                            "shed_dead_jobs": batch["shed_dead_jobs"],
                            "cancelled_jobs": batch["cancelled_jobs"],
                            # (job, segment) pairs the batcher scored
                            # through the chunked block-max path
                            "chunked_jobs": batch["chunked_jobs"],
                            # the BM25 tile-add launches of their passes
                            "chunked_launches": batch["chunked_launches"],
                            # the impact-tile launches of the sparse
                            # family's scoring passes
                            "sparse_launches": batch["sparse_launches"],
                        }
                    },
                    "uptime_in_millis": int(
                        (time.time() - self.started_at) * 1000
                    ),
                }
            },
        }

    def all_stats(self, body, params, qs):
        indices = {
            name: idx.stats() for name, idx in self.cluster.indices.items()
        }
        total_docs = sum(i.num_docs for i in self.cluster.indices.values())
        return 200, {
            "_all": {"primaries": {"docs": {"count": total_docs}}},
            "indices": indices,
        }

    def cat_indices(self, body, params, qs):
        rows = []
        for name, idx in sorted(self.cluster.indices.items()):
            rows.append(
                {
                    "health": "green"
                    if int(idx.settings.get("number_of_replicas", 1)) == 0
                    else "yellow",
                    "status": "open",
                    "index": name,
                    "uuid": idx.uuid,
                    "pri": str(idx.num_shards),
                    "rep": str(idx.settings.get("number_of_replicas", 1)),
                    "docs.count": str(idx.num_docs),
                    "docs.deleted": "0",
                    "store.size": f"{idx.stats()['primaries']['store']['size_in_bytes']}b",
                    "pri.store.size": f"{idx.stats()['primaries']['store']['size_in_bytes']}b",
                }
            )
        if qs.get("format") == ["json"]:
            return 200, rows
        header = "health status index uuid pri rep docs.count docs.deleted store.size pri.store.size"
        lines = [header] if "v" in qs else []
        for r in rows:
            lines.append(
                f"{r['health']} {r['status']} {r['index']} {r['uuid']} "
                f"{r['pri']} {r['rep']} {r['docs.count']} {r['docs.deleted']} "
                f"{r['store.size']} {r['pri.store.size']}"
            )
        return 200, "\n".join(lines) + "\n"

    def cat_shards(self, body, params, qs):
        """_cat/shards: one row per shard COPY with primary/replica
        role, state, and owning node (replication made this real)."""
        rows = []
        node_name = self.cluster.node_name
        for name, idx in sorted(self.cluster.indices.items()):
            for sid in range(idx.num_shards):
                entry = idx._entry(sid)
                if entry is None:
                    eng = idx.local_shards.get(sid)
                    rows.append({
                        "index": name, "shard": str(sid), "prirep": "p",
                        "state": "STARTED",
                        "docs": str(eng.num_docs if eng else 0),
                        "node": node_name,
                    })
                    continue
                copies = (
                    [(entry["primary"], "p")]
                    if entry["primary"] is not None
                    else []
                ) + [(r, "r") for r in entry["replicas"]]
                if not copies:
                    rows.append({
                        "index": name, "shard": str(sid), "prirep": "p",
                        "state": "UNASSIGNED", "docs": "", "node": "",
                    })
                for node, role in copies:
                    in_sync = node in entry["in_sync"]
                    eng = (
                        idx.local_shards.get(sid)
                        if node == idx.local_node
                        else None
                    )
                    rows.append({
                        "index": name,
                        "shard": str(sid),
                        "prirep": role,
                        "state": "STARTED" if in_sync else "INITIALIZING",
                        "docs": str(eng.num_docs) if eng is not None else "",
                        "node": node,
                    })
        if qs.get("format") == ["json"]:
            return 200, rows
        header = "index shard prirep state docs node"
        lines = [header] if "v" in qs else []
        for r in rows:
            lines.append(
                f"{r['index']} {r['shard']} {r['prirep']} {r['state']} "
                f"{r['docs']} {r['node']}"
            )
        return 200, "\n".join(lines) + "\n"

    def cat_health(self, body, params, qs):
        h = self.cluster.health()
        return 200, f"{int(time.time())} {h['cluster_name']} {h['status']}\n"

    # ------------------------------------------------------------------
    # index admin
    # ------------------------------------------------------------------

    def create_index(self, body, params, qs):
        return 200, self.cluster.create_index(params["index"], body)

    def delete_index(self, body, params, qs):
        return 200, self.cluster.delete_index(params["index"])

    def get_index_meta(self, body, params, qs):
        idx = self.cluster.get_index(params["index"])
        return 200, {params["index"]: idx.metadata()}

    def get_mapping(self, body, params, qs):
        idx = self.cluster.get_index(params["index"])
        return 200, {params["index"]: {"mappings": idx.mappings.to_json()}}

    def put_mapping(self, body, params, qs):
        return 200, self.cluster.put_mapping(params["index"], body or {})

    def get_settings(self, body, params, qs):
        idx = self.cluster.get_index(params["index"])
        return 200, {params["index"]: idx.metadata()["settings"] | {}}

    def put_settings(self, body, params, qs):
        return 200, self.cluster.update_settings(params["index"], body or {})

    def index_stats(self, body, params, qs):
        idx = self.cluster.get_index(params["index"])
        return 200, {
            "_shards": {
                "total": idx.num_shards,
                "successful": idx.num_shards,
                "failed": 0,
            },
            "_all": idx.stats(),
            "indices": {params["index"]: idx.stats()},
        }

    def refresh_index(self, body, params, qs):
        idx = self.cluster.get_index(params["index"])
        idx.refresh()
        n = idx.num_shards
        return 200, {"_shards": {"total": n, "successful": n, "failed": 0}}

    def refresh_all(self, body, params, qs):
        n = 0
        for idx in self.cluster.indices.values():
            idx.refresh()
            n += idx.num_shards
        return 200, {"_shards": {"total": n, "successful": n, "failed": 0}}

    def flush_index(self, body, params, qs):
        idx = self.cluster.get_index(params["index"])
        idx.flush()
        n = idx.num_shards
        return 200, {"_shards": {"total": n, "successful": n, "failed": 0}}

    def flush_all(self, body, params, qs):
        self.cluster.flush_all()
        return 200, {"_shards": {"total": 0, "successful": 0, "failed": 0}}

    def forcemerge(self, body, params, qs):
        idx = self.cluster.get_index(params["index"])
        max_seg = int(qs.get("max_num_segments", ["1"])[0])
        for s in idx.shards:
            s.maybe_merge(max_segments=max_seg)
        n = idx.num_shards
        return 200, {"_shards": {"total": n, "successful": n, "failed": 0}}

    # ------------------------------------------------------------------
    # documents
    # ------------------------------------------------------------------

    def _doc_response(self, index: str, r, shards: int) -> dict:
        return {
            "_index": index,
            "_id": r.doc_id,
            "_version": r.version,
            "result": r.result,
            "_shards": {"total": 1, "successful": 1, "failed": 0},
            "_seq_no": r.seq_no,
            "_primary_term": r.primary_term,
        }

    @staticmethod
    def _parse_refresh_param(qs):
        """Validated ?refresh= value: None | "true" | "false" |
        "wait_for". Anything else is a request-scoped 400 (the
        RestActions.parseRefreshPolicy contract)."""
        refresh = qs.get("refresh", [None])[0]
        if refresh is None:
            return None
        if refresh == "":
            return "true"
        if refresh in ("true", "false", "wait_for"):
            return refresh
        raise ClusterError(
            400,
            f"Unknown value for refresh: [{refresh}].",
            "illegal_argument_exception",
        )

    def _maybe_refresh(self, idx, qs):
        policy = self._parse_refresh_param(qs)
        if policy == "true":
            idx.refresh()
        elif policy == "wait_for":
            # blocks on the NEXT background generation swap (or degrades
            # to a blocking refresh when no refresher is running)
            idx.wait_for_refresh()

    def index_doc(self, body, params, qs, op_type=None):
        self._parse_refresh_param(qs)  # invalid ?refresh 400s pre-write
        idx, index_name = self.cluster.resolve_write_index(params["index"])
        params = dict(params, index=index_name)
        routing = qs.get("routing", [None])[0]
        op = op_type or qs.get("op_type", ["index"])[0]
        kwargs = {}
        if "if_seq_no" in qs:
            kwargs["if_seq_no"] = int(qs["if_seq_no"][0])
        if "if_primary_term" in qs:
            kwargs["if_primary_term"] = int(qs["if_primary_term"][0])
        source = self.cluster.apply_ingest(
            index_name, idx, body or {}, params["id"],
            pipeline=qs.get("pipeline", [None])[0],
        )
        if source is None:  # dropped by the pipeline
            return 200, {
                "_index": params["index"],
                "_id": params["id"],
                "result": "noop",
                "_shards": {"total": 0, "successful": 0, "failed": 0},
            }
        r = idx.index_doc(
            params["id"], source, op_type=op, routing=routing, **kwargs
        )
        self._maybe_refresh(idx, qs)
        return (201 if r.result == "created" else 200), self._doc_response(
            params["index"], r, idx.num_shards
        )

    def index_doc_auto(self, body, params, qs):
        params = dict(params, id=_auto_id())
        return self.index_doc(body, params, qs, op_type="create")

    def create_doc(self, body, params, qs):
        return self.index_doc(body, params, qs, op_type="create")

    def _single_target(self, name: str):
        targets = self.cluster.resolve(name)
        if len(targets) != 1:
            raise ClusterError(
                400,
                f"alias [{name}] has more than one index associated with it",
                "illegal_argument_exception",
            )
        return self.cluster.get_index(targets[0][0]), targets[0][0]

    def get_doc(self, body, params, qs):
        idx, _ = self._single_target(params["index"])
        routing = qs.get("routing", [None])[0]
        doc = idx.get_doc(params["id"], routing=routing)
        if doc is None:
            return 404, {
                "_index": params["index"],
                "_id": params["id"],
                "found": False,
            }
        return 200, {
            "_index": params["index"],
            **doc,
            "found": True,
        }

    def get_source(self, body, params, qs):
        idx, _ = self._single_target(params["index"])
        doc = idx.get_doc(params["id"], routing=qs.get("routing", [None])[0])
        if doc is None:
            return 404, error_body(
                404,
                "resource_not_found_exception",
                f"Document not found [{params['index']}]/[{params['id']}]",
            )
        return 200, doc["_source"]

    def delete_doc(self, body, params, qs):
        self._parse_refresh_param(qs)  # invalid ?refresh 400s pre-write
        idx, index_name = self.cluster.resolve_write_index(
            params["index"], allow_auto_create=False
        )
        params = dict(params, index=index_name)
        routing = qs.get("routing", [None])[0]
        kwargs = {}
        if "if_seq_no" in qs:
            kwargs["if_seq_no"] = int(qs["if_seq_no"][0])
        if "if_primary_term" in qs:
            kwargs["if_primary_term"] = int(qs["if_primary_term"][0])
        r = idx.delete_doc(params["id"], routing=routing, **kwargs)
        self._maybe_refresh(idx, qs)
        status = 200 if r.result == "deleted" else 404
        return status, self._doc_response(params["index"], r, idx.num_shards)

    def update_doc(self, body, params, qs):
        """_update: partial doc merge, doc_as_upsert, SCRIPTED updates
        (ctx._source/ctx.op contract), noop detection
        (TransportUpdateAction + UpdateHelper)."""
        self._parse_refresh_param(qs)  # invalid ?refresh 400s pre-write
        idx, index_name = self.cluster.resolve_write_index(
            params["index"], allow_auto_create=False
        )
        params = dict(params, index=index_name)
        routing = qs.get("routing", [None])[0]
        body = body or {}
        doc_part = body.get("doc")
        script = body.get("script")
        if doc_part is None and script is None:
            return 400, error_body(
                400,
                "action_request_validation_exception",
                "script or doc is missing",
            )
        if doc_part is not None and script is not None:
            return 400, error_body(
                400,
                "action_request_validation_exception",
                "can't provide both script and doc",
            )
        if body.get("doc_as_upsert") and doc_part is None:
            return 400, error_body(
                400,
                "action_request_validation_exception",
                "doc must be specified if doc_as_upsert is enabled",
            )
        # read-then-write races are caught by a seq_no CAS (the engine's
        # if_seq_no/if_primary_term) and retried per retry_on_conflict —
        # UpdateHelper + TransportUpdateAction semantics; without the CAS
        # a concurrent write between our get and our index is silently
        # overwritten (lost write)
        retries = int(qs.get("retry_on_conflict", ["0"])[0])
        while True:
            try:
                return self._update_doc_once(idx, params, routing, body, qs)
            except VersionConflictError as e:
                if retries <= 0:
                    return 409, error_body(
                        409, "version_conflict_engine_exception", str(e)
                    )
                retries -= 1

    def _update_doc_once(self, idx, params, routing, body, qs):
        doc_part = body.get("doc")
        script = body.get("script")
        existing = idx.get_doc(params["id"], routing=routing)
        if existing is None:
            if body.get("doc_as_upsert") or "upsert" in body:
                base = body.get(
                    "upsert",
                    doc_part if body.get("doc_as_upsert") else {},
                )
                merged = (
                    deep_merge(base, doc_part)
                    if doc_part is not None
                    else base
                )
                if script is not None and body.get("scripted_upsert"):
                    merged, op = self._run_update_script(script, merged, params["id"])
                    if op == "none":
                        return 200, {
                            "_index": params["index"], "_id": params["id"],
                            "result": "noop",
                            "_shards": {"total": 0, "successful": 0,
                                        "failed": 0},
                        }
                # op_type=create: a doc created concurrently since our
                # get is a conflict, not a blind overwrite
                r = idx.index_doc(
                    params["id"], merged, op_type="create", routing=routing
                )
                self._maybe_refresh(idx, qs)
                return 201, self._doc_response(params["index"], r, idx.num_shards)
            return 404, error_body(
                404,
                "document_missing_exception",
                f"[{params['id']}]: document missing",
            )
        if script is not None:
            merged, op = self._run_update_script(
                script, dict(existing["_source"]), params["id"]
            )
            if op == "none":
                return 200, {
                    "_index": params["index"],
                    "_id": params["id"],
                    "_version": existing["_version"],
                    "result": "noop",
                    "_shards": {"total": 0, "successful": 0, "failed": 0},
                    "_seq_no": existing["_seq_no"],
                    "_primary_term": existing["_primary_term"],
                }
            if op == "delete":
                r = idx.delete_doc(
                    params["id"], routing=routing,
                    if_seq_no=existing["_seq_no"],
                    if_primary_term=existing["_primary_term"],
                )
                self._maybe_refresh(idx, qs)
                return 200, self._doc_response(
                    params["index"], r, idx.num_shards
                )
            r = idx.index_doc(
                params["id"], merged, routing=routing,
                if_seq_no=existing["_seq_no"],
                if_primary_term=existing["_primary_term"],
            )
            self._maybe_refresh(idx, qs)
            return 200, self._doc_response(params["index"], r, idx.num_shards)
        merged = deep_merge(existing["_source"], doc_part)
        if merged == existing["_source"] and body.get("detect_noop", True):
            return 200, {
                "_index": params["index"],
                "_id": params["id"],
                "_version": existing["_version"],
                "result": "noop",
                "_shards": {"total": 0, "successful": 0, "failed": 0},
                "_seq_no": existing["_seq_no"],
                "_primary_term": existing["_primary_term"],
            }
        r = idx.index_doc(
            params["id"], merged, routing=routing,
            if_seq_no=existing["_seq_no"],
            if_primary_term=existing["_primary_term"],
        )
        self._maybe_refresh(idx, qs)
        return 200, self._doc_response(params["index"], r, idx.num_shards)

    @staticmethod
    def _run_update_script(script, source: dict, doc_id: str):
        """(new_source, op) for an update script: ctx._source mutations
        + ctx.op in {index (default), none/noop, delete}. The source is
        DEEP-copied first — the engine's get() hands back the live
        stored object, and a script must never mutate it in place
        (especially on the noop path)."""
        import copy

        from ..script import ScriptError, script_service

        ctx = {
            "_source": copy.deepcopy(source),
            "_id": doc_id,
            "op": "index",
        }
        try:
            script_service.run_ingest(script, ctx)
        except ScriptError as e:
            raise ClusterError(400, str(e), "script_exception")
        op = str(ctx.get("op", "index"))
        if op in ("noop", "none"):
            op = "none"
        elif op not in ("index", "delete"):
            # UpdateHelper rejects unknown ops instead of masking typos
            raise ClusterError(
                400,
                f"Operation type [{op}] not allowed, only [noop, index, "
                "delete] are allowed",
                "illegal_argument_exception",
            )
        return ctx.get("_source", source), op

    def mget(self, body, params, qs):
        body = body or {}
        docs_spec = body.get("docs")
        out = []
        if docs_spec is None and "ids" in body and "index" in params:
            docs_spec = [{"_id": i} for i in body["ids"]]
        for spec in docs_spec or []:
            index = spec.get("_index", params.get("index"))
            try:
                idx, index = self._single_target(index)
                doc = idx.get_doc(spec["_id"], routing=spec.get("routing"))
            except ClusterError:
                doc = None
            if doc is None:
                out.append({"_index": index, "_id": spec["_id"], "found": False})
            else:
                out.append({"_index": index, **doc, "found": True})
        return 200, {"docs": out}

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def search(self, body, params, qs):
        """`/<index>/_search`, as the `search` span of the request's
        trace: the HTTP layer arms the trace (its `http` span is the
        root); a search called in process arms one of its own."""
        tags = {
            "index": str(params["index"]),
            "profile": bool((body or {}).get("profile")),
        }
        handle = None
        tr = tracing.current()
        if tr is None:
            handle = tracing.begin("search", **tags)
            tr = handle[0] if handle is not None else None
        else:
            tr.tags.update(tags)
        try:
            if tr is None:
                return self._search(body, params, qs)
            with tr.span("search"):
                return self._search(body, params, qs)
        finally:
            tracing.end(handle)

    def _search(self, body, params, qs):
        body = dict(body or {})
        if "size" in qs:
            body["size"] = int(qs["size"][0])
        if "from" in qs:
            body["from"] = int(qs["from"][0])
        if "q" in qs:
            # query_string lite: field:value or plain terms on all text fields
            body["query"] = _parse_q_param(qs["q"][0])
        if "search_type" in qs:
            body["search_type"] = qs["search_type"][0]
        if "request_cache" in qs:
            # per-request shard-request-cache override (rides the body
            # down to the shard; excluded from the cache key itself)
            body["request_cache"] = qs["request_cache"][0] not in (
                "false", "0",
            )
        if "timeout" in qs:
            body["timeout"] = qs["timeout"][0]
        if "exact" in qs:
            # ANN escape hatch: ?exact=true routes every knn section of
            # this request to the brute-force float oracle even on an
            # index.knn.type=ivf index (rides the body to the shards)
            body["exact"] = qs["exact"][0] not in ("false", "0")
        if "rescore" in qs and qs["rescore"][0] in ("false", "0"):
            # second-stage escape hatch: ?rescore=false strips the
            # body's rescore element so the request serves the pure
            # first-stage ranking (the per-request form of
            # ES_TPU_RERANK=off)
            body.pop("rescore", None)
        if "allow_degraded" in qs:
            # brownout opt-out: pins the request to full-fidelity
            # execution (it can still be shed outright under overload)
            body["allow_degraded"] = qs["allow_degraded"][0] not in (
                "false", "0",
            )
        if "allow_partial_search_results" in qs:
            body["allow_partial_search_results"] = qs[
                "allow_partial_search_results"
            ][0] not in ("false", "0")
        if "scroll" in qs:
            targets = self.cluster.resolve(params["index"])
            if len(targets) != 1:
                return 400, error_body(
                    400,
                    "illegal_argument_exception",
                    "scroll is only supported over a single index",
                )
            name, alias_filter = targets[0]
            if alias_filter is not None:
                inner = body.get("query", {"match_all": {}})
                body = {
                    **body,
                    "query": {"bool": {"must": [inner], "filter": [alias_filter]}},
                }
            return 200, self.cluster.create_scroll(
                name, body, qs["scroll"][0] or "1m"
            )
        # every search runs as a registered CANCELLABLE task
        # (TaskManager.register around TransportSearchAction): the
        # coordinator's gather loop polls check_cancelled(), so a
        # cancel landing mid-collect aborts the request promptly now
        # that timeout cancellation exists on the same path
        desc = f"indices[{params['index']}]"
        opaque = tracing.OPAQUE_ID_CTX.get()
        if opaque:
            # X-Opaque-Id lands in the task description so _tasks output
            # attributes in-flight searches to their caller
            desc = f"{desc} opaque_id[{opaque}]"
        task = self.cluster.tasks.register(
            "indices:data/read/search",
            desc,
            cancellable=True,
        )
        try:
            return 200, self.cluster.search(params["index"], body, task=task)
        finally:
            self.cluster.tasks.unregister(task)

    def search_no_index(self, body, params, qs):
        body = body or {}
        if "pit" in body:
            return 200, self.cluster.pit_search(body)
        return 400, error_body(
            400,
            "action_request_validation_exception",
            "index is missing (only pit searches may omit the index)",
        )

    def scroll(self, body, params, qs):
        body = body or {}
        scroll_id = body.get("scroll_id") or (qs.get("scroll_id", [None])[0])
        if not scroll_id:
            return 400, error_body(
                400, "action_request_validation_exception", "scroll_id is missing"
            )
        keep = body.get("scroll") or qs.get("scroll", [None])[0]
        return 200, self.cluster.continue_scroll(scroll_id, keep)

    def delete_scroll(self, body, params, qs):
        body = body or {}
        ids = body.get("scroll_id", "_all")
        if isinstance(ids, str) and ids != "_all":
            ids = [ids]
        return 200, self.cluster.delete_scrolls(ids)

    def open_pit(self, body, params, qs):
        keep = qs.get("keep_alive", ["1m"])[0]
        return 200, self.cluster.open_pit(params["index"], keep)

    def close_pit(self, body, params, qs):
        body = body or {}
        pit_id = body.get("id")
        if not pit_id:
            return 400, error_body(
                400, "action_request_validation_exception", "id is missing"
            )
        return 200, self.cluster.close_pit(pit_id)

    def analyze(self, body, params, qs):
        """_analyze (TransportAnalyzeAction): run an analyzer or an ad-hoc
        tokenizer/filter chain over text, return tokens with offsets."""
        body = body or {}
        text = body.get("text")
        if text is None:
            return 400, error_body(
                400, "action_request_validation_exception", "text is missing"
            )
        texts = text if isinstance(text, list) else [text]
        if "index" in params:
            idx = self.cluster.get_index(params["index"])
            registry = idx.analysis
            field = body.get("field")
            if field is not None and body.get("analyzer") is None:
                mf = idx.mappings.get(field)
                analyzer_name = (mf.analyzer if mf else None) or "standard"
            else:
                analyzer_name = body.get("analyzer", "standard")
        else:
            from ..analysis import AnalysisRegistry

            registry = AnalysisRegistry()
            analyzer_name = body.get("analyzer", "standard")
        analyzer = registry.get(analyzer_name)
        tokens = []
        pos_offset = 0
        for t in texts:
            toks = analyzer.analyze(t)
            for tok in toks:
                tokens.append(
                    {
                        "token": tok.text,
                        "start_offset": tok.start_offset,
                        "end_offset": tok.end_offset,
                        "type": "<NUM>" if tok.text.isdigit() else "<ALPHANUM>",
                        "position": pos_offset + tok.position,
                    }
                )
            if toks:
                pos_offset += toks[-1].position + 100  # position_increment_gap
        return 200, {"tokens": tokens}

    def rank_eval(self, body, params, qs):
        """_rank_eval (modules/rank-eval): run rated requests, score
        with precision@k / recall@k / MRR / DCG."""
        import math as _math

        body = body or {}
        requests = body.get("requests") or []
        metric_spec = body.get("metric") or {"precision": {"k": 10}}
        if len(metric_spec) != 1:
            return 400, error_body(
                400, "parsing_exception", "[metric] must have one entry"
            )
        metric_name, mparams = next(iter(metric_spec.items()))
        mparams = mparams or {}
        k = int(mparams.get("k", 10))
        threshold = int(mparams.get("relevant_rating_threshold", 1))
        details = {}
        scores = []
        for req in requests:
            rid = req.get("id")
            try:
                ratings = {
                    r["_id"]: int(r.get("rating", 0))
                    for r in req.get("ratings", [])
                }
            except (KeyError, TypeError, ValueError) as e:
                return 400, error_body(
                    400, "parsing_exception",
                    f"malformed ratings in request [{rid}]: {e}",
                )
            search_body = dict(req.get("request") or {})
            search_body["size"] = max(k, int(search_body.get("size", k)))
            search_body.setdefault("_source", False)
            resp = self.cluster.search(params["index"], search_body)
            hit_ids = [h["_id"] for h in resp["hits"]["hits"]][:k]
            hit_ratings = [ratings.get(h, 0) for h in hit_ids]
            relevant_in_k = sum(1 for r in hit_ratings if r >= threshold)
            total_relevant = sum(
                1 for r in ratings.values() if r >= threshold
            )
            if metric_name == "precision":
                # PrecisionAtK divides by RETRIEVED docs, not k: a
                # 3-hit all-relevant result at k=10 scores 1.0
                score = (
                    relevant_in_k / len(hit_ratings) if hit_ratings else 0.0
                )
            elif metric_name == "recall":
                score = (
                    relevant_in_k / total_relevant if total_relevant else 0.0
                )
            elif metric_name == "mean_reciprocal_rank":
                score = 0.0
                for rank, r in enumerate(hit_ratings, 1):
                    if r >= threshold:
                        score = 1.0 / rank
                        break
            elif metric_name == "dcg":
                normalize = bool(mparams.get("normalize", False))
                dcg = sum(
                    (2**r - 1) / _math.log2(rank + 1)
                    for rank, r in enumerate(hit_ratings, 1)
                )
                if normalize:
                    ideal = sorted(ratings.values(), reverse=True)[:k]
                    idcg = sum(
                        (2**r - 1) / _math.log2(rank + 1)
                        for rank, r in enumerate(ideal, 1)
                    )
                    score = dcg / idcg if idcg else 0.0
                else:
                    score = dcg
            else:
                return 400, error_body(
                    400, "parsing_exception",
                    f"unknown metric [{metric_name}]",
                )
            scores.append(score)
            details[rid] = {
                "metric_score": round(score, 6),
                "unrated_docs": [
                    {"_index": params["index"], "_id": h}
                    for h in hit_ids
                    if h not in ratings
                ],
                "hits": [
                    {
                        "hit": {"_index": params["index"], "_id": h},
                        "rating": ratings.get(h),
                    }
                    for h in hit_ids
                ],
            }
        return 200, {
            "metric_score": (
                round(sum(scores) / len(scores), 6) if scores else 0.0
            ),
            "details": details,
            "failures": {},
        }

    def validate_query(self, body, params, qs):
        """_validate/query (ValidateQueryAction): parse-checks the query
        without executing it; explain=true carries the error."""
        from ..search import dsl as _dsl

        targets = self.cluster.resolve(params["index"])
        n = len(targets)
        resp = {
            "valid": True,
            "_shards": {"total": n, "successful": n, "failed": 0},
        }
        explain = qs.get("explain", ["false"])[0] in ("true", "")
        try:
            q = (body or {}).get("query")
            if q is not None:
                _dsl.parse_query(q)
            if explain:
                resp["explanations"] = [
                    {"index": name, "valid": True,
                     "explanation": "query parsed"}
                    for name, _ in targets
                ]
        except _dsl.QueryParseError as e:
            resp["valid"] = False
            if explain:
                resp["error"] = str(e)
        return 200, resp

    def explain_doc(self, body, params, qs):
        """_explain (TransportExplainAction): scores ONE document
        against the query on its owning shard."""
        from ..search import dsl as _dsl
        from ..utils.murmur3 import shard_id as route_shard_id

        idx, index_name = self._single_target(params["index"])
        doc_id = params["id"]
        routing = qs.get("routing", [None])[0]
        q_body = (body or {}).get("query")
        if q_body is None:
            return 400, error_body(
                400, "action_request_validation_exception",
                "query is missing",
            )
        base = {
            "_index": index_name,  # the concrete index, not the alias
            "_id": doc_id,
        }
        doc = idx.get_doc(doc_id, routing=routing)
        if doc is None:
            return 404, {**base, "matched": False}
        sid = route_shard_id(
            routing if routing is not None else doc_id, idx.num_shards
        )
        # score through an ids-filtered search (the filter adds no
        # score, so the value equals the plain query's score for this
        # doc); identical for local and remote shard owners, O(1) docs.
        # QueryParseError from the search maps to 400 in the dispatcher.
        resp = idx.search({
            "query": {"bool": {"must": [q_body],
                               "filter": [{"ids": {"values": [doc_id]}}]}},
            "size": 1,
            "_source": False,
        })
        hits = resp["hits"]["hits"]
        matched = bool(hits)
        score = hits[0]["_score"] if hits else 0.0
        out = {**base, "matched": matched}
        if matched:
            out["explanation"] = {
                "value": score,
                "description": f"score for [{doc_id}] on shard [{sid}] "
                "(TPU-native scorer; per-term breakdown not emitted)",
                "details": [],
            }
        return 200, out

    def rollover(self, body, params, qs):
        """_rollover (RolloverAction subset): the write alias moves to a
        freshly created index named by incrementing the -NNNNNN suffix;
        conditions (max_docs, max_age ignored-if-absent) gate the roll."""
        import re as _re

        alias = params["index"]
        targets = self.cluster.aliases.get(alias)
        if not targets:
            return 400, error_body(
                400,
                "illegal_argument_exception",
                f"rollover target [{alias}] is not an alias",
            )
        # current write index (is_write_index, else sole target)
        write = [n for n, meta in targets.items() if meta.get("is_write_index")]
        old_index = write[0] if write else sorted(targets)[-1]
        m = _re.match(r"^(.*?)-(\d+)$", old_index)
        new_index = params.get("new_index")
        if new_index is None:
            if not m:
                return 400, error_body(
                    400,
                    "illegal_argument_exception",
                    f"index name [{old_index}] does not match pattern "
                    "'^.*-\\d+$'",
                )
            new_index = f"{m.group(1)}-{int(m.group(2)) + 1:0{len(m.group(2))}d}"
        conditions = (body or {}).get("conditions") or {}
        idx = self.cluster.get_index(old_index)
        met = {}
        if "max_docs" in conditions:
            max_docs = int(conditions["max_docs"])  # ES accepts strings
            met[f"[max_docs: {max_docs}]"] = idx.num_docs >= max_docs
        dry_run = qs.get("dry_run", ["false"])[0] in ("true", "")
        rolled = not conditions or any(met.values())
        resp = {
            "acknowledged": rolled and not dry_run,
            "shards_acknowledged": rolled and not dry_run,
            "old_index": old_index,
            "new_index": new_index,
            # ES reports rolled_over false on dry run regardless of
            # whether the conditions were met
            "rolled_over": rolled and not dry_run,
            "dry_run": dry_run,
            "conditions": {k: v for k, v in met.items()},
        }
        if dry_run or not rolled:
            return 200, resp
        create_body = {k: v for k, v in (body or {}).items()
                       if k in ("settings", "mappings", "aliases")}
        self.cluster.create_index(new_index, create_body)
        actions = [
            {"add": {"index": new_index, "alias": alias,
                     "is_write_index": True}},
        ]
        if old_index in targets:
            old_meta = targets.get(old_index) or {}
            re_add = {"index": old_index, "alias": alias,
                      "is_write_index": False}
            if old_meta.get("filter") is not None:
                # the add action replaces the whole alias entry — the
                # old index's filter must survive the rollover
                re_add["filter"] = old_meta["filter"]
            actions.append({"add": re_add})
        self.cluster.update_aliases({"actions": actions})
        return 200, resp

    def count(self, body, params, qs):
        return 200, self.cluster.count(params["index"], body)

    def msearch(self, body, params, qs):
        # body arrives pre-split as a list of (header, body) dicts
        t0 = time.perf_counter()
        responses = []
        for header, sub in body:
            index = header.get("index", params.get("index"))
            try:
                resp = self.cluster.search(index, sub)
                resp["status"] = 200
            except (ClusterError, QueryParseError) as e:
                status = e.status if isinstance(e, ClusterError) else 400
                resp = error_body(status, "search_phase_execution_exception", str(e))
            responses.append(resp)
        # real coordinator wall-clock across every sub-search (the
        # reference sums phase times; one monotonic clock here)
        took = int((time.perf_counter() - t0) * 1000)
        return 200, {"took": took, "responses": responses}

    # ------------------------------------------------------------------
    # bulk (NDJSON)
    # ------------------------------------------------------------------

    def bulk(self, body, params, qs):
        """body: list of parsed NDJSON lines (RestBulkAction →
        TransportBulkAction: per-item routing + independent failures)."""
        items: List[dict] = []
        errors = False
        t0 = time.perf_counter()
        # ?refresh validates BEFORE any op is applied: an invalid value
        # is a request-scoped 400, not a half-applied bulk
        refresh_policy = self._parse_refresh_param(qs)
        i = 0
        lines = body
        default_index = params.get("index")
        touched = set()
        while i < len(lines):
            action_line = lines[i]
            i += 1
            if not isinstance(action_line, dict) or len(action_line) != 1:
                return 400, error_body(
                    400,
                    "illegal_argument_exception",
                    "Malformed action/metadata line",
                )
            action, meta = next(iter(action_line.items()))
            if action not in ("index", "create", "delete", "update"):
                return 400, error_body(
                    400,
                    "illegal_argument_exception",
                    f"Unknown action [{action}]",
                )
            index = meta.get("_index", default_index)
            doc_id = meta.get("_id")
            routing = meta.get("routing")
            doc = None
            if action in ("index", "create", "update"):
                if i >= len(lines):
                    return 400, error_body(
                        400,
                        "illegal_argument_exception",
                        "Validation Failed: 1: no requests added;",
                    )
                doc = lines[i]
                i += 1
            if index is None or (doc_id is None and action in ("delete", "update")):
                items.append(
                    {
                        action: {
                            "_id": doc_id,
                            "status": 400,
                            "error": {
                                "type": "action_request_validation_exception",
                                "reason": "index is missing"
                                if index is None
                                else "id is missing",
                            },
                        }
                    }
                )
                errors = True
                continue
            try:
                idx, index = self.cluster.resolve_write_index(index)
                touched.add(index)
                if action == "delete":
                    r = idx.delete_doc(doc_id, routing=routing)
                    items.append(
                        {
                            "delete": {
                                **self._doc_response(index, r, idx.num_shards),
                                "status": 200 if r.result == "deleted" else 404,
                            }
                        }
                    )
                elif action == "update":
                    sub_qs = {"routing": [routing]} if routing is not None else {}
                    status, resp = self.update_doc(
                        doc, {"index": index, "id": doc_id}, sub_qs
                    )
                    if status >= 400:
                        errors = True
                        items.append(
                            {
                                "update": {
                                    "_index": index,
                                    "_id": doc_id,
                                    "status": status,
                                    "error": resp.get("error", resp),
                                }
                            }
                        )
                    else:
                        items.append({"update": {**resp, "status": status}})
                else:
                    if doc_id is None:
                        doc_id = _auto_id()
                    op = "create" if action == "create" else "index"
                    source = self.cluster.apply_ingest(
                        index, idx, doc or {}, doc_id,
                        pipeline=meta.get(
                            "pipeline", qs.get("pipeline", [None])[0]
                        ),
                    )
                    if source is None:  # dropped by the pipeline
                        items.append(
                            {action: {"_index": index, "_id": doc_id,
                                      "result": "noop", "status": 200}}
                        )
                        continue
                    r = idx.index_doc(doc_id, source, op_type=op, routing=routing)
                    items.append(
                        {
                            action: {
                                **self._doc_response(index, r, idx.num_shards),
                                "status": 201 if r.result == "created" else 200,
                            }
                        }
                    )
            except (VersionConflictError, ClusterError, QueryParseError) as e:
                errors = True
                if isinstance(e, VersionConflictError):
                    status, etype = 409, "version_conflict_engine_exception"
                elif isinstance(e, ClusterError):
                    status, etype = e.status, e.err_type
                else:
                    status, etype = 400, "parsing_exception"
                items.append(
                    {
                        action: {
                            "_index": index,
                            "_id": doc_id,
                            "status": status,
                            "error": {"type": etype, "reason": str(e)},
                        }
                    }
                )
        if refresh_policy in ("true", "wait_for"):
            for name in touched:
                try:
                    idx = self.cluster.get_index(name)
                except ClusterError:
                    continue
                if refresh_policy == "wait_for":
                    idx.wait_for_refresh()
                else:
                    idx.refresh()
        took = int((time.perf_counter() - t0) * 1000)
        return 200, {"took": took, "errors": errors, "items": items}


def _parse_q_param(q: str) -> dict:
    """?q= mini query_string: ``field:value`` or free text (match on the
    catch-all would need _all; we use multi_match over * fields via
    query_string subset — round 1: single field or match on 'body')."""
    if ":" in q:
        field, _, value = q.partition(":")
        return {"match": {field: value}}
    return {"multi_match": {"query": q, "fields": ["*"]}}
