"""Reindex / update-by-query / delete-by-query: scroll+bulk loops as
cancellable tasks.

Reference analogs: modules/reindex — Reindexer,
AbstractAsyncBulkByScrollAction (scroll batches + bulk writes +
BulkByScrollTask.Status progress), TransportUpdateByQueryAction,
TransportDeleteByQueryAction (SURVEY.md §2.3 reindex row). The loop is
a cooperative cancellation point per batch (CancellableTask).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from .cluster.service import ClusterError, ClusterService
from .index.engine import VersionConflictError
from .tasks import Task, TaskCancelledException

SCROLL_KEEPALIVE = "5m"
DEFAULT_BATCH = 1000


class _ByScroll:
    """Shared scroll-batch runner (AbstractAsyncBulkByScrollAction)."""

    def __init__(
        self,
        cluster: ClusterService,
        index: str,
        body: Optional[dict],
        task: Task,
        max_docs: Optional[int] = None,
        conflicts_proceed: bool = False,
        batch_size: Optional[int] = None,
    ):
        self.cluster = cluster
        self.index = index
        self.query = (body or {}).get("query") or {"match_all": {}}
        # NOTE: reindex passes `source` as body, where `size` IS the
        # scroll batch size; update/delete_by_query pass batch_size
        # explicitly because their body `size` means max_docs
        self.batch_size = (
            batch_size
            if batch_size is not None
            else int((body or {}).get("size") or 0) or DEFAULT_BATCH
        )
        self.max_docs = max_docs
        self.task = task
        self.conflicts_proceed = conflicts_proceed
        self.counters = {
            "total": 0,
            "updated": 0,
            "created": 0,
            "deleted": 0,
            "batches": 0,
            "version_conflicts": 0,
            "noops": 0,
        }
        self.failures: List[dict] = []

    def run(self, process_hit) -> dict:
        t0 = time.perf_counter()
        resp = self.cluster.create_scroll(
            self.index,
            {"query": self.query, "size": self.batch_size},
            SCROLL_KEEPALIVE,
        )
        scroll_id = resp["_scroll_id"]
        self.counters["total"] = int(resp["hits"]["total"]["value"])
        if self.max_docs is not None:
            self.counters["total"] = min(self.counters["total"], self.max_docs)
        done = 0
        try:
            while True:
                hits = resp["hits"]["hits"]
                if not hits:
                    break
                self.counters["batches"] += 1
                for h in hits:
                    self.task.check_cancelled()
                    if self.max_docs is not None and done >= self.max_docs:
                        return self._response(t0)
                    try:
                        process_hit(h)
                    except VersionConflictError as e:
                        self.counters["version_conflicts"] += 1
                        if not self.conflicts_proceed:
                            self.failures.append(
                                {"id": h["_id"], "cause": str(e), "status": 409}
                            )
                            return self._response(t0)
                    done += 1
                    self.task.status.update(self.counters)
                self.task.check_cancelled()
                resp = self.cluster.continue_scroll(scroll_id, SCROLL_KEEPALIVE)
        finally:
            try:
                self.cluster.delete_scrolls([scroll_id])
            except ClusterError:
                pass
        return self._response(t0)

    def _response(self, t0: float) -> dict:
        return {
            "took": int((time.perf_counter() - t0) * 1000),
            "timed_out": False,
            **self.counters,
            "retries": {"bulk": 0, "search": 0},
            "throttled_millis": 0,
            "requests_per_second": -1.0,
            "throttled_until_millis": 0,
            "failures": self.failures,
        }


def _run_script_ctx(script: Any, source: dict, doc_id: str, op: str) -> tuple:
    """ctx._source / ctx._id / ctx.op script contract (UpdateByQuery /
    Reindex script context)."""
    from .script import ScriptError, script_service

    ctx = {"_source": dict(source), "_id": doc_id, "op": op}
    try:
        script_service.run_ingest(script, ctx)
    except ScriptError as e:
        raise ClusterError(400, str(e), "script_exception")
    return ctx.get("_source", source), ctx.get("op", op)


def reindex(cluster: ClusterService, body: dict, task: Task) -> dict:
    body = body or {}
    source = body.get("source") or {}
    dest = body.get("dest") or {}
    src_index = source.get("index")
    dest_index = dest.get("index")
    if not src_index or not dest_index:
        raise ClusterError(
            400,
            "[source.index] and [dest.index] are required",
            "action_request_validation_exception",
        )
    src_indices = src_index if isinstance(src_index, list) else [src_index]
    op_type = dest.get("op_type", "index")
    pipeline = dest.get("pipeline")
    script = body.get("script")
    conflicts_proceed = body.get("conflicts") == "proceed"
    max_docs = body.get("max_docs")
    dest_idx = cluster.get_or_autocreate(dest_index)

    merged: Optional[dict] = None
    remaining = max_docs
    for one_index in src_indices:
        runner = _ByScroll(
            cluster, one_index, source, task,
            max_docs=remaining, conflicts_proceed=conflicts_proceed,
        )

        def process(h: dict):
            src = dict(h.get("_source") or {})
            doc_id = h["_id"]
            op = "index"
            if script is not None:
                src, op = _run_script_ctx(script, src, doc_id, op)
                if op == "noop":
                    runner.counters["noops"] += 1
                    return
                if op == "delete":
                    r = dest_idx.delete_doc(doc_id)
                    if r.result == "deleted":
                        runner.counters["deleted"] += 1
                    return
            out = cluster.apply_ingest(
                dest_index, dest_idx, src, doc_id, pipeline=pipeline
            )
            if out is None:
                runner.counters["noops"] += 1
                return
            r = dest_idx.index_doc(doc_id, out, op_type=op_type)
            runner.counters[
                "created" if r.result == "created" else "updated"
            ] += 1

        resp = runner.run(process)
        if merged is None:
            merged = resp
        else:
            for k in (
                "total", "updated", "created", "deleted", "batches",
                "version_conflicts", "noops",
            ):
                merged[k] += resp[k]
            merged["took"] += resp["took"]
            merged["failures"].extend(resp["failures"])
        if remaining is not None:
            done = resp["created"] + resp["updated"] + resp["deleted"] + resp["noops"]
            remaining = max(0, remaining - done)
            if remaining == 0:
                break
        if resp["failures"]:
            break
    dest_idx.refresh()
    assert merged is not None  # src_indices validated non-empty above
    return merged


def update_by_query(
    cluster: ClusterService, index: str, body: Optional[dict], task: Task
) -> dict:
    body = body or {}
    script = body.get("script")
    conflicts_proceed = body.get("conflicts") == "proceed"
    idx = cluster.get_index(index)
    # body `size` is the legacy max_docs alias here (not batch size)
    max_docs = body.get("max_docs", body.get("size"))
    runner = _ByScroll(
        cluster, index, body, task,
        max_docs=max_docs, conflicts_proceed=conflicts_proceed,
        batch_size=DEFAULT_BATCH,
    )

    def process(h: dict):
        doc_id = h["_id"]
        # re-read through the primary for the doc's CURRENT source and
        # seq_no, then write with a seq_no CAS: a concurrent write
        # between the read and the reindex raises VersionConflictError
        # (counted into version_conflicts / honored per conflicts=
        # proceed by the runner) instead of being silently lost
        cur = idx.get_doc(doc_id)
        if cur is None:
            raise VersionConflictError(
                f"[{doc_id}]: version conflict, document deleted"
            )
        src = dict(cur["_source"] or {})
        cas = {
            "if_seq_no": cur["_seq_no"],
            "if_primary_term": cur["_primary_term"],
        }
        op = "index"
        if script is not None:
            src, op = _run_script_ctx(script, src, doc_id, op)
        if op == "noop":
            runner.counters["noops"] += 1
            return
        if op == "delete":
            r = idx.delete_doc(doc_id, **cas)
            if r.result == "deleted":
                runner.counters["deleted"] += 1
            return
        idx.index_doc(doc_id, src, **cas)
        runner.counters["updated"] += 1

    resp = runner.run(process)
    idx.refresh()
    return resp


def delete_by_query(
    cluster: ClusterService, index: str, body: Optional[dict], task: Task
) -> dict:
    if not (body or {}).get("query"):
        raise ClusterError(
            400,
            "query is missing",
            "action_request_validation_exception",
        )
    idx = cluster.get_index(index)
    runner = _ByScroll(
        cluster, index, body, task,
        max_docs=(body or {}).get("max_docs", (body or {}).get("size")),
        conflicts_proceed=(body or {}).get("conflicts") == "proceed",
        batch_size=DEFAULT_BATCH,
    )

    def process(h: dict):
        r = idx.delete_doc(h["_id"])
        if r.result == "deleted":
            runner.counters["deleted"] += 1

    resp = runner.run(process)
    idx.refresh()
    return resp
