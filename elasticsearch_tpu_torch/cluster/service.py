"""ClusterService: node-level index registry + persisted cluster state.

Reference analogs: org.elasticsearch.cluster.service (MasterService's
serialized state-update queue + ClusterApplierService), IndicesService
(creates IndexService per metadata change), and GatewayMetaState /
PersistedClusterStateService (durable cluster metadata, SURVEY.md §5
"Checkpoint / resume"). Single-node in round 1: this process is the
master; state updates are applied under one lock and persisted as an
atomically-replaced JSON document, versioned like ClusterState.version.

PyTorch port: every index is created on the service's ``device``
("cuda" unless the caller passes another; no card → the constructor
raises). With a ``data_path`` the node keeps its cluster state and its
shards on disk and recovers them on the next start; every recovered or
restored index serves on the same device.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..analysis import AnalysisRegistry
from ..common import deep_merge
from ..common.settings import ClusterSettingsStore, SettingsError, validate_index_settings
from ..index.mapping import MappingParseError
from .indices import IndexService, _flatten_settings


class ClusterError(Exception):
    def __init__(self, status: int, reason: str, err_type: str = "illegal_argument_exception"):
        super().__init__(reason)
        self.status = status
        self.reason = reason
        self.err_type = err_type


class IndexNotFoundError(ClusterError):
    def __init__(self, name: str):
        super().__init__(404, f"no such index [{name}]", "index_not_found_exception")


class ClusterService:
    def __init__(
        self,
        data_path: Optional[str] = None,
        cluster_name: str = "elasticsearch-tpu",
        node_name: str = "node-0",
        device="cuda",
    ):
        import torch

        # every index of this node serves on this device; the CPU only
        # when the caller asks for it (no fallback)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ClusterService: device 'cuda' was asked for and no CUDA "
                "device is available (pass device='cpu' to run on the CPU)"
            )
        self.cluster_name = cluster_name
        self.node_name = node_name
        self.data_path = data_path
        self.version = 0
        self.indices: Dict[str, IndexService] = {}
        self.cluster_settings = ClusterSettingsStore()
        # alias → {index → {"filter": dict|None, "is_write_index": bool}}
        self.aliases: Dict[str, Dict[str, dict]] = {}
        # template name → {"index_patterns": [...], "template": {...}, "priority": N}
        self.templates: Dict[str, dict] = {}
        # repository name → {"type": "fs", "settings": {"location": ...}}
        self.repositories: Dict[str, dict] = {}
        from ..ingest import IngestService
        from ..tasks import TaskManager

        self.ingest = IngestService()
        self.tasks = TaskManager(node_name)
        self._scrolls: Dict[str, dict] = {}
        self._pits: Dict[str, dict] = {}
        self._lock = threading.RLock()
        self._started_at = time.time()
        # dynamic overload-protection knobs dispatch to the node-wide
        # admission controller (ClusterSettings.addSettingsUpdateConsumer)
        from ..search.admission import admission

        self.cluster_settings.add_consumer(
            "search.admission.enabled",
            lambda v: admission.configure(enabled=v),
        )
        self.cluster_settings.add_consumer(
            "search.admission.target_delay_ms",
            lambda v: admission.configure(target_delay_ms=v),
        )
        self.cluster_settings.add_consumer(
            "search.admission.max_queue",
            lambda v: admission.configure(max_queue=v),
        )
        self.cluster_settings.add_consumer(
            "search.admission.retry_budget.ratio",
            lambda v: admission.configure(retry_budget_ratio=v),
        )
        if data_path is not None:
            os.makedirs(data_path, exist_ok=True)
            self._recover()

    # ------------------------------------------------------------------
    # state persistence (PersistedClusterStateService analog)
    # ------------------------------------------------------------------

    def _state_path(self) -> str:
        assert self.data_path is not None
        return os.path.join(self.data_path, "cluster_state.json")

    def _persist(self) -> None:
        if self.data_path is None:
            return
        state = {
            "version": self.version,
            "cluster_name": self.cluster_name,
            "aliases": self.aliases,
            "templates": self.templates,
            "repositories": self.repositories,
            "pipelines": self.ingest.bodies(),
            "indices": {
                name: {
                    "settings": {k: v for k, v in idx.settings.items()},
                    "mappings": idx.mappings.to_json(),
                    "uuid": idx.uuid,
                    "creation_date": idx.creation_date,
                }
                for name, idx in self.indices.items()
            },
        }
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._state_path())

    def _recover(self) -> None:
        try:
            with open(self._state_path(), encoding="utf-8") as f:
                state = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return
        self.version = state.get("version", 0)
        self.aliases = state.get("aliases", {})
        self.templates = state.get("templates", {})
        self.repositories = state.get("repositories", {})
        self.ingest.load(state.get("pipelines", {}))
        for name, meta in state.get("indices", {}).items():
            path = self._index_path(name)
            # prefer the per-index _meta.json written at flush — it carries
            # dynamic-mapping updates newer than the cluster-state snapshot
            disk_meta = IndexService.load_meta(path) if path else None
            if disk_meta is not None:
                meta = disk_meta
            idx = IndexService(
                name,
                settings=meta.get("settings"),
                mappings_json=meta.get("mappings"),
                base_path=path,
                device=self.device,
            )
            idx.uuid = meta.get("uuid", idx.uuid)
            idx.creation_date = meta.get("creation_date", idx.creation_date)
            self.indices[name] = idx

    def _index_path(self, name: str) -> Optional[str]:
        if self.data_path is None:
            return None
        return os.path.join(self.data_path, "indices", name)

    # ------------------------------------------------------------------
    # index CRUD (MetadataCreateIndexService analogs)
    # ------------------------------------------------------------------

    def create_index(self, name: str, body: Optional[dict] = None) -> dict:
        with self._lock:
            _validate_index_name(name)
            if name in self.indices:
                raise ClusterError(
                    400,
                    f"index [{name}] already exists",
                    "resource_already_exists_exception",
                )
            if name in self.aliases:
                raise ClusterError(
                    400,
                    f"an alias with the same name as the index [{name}] "
                    "already exists",
                    "invalid_index_name_exception",
                )
            body = body or {}
            settings = body.get("settings") or {}
            mappings = body.get("mappings") or {}
            template = self._template_for(name)
            if template is not None:
                t = template.get("template", {})
                settings = deep_merge(t.get("settings") or {}, settings)
                mappings = deep_merge(t.get("mappings") or {}, mappings)
            try:
                idx = IndexService(
                    name,
                    settings=settings,
                    mappings_json=mappings,
                    base_path=self._index_path(name),
                    device=self.device,
                )
            except SettingsError as e:
                raise ClusterError(400, str(e), "illegal_argument_exception")
            except (MappingParseError, ValueError) as e:
                raise ClusterError(400, str(e), "mapper_parsing_exception")
            self.indices[name] = idx
            self.version += 1
            self._persist()
            idx._persist_meta()
            return {"acknowledged": True, "shards_acknowledged": True, "index": name}

    def delete_index(self, name: str) -> dict:
        with self._lock:
            idx = self.indices.pop(name, None)
            if idx is None:
                raise IndexNotFoundError(name)
            for alias in list(self.aliases):
                self.aliases[alias].pop(name, None)
                if not self.aliases[alias]:
                    self.aliases.pop(alias)
            idx.close()
            path = self._index_path(name)
            if path and os.path.isdir(path):
                import shutil

                shutil.rmtree(path, ignore_errors=True)
            self.version += 1
            self._persist()
            return {"acknowledged": True}

    def get_index(self, name: str) -> IndexService:
        idx = self.indices.get(name)
        if idx is None:
            raise IndexNotFoundError(name)
        return idx

    def get_or_autocreate(self, name: str) -> IndexService:
        """Auto-create on first document op (action.auto_create_index)."""
        with self._lock:
            idx = self.indices.get(name)
            if idx is None:
                if not self.cluster_settings.get("action.auto_create_index"):
                    raise IndexNotFoundError(name)
                self.create_index(name)
                idx = self.indices[name]
            return idx

    def put_mapping(self, name: str, body: dict) -> dict:
        with self._lock:
            idx = self.get_index(name)
            try:
                idx.mappings.merge(body)
            except MappingParseError as e:
                raise ClusterError(400, str(e), "illegal_argument_exception")
            self.version += 1
            self._persist()
            idx._persist_meta()  # keep _meta.json ≥ cluster-state freshness
            return {"acknowledged": True}

    def update_settings(self, name: str, body: dict) -> dict:
        with self._lock:
            idx = self.get_index(name)
            flat = _flatten_settings(body)
            try:
                validated = validate_index_settings(flat, creating=False)
            except SettingsError as e:
                raise ClusterError(400, str(e), "illegal_argument_exception")
            idx.settings.update(validated)
            idx.apply_translog_settings()
            idx.apply_refresh_settings()
            idx.apply_slowlog_settings()
            self.version += 1
            self._persist()
            idx._persist_meta()
            return {"acknowledged": True}

    def update_cluster_settings(self, body: dict) -> dict:
        try:
            return self.cluster_settings.update(body or {})
        except SettingsError as e:
            raise ClusterError(400, str(e), "illegal_argument_exception")

    # ------------------------------------------------------------------
    # cluster-level APIs
    # ------------------------------------------------------------------

    # ------------------------------------------------------------------
    # aliases (MetadataIndexAliasesService / TransportIndicesAliasesAction)
    # ------------------------------------------------------------------

    def update_aliases(self, body: dict) -> dict:
        with self._lock:
            actions = (body or {}).get("actions", [])
            for entry in actions:
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
                        self.get_index(index)  # must exist
                        for alias in names:
                            if alias in self.indices:
                                raise ClusterError(
                                    400,
                                    f"an index exists with the same name as the alias [{alias}]",
                                    "invalid_alias_name_exception",
                                )
                            self.aliases.setdefault(alias, {})[index] = {
                                "filter": spec.get("filter"),
                                "is_write_index": bool(
                                    spec.get("is_write_index", False)
                                ),
                            }
                elif op == "remove":
                    for index in indices:
                        for alias in names:
                            entry2 = self.aliases.get(alias)
                            if entry2 is None or index not in entry2:
                                if not spec.get("must_exist", True) is False:
                                    raise ClusterError(
                                        404,
                                        f"aliases [{alias}] missing",
                                        "aliases_not_found_exception",
                                    )
                            else:
                                entry2.pop(index, None)
                                if not entry2:
                                    self.aliases.pop(alias, None)
                elif op == "remove_index":
                    for index in indices:
                        self.delete_index(index)
                else:
                    raise ClusterError(
                        400,
                        f"unknown alias action [{op}]",
                        "illegal_argument_exception",
                    )
            self.version += 1
            self._persist()
            return {"acknowledged": True}

    def get_aliases(self, index: Optional[str] = None) -> dict:
        out: Dict[str, dict] = {}
        for alias, entries in self.aliases.items():
            for idx_name, spec in entries.items():
                if index is not None and idx_name != index:
                    continue
                meta: dict = {}
                if spec.get("filter") is not None:
                    meta["filter"] = spec["filter"]
                if spec.get("is_write_index"):
                    meta["is_write_index"] = True
                out.setdefault(idx_name, {"aliases": {}})["aliases"][alias] = meta
        if index is not None and index in self.indices and index not in out:
            out[index] = {"aliases": {}}
        return out

    # ------------------------------------------------------------------
    # index-expression resolution (IndexNameExpressionResolver)
    # ------------------------------------------------------------------

    def resolve(self, expression: str) -> List[Tuple[str, Optional[dict]]]:
        """'a,logs-*,myalias' → [(concrete index, alias filter or None)].

        Wildcards match index names and aliases; unknown concrete names
        raise index_not_found (like ignore_unavailable=false)."""
        import fnmatch

        # one entry per concrete index: an unfiltered route wins outright;
        # multiple filtered aliases OR their filters (AliasFilter semantics)
        resolved: Dict[str, Optional[dict]] = {}
        order: List[str] = []
        NO_FILTER = object()

        def add(name: str, filt: Optional[dict]):
            if name not in resolved:
                resolved[name] = NO_FILTER if filt is None else filt
                order.append(name)
                return
            cur = resolved[name]
            if cur is NO_FILTER or filt is None:
                resolved[name] = NO_FILTER
            elif json.dumps(cur, sort_keys=True) != json.dumps(filt, sort_keys=True):
                resolved[name] = {
                    "bool": {"should": [cur, filt], "minimum_should_match": 1}
                }

        for part in str(expression).split(","):
            part = part.strip()
            if not part:
                continue
            if part in ("_all", "*"):
                for name in sorted(self.indices):
                    add(name, None)
                continue
            if "*" in part or "?" in part:
                matched = False
                for name in sorted(self.indices):
                    if fnmatch.fnmatch(name, part):
                        add(name, None)
                        matched = True
                for alias in sorted(self.aliases):
                    if fnmatch.fnmatch(alias, part):
                        for idx_name, spec in self.aliases[alias].items():
                            add(idx_name, spec.get("filter"))
                        matched = True
                # non-matching wildcards resolve to nothing (ES default
                # allow_no_indices=true)
                continue
            if part in self.indices:
                add(part, None)
            elif part in self.aliases:
                for idx_name, spec in self.aliases[part].items():
                    add(idx_name, spec.get("filter"))
            else:
                raise IndexNotFoundError(part)
        return [
            (name, None if resolved[name] is NO_FILTER else resolved[name])
            for name in order
        ]

    def resolve_write_index(
        self, name: str, allow_auto_create: bool = True
    ) -> Tuple["IndexService", Optional[str]]:
        """Write target for a name: concrete index, or alias with a single
        index / an is_write_index (TransportBulkAction resolution)."""
        if name in self.indices:
            return self.indices[name], name
        entries = self.aliases.get(name)
        if entries:
            writes = [i for i, s in entries.items() if s.get("is_write_index")]
            if len(writes) == 1:
                return self.indices[writes[0]], writes[0]
            if len(entries) == 1:
                only = next(iter(entries))
                return self.indices[only], only
            raise ClusterError(
                400,
                f"no write index is defined for alias [{name}]. The write "
                "index may be explicitly disabled using is_write_index=false "
                "or the alias points to multiple indices without one being "
                "designated as a write index",
                "illegal_argument_exception",
            )
        if not allow_auto_create:
            raise IndexNotFoundError(name)
        idx = self.get_or_autocreate(name)
        return idx, name

    # ------------------------------------------------------------------
    # multi-index search (TransportSearchAction over resolved indices)
    # ------------------------------------------------------------------

    def _with_partial_default(self, body: dict) -> dict:
        """Applies the cluster-level request defaults the body didn't
        choose explicitly: search.default_allow_partial_results and
        search.default_search_timeout."""
        out = body
        if "allow_partial_search_results" not in out:
            default = self.cluster_settings.get(
                "search.default_allow_partial_results"
            )
            if default is not None and not bool(default):
                out = {**out, "allow_partial_search_results": False}
        if "timeout" not in out:
            dt = self.cluster_settings.get("search.default_search_timeout")
            if dt not in (None, "-1"):
                out = {**out, "timeout": dt}
        return out

    def search(
        self, expression: str, body: Optional[dict] = None, task=None
    ) -> dict:
        t0 = time.perf_counter()
        targets = self.resolve(expression)
        body = self._with_partial_default(body or {})
        if len(targets) == 1 and targets[0][1] is None:
            return self.get_index(targets[0][0]).search(body, task=task)
        if not targets:
            return _empty_search_response()
        # multi-index / filtered-alias coordinator: ONE admission grant
        # covers the whole request (the per-index search_internal calls
        # below sit behind this gate, not the per-index one)
        from ..search.admission import admission, apply_brownout
        from ..search.failures import deadline_from

        ticket = admission.acquire(
            expression, deadline=deadline_from(body)
        )
        try:
            body, brownout_actions = apply_brownout(body, ticket.tier)
            out = self._search_multi(targets, body, task)
            if ticket.tier > 0:
                out["_overload"] = {
                    "pressure_tier": ticket.tier,
                    "pressure_mode": ticket.mode,
                    "actions": brownout_actions,
                }
            return out
        finally:
            admission.release(ticket)

    def _search_multi(self, targets, body: dict, task=None) -> dict:
        t0 = time.perf_counter()
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        sub = {**body, "from": 0, "size": from_ + size}
        responses = []
        agg_nodes = None
        all_partials: List[dict] = []
        sort_specs = None
        if "sort" in body:
            from ..search.executor import parse_sort

            sort_specs = parse_sort(body["sort"])
        for name, filt in targets:
            idx = self.get_index(name)
            resp, nodes, partials = idx.search_internal(
                sub, extra_filter=filt, task=task
            )
            responses.append((name, resp))
            if nodes is not None:
                agg_nodes = nodes
                all_partials.extend(partials)
        # merge hits across indices
        entries = []
        total = 0
        max_score = None
        shards = {"total": 0, "successful": 0, "skipped": 0, "failed": 0}
        failures: List[dict] = []
        timed_out = False
        for pos, (name, resp) in enumerate(responses):
            rs = resp["_shards"]
            for k in ("total", "successful", "skipped", "failed"):
                shards[k] += int(rs.get(k, 0))
            failures.extend(rs.get("failures", []))
            timed_out = timed_out or bool(resp.get("timed_out"))
            ht = resp["hits"].get("total")
            if ht:
                total += ht["value"]
            ms = resp["hits"].get("max_score")
            if ms is not None:
                max_score = ms if max_score is None else max(max_score, ms)
            for hi, h in enumerate(resp["hits"]["hits"]):
                if sort_specs is not None:
                    from ..search.coordinator import _col_key

                    key = tuple(
                        _col_key(v, spec)
                        for v, spec in zip(h.get("sort", []), sort_specs)
                    )
                else:
                    score = h.get("_score")
                    key = (-(score if score is not None else 0.0),)
                entries.append((key, pos, hi, h))
        entries.sort(key=lambda e: e[:3])
        hits = [h for _, _, _, h in entries[from_ : from_ + size]]
        if failures:
            shards["failures"] = failures
        out = {
            # coordinator wall-clock, NOT the sum of per-index tooks —
            # the per-index searches ran from one coordinator thread but
            # their own tooks overlap fan-out waits
            "took": int((time.perf_counter() - t0) * 1000),
            "timed_out": timed_out,
            "_shards": shards,
            "hits": {
                "total": {"value": total, "relation": "eq"},
                "max_score": max_score,
                "hits": hits,
            },
        }
        if agg_nodes is not None:
            from ..search.aggs import reduce_aggs

            out["aggregations"] = reduce_aggs(agg_nodes, all_partials)
        return out

    def count(self, expression: str, body: Optional[dict] = None) -> dict:
        targets = self.resolve(expression)
        body = self._with_partial_default(body or {})
        total = 0
        shards = {"total": 0, "successful": 0, "skipped": 0, "failed": 0}
        failures: List[dict] = []
        for name, filt in targets:
            r = self.get_index(name).count(body, extra_filter=filt)
            total += r["count"]
            rs = r["_shards"]
            for k in ("total", "successful", "skipped", "failed"):
                shards[k] += int(rs.get(k, 0))
            failures.extend(rs.get("failures", []))
        if failures:
            shards["failures"] = failures
        return {"count": total, "_shards": shards}

    # ------------------------------------------------------------------
    # index templates (MetadataIndexTemplateService, composable v2 subset)
    # ------------------------------------------------------------------

    def put_template(self, name: str, body: dict) -> dict:
        with self._lock:
            body = body or {}
            patterns = body.get("index_patterns")
            if not patterns:
                raise ClusterError(
                    400,
                    "index template must have at least one index pattern",
                    "illegal_argument_exception",
                )
            self.templates[name] = {
                "index_patterns": patterns
                if isinstance(patterns, list)
                else [patterns],
                "template": body.get("template", {}),
                "priority": int(body.get("priority", 0)),
            }
            self.version += 1
            self._persist()
            return {"acknowledged": True}

    def get_templates(self, name: Optional[str] = None) -> dict:
        out = []
        for tname, t in sorted(self.templates.items()):
            if name is not None and tname != name:
                continue
            out.append({"name": tname, "index_template": t})
        if name is not None and not out:
            raise ClusterError(
                404,
                f"index template matching [{name}] not found",
                "resource_not_found_exception",
            )
        return {"index_templates": out}

    def delete_template(self, name: str) -> dict:
        with self._lock:
            if self.templates.pop(name, None) is None:
                raise ClusterError(
                    404,
                    f"index template matching [{name}] not found",
                    "resource_not_found_exception",
                )
            self.version += 1
            self._persist()
            return {"acknowledged": True}

    def _template_for(self, index_name: str) -> Optional[dict]:
        import fnmatch

        best = None
        for t in self.templates.values():
            if any(fnmatch.fnmatch(index_name, p) for p in t["index_patterns"]):
                if best is None or t["priority"] > best["priority"]:
                    best = t
        return best

    # ------------------------------------------------------------------
    # scroll + point-in-time contexts (ReaderContext registry analog:
    # SearchService.createAndPutReaderContext / freeReaderContext)
    # ------------------------------------------------------------------

    def create_scroll(self, index: str, body: dict, keep_alive: str) -> dict:
        import uuid as _uuid

        idx = self.get_index(index)
        body = dict(body or {})
        size = int(body.get("size", 10))
        body.pop("from", None)
        pinned = idx.pin_executors(keep_alive=_parse_keep_alive(keep_alive))
        resp = idx.search({**body, "from": 0, "size": size}, pinned_executors=pinned)
        scroll_id = _uuid.uuid4().hex
        with self._lock:
            self._scrolls[scroll_id] = {
                "index": index,
                "body": body,
                "offset": size,
                "size": size,
                "pinned": pinned,
                "expires": time.time() + _parse_keep_alive(keep_alive),
            }
        resp["_scroll_id"] = scroll_id
        return resp

    def continue_scroll(self, scroll_id: str, keep_alive: Optional[str]) -> dict:
        with self._lock:
            ctx = self._scrolls.get(scroll_id)
            if ctx is None or ctx["expires"] < time.time():
                self._scrolls.pop(scroll_id, None)
                raise ClusterError(
                    404,
                    "No search context found for id [" + scroll_id + "]",
                    "search_context_missing_exception",
                )
            if keep_alive:
                ctx["expires"] = time.time() + _parse_keep_alive(keep_alive)
            offset = ctx["offset"]
            ctx["offset"] += ctx["size"]
        idx = self.get_index(ctx["index"])
        resp = idx.search(
            {**ctx["body"], "from": offset, "size": ctx["size"]},
            pinned_executors=ctx["pinned"],
        )
        resp["_scroll_id"] = scroll_id
        return resp

    def delete_scrolls(self, ids) -> dict:
        freed = 0
        with self._lock:
            if ids == "_all":
                freed = len(self._scrolls)
                self._scrolls.clear()
            else:
                for sid in ids:
                    if self._scrolls.pop(sid, None) is not None:
                        freed += 1
        return {"succeeded": True, "num_freed": freed}

    def open_pit(self, index: str, keep_alive: str) -> dict:
        import uuid as _uuid

        idx = self.get_index(index)
        pit_id = _uuid.uuid4().hex
        with self._lock:
            self._pits[pit_id] = {
                "index": index,
                "pinned": idx.pin_executors(keep_alive=_parse_keep_alive(keep_alive)),
                "expires": time.time() + _parse_keep_alive(keep_alive),
            }
        return {"id": pit_id}

    def pit_search(self, body: dict) -> dict:
        pit = body.get("pit") or {}
        pit_id = pit.get("id")
        with self._lock:
            ctx = self._pits.get(pit_id)
            if ctx is None or ctx["expires"] < time.time():
                self._pits.pop(pit_id, None)
                raise ClusterError(
                    404,
                    f"No search context found for id [{pit_id}]",
                    "search_context_missing_exception",
                )
            if pit.get("keep_alive"):
                ctx["expires"] = time.time() + _parse_keep_alive(pit["keep_alive"])
        idx = self.get_index(ctx["index"])
        sub = {k: v for k, v in body.items() if k != "pit"}
        resp = idx.search(sub, pinned_executors=ctx["pinned"])
        resp["pit_id"] = pit_id
        return resp

    def close_pit(self, pit_id: str) -> dict:
        with self._lock:
            found = self._pits.pop(pit_id, None) is not None
        return {"succeeded": found, "num_freed": 1 if found else 0}

    # ------------------------------------------------------------------
    # ingest pipelines (IngestService registry behind the cluster state)
    # ------------------------------------------------------------------

    def put_pipeline(self, pid: str, body: dict) -> dict:
        from ..ingest import IngestError

        try:
            self.ingest.put_pipeline(pid, body or {})
        except IngestError as e:
            raise ClusterError(400, str(e), e.err_type)
        with self._lock:
            self.version += 1
            self._persist()
        return {"acknowledged": True}

    def get_pipeline(self, pid: Optional[str] = None) -> dict:
        from ..ingest import IngestError

        try:
            return self.ingest.get_pipeline(pid)
        except IngestError as e:
            raise ClusterError(404, str(e), e.err_type)

    def delete_pipeline(self, pid: str) -> dict:
        from ..ingest import IngestError

        try:
            self.ingest.delete_pipeline(pid)
        except IngestError as e:
            raise ClusterError(404, str(e), e.err_type)
        with self._lock:
            self.version += 1
            self._persist()
        return {"acknowledged": True}

    def simulate_pipeline(self, pid: Optional[str], body: dict) -> dict:
        from ..ingest import IngestError

        try:
            return self.ingest.simulate(pid, body or {})
        except IngestError as e:
            status = 404 if e.err_type == "resource_not_found_exception" else 400
            raise ClusterError(status, str(e), e.err_type)

    def apply_ingest(
        self,
        index_name: str,
        idx: IndexService,
        source: dict,
        doc_id: Optional[str],
        pipeline: Optional[str] = None,
    ) -> Optional[dict]:
        """Runs the request pipeline (?pipeline=) or the index's
        default_pipeline, then final_pipeline (IngestService
        .executeBulkRequest ordering). None = document dropped."""
        from ..ingest import IngestError

        pid = pipeline if pipeline is not None else idx.settings.get(
            "default_pipeline"
        )
        out: Optional[dict] = source
        for p in (pid, idx.settings.get("final_pipeline")):
            if not p or p == "_none" or out is None:
                continue
            try:
                out = self.ingest.execute(p, out, index_name, doc_id)
            except IngestError as e:
                raise ClusterError(400, str(e), e.err_type)
        return out

    # ------------------------------------------------------------------
    # snapshots (SnapshotsService / RepositoriesService)
    # ------------------------------------------------------------------

    def put_repository(self, name: str, body: dict) -> dict:
        body = body or {}
        rtype = body.get("type")
        if rtype != "fs":
            raise ClusterError(
                400,
                f"repository type [{rtype}] does not exist (only [fs] is "
                "supported)",
                "repository_exception",
            )
        location = (body.get("settings") or {}).get("location")
        if not location:
            raise ClusterError(
                400,
                "[fs] missing location",
                "repository_exception",
            )
        # verify: the location must be creatable+writable (the analog of
        # VerifyRepositoryAction's write-read roundtrip)
        try:
            os.makedirs(location, exist_ok=True)
            probe = os.path.join(location, ".verify")
            with open(probe, "w") as f:
                f.write("ok")
            os.remove(probe)
        except OSError as e:
            raise ClusterError(
                500,
                f"[{name}] cannot access repository location: {e}",
                "repository_verification_exception",
            )
        with self._lock:
            self.repositories[name] = {
                "type": "fs",
                "settings": {"location": location},
            }
            self.version += 1
            self._persist()
        return {"acknowledged": True}

    def get_repository(self, name: Optional[str] = None) -> dict:
        if name is None or name in ("_all", "*"):
            return dict(self.repositories)
        repo = self.repositories.get(name)
        if repo is None:
            raise ClusterError(
                404, f"[{name}] missing", "repository_missing_exception"
            )
        return {name: repo}

    def delete_repository(self, name: str) -> dict:
        with self._lock:
            if self.repositories.pop(name, None) is None:
                raise ClusterError(
                    404, f"[{name}] missing", "repository_missing_exception"
                )
            self.version += 1
            self._persist()
        return {"acknowledged": True}

    def _repo(self, name: str):
        from ..snapshots import FsRepository

        meta = self.repositories.get(name)
        if meta is None:
            raise ClusterError(
                404, f"[{name}] missing", "repository_missing_exception"
            )
        return FsRepository(name, meta["settings"]["location"])

    def _snapshot_indices(self, expression) -> List[str]:
        """Resolves a snapshot/restore indices expression (list or
        comma-string, wildcards) against existing indices."""
        import fnmatch

        if expression is None:
            expression = "_all"
        parts = (
            expression
            if isinstance(expression, list)
            else [p.strip() for p in str(expression).split(",") if p.strip()]
        )
        out: List[str] = []
        for part in parts:
            if part in ("_all", "*"):
                out.extend(self.indices.keys())
            elif "*" in part or "?" in part:
                out.extend(
                    n for n in self.indices if fnmatch.fnmatch(n, part)
                )
            elif part in self.indices:
                out.append(part)
            else:
                raise IndexNotFoundError(part)
        seen: Dict[str, None] = {}
        for n in out:
            seen.setdefault(n)
        return list(seen)

    def create_snapshot(self, repo: str, snap: str, body: Optional[dict] = None) -> dict:
        from ..snapshots import SnapshotError

        body = body or {}
        repository = self._repo(repo)
        names = self._snapshot_indices(body.get("indices"))
        payloads: Dict[str, dict] = {}
        for name in names:
            idx = self.indices[name]
            meta_settings = {k: v for k, v in idx.settings.items()}
            if idx.analysis_config:
                meta_settings["analysis"] = idx.analysis_config
            payloads[name] = {
                "settings": meta_settings,
                "mappings": idx.mappings.to_json(),
                "uuid": idx.uuid,
                "num_shards": idx.num_shards,
                "shards": idx.snapshot_shards(),
            }
        try:
            entry = repository.create(snap, payloads)
        except SnapshotError as e:
            raise ClusterError(e.status, e.reason, e.err_type)
        return {
            "snapshot": {
                "snapshot": snap,
                "uuid": entry["uuid"],
                "state": entry["state"],
                "indices": names,
                "shards": {
                    "total": sum(self.indices[n].num_shards for n in names),
                    "failed": 0,
                    "successful": sum(
                        self.indices[n].num_shards for n in names
                    ),
                },
            }
        }

    def get_snapshot(self, repo: str, snap: str) -> dict:
        from ..snapshots import SnapshotError

        repository = self._repo(repo)
        try:
            if snap in ("_all", "*"):
                entries = repository.list()
            else:
                entries = [repository.get(s) for s in snap.split(",")]
        except SnapshotError as e:
            raise ClusterError(e.status, e.reason, e.err_type)
        return {
            "snapshots": [
                {
                    "snapshot": e["snapshot"],
                    "uuid": e["uuid"],
                    "state": e["state"],
                    "indices": sorted(e["indices"].keys()),
                    "start_time_in_millis": e["start_time_in_millis"],
                    "end_time_in_millis": e["end_time_in_millis"],
                }
                for e in entries
            ]
        }

    def delete_snapshot(self, repo: str, snap: str) -> dict:
        from ..snapshots import SnapshotError

        repository = self._repo(repo)
        try:
            repository.delete(snap)
        except SnapshotError as e:
            raise ClusterError(e.status, e.reason, e.err_type)
        return {"acknowledged": True}

    def restore_snapshot(self, repo: str, snap: str, body: Optional[dict] = None) -> dict:
        """Restore = recovery from the repository (restoreShard): file
        snapshots are materialized into the index path and the engines
        recover from them, preserving versions and seqnos; doc-mode
        shards replay with their recorded version/seqno stamps."""
        import fnmatch
        import re as _re

        from ..snapshots import SnapshotError

        body = body or {}
        repository = self._repo(repo)
        try:
            entry = repository.get(snap)
        except SnapshotError as e:
            raise ClusterError(e.status, e.reason, e.err_type)
        expression = body.get("indices", "_all")
        parts = (
            expression
            if isinstance(expression, list)
            else [p.strip() for p in str(expression).split(",") if p.strip()]
        )
        chosen: List[str] = []
        for part in parts:
            if part in ("_all", "*"):
                chosen.extend(entry["indices"].keys())
            else:
                matched = [
                    n for n in entry["indices"] if fnmatch.fnmatch(n, part)
                ]
                if not matched:
                    raise IndexNotFoundError(part)
                chosen.extend(matched)
        pattern = body.get("rename_pattern")
        replacement = body.get("rename_replacement", "")
        restored: List[str] = []
        for source_name in dict.fromkeys(chosen):
            target = (
                _re.sub(pattern, replacement, source_name)
                if pattern
                else source_name
            )
            if target in self.indices:
                raise ClusterError(
                    400,
                    f"cannot restore index [{target}] because an open index "
                    "with same name already exists in the cluster",
                    "snapshot_restore_exception",
                )
            self._restore_index(repository, snap, entry, source_name, target)
            restored.append(target)
        return {
            "snapshot": {
                "snapshot": snap,
                "indices": restored,
                "shards": {
                    "total": sum(
                        entry["indices"][s]["num_shards"] for s in dict.fromkeys(chosen)
                    ),
                    "failed": 0,
                    "successful": sum(
                        entry["indices"][s]["num_shards"] for s in dict.fromkeys(chosen)
                    ),
                },
            }
        }

    def _restore_index(
        self, repository, snap: str, entry: dict, source_name: str, target: str
    ) -> None:
        imeta = entry["indices"][source_name]
        num_shards = int(imeta["num_shards"])
        index_path = self._index_path(target)
        file_restore = index_path is not None
        if file_restore:
            # phase 1: lay the committed shard files down BEFORE the
            # engines open — IndexService recovery then treats them
            # exactly like a local restart (restore-as-recovery-source)
            for sid in range(num_shards):
                files = repository.shard_files(snap, source_name, sid)
                if files is None:
                    continue
                shard_dir = os.path.join(index_path, str(sid))
                for rel, data in files.items():
                    full = os.path.join(shard_dir, rel)
                    os.makedirs(os.path.dirname(full), exist_ok=True)
                    with open(full, "wb") as f:
                        f.write(data)
        with self._lock:
            idx = IndexService(
                target,
                settings=imeta.get("settings"),
                mappings_json=imeta.get("mappings"),
                base_path=index_path,
                device=self.device,
            )
            self.indices[target] = idx
            self.version += 1
            self._persist()
        # doc-mode shards (or file snapshots restored into a diskless
        # node) replay with their recorded version/seqno stamps
        for sid in range(num_shards):
            docs = repository.shard_docs(snap, source_name, sid)
            if docs is None and index_path is None:
                files = repository.shard_files(snap, source_name, sid)
                if files is not None:
                    docs = _docs_from_snapshot_files(
                        files, imeta.get("mappings"), imeta.get("settings")
                    )
            if docs:
                eng = idx.local_shard(sid)
                for d in docs:
                    eng.index_replica(
                        d["id"], d["source"], d["version"], d["seq_no"]
                    )
                eng.refresh()

    def health(self, params: Optional[dict] = None) -> dict:
        """Cluster health with the wait semantics of
        TransportClusterHealthAction: `wait_for_status` blocks until the
        status is at least as good, `wait_for_no_relocating_shards`
        until no relocation is in flight; `timeout` (default 30s) bounds
        the wait and sets `timed_out` instead of raising."""
        params = params or {}
        wait_status = params.get("wait_for_status")
        wait_reloc = str(
            params.get("wait_for_no_relocating_shards", "")
        ).lower() in ("1", "true")
        snap = self._health_snapshot()
        if wait_status is None and not wait_reloc:
            return snap
        rank = {"green": 0, "yellow": 1, "red": 2}
        if wait_status is not None and wait_status not in rank:
            raise ClusterError(
                400,
                "request [/_cluster/health] contains unrecognized "
                f"wait_for_status: [{wait_status}]",
                "illegal_argument_exception",
            )
        from ..search.failures import parse_timeout

        try:
            timeout = parse_timeout(params.get("timeout", "30s"))
        except ValueError as e:
            raise ClusterError(400, str(e), "illegal_argument_exception")
        if timeout is None:
            timeout = 30.0
        deadline = time.monotonic() + timeout
        while True:
            ok = True
            if wait_status is not None and rank[snap["status"]] > rank[wait_status]:
                ok = False
            if wait_reloc and snap.get("relocating_shards", 0) > 0:
                ok = False
            if ok:
                return snap
            if time.monotonic() >= deadline:
                snap["timed_out"] = True
                return snap
            time.sleep(0.05)
            snap = self._health_snapshot()

    def reroute(self, body: Optional[dict] = None, dry_run: bool = False) -> dict:
        raise ClusterError(
            400,
            "cluster reroute requires a multi-node cluster (single-node "
            "mode has no routing table to move shards across)",
            "illegal_argument_exception",
        )

    def allocation_explain(self, body: Optional[dict] = None) -> dict:
        raise ClusterError(
            400,
            "unable to find any unassigned or relocating shards to "
            "explain (single-node mode has no routing table)",
            "illegal_argument_exception",
        )

    def _health_snapshot(self) -> dict:
        n_primaries = sum(i.num_shards for i in self.indices.values())
        n_replicas = sum(
            i.num_shards * int(i.settings.get("number_of_replicas", 1))
            for i in self.indices.values()
        )
        status = "yellow" if n_replicas > 0 else "green"
        if not self.indices:
            status = "green"
        return {
            "cluster_name": self.cluster_name,
            "status": status,
            "timed_out": False,
            "number_of_nodes": 1,
            "number_of_data_nodes": 1,
            "active_primary_shards": n_primaries,
            "active_shards": n_primaries,
            "relocating_shards": 0,
            "initializing_shards": 0,
            "unassigned_shards": n_replicas,
            "delayed_unassigned_shards": 0,
            "number_of_pending_tasks": 0,
            "number_of_in_flight_fetch": 0,
            "task_max_waiting_in_queue_millis": 0,
            "active_shards_percent_as_number": 100.0 if n_primaries else 100.0,
        }

    def flush_all(self) -> None:
        for idx in self.indices.values():
            idx.flush()

    def close(self) -> None:
        for idx in self.indices.values():
            idx.close()


def _docs_from_snapshot_files(
    files: Dict[str, bytes], mappings_json: Optional[dict], settings: Optional[dict]
) -> List[dict]:
    """Opens a file-mode shard snapshot in a scratch directory and dumps
    its live docs — the bridge from file snapshots to doc-replay
    restores (diskless nodes, distributed mode)."""
    import shutil
    import tempfile

    from ..analysis import AnalysisRegistry
    from ..index.engine import ShardEngine
    from ..index.mapping import Mappings
    from .indices import dump_engine_docs

    tmp = tempfile.mkdtemp(prefix="restore-shard-")
    try:
        for rel, data in files.items():
            full = os.path.join(tmp, rel)
            os.makedirs(os.path.dirname(full), exist_ok=True)
            with open(full, "wb") as f:
                f.write(data)
        analysis_cfg = (settings or {}).get("analysis")
        eng = ShardEngine(
            Mappings(mappings_json or {}),
            AnalysisRegistry(
                {"analysis": analysis_cfg} if analysis_cfg else None
            ),
            path=tmp,
            # it only dumps docs: a replayed tail builds on the host,
            # never on the card
            device_build=False,
            device="cpu",
        )
        docs = dump_engine_docs(eng)
        eng.close()
        return docs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _empty_search_response() -> dict:
    return {
        "took": 0,
        "timed_out": False,
        "_shards": {"total": 0, "successful": 0, "skipped": 0, "failed": 0},
        "hits": {
            "total": {"value": 0, "relation": "eq"},
            "max_score": None,
            "hits": [],
        },
    }


def _parse_keep_alive(value: str) -> float:
    """'1m' / '30s' / '500ms' → seconds (TimeValue subset)."""
    s = str(value)
    for suffix, mult in (("ms", 0.001), ("s", 1.0), ("m", 60.0), ("h", 3600.0), ("d", 86400.0)):
        if s.endswith(suffix) and s[: -len(suffix)].replace(".", "", 1).isdigit():
            return float(s[: -len(suffix)]) * mult
    raise ClusterError(
        400,
        f"failed to parse setting [keep_alive] with value [{value}]",
        "illegal_argument_exception",
    )


def _validate_index_name(name: str) -> None:
    if not name or name != name.lower() or name.startswith(("_", "-", "+")):
        raise ClusterError(
            400, f"invalid index name [{name}]", "invalid_index_name_exception"
        )
    for ch in ' "*\\<|,>/?':
        if ch in name:
            raise ClusterError(
                400,
                f"invalid index name [{name}], must not contain [{ch}]",
                "invalid_index_name_exception",
            )
