"""Pipeline + processor implementations.

Reference analogs, per processor: modules/ingest-common's
SetProcessor, RemoveProcessor, RenameProcessor, ConvertProcessor,
LowercaseProcessor/UppercaseProcessor/TrimProcessor (AbstractString
Processor), SplitProcessor, JoinProcessor, GsubProcessor,
AppendProcessor, DateProcessor, JsonProcessor, KeyValueProcessor,
DotExpanderProcessor, HtmlStripProcessor, FailProcessor, DropProcessor,
ScriptProcessor, PipelineProcessor. Common config (`if`, `tag`,
`ignore_failure`, `on_failure`) mirrors ConfigurationUtils +
CompoundProcessor semantics: a failing processor runs its on_failure
chain (with error metadata bound) or aborts the document.
"""

from __future__ import annotations

import datetime as _dt
import json
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class IngestError(Exception):
    def __init__(self, reason: str, err_type: str = "illegal_argument_exception"):
        super().__init__(reason)
        self.reason = reason
        self.err_type = err_type


class DropDocument(Exception):
    """Raised by the drop processor: the doc is silently discarded."""


# ---------------------------------------------------------------------------
# dotted-path ctx access (IngestDocument.getFieldValue/setFieldValue)
# ---------------------------------------------------------------------------


def get_field(ctx: dict, path: str, default=None):
    node: Any = ctx
    for part in path.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return default
    return node


def has_field(ctx: dict, path: str) -> bool:
    sentinel = object()
    return get_field(ctx, path, sentinel) is not sentinel


def set_field(ctx: dict, path: str, value) -> None:
    parts = path.split(".")
    node = ctx
    for part in parts[:-1]:
        nxt = node.get(part)
        if not isinstance(nxt, dict):
            nxt = {}
            node[part] = nxt
        node = nxt
    node[parts[-1]] = value


def remove_field(ctx: dict, path: str) -> bool:
    parts = path.split(".")
    node = ctx
    for part in parts[:-1]:
        node = node.get(part) if isinstance(node, dict) else None
        if node is None:
            return False
    if isinstance(node, dict) and parts[-1] in node:
        del node[parts[-1]]
        return True
    return False


_TEMPLATE_RE = re.compile(r"\{\{\{?\s*([\w.@_]+)\s*\}?\}\}")


def render_template(value, ctx: dict):
    """Mustache-lite `{{field}}` substitution (ingest template snippets)."""
    if not isinstance(value, str) or "{{" not in value:
        return value
    def sub(m):
        v = get_field(ctx, m.group(1))
        return "" if v is None else str(v)
    return _TEMPLATE_RE.sub(sub, value)


# ---------------------------------------------------------------------------
# processors
# ---------------------------------------------------------------------------


class Processor:
    TYPE = "?"

    def __init__(self, cfg: dict):
        self.tag = cfg.get("tag")
        self.if_cond = cfg.get("if")
        self.ignore_failure = bool(cfg.get("ignore_failure", False))
        self.on_failure = [
            build_processor(p) for p in (cfg.get("on_failure") or [])
        ]
        self.description = cfg.get("description")

    def _required(self, cfg: dict, key: str):
        if key not in cfg:
            raise IngestError(
                f"[{self.TYPE}] [{key}] required property is missing"
            )
        return cfg[key]

    def should_run(self, ctx: dict) -> bool:
        if self.if_cond is None:
            return True
        from ..script import script_service

        return script_service.run_condition(self.if_cond, ctx)

    def process(self, ctx: dict) -> None:
        raise NotImplementedError


class SetProcessor(Processor):
    TYPE = "set"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.field = self._required(cfg, "field")
        if "value" not in cfg and "copy_from" not in cfg:
            raise IngestError("[set] [value] required property is missing")
        self.value = cfg.get("value")
        self.copy_from = cfg.get("copy_from")
        self.override = bool(cfg.get("override", True))

    def process(self, ctx):
        if not self.override and has_field(ctx, self.field):
            return
        if self.copy_from is not None:
            if not has_field(ctx, self.copy_from):
                raise IngestError(f"field [{self.copy_from}] not present")
            value = get_field(ctx, self.copy_from)
        else:
            value = render_template(self.value, ctx)
        set_field(ctx, self.field, value)


class RemoveProcessor(Processor):
    TYPE = "remove"

    def __init__(self, cfg):
        super().__init__(cfg)
        field = self._required(cfg, "field")
        self.fields = field if isinstance(field, list) else [field]
        self.ignore_missing = bool(cfg.get("ignore_missing", False))

    def process(self, ctx):
        for f in self.fields:
            if not remove_field(ctx, f) and not self.ignore_missing:
                raise IngestError(f"field [{f}] not present as part of path [{f}]")


class RenameProcessor(Processor):
    TYPE = "rename"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.field = self._required(cfg, "field")
        self.target_field = self._required(cfg, "target_field")
        self.ignore_missing = bool(cfg.get("ignore_missing", False))

    def process(self, ctx):
        if not has_field(ctx, self.field):
            if self.ignore_missing:
                return
            raise IngestError(
                f"field [{self.field}] doesn't exist"
            )
        if has_field(ctx, self.target_field):
            raise IngestError(
                f"field [{self.target_field}] already exists"
            )
        set_field(ctx, self.target_field, get_field(ctx, self.field))
        remove_field(ctx, self.field)


class ConvertProcessor(Processor):
    TYPE = "convert"

    _CASTS: Dict[str, Callable] = {
        "integer": int,
        "long": int,
        "float": float,
        "double": float,
        "string": str,
        "boolean": lambda v: (
            v if isinstance(v, bool)
            else {"true": True, "false": False}[str(v).lower()]
        ),
    }

    def __init__(self, cfg):
        super().__init__(cfg)
        self.field = self._required(cfg, "field")
        self.type = self._required(cfg, "type")
        self.target_field = cfg.get("target_field", self.field)
        self.ignore_missing = bool(cfg.get("ignore_missing", False))
        if self.type not in (*self._CASTS, "auto"):
            raise IngestError(f"type [{self.type}] not supported")

    def _auto(self, v):
        s = str(v)
        for cast in (int, float):
            try:
                return cast(s)
            except ValueError:
                pass
        if s.lower() in ("true", "false"):
            return s.lower() == "true"
        return s

    def process(self, ctx):
        if not has_field(ctx, self.field):
            if self.ignore_missing:
                return
            raise IngestError(f"field [{self.field}] not present")
        v = get_field(ctx, self.field)
        cast = self._auto if self.type == "auto" else self._CASTS[self.type]
        try:
            out = [cast(x) for x in v] if isinstance(v, list) else cast(v)
        except (ValueError, KeyError, TypeError):
            raise IngestError(
                f"unable to convert [{v}] to {self.type}"
            )
        set_field(ctx, self.target_field, out)


class _StringProcessor(Processor):
    FN: Callable[[str], str] = staticmethod(lambda s: s)

    def __init__(self, cfg):
        super().__init__(cfg)
        self.field = self._required(cfg, "field")
        self.target_field = cfg.get("target_field", self.field)
        self.ignore_missing = bool(cfg.get("ignore_missing", False))

    def process(self, ctx):
        if not has_field(ctx, self.field):
            if self.ignore_missing:
                return
            raise IngestError(f"field [{self.field}] not present")
        v = get_field(ctx, self.field)
        fn = type(self).FN
        if isinstance(v, list):
            out = [fn(str(x)) for x in v]
        elif not isinstance(v, str):
            raise IngestError(
                f"field [{self.field}] of type "
                f"[{type(v).__name__}] cannot be cast to string"
            )
        else:
            out = fn(v)
        set_field(ctx, self.target_field, out)


class LowercaseProcessor(_StringProcessor):
    TYPE = "lowercase"
    FN = staticmethod(str.lower)


class UppercaseProcessor(_StringProcessor):
    TYPE = "uppercase"
    FN = staticmethod(str.upper)


class TrimProcessor(_StringProcessor):
    TYPE = "trim"
    FN = staticmethod(str.strip)


class HtmlStripProcessor(_StringProcessor):
    TYPE = "html_strip"
    FN = staticmethod(lambda s: re.sub(r"<[^>]*>", "", s))


class SplitProcessor(Processor):
    TYPE = "split"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.field = self._required(cfg, "field")
        self.separator = self._required(cfg, "separator")
        self.target_field = cfg.get("target_field", self.field)
        self.ignore_missing = bool(cfg.get("ignore_missing", False))
        self.preserve_trailing = bool(cfg.get("preserve_trailing", False))

    def process(self, ctx):
        if not has_field(ctx, self.field):
            if self.ignore_missing:
                return
            raise IngestError(f"field [{self.field}] not present")
        v = get_field(ctx, self.field)
        if not isinstance(v, str):
            raise IngestError(f"field [{self.field}] is not a string")
        parts = re.split(self.separator, v)
        if not self.preserve_trailing:
            while parts and parts[-1] == "":
                parts.pop()
        set_field(ctx, self.target_field, parts)


class JoinProcessor(Processor):
    TYPE = "join"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.field = self._required(cfg, "field")
        self.separator = self._required(cfg, "separator")
        self.target_field = cfg.get("target_field", self.field)

    def process(self, ctx):
        v = get_field(ctx, self.field)
        if not isinstance(v, list):
            raise IngestError(f"field [{self.field}] is not a list")
        set_field(ctx, self.target_field, self.separator.join(str(x) for x in v))


class GsubProcessor(Processor):
    TYPE = "gsub"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.field = self._required(cfg, "field")
        self.pattern = re.compile(self._required(cfg, "pattern"))
        self.replacement = self._required(cfg, "replacement")
        self.target_field = cfg.get("target_field", self.field)
        self.ignore_missing = bool(cfg.get("ignore_missing", False))

    def process(self, ctx):
        if not has_field(ctx, self.field):
            if self.ignore_missing:
                return
            raise IngestError(f"field [{self.field}] not present")
        v = get_field(ctx, self.field)
        if not isinstance(v, str):
            raise IngestError(f"field [{self.field}] is not a string")
        set_field(ctx, self.target_field, self.pattern.sub(self.replacement, v))


class AppendProcessor(Processor):
    TYPE = "append"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.field = self._required(cfg, "field")
        self.value = self._required(cfg, "value")
        self.allow_duplicates = bool(cfg.get("allow_duplicates", True))

    def process(self, ctx):
        add = self.value if isinstance(self.value, list) else [self.value]
        add = [render_template(v, ctx) for v in add]
        cur = get_field(ctx, self.field)
        if cur is None:
            cur = []
        elif not isinstance(cur, list):
            cur = [cur]
        else:
            cur = list(cur)
        for v in add:
            if self.allow_duplicates or v not in cur:
                cur.append(v)
        set_field(ctx, self.field, cur)


class DateProcessor(Processor):
    TYPE = "date"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.field = self._required(cfg, "field")
        self.formats = self._required(cfg, "formats")
        self.target_field = cfg.get("target_field", "@timestamp")
        self.output_format = cfg.get("output_format", "%Y-%m-%dT%H:%M:%S.%f")

    def _parse(self, v):
        for fmt in self.formats:
            if fmt == "ISO8601":
                try:
                    return _dt.datetime.fromisoformat(str(v).replace("Z", "+00:00"))
                except ValueError:
                    continue
            if fmt == "UNIX":
                try:
                    return _dt.datetime.fromtimestamp(float(v), _dt.timezone.utc)
                except (ValueError, TypeError):
                    continue
            if fmt == "UNIX_MS":
                try:
                    return _dt.datetime.fromtimestamp(
                        float(v) / 1000.0, _dt.timezone.utc
                    )
                except (ValueError, TypeError):
                    continue
            try:
                return _dt.datetime.strptime(str(v), fmt)
            except ValueError:
                continue
        raise IngestError(
            f"unable to parse date [{v}] using formats {self.formats}"
        )

    def process(self, ctx):
        v = get_field(ctx, self.field)
        if v is None:
            raise IngestError(f"field [{self.field}] not present")
        dt = self._parse(v)
        set_field(
            ctx, self.target_field, dt.strftime(self.output_format)[:-3]
            if self.output_format.endswith("%f")
            else dt.strftime(self.output_format),
        )


class JsonProcessor(Processor):
    TYPE = "json"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.field = self._required(cfg, "field")
        self.target_field = cfg.get("target_field")
        self.add_to_root = bool(cfg.get("add_to_root", False))

    def process(self, ctx):
        v = get_field(ctx, self.field)
        try:
            parsed = json.loads(v)
        except (TypeError, json.JSONDecodeError) as e:
            raise IngestError(f"field [{self.field}] is not valid JSON: {e}")
        if self.add_to_root:
            if not isinstance(parsed, dict):
                raise IngestError("cannot add non-object JSON to root")
            ctx.update(parsed)
        else:
            set_field(ctx, self.target_field or self.field, parsed)


class KvProcessor(Processor):
    TYPE = "kv"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.field = self._required(cfg, "field")
        self.field_split = self._required(cfg, "field_split")
        self.value_split = self._required(cfg, "value_split")
        self.target_field = cfg.get("target_field")
        self.ignore_missing = bool(cfg.get("ignore_missing", False))

    def process(self, ctx):
        if not has_field(ctx, self.field):
            if self.ignore_missing:
                return
            raise IngestError(f"field [{self.field}] not present")
        v = str(get_field(ctx, self.field))
        out = {}
        for pair in re.split(self.field_split, v):
            if not pair:
                continue
            kv = re.split(self.value_split, pair, maxsplit=1)
            if len(kv) == 2:
                out[kv[0]] = kv[1]
        if self.target_field:
            set_field(ctx, self.target_field, out)
        else:
            for k, val in out.items():
                set_field(ctx, k, val)


class DotExpanderProcessor(Processor):
    TYPE = "dot_expander"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.field = self._required(cfg, "field")

    def process(self, ctx):
        fields = (
            [k for k in list(ctx) if "." in k and not k.startswith("_")]
            if self.field == "*"
            else [self.field]
        )
        for f in fields:
            if f in ctx:
                v = ctx.pop(f)
                set_field(ctx, f, v)


class FailProcessor(Processor):
    TYPE = "fail"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.message = self._required(cfg, "message")

    def process(self, ctx):
        raise IngestError(render_template(self.message, ctx))


class DropProcessor(Processor):
    TYPE = "drop"

    def __init__(self, cfg):
        super().__init__(cfg)

    def process(self, ctx):
        raise DropDocument()


class ScriptProcessor(Processor):
    TYPE = "script"

    def __init__(self, cfg):
        super().__init__(cfg)
        if "source" in cfg or "id" in cfg:
            self.script = {
                k: cfg[k] for k in ("source", "id", "params") if k in cfg
            }
        else:
            self.script = self._required(cfg, "script")

    def process(self, ctx):
        from ..script import ScriptError, script_service

        try:
            script_service.run_ingest(self.script, ctx)
        except ScriptError as e:
            raise IngestError(str(e), "script_exception")


class PipelineProcessor(Processor):
    TYPE = "pipeline"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.name = self._required(cfg, "name")
        self.ignore_missing_pipeline = bool(
            cfg.get("ignore_missing_pipeline", False)
        )
        self._service: Optional["IngestService"] = None  # bound at exec

    def process(self, ctx):
        if self._service is None:
            raise IngestError("pipeline processor not bound to a service")
        pipeline = self._service.pipelines.get(self.name)
        if pipeline is None:
            if self.ignore_missing_pipeline:
                return
            raise IngestError(f"pipeline [{self.name}] does not exist")
        if pipeline.run(ctx, self._service) is None:
            # a drop inside the nested pipeline drops the outer doc too
            raise DropDocument()


PROCESSOR_TYPES: Dict[str, type] = {
    cls.TYPE: cls
    for cls in (
        SetProcessor, RemoveProcessor, RenameProcessor, ConvertProcessor,
        LowercaseProcessor, UppercaseProcessor, TrimProcessor,
        HtmlStripProcessor, SplitProcessor, JoinProcessor, GsubProcessor,
        AppendProcessor, DateProcessor, JsonProcessor, KvProcessor,
        DotExpanderProcessor, FailProcessor, DropProcessor,
        ScriptProcessor, PipelineProcessor,
    )
}


def build_processor(spec: dict) -> Processor:
    if not isinstance(spec, dict) or len(spec) != 1:
        raise IngestError(
            "processor definition must be a single-key object"
        )
    ptype, cfg = next(iter(spec.items()))
    cls = PROCESSOR_TYPES.get(ptype)
    if cls is None:
        raise IngestError(
            f"No processor type exists with name [{ptype}]",
            "parse_exception",
        )
    return cls(cfg if isinstance(cfg, dict) else {})


# ---------------------------------------------------------------------------
# pipeline + service
# ---------------------------------------------------------------------------


class Pipeline:
    def __init__(self, pid: str, body: dict):
        self.id = pid
        self.description = (body or {}).get("description")
        self.processors = [
            build_processor(p) for p in (body or {}).get("processors", [])
        ]
        self.on_failure = [
            build_processor(p) for p in (body or {}).get("on_failure", [])
        ]
        self.body = body or {}

    def run(self, ctx: dict, service: "IngestService") -> Optional[dict]:
        """Runs the chain on ctx in place; returns None if dropped.
        CompoundProcessor semantics: a processor failure runs its
        on_failure chain (with error metadata), else the pipeline's,
        else propagates."""
        try:
            for proc in self.processors:
                self._run_one(proc, ctx, service)
        except DropDocument:
            return None
        except IngestError:
            if not self.on_failure:
                raise
            try:
                for proc in self.on_failure:
                    self._run_one(proc, ctx, service)
            except DropDocument:
                return None
        return ctx

    def _run_one(self, proc: Processor, ctx: dict, service: "IngestService"):
        if isinstance(proc, PipelineProcessor):
            proc._service = service
        try:
            if not proc.should_run(ctx):
                return
            proc.process(ctx)
        except DropDocument:
            raise
        except IngestError as e:
            if proc.ignore_failure:
                return
            if proc.on_failure:
                ctx.setdefault("_ingest", {})["on_failure_message"] = str(e)
                ctx["_ingest"]["on_failure_processor_type"] = proc.TYPE
                if proc.tag:
                    ctx["_ingest"]["on_failure_processor_tag"] = proc.tag
                for handler in proc.on_failure:
                    self._run_one(handler, ctx, service)
                return
            raise


class IngestService:
    """Pipeline registry + bulk execution hook."""

    def __init__(self):
        self.pipelines: Dict[str, Pipeline] = {}
        self._lock = threading.Lock()
        self.stats = {"count": 0, "failed": 0}

    def put_pipeline(self, pid: str, body: dict) -> None:
        pipeline = Pipeline(pid, body)  # parse/validate first
        with self._lock:
            self.pipelines[pid] = pipeline

    def get_pipeline(self, pid: Optional[str] = None) -> Dict[str, dict]:
        if pid is None or pid in ("*", "_all"):
            return {p: pl.body for p, pl in self.pipelines.items()}
        pl = self.pipelines.get(pid)
        if pl is None:
            raise IngestError(
                f"pipeline [{pid}] is missing", "resource_not_found_exception"
            )
        return {pid: pl.body}

    def delete_pipeline(self, pid: str) -> None:
        with self._lock:
            if self.pipelines.pop(pid, None) is None:
                raise IngestError(
                    f"pipeline [{pid}] is missing",
                    "resource_not_found_exception",
                )

    def load(self, bodies: Dict[str, dict]) -> None:
        """Replaces the registry from persisted/published state."""
        with self._lock:
            self.pipelines = {
                pid: Pipeline(pid, body) for pid, body in bodies.items()
            }

    def bodies(self) -> Dict[str, dict]:
        return {pid: pl.body for pid, pl in self.pipelines.items()}

    def execute(
        self, pid: str, source: dict, index: str, doc_id: Optional[str]
    ) -> Optional[dict]:
        """Runs one document through a pipeline. Returns the transformed
        source, or None if dropped. Metadata fields ride the ctx and are
        stripped back out (IngestDocument's metadata handling)."""
        pl = self.pipelines.get(pid)
        if pl is None:
            raise IngestError(
                f"pipeline with id [{pid}] does not exist",
                "illegal_argument_exception",
            )
        ctx = dict(source)
        ctx["_index"] = index
        if doc_id is not None:
            ctx["_id"] = doc_id
        ctx["_ingest"] = {
            "timestamp": _dt.datetime.now(_dt.timezone.utc).isoformat()
        }
        self.stats["count"] += 1
        try:
            out = pl.run(ctx, self)
        except IngestError:
            self.stats["failed"] += 1
            raise
        if out is None:
            return None
        out.pop("_index", None)
        out.pop("_id", None)
        out.pop("_ingest", None)
        return out

    def simulate(self, pid: Optional[str], body: dict) -> dict:
        """_ingest/pipeline/_simulate: run sample docs, report per-doc
        results or errors."""
        if pid is not None:
            pipeline = self.pipelines.get(pid)
            if pipeline is None:
                raise IngestError(
                    f"pipeline [{pid}] is missing",
                    "resource_not_found_exception",
                )
        else:
            pipeline = Pipeline("_simulate_pipeline", body.get("pipeline") or {})
        docs_out = []
        for doc in body.get("docs", []):
            src = dict(doc.get("_source") or {})
            ctx = dict(src)
            ctx["_index"] = doc.get("_index", "_index")
            ctx["_id"] = doc.get("_id", "_id")
            ctx["_ingest"] = {
                "timestamp": _dt.datetime.now(_dt.timezone.utc).isoformat()
            }
            try:
                out = pipeline.run(ctx, self)
                if out is None:
                    docs_out.append(None)
                    continue
                ts = out.pop("_ingest", {}).get("timestamp")
                meta = {
                    "_index": out.pop("_index", "_index"),
                    "_id": out.pop("_id", "_id"),
                    "_source": out,
                    "_ingest": {"timestamp": ts},
                }
                docs_out.append({"doc": meta})
            except IngestError as e:
                docs_out.append(
                    {"error": {"type": e.err_type, "reason": str(e)}}
                )
        return {"docs": docs_out}
