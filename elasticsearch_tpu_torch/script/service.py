"""ScriptService: AST-whitelisted expression engine with compile cache.

Reference analogs: ScriptService.compile (per-context compilation,
LRU-cached, compile-rate limited), ScoreScript (score context with
doc-values access + `_score`), IngestScript (ctx-mutating statements),
and painless's allowlist-based API surface (PainlessLookup). SURVEY.md
§2.1 Scripting, §2.3 lang-painless.

TPU-native stance: scripts are a HOST-side escape hatch exactly as in
the reference (painless runs on the JVM, not in Lucene kernels). The
language is "painless-lite": Python expression/statement syntax hardened
by an AST whitelist (no imports, no dunders, no attribute access outside
an allowlist), with the painless standard bindings — `doc['f'].value`,
`params`, `_score`, `ctx` (ingest), `Math`, and the vector functions
(`cosineSimilarity`, `dotProduct`, `l1norm`, `l2norm`) the reference
uses for brute-force kNN (SURVEY.md §3.4 script_score path).
"""

from __future__ import annotations

import ast
import math
import threading
from typing import Any, Callable, Dict, Optional


class ScriptError(Exception):
    def __init__(self, reason: str, err_type: str = "script_exception"):
        super().__init__(reason)
        self.reason = reason
        self.err_type = err_type


class ScriptContext:
    SCORE = "score"
    FILTER = "filter"
    INGEST = "ingest"
    FIELD = "field"
    CONDITION = "condition"


_ALLOWED_NODES = (
    ast.Module, ast.Expr, ast.Expression, ast.Load, ast.Store,
    ast.Assign, ast.AugAssign, ast.If, ast.For, ast.While, ast.Break,
    ast.Continue, ast.Pass, ast.BoolOp, ast.BinOp, ast.UnaryOp,
    ast.IfExp, ast.Compare, ast.Call, ast.Constant, ast.Name,
    ast.Attribute, ast.Subscript, ast.Index, ast.Slice, ast.Tuple,
    ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
    ast.SetComp, ast.GeneratorExp, ast.comprehension, ast.keyword,
    ast.Starred, ast.JoinedStr, ast.FormattedValue,
    ast.And, ast.Or, ast.Not, ast.Add, ast.Sub, ast.Mult, ast.Div,
    ast.FloorDiv, ast.Mod, ast.Pow, ast.USub, ast.UAdd,
    ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.In,
    ast.NotIn, ast.Is, ast.IsNot, ast.Delete, ast.Return,
)

# attribute names scripts may touch (painless API allowlist analog);
# everything dunder is rejected outright
_ALLOWED_ATTRS = {
    # Math + common container/string methods
    "value", "values", "length", "size", "empty",
    "get", "keys", "items", "append", "remove", "pop", "update",
    "split", "join", "strip", "lower", "upper", "replace", "startswith",
    "endswith", "contains", "containsKey", "add", "put", "sort",
    # Math members
    "log", "log10", "log1p", "sqrt", "exp", "pow", "abs", "min", "max",
    "floor", "ceil", "round", "E", "PI",
}


class _Validator(ast.NodeVisitor):
    def generic_visit(self, node):
        if not isinstance(node, _ALLOWED_NODES):
            raise ScriptError(
                f"illegal construct [{type(node).__name__}] in script",
                "illegal_argument_exception",
            )
        super().generic_visit(node)

    def visit_Attribute(self, node):
        if node.attr.startswith("__"):
            raise ScriptError(
                f"forbidden attribute [{node.attr}]",
                "illegal_argument_exception",
            )
        # params.factor / Math.log / ctx.field: any non-dunder attribute
        # on the well-known root objects (their surface is controlled).
        # Writes are allowed on ctx only — assigning to Math/params would
        # poison the process-wide bindings for every later script.
        root = node.value.id if isinstance(node.value, ast.Name) else None
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            if root != "ctx":
                raise ScriptError(
                    f"cannot assign to attribute [{node.attr}]",
                    "illegal_argument_exception",
                )
        elif root not in (
            "params", "Math", "ctx", "MovingFunctions"
        ) and node.attr not in _ALLOWED_ATTRS:
            raise ScriptError(
                f"unknown or forbidden attribute [{node.attr}]",
                "illegal_argument_exception",
            )
        self.generic_visit(node)

    def visit_Name(self, node):
        if node.id.startswith("__"):
            raise ScriptError(
                f"forbidden name [{node.id}]", "illegal_argument_exception"
            )
        self.generic_visit(node)


class _Math:
    """painless's java.lang.Math surface."""

    E = math.e
    PI = math.pi
    log = staticmethod(math.log)
    log10 = staticmethod(math.log10)
    log1p = staticmethod(math.log1p)
    sqrt = staticmethod(math.sqrt)
    exp = staticmethod(math.exp)
    pow = staticmethod(pow)
    abs = staticmethod(abs)
    min = staticmethod(min)
    max = staticmethod(max)
    floor = staticmethod(math.floor)
    ceil = staticmethod(math.ceil)
    round = staticmethod(round)


class _DocValue:
    """`doc['field']` wrapper: .value / .values / .length / .empty /
    iteration, matching painless's ScriptDocValues."""

    __slots__ = ("_vals",)

    def __init__(self, vals):
        if vals is None:
            vals = []
        elif not isinstance(vals, list):
            vals = [vals]
        self._vals = vals

    @property
    def value(self):
        if not self._vals:
            raise ScriptError(
                "A document doesn't have a value for a field! Use "
                "doc[<field>].size()==0 to check if a document is missing "
                "a field!"
            )
        return self._vals[0]

    @property
    def values(self):
        return list(self._vals)

    @property
    def length(self):
        return len(self._vals)

    @property
    def empty(self):
        return not self._vals

    def size(self):
        return len(self._vals)

    def get(self, i):
        return self._vals[i]

    def __iter__(self):
        return iter(self._vals)

    def __len__(self):
        return len(self._vals)

    def __getitem__(self, i):
        return self._vals[i]


class _Params(dict):
    """params with painless-style attribute access (params.factor)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise ScriptError(f"missing script parameter [{name}]")


def _vector_fns(doc_lookup: Callable[[str], list]):
    """cosineSimilarity / dotProduct / l1norm / l2norm — the reference's
    brute-force kNN script functions (DenseVectorScriptDocValues)."""

    def _vec(field):
        v = doc_lookup(field)
        if not v:
            raise ScriptError(f"A document doesn't have a value for vector field [{field}]")
        return v

    def cosineSimilarity(query_vector, field):
        v = _vec(field)
        dot = sum(a * b for a, b in zip(query_vector, v))
        nq = math.sqrt(sum(a * a for a in query_vector))
        nv = math.sqrt(sum(a * a for a in v))
        if nq == 0 or nv == 0:
            return 0.0
        return dot / (nq * nv)

    def dotProduct(query_vector, field):
        return sum(a * b for a, b in zip(query_vector, _vec(field)))

    def l1norm(query_vector, field):
        return sum(abs(a - b) for a, b in zip(query_vector, _vec(field)))

    def l2norm(query_vector, field):
        return math.sqrt(sum((a - b) ** 2 for a, b in zip(query_vector, _vec(field))))

    return {
        "cosineSimilarity": cosineSimilarity,
        "dotProduct": dotProduct,
        "l1norm": l1norm,
        "l2norm": l2norm,
    }


# painless enforces loop/statement budgets (CompilerSettings
# MAX_LOOP_COUNTER); same idea here: statement loops get a tick check
# injected, and range() is capped so eval-mode comprehensions can't
# iterate unbounded either
MAX_LOOP_ITERATIONS = 1_000_000


def _capped_range(*args):
    r = range(*args)
    if len(r) > MAX_LOOP_ITERATIONS:
        raise ScriptError(
            f"range of {len(r)} exceeds the loop limit "
            f"[{MAX_LOOP_ITERATIONS}]"
        )
    return r


class _LoopTicker:
    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        if self.n > MAX_LOOP_ITERATIONS:
            raise ScriptError(
                f"script exceeded the loop limit [{MAX_LOOP_ITERATIONS}]"
            )


class _LoopLimiter(ast.NodeTransformer):
    """Prepends a `_loop_tick()` call to every loop body."""

    def _tick(self):
        return ast.Expr(
            value=ast.Call(
                func=ast.Name(id="_loop_tick", ctx=ast.Load()),
                args=[], keywords=[],
            )
        )

    def visit_For(self, node):
        self.generic_visit(node)
        node.body.insert(0, self._tick())
        return node

    def visit_While(self, node):
        self.generic_visit(node)
        node.body.insert(0, self._tick())
        return node


_SAFE_BUILTINS = {
    "abs": abs, "min": min, "max": max, "round": round, "len": len,
    "float": float, "int": int, "str": str, "bool": bool, "sum": sum,
    "sorted": sorted, "range": _capped_range, "enumerate": enumerate,
    "zip": zip,
    "list": list, "dict": dict, "set": set, "True": True, "False": False,
    "None": None, "null": None, "true": True, "false": False,
}


class CompiledScript:
    def __init__(self, source: str, mode: str):
        self.source = source
        self.mode = mode  # "eval" | "exec"
        tree = ast.parse(source, mode="eval" if mode == "eval" else "exec")
        _Validator().visit(tree)
        if mode == "exec":
            tree = ast.fix_missing_locations(_LoopLimiter().visit(tree))
        self.code = compile(tree, "<script>", mode)

    def run(self, bindings: Dict[str, Any]) -> Any:
        g = {
            "__builtins__": {},
            "Math": _Math,
            "_loop_tick": _LoopTicker(),
            **_SAFE_BUILTINS,
            **bindings,
        }
        try:
            if self.mode == "eval":
                return eval(self.code, g)  # noqa: S307 — AST-whitelisted
            exec(self.code, g)  # noqa: S102 — AST-whitelisted
            return g.get("ctx")
        except ScriptError:
            raise
        except Exception as e:
            raise ScriptError(f"runtime error in script: {e}")


class ScriptService:
    """Compile cache keyed by (source, context) with a max size
    (ScriptService's ScriptCache + compile-rate limiting, simplified to
    a bounded cache)."""

    def __init__(self, max_cache: int = 512):
        self._cache: Dict[tuple, CompiledScript] = {}
        self._lock = threading.Lock()
        self.max_cache = max_cache
        self.stats = {"compilations": 0, "cache_evictions": 0}

    def compile(self, script: Any, context: str) -> CompiledScript:
        source, _ = _script_source(script)
        mode = "exec" if context == ScriptContext.INGEST else "eval"
        key = (source, mode)
        with self._lock:
            cached = self._cache.get(key)
            if cached is not None:
                return cached
        compiled = CompiledScript(source, mode)
        with self._lock:
            if len(self._cache) >= self.max_cache:
                self._cache.pop(next(iter(self._cache)))
                self.stats["cache_evictions"] += 1
            self._cache[key] = compiled
            self.stats["compilations"] += 1
        return compiled

    # ---- context runners ----

    def run_score(
        self,
        script: Any,
        doc_lookup: Callable[[str], list],
        score: float = 0.0,
        extra: Optional[dict] = None,
    ) -> float:
        _, params = _script_source(script)
        compiled = self.compile(script, ScriptContext.SCORE)

        class _Doc:
            def __getitem__(self, field):
                return _DocValue(doc_lookup(field))

            def containsKey(self, field):
                return bool(doc_lookup(field))

        bindings = {
            "doc": _Doc(),
            "params": _Params(params),
            "_score": score,
            **_vector_fns(doc_lookup),
        }
        if extra:
            bindings.update(extra)
        out = compiled.run(bindings)
        try:
            return float(out)
        except (TypeError, ValueError):
            raise ScriptError(
                f"script returned a non-numeric score [{out!r}]"
            )

    def run_filter(
        self, script: Any, doc_lookup: Callable[[str], list]
    ) -> bool:
        return bool(self._run_bool(script, doc_lookup))

    def _run_bool(self, script, doc_lookup):
        _, params = _script_source(script)
        compiled = self.compile(script, ScriptContext.FILTER)

        class _Doc:
            def __getitem__(self, field):
                return _DocValue(doc_lookup(field))

            def containsKey(self, field):
                return bool(doc_lookup(field))

        return compiled.run(
            {"doc": _Doc(), "params": _Params(params), **_vector_fns(doc_lookup)}
        )

    def run_field(
        self, script: Any, doc_lookup: Callable[[str], list]
    ) -> Any:
        """script_fields context: raw value return."""
        return self._run_raw(script, doc_lookup)

    def _run_raw(self, script, doc_lookup):
        _, params = _script_source(script)
        compiled = self.compile(script, ScriptContext.FIELD)

        class _Doc:
            def __getitem__(self, field):
                return _DocValue(doc_lookup(field))

            def containsKey(self, field):
                return bool(doc_lookup(field))

        return compiled.run(
            {"doc": _Doc(), "params": _Params(params), **_vector_fns(doc_lookup)}
        )

    def run_ingest(self, script: Any, ctx: dict) -> dict:
        _, params = _script_source(script)
        compiled = self.compile(script, ScriptContext.INGEST)
        compiled.run({"ctx": ctx, "params": _Params(params)})
        return ctx

    def run_condition(self, script: Any, ctx: dict) -> bool:
        _, params = _script_source(script)
        compiled = self.compile(script, ScriptContext.CONDITION)
        return bool(compiled.run({"ctx": ctx, "params": _Params(params)}))


def _script_source(script: Any):
    """Accepts {"source": ..., "params": {...}}, {"id": ...} (rejected —
    no stored scripts yet), or a bare source string."""
    if isinstance(script, str):
        return script, {}
    if isinstance(script, dict):
        if "source" in script:
            return str(script["source"]), dict(script.get("params") or {})
        if "id" in script:
            raise ScriptError(
                "stored scripts are not supported", "illegal_argument_exception"
            )
    raise ScriptError(f"invalid script [{script!r}]", "illegal_argument_exception")


# process-wide default instance (the node's ScriptService singleton)
script_service = ScriptService()
