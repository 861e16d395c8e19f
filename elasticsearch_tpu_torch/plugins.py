"""Plugin SPI: extension points for queries, processors, analysis, REST.

Reference analogs (SURVEY.md §1 L9): org.elasticsearch.plugins —
SearchPlugin.getQueries, IngestPlugin.getProcessors,
AnalysisPlugin.getTokenFilters/getAnalyzers, ActionPlugin.getRestHandlers,
loaded by PluginsService during NodeConstruction. The TPU-native
framework loads plugins from Python classes (programmatically or via the
ES_TPU_PLUGINS env var, "module.path:ClassName" comma-separated) and
installs their registrations into the live registries.
"""

from __future__ import annotations

import importlib
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple


class Plugin:
    """Extension-point surface. Subclass and override any hook.

    Hook contracts:
      * get_query_parsers() → {query_name: parser(params) -> dsl.Query}
      * get_processors() → {processor_type: Processor subclass}
      * get_token_filters() → {filter_type: factory(cfg) -> TokenFilter}
      * get_analyzers() → {analyzer_name: Analyzer instance}
      * get_rest_handlers() → [(method, path_pattern, handler)] where
        handler(cluster, body, params, qs) -> (status, payload)
      * get_script_contexts() → {name: callable} merged into the script
        sandbox's global bindings
    """

    name: str = "plugin"

    def get_query_parsers(self) -> Dict[str, Callable]:
        return {}

    def get_processors(self) -> Dict[str, type]:
        return {}

    def get_token_filters(self) -> Dict[str, Callable]:
        return {}

    def get_analyzers(self) -> Dict[str, object]:
        return {}

    def get_rest_handlers(self) -> List[Tuple[str, str, Callable]]:
        return []

    def get_script_contexts(self) -> Dict[str, Callable]:
        return {}


class PluginsService:
    """Loads + installs plugins into the live registries
    (PluginsService + NodeConstruction's SPI consumption)."""

    def __init__(self):
        self.plugins: List[Plugin] = []
        self._lock = threading.Lock()
        # REST handlers registered by plugins. RestActions reads this at
        # CONSTRUCTION only — plugins must be installed before the REST
        # server starts (exactly the reference's constraint: PluginsService
        # loads during NodeConstruction, never after).
        self.rest_handlers: List[Tuple[str, str, Callable]] = []
        self._loaded_specs: set = set()

    def install(self, plugin: Plugin) -> None:
        with self._lock:
            # validate EVERYTHING before mutating any registry: a plugin
            # that fails halfway must not leave orphaned registrations
            self._validate(plugin)
            self._apply(plugin)
            self.plugins.append(plugin)
            self._loaded_specs.add(getattr(plugin, "_spec", plugin.name))

    def load_spec(self, spec: str) -> Optional[Plugin]:
        """Loads "module.path:ClassName" and installs it (idempotent:
        an already-loaded spec is skipped)."""
        if spec in self._loaded_specs:
            return None
        mod_name, _, cls_name = spec.partition(":")
        if not cls_name:
            raise ValueError(
                f"plugin spec [{spec}] must be module.path:ClassName"
            )
        mod = importlib.import_module(mod_name)
        cls = getattr(mod, cls_name)
        plugin = cls()
        if not isinstance(plugin, Plugin):
            raise TypeError(f"[{spec}] is not a Plugin subclass")
        plugin._spec = spec
        self.install(plugin)
        return plugin

    def load_env(self, env: str = "ES_TPU_PLUGINS") -> List[Plugin]:
        specs = [s.strip() for s in os.environ.get(env, "").split(",") if s.strip()]
        out = []
        for s in specs:
            p = self.load_spec(s)
            if p is not None:
                out.append(p)
        return out

    def _validate(self, plugin: Plugin) -> None:
        from .analysis.analyzer import AnalysisRegistry
        from .ingest.service import PROCESSOR_TYPES, Processor
        from .search import dsl

        for qname in plugin.get_query_parsers():
            if qname in dsl._PARSERS:
                raise ValueError(
                    f"plugin [{plugin.name}] redefines query [{qname}]"
                )
        for ptype, cls in plugin.get_processors().items():
            if not (isinstance(cls, type) and issubclass(cls, Processor)):
                raise TypeError(
                    f"processor [{ptype}] must subclass ingest Processor"
                )
            if ptype in PROCESSOR_TYPES:
                raise ValueError(
                    f"plugin [{plugin.name}] redefines processor [{ptype}]"
                )
        for fname in plugin.get_token_filters():
            if fname in AnalysisRegistry._FILTERS:
                raise ValueError(
                    f"plugin [{plugin.name}] redefines token filter [{fname}]"
                )
        for aname in plugin.get_analyzers():
            if aname in AnalysisRegistry.EXTRA_ANALYZERS:
                raise ValueError(
                    f"plugin [{plugin.name}] redefines analyzer [{aname}]"
                )

    def _apply(self, plugin: Plugin) -> None:
        """Registers everything; callers must have run _validate first."""
        from .analysis.analyzer import AnalysisRegistry
        from .ingest.service import PROCESSOR_TYPES
        from .search import dsl

        dsl._PARSERS.update(plugin.get_query_parsers())
        PROCESSOR_TYPES.update(plugin.get_processors())
        AnalysisRegistry._FILTERS.update(plugin.get_token_filters())
        AnalysisRegistry.EXTRA_ANALYZERS.update(plugin.get_analyzers())
        # REST handlers (consumed by RestActions at construction)
        self.rest_handlers.extend(plugin.get_rest_handlers())
        # script bindings
        if plugin.get_script_contexts():
            from .script import service as script_mod

            script_mod._SAFE_BUILTINS.update(plugin.get_script_contexts())

    def info(self) -> List[dict]:
        return [
            {
                "name": p.name,
                "queries": sorted(p.get_query_parsers()),
                "processors": sorted(p.get_processors()),
                "token_filters": sorted(p.get_token_filters()),
                "analyzers": sorted(p.get_analyzers()),
                "rest_handlers": [
                    f"{m} {path}" for m, path, _ in p.get_rest_handlers()
                ],
            }
            for p in self.plugins
        ]


# process-wide registry (the node's PluginsService)
plugins_service = PluginsService()
