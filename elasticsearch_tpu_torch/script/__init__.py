"""Scripting SPI: compile-cached safe expression engine.

Reference analogs: org.elasticsearch.script.ScriptService.compile +
ScriptContext (score/filter/ingest/field contexts) and the default
lang-painless module (SURVEY.md §2.1 Scripting row, §2.3 lang-painless).
"""

from .service import (
    ScriptContext,
    ScriptError,
    ScriptService,
    script_service,
)

__all__ = ["ScriptContext", "ScriptError", "ScriptService", "script_service"]
