"""Shared infrastructure (settings registry, small utilities).

Reference analog: org.elasticsearch.common.** leaf utilities.
"""

from typing import Any, Dict


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge, non-mutating; override wins on conflicts
    (XContentHelper.mergeDefaults inverted: used for template application
    and _update partial-doc merges)."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out
