"""REST routing: method + path-pattern dispatch table.

Reference analog: org.elasticsearch.rest.RestController — handlers
register (method, path-with-{params}) pairs (`RestController.registerHandler`,
each `BaseRestHandler.routes()`), the trie dispatches and extracts path
params, and errors render as the standard ES error envelope
(`ElasticsearchException.generateFailureXContent`).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

Handler = Callable[..., Tuple[int, Any]]  # (status, body-json)


class Route:
    def __init__(self, method: str, pattern: str, handler: Handler):
        self.method = method
        self.pattern = pattern
        self.handler = handler
        parts = pattern.strip("/").split("/")
        regex = []
        self.params: List[str] = []
        for p in parts:
            if p.startswith("{") and p.endswith("}"):
                name = p[1:-1]
                self.params.append(name)
                regex.append(r"([^/]+)")
            else:
                regex.append(re.escape(p))
        self._re = re.compile("^/" + "/".join(regex) + "/?$")

    def match(self, path: str) -> Optional[Dict[str, str]]:
        m = self._re.match(path)
        if m is None:
            return None
        return dict(zip(self.params, m.groups()))


class Router:
    def __init__(self):
        self._routes: List[Route] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        self._routes.append(Route(method, pattern, handler))

    def dispatch(
        self, method: str, path: str
    ) -> Tuple[Optional[Route], Optional[Dict[str, str]], bool]:
        """Returns (route, path_params, path_exists_for_other_method)."""
        path_seen = False
        for r in self._routes:
            params = r.match(path)
            if params is None:
                continue
            path_seen = True
            if r.method == method or (method == "HEAD" and r.method == "GET"):
                return r, params, True
        return None, None, path_seen


def error_body(status: int, err_type: str, reason: str) -> dict:
    return {
        "error": {
            "root_cause": [{"type": err_type, "reason": reason}],
            "type": err_type,
            "reason": reason,
        },
        "status": status,
    }
