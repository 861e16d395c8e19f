"""HTTP server: stdlib threading server fronting RestActions.

Reference analog: org.elasticsearch.http.AbstractHttpServerTransport +
modules/transport-netty4 Netty4HttpServerTransport — here a
ThreadingHTTPServer (one thread per connection, the 'http_server_worker'
pool analog) because the compute path is device-bound, not socket-bound.
NDJSON endpoints (_bulk, _msearch) are split/parsed here, mirroring
RestBulkAction's line-by-line XContent parsing.

PyTorch port: the node serves on the card (`device="cuda"`, an argument
of `ElasticsearchTpuServer` and of `TpuNode`; tests pass "cpu"). With
``--node-name``/``--seeds`` the HTTP tier fronts a `TpuNode` on the
card. A request that reaches a path the port does not have yet gets a
501 whose reason names the slice that brings it.

Run: ``python -m elasticsearch_tpu_torch.rest.server --port 9200
[--data-path d] [--node-name n --transport-port p --seeds host:port,...]``
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote, urlparse

from ..cluster import ClusterError, ClusterService
from ..common.memory import CircuitBreakingException
from ..common import tracing
from ..common.tracing import OPAQUE_ID_CTX
from ..index.engine import EngineError, VersionConflictError
from ..index.mapping import MappingParseError
from ..search.admission import EsOverloadedError, admission, overload_body
from ..search.aggs import AggParseError
from ..search.batcher import EsRejectedExecutionError
from ..search.dsl import QueryParseError
from ..tasks import TaskCancelledException
from .actions import RestActions
from .router import error_body

NDJSON_PATHS = frozenset({"_bulk", "_msearch"})


class _HttpServer(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 resets connections
    # when more clients than that connect at once
    request_queue_size = 128


class ElasticHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "elasticsearch-tpu"
    actions: RestActions  # set on the server class

    # silence per-request stderr logging
    def log_message(self, fmt, *args):
        pass

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _respond(
        self, status: int, payload, head_only: bool = False,
        headers: Optional[dict] = None, trace=None,
    ) -> None:
        """Encodes and writes one response; with the request's `trace`,
        as its `http.encode` and `http.write` spans (the header block
        and the body are one socket write each)."""
        t0 = tracing.now_ns()
        if isinstance(payload, (dict, list)):
            data = json.dumps(payload).encode()
            ctype = "application/json"
        else:
            data = str(payload).encode()
            ctype = "text/plain; charset=UTF-8"
        t1 = tracing.now_ns()
        self.send_response(status)
        self.send_header("X-elastic-product", "Elasticsearch")
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        head = sum(len(b) for b in getattr(self, "_headers_buffer", ()))
        self.end_headers()
        if not head_only:
            self.wfile.write(data)
        if trace is not None:
            trace.add_span("http.encode", t0, t1, bytes=len(data))
            trace.add_span(
                "http.write", t1, tracing.now_ns(), writes=1 + (not head_only),
                bytes=head + (0 if head_only else len(data)),
            )

    def _handle(self, method: str) -> None:
        # a `_search` is traced from here, where its body read starts, to
        # its response's last byte written (the `http` span)
        t_read = tracing.now_ns()
        parsed = urlparse(self.path)
        path = parsed.path
        qs = parse_qs(parsed.query, keep_blank_values=True)
        raw = self._read_body()
        t_body = tracing.now_ns()
        head_only = method == "HEAD"
        route, params, path_exists = self.actions.router.dispatch(method, path)
        # percent-decode extracted path params AFTER routing so an
        # encoded %2F stays inside one path segment during dispatch but
        # the handler sees the client's literal id ("a%20b" → "a b") —
        # RestUtils.decodeComponent semantics
        if params:
            params = {k: unquote(v) for k, v in params.items()}
        if route is None:
            if path_exists:
                self._respond(
                    405,
                    error_body(
                        405,
                        "method_not_allowed_exception",
                        f"Incorrect HTTP method for uri [{self.path}] and "
                        f"method [{method}]",
                    ),
                    head_only,
                )
            else:
                self._respond(
                    400,
                    error_body(
                        400,
                        "illegal_argument_exception",
                        f"no handler found for uri [{path}] and method [{method}]",
                    ),
                    head_only,
                )
            return
        resp_headers: Optional[dict] = None
        # X-Opaque-Id rides a contextvar for the request's lifetime so
        # task descriptions, traces, and slow logs can stamp it
        opaque_tok = OPAQUE_ID_CTX.set(self.headers.get("X-Opaque-Id"))
        # only `_search` requests enter the trace ring
        handle = http_id = parent_tok = None
        if route.handler == self.actions.search:
            handle = tracing.begin("search")
        if handle is not None:
            tr = handle[0]
            tr.start_ns = t_read
            http_id = tr.reserve()
            tr.add_span("http.read", t_read, t_body, parent_id=http_id,
                        bytes=len(raw))
            parent_tok = tracing.set_parent(http_id)
        try:
            t0 = tracing.now_ns()
            body = self._parse_body(path, raw)
            if handle is not None:
                tr.add_span("http.decode", t0, tracing.now_ns())
            status, payload = route.handler(body, params or {}, qs)
        except ClusterError as e:
            status, payload = e.status, error_body(e.status, e.err_type, e.reason)
        except VersionConflictError as e:
            status, payload = 409, error_body(
                409, "version_conflict_engine_exception", str(e)
            )
        except (QueryParseError, MappingParseError, AggParseError) as e:
            status, payload = 400, error_body(400, "parsing_exception", str(e))
        except (
            EsOverloadedError, EsRejectedExecutionError,
            CircuitBreakingException,
        ) as e:
            # EVERY overload rejection — admission shed, bounded-queue
            # overflow (EsRejectedExecutionException contract), HBM
            # breaker — is a 429 with a computed Retry-After header and
            # the structured es.overloaded body block
            retry_after = getattr(e, "retry_after", None)
            if retry_after is None:
                retry_after = admission.retry_after_s()
            status, payload = 429, overload_body(e, retry_after)
            resp_headers = {"Retry-After": int(retry_after)}
        except TaskCancelledException as e:
            # a cancelled search surfaces as 400 task_cancelled_exception
            # (TransportSearchAction's cancellation contract)
            status, payload = 400, error_body(
                400, "task_cancelled_exception", str(e)
            )
        except EngineError as e:
            status, payload = 500, error_body(500, "engine_exception", str(e))
        except json.JSONDecodeError as e:
            status, payload = 400, error_body(
                400, "json_parse_exception", f"invalid JSON: {e}"
            )
        except Exception as e:  # the 500 of last resort
            status, payload = 500, error_body(500, "exception", repr(e))
        finally:
            OPAQUE_ID_CTX.reset(opaque_tok)
        if handle is None:
            self._respond(status, payload, head_only, headers=resp_headers)
            return
        try:
            self._respond(status, payload, head_only, headers=resp_headers,
                          trace=tr)
        finally:
            tracing.reset_parent(parent_tok)
            tr.add_span("http", t_read, tracing.now_ns(), parent_id=None,
                        span_id=http_id, method=method, status=status)
            tracing.end(handle)

    def _parse_body(self, path: str, raw: bytes):
        last = path.rstrip("/").rsplit("/", 1)[-1]
        if not raw:
            return [] if last in NDJSON_PATHS else None
        text = raw.decode("utf-8")
        if last == "_bulk":
            return [json.loads(l) for l in text.splitlines() if l.strip()]
        if last == "_msearch":
            lines = [json.loads(l) for l in text.splitlines() if l.strip()]
            pairs = []
            i = 0
            while i < len(lines):
                header = lines[i]
                if i + 1 < len(lines):
                    pairs.append((header, lines[i + 1]))
                    i += 2
                else:
                    pairs.append((header, {}))
                    i += 1
            return pairs
        return json.loads(text)

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_PUT(self):
        self._handle("PUT")

    def do_DELETE(self):
        self._handle("DELETE")

    def do_HEAD(self):
        # index/doc existence checks: HEAD maps onto the GET handler
        self._handle("HEAD")


class ElasticsearchTpuServer:
    """Owns the ClusterService + HTTP listener (Node.start analog)."""

    def __init__(
        self,
        port: int = 9200,
        host: str = "127.0.0.1",
        data_path: Optional[str] = None,
        cluster: Optional[ClusterService] = None,
        device="cuda",
    ):
        self.cluster = cluster or ClusterService(data_path=data_path, device=device)
        self.actions = RestActions(self.cluster)
        handler = type("BoundHandler", (ElasticHandler,), {"actions": self.actions})
        self.httpd = _HttpServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start_background(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.cluster.close()


def main(argv=None):
    # plugins install BEFORE any registry is consumed (NodeConstruction
    # ordering): ES_TPU_PLUGINS="module.path:ClassName,..."
    from ..plugins import plugins_service

    plugins_service.load_env()
    ap = argparse.ArgumentParser(description="elasticsearch-tpu node")
    ap.add_argument("--port", type=int, default=9200, help="HTTP port")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--data-path", default=None)
    ap.add_argument(
        "--node-name", default=None, help="start a cluster node (transport on)"
    )
    ap.add_argument(
        "--transport-port", type=int, default=9300, help="inter-node RPC port"
    )
    ap.add_argument(
        "--seeds",
        default=None,
        help="comma-separated host:port seed list (discovery.seed_hosts)",
    )
    args = ap.parse_args(argv)
    node = None
    if args.node_name is not None or args.seeds is not None:
        # multi-node mode: the HTTP tier fronts a TpuNode's distributed
        # cluster service (Netty4HttpServerTransport + TransportService
        # both bound on one Node, SURVEY.md §3.1)
        from ..cluster.node import TpuNode

        seeds = []
        for part in (args.seeds or "").split(","):
            part = part.strip()
            if part:
                h, _, p = part.rpartition(":")
                seeds.append((h or "127.0.0.1", int(p)))
        node = TpuNode(
            args.node_name or "node-0",
            seeds=seeds,
            data_path=args.data_path,
            port=args.transport_port,
        ).start()
        server = ElasticsearchTpuServer(
            port=args.port, host=args.host, cluster=node.cluster
        )
        print(
            f"elasticsearch-tpu node [{node.name}] transport "
            f"{node.address[0]}:{node.address[1]} http://{args.host}:{server.port}"
            f" (data: {args.data_path or 'in-memory'})",
            flush=True,
        )
    else:
        server = ElasticsearchTpuServer(
            port=args.port, host=args.host, data_path=args.data_path
        )
        print(
            f"elasticsearch-tpu listening on http://{args.host}:{server.port} "
            f"(data: {args.data_path or 'in-memory'})",
            flush=True,
        )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        if node is None:
            server.close()
        else:
            # the node closes its cluster service itself: closing it
            # through the server too would close each engine twice
            server.httpd.shutdown()
            server.httpd.server_close()
            node.close()


if __name__ == "__main__":
    main()
