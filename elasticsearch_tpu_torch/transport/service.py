"""Inter-node RPC: the TransportService analog over asyncio TCP.

Reference analog: org.elasticsearch.transport.TransportService +
TcpTransport + modules/transport-netty4 (SURVEY.md §2.7, L4): named
request handlers (`registerRequestHandler`), request-id correlated
async responses, per-request timeouts, and a version handshake on
connect (`TransportHandshaker`). The binary `Writeable` codec is
replaced by length-prefixed JSON frames — control-plane payloads here
are small metadata/doc blobs riding DCN, while bulk scoring data stays
on-device (ICI collectives in parallel/sharded.py); SURVEY §2.7
prescribes exactly this two-plane split.

Wire format: 4-byte big-endian length + UTF-8 JSON frame.
  request:  {"t": "q", "id": n, "a": action, "p": payload}
  response: {"t": "r", "id": n, "p": payload}
  error:    {"t": "e", "id": n, "error": reason, "etype": class}
Handshake (first frame each direction on connect):
  {"t": "h", "node": node_id, "version": TRANSPORT_VERSION, "cluster": name}

The event loop runs on a dedicated daemon thread; handlers execute on a
thread pool so blocking engine work never stalls the loop (the analog of
ES dispatching transport messages onto named threadpools).
"""

from __future__ import annotations

import asyncio
import itertools
import json
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

# v2: frames carry a leading flag byte (raw | DEFLATE)
TRANSPORT_VERSION = 2
_LEN = struct.Struct(">I")
MAX_FRAME = 256 * 1024 * 1024


class TransportError(Exception):
    def __init__(self, reason: str, etype: str = "transport_exception"):
        super().__init__(reason)
        self.etype = etype


class ConnectTransportError(TransportError):
    def __init__(self, reason: str):
        super().__init__(reason, "connect_transport_exception")


class ReceiveTimeoutTransportError(TransportError):
    def __init__(self, reason: str):
        super().__init__(reason, "receive_timeout_transport_exception")


class RemoteTransportError(TransportError):
    """An exception raised by the remote handler, re-raised locally.
    Carries the remote exception's REST status/err_type when the remote
    raised a ClusterError-shaped exception, so coordinators can re-raise
    with the right HTTP status (ES serializes ElasticsearchException
    status over the wire the same way)."""

    def __init__(
        self,
        reason: str,
        etype: str,
        status: Optional[int] = None,
        err_type: Optional[str] = None,
    ):
        super().__init__(reason, etype)
        self.status = status
        self.err_type = err_type


# frames at or above this size are DEFLATE-compressed on the wire
# (TransportSettings.TRANSPORT_COMPRESS / Lucene's transport LZ4 —
# recovery file chunks and bulk doc batches shrink several-fold)
COMPRESS_MIN = 8 * 1024
_FLAG_RAW = 0
_FLAG_DEFLATE = 1


async def _read_frame(reader: asyncio.StreamReader) -> dict:
    head = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        raise TransportError(f"frame of {n} bytes exceeds limit")
    if n < 1:
        raise TransportError("empty frame")
    body = await reader.readexactly(n)
    flag, payload = body[0], body[1:]
    if flag == _FLAG_DEFLATE:
        import zlib

        # bounded inflate: the MAX_FRAME limit must hold for the
        # DECOMPRESSED size too (decompression-bomb guard)
        try:
            d = zlib.decompressobj()
            payload = d.decompress(payload, MAX_FRAME)
        except zlib.error as e:
            raise TransportError(f"corrupt compressed frame: {e}")
        if d.unconsumed_tail:
            raise TransportError(
                f"inflated frame exceeds the {MAX_FRAME} byte limit"
            )
    elif flag != _FLAG_RAW:
        raise TransportError(f"unknown frame flag [{flag}]")
    return json.loads(payload)


def _frame(msg: dict) -> bytes:
    body = json.dumps(msg, separators=(",", ":")).encode()
    flag = _FLAG_RAW
    if len(body) >= COMPRESS_MIN:
        import zlib

        comp = zlib.compress(body, 6)
        if len(comp) < len(body):
            body = comp
            flag = _FLAG_DEFLATE
    return _LEN.pack(len(body) + 1) + bytes([flag]) + body


class _Connection:
    """One outbound connection with request-id correlation."""

    def __init__(self, reader, writer, remote_node: str):
        self.reader = reader
        self.writer = writer
        self.remote_node = remote_node
        self.pending: Dict[int, asyncio.Future] = {}
        self.closed = False

    async def pump(self):
        """Reads responses and resolves pending futures."""
        try:
            while True:
                msg = await _read_frame(self.reader)
                fut = self.pending.pop(msg.get("id"), None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self.closed = True
            for fut in self.pending.values():
                if not fut.done():
                    fut.set_exception(
                        ConnectTransportError("connection closed")
                    )
            self.pending.clear()
            try:
                self.writer.close()
            except Exception:
                pass


class TransportService:
    """Named-action RPC endpoint bound to one node."""

    def __init__(
        self,
        node_id: str,
        cluster_name: str = "elasticsearch-tpu",
        host: str = "127.0.0.1",
        port: int = 0,
        handler_threads: int = 8,
    ):
        self.node_id = node_id
        self.cluster_name = cluster_name
        self.host = host
        self._requested_port = port
        self.port: Optional[int] = None
        self._handlers: Dict[str, Callable[[dict], Any]] = {}
        self._conns: Dict[Tuple[str, int], _Connection] = {}
        self._req_ids = itertools.count(1)
        self._pool = ThreadPoolExecutor(
            max_workers=handler_threads, thread_name_prefix=f"transport-{node_id}"
        )
        self._loop = asyncio.new_event_loop()
        # dispatch/pump tasks tracked so close() can cancel them — an
        # un-cancelled pending task at loop close leaks ("Task was
        # destroyed but it is pending!")
        self._tasks: set = set()
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = threading.Event()
        self._thread = threading.Thread(
            target=self._run_loop, name=f"transport-loop-{node_id}", daemon=True
        )
        self.stats = {"rx_count": 0, "tx_count": 0}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "TransportService":
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise TransportError("transport failed to start")
        return self

    def _run_loop(self):
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(self._start_server())
        self._started.set()
        self._loop.run_forever()
        # drain pending callbacks after stop
        self._loop.run_until_complete(self._loop.shutdown_asyncgens())
        self._loop.close()

    async def _start_server(self):
        self._server = await asyncio.start_server(
            self._serve_conn, self.host, self._requested_port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def close(self):
        def _shutdown():
            if self._server is not None:
                self._server.close()
            # cancel in-flight dispatch/pump tasks first; their
            # cancellation wakeups are queued ahead of the stop below,
            # so every task completes (cancelled) before the loop halts
            for t in list(self._tasks):
                t.cancel()
            for c in self._conns.values():
                try:
                    c.writer.close()
                except Exception:
                    pass
            self._loop.call_soon(self._loop.stop)

        if self._loop.is_running():
            self._loop.call_soon_threadsafe(_shutdown)
            self._thread.join(timeout=5)
        self._pool.shutdown(wait=False)

    def _track(self, coro) -> "asyncio.Task":
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    # ------------------------------------------------------------------
    # server side
    # ------------------------------------------------------------------

    def register_handler(self, action: str, fn: Callable[[dict], Any]):
        """`TransportService.registerRequestHandler` — fn(payload) → payload
        runs on the handler pool; raising maps to an error frame."""
        self._handlers[action] = fn

    async def _serve_conn(self, reader, writer):
        # inbound handler tasks are spawned by asyncio.start_server, not
        # by _track — self-register so close() can cancel them too
        task = asyncio.current_task()
        if task is not None:
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
        try:
            hello = await _read_frame(reader)
            if hello.get("t") != "h" or hello.get("version") != TRANSPORT_VERSION:
                writer.write(
                    _frame(
                        {
                            "t": "e",
                            "id": 0,
                            "error": "handshake failed: incompatible version",
                            "etype": "illegal_state_exception",
                        }
                    )
                )
                await writer.drain()
                writer.close()
                return
            writer.write(
                _frame(
                    {
                        "t": "h",
                        "node": self.node_id,
                        "version": TRANSPORT_VERSION,
                        "cluster": self.cluster_name,
                    }
                )
            )
            await writer.drain()
            while True:
                msg = await _read_frame(reader)
                if msg.get("t") != "q":
                    continue
                self.stats["rx_count"] += 1
                self._track(self._dispatch(msg, writer))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, msg: dict, writer):
        rid = msg.get("id")
        action = msg.get("a")
        fn = self._handlers.get(action)
        if fn is None:
            out = {
                "t": "e",
                "id": rid,
                "error": f"no handler for action [{action}]",
                "etype": "action_not_found_transport_exception",
            }
        else:
            try:
                result = await self._loop.run_in_executor(
                    self._pool, fn, msg.get("p")
                )
                out = {"t": "r", "id": rid, "p": result}
            except Exception as e:
                out = {
                    "t": "e",
                    "id": rid,
                    "error": str(e),
                    "etype": type(e).__name__,
                }
                status = getattr(e, "status", None)
                err_type = getattr(e, "err_type", None)
                if isinstance(status, int):
                    out["status"] = status
                if isinstance(err_type, str):
                    out["err_type"] = err_type
        try:
            writer.write(_frame(out))
            await writer.drain()
        except (ConnectionError, OSError):
            pass

    # ------------------------------------------------------------------
    # client side
    # ------------------------------------------------------------------

    async def _get_conn(self, address: Tuple[str, int]) -> _Connection:
        conn = self._conns.get(address)
        if conn is not None and not conn.closed:
            return conn
        try:
            reader, writer = await asyncio.open_connection(*address)
        except (ConnectionError, OSError) as e:
            raise ConnectTransportError(f"connect to {address} failed: {e}")
        writer.write(
            _frame(
                {
                    "t": "h",
                    "node": self.node_id,
                    "version": TRANSPORT_VERSION,
                    "cluster": self.cluster_name,
                }
            )
        )
        await writer.drain()
        hello = await _read_frame(reader)
        if hello.get("t") == "e":
            writer.close()
            raise ConnectTransportError(hello.get("error", "handshake rejected"))
        if hello.get("t") != "h" or hello.get("version") != TRANSPORT_VERSION:
            writer.close()
            raise ConnectTransportError("handshake failed: incompatible version")
        if hello.get("cluster") != self.cluster_name:
            writer.close()
            raise ConnectTransportError(
                f"remote cluster name [{hello.get('cluster')}] "
                f"does not match [{self.cluster_name}]"
            )
        conn = _Connection(reader, writer, hello.get("node"))
        self._conns[address] = conn
        self._track(conn.pump())
        return conn

    async def _send_async(
        self, address: Tuple[str, int], action: str, payload, timeout: float
    ):
        conn = await self._get_conn(address)
        rid = next(self._req_ids)
        fut = self._loop.create_future()
        conn.pending[rid] = fut
        conn.writer.write(_frame({"t": "q", "id": rid, "a": action, "p": payload}))
        await conn.writer.drain()
        self.stats["tx_count"] += 1
        try:
            msg = await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            conn.pending.pop(rid, None)
            raise ReceiveTimeoutTransportError(
                f"[{action}] request to {address} timed out after {timeout}s"
            )
        if msg.get("t") == "e":
            raise RemoteTransportError(
                msg.get("error", "remote error"),
                msg.get("etype", "exception"),
                status=msg.get("status"),
                err_type=msg.get("err_type"),
            )
        return msg.get("p")

    def send(
        self,
        address: Tuple[str, int],
        action: str,
        payload=None,
        timeout: float = 30.0,
    ):
        """Synchronous request/response (`TransportService.sendRequest` +
        blocking future). Safe to call from any non-loop thread."""
        from ..common.faults import InjectedFault, faults

        # fault-injection site: drops/delays/errors on the outbound hop
        # (MockTransportService-style disruption, armed via ES_TPU_FAULTS
        # or POST /_internal/faults; a no-op when unarmed)
        try:
            faults.check(
                "transport.send",
                action=action,
                address=f"{address[0]}:{address[1]}",
            )
        except InjectedFault as e:
            if e.err_type == "connect_transport_exception":
                # an injected drop looks exactly like a broken connection
                raise ConnectTransportError(str(e))
            raise
        fut = asyncio.run_coroutine_threadsafe(
            self._send_async(tuple(address), action, payload, timeout), self._loop
        )
        return fut.result(timeout=timeout + 5)

    def ping(self, address: Tuple[str, int], timeout: float = 5.0) -> Optional[str]:
        """Handshake-probe a peer; returns its node id or None.
        (`HandshakingTransportAddressConnector` analog for discovery.)"""
        try:
            return self.send(address, "internal:ping", {}, timeout=timeout)["node"]
        except TransportError:
            return None
