"""The port's transport against the JAX package's, on the CPU.

tests/test_transport.py's contract (named handlers, request-id
correlation, the handshake, remote errors, timeouts, DEFLATE above
`COMPRESS_MIN`, the `MAX_FRAME` bound on the inflated size) on the
port's `TransportService`, over real localhost TCP. The two packages
speak one wire format, so each exchange runs port to port and across
the packages both ways, and `_frame` writes the same bytes in both.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
import zlib

import pytest

from elasticsearch_tpu.transport import service as jt
from elasticsearch_tpu_torch import transport as pt_pkg
from elasticsearch_tpu_torch.transport import service as pt

from test_torch_multinode import multinode_harness  # noqa: F401  (autouse)

PAIRS = {
    "port-port": (pt, pt),
    "port-jax": (pt, jt),
    "jax-port": (jt, pt),
}


@pytest.fixture(params=sorted(PAIRS))
def pair(request):
    """(caller, callee): the caller's package raises the errors the
    tests expect, so its error types are the ones checked."""
    caller_mod, callee_mod = PAIRS[request.param]
    a = caller_mod.TransportService("node-a").start()
    b = callee_mod.TransportService("node-b").start()
    try:
        yield caller_mod, a, b
    finally:
        a.close()
        b.close()


def test_exports_match_the_reference():
    from elasticsearch_tpu import transport as jt_pkg

    assert pt_pkg.__all__ == jt_pkg.__all__
    for name in ("TRANSPORT_VERSION", "MAX_FRAME", "COMPRESS_MIN",
                 "_FLAG_RAW", "_FLAG_DEFLATE"):
        assert getattr(pt, name) == getattr(jt, name), name


class TestTransport:
    def test_request_response(self, pair):
        _, a, b = pair
        b.register_handler("echo", lambda p: {"echo": p, "from": "node-b"})
        assert a.send(b.address, "echo", {"x": 1}) == {
            "echo": {"x": 1}, "from": "node-b"}

    def test_concurrent_correlation(self, pair):
        _, a, b = pair

        def slow_id(p):
            time.sleep(0.01 * (5 - p["i"] % 5))
            return {"i": p["i"]}

        b.register_handler("slow", slow_id)
        results, errs = {}, []

        def call(i):
            try:
                results[i] = a.send(b.address, "slow", {"i": i})["i"]
            except Exception as e:
                errs.append(e)

        ts = [threading.Thread(target=call, args=(i,)) for i in range(20)]
        [t.start() for t in ts]
        [t.join(30) for t in ts]
        assert not errs
        assert results == {i: i for i in range(20)}

    def test_remote_exception_propagates(self, pair):
        mod, a, b = pair

        def boom(p):
            raise ValueError("kaboom")

        b.register_handler("boom", boom)
        with pytest.raises(mod.RemoteTransportError) as ei:
            a.send(b.address, "boom", {})
        assert "kaboom" in str(ei.value)
        assert ei.value.etype == "ValueError"

    def test_remote_status_crosses_the_hop(self, pair):
        """A ClusterError-shaped remote failure keeps its REST status and
        error type over the wire."""
        mod, a, b = pair

        class Shaped(Exception):
            status = 409
            err_type = "version_conflict_engine_exception"

        def conflict(p):
            raise Shaped("conflict on [x]")

        b.register_handler("conflict", conflict)
        with pytest.raises(mod.RemoteTransportError) as ei:
            a.send(b.address, "conflict", {})
        assert ei.value.status == 409
        assert ei.value.err_type == "version_conflict_engine_exception"

    def test_unknown_action(self, pair):
        mod, a, b = pair
        with pytest.raises(mod.RemoteTransportError) as ei:
            a.send(b.address, "nope", {})
        assert ei.value.etype == "action_not_found_transport_exception"

    def test_timeout(self, pair):
        mod, a, b = pair
        b.register_handler("hang", lambda p: time.sleep(2))
        with pytest.raises(mod.ReceiveTimeoutTransportError):
            a.send(b.address, "hang", {}, timeout=0.2)

    def test_connect_refused(self, pair):
        mod, a, _ = pair
        with pytest.raises(mod.ConnectTransportError):
            a.send(("127.0.0.1", 1), "echo", {}, timeout=1)

    def test_ping(self, pair):
        _, a, b = pair
        b.register_handler("internal:ping", lambda p: {"node": "node-b"})
        assert a.ping(b.address) == "node-b"
        assert a.ping(("127.0.0.1", 1)) is None


@pytest.mark.parametrize("caller,callee", [(pt, pt), (pt, jt), (jt, pt)],
                         ids=["port-port", "port-jax", "jax-port"])
def test_cluster_name_mismatch(caller, callee):
    a = caller.TransportService("a", cluster_name="c1").start()
    b = callee.TransportService("b", cluster_name="c2").start()
    try:
        with pytest.raises(caller.ConnectTransportError):
            a.send(b.address, "x", {})
    finally:
        a.close()
        b.close()


class TestFrameCompression:
    @pytest.mark.parametrize("msg", [
        {"a": "x"},
        {"t": "q", "id": 7, "a": "indices:data/read/search_shard",
         "p": {"index": "i", "shard": 3, "scores": [0.5, 1.25]}},
        {"blob": "word " * (pt.COMPRESS_MIN // 4)},
    ], ids=["small", "request", "deflated"])
    def test_frames_are_the_reference_bytes(self, msg):
        assert pt._frame(msg) == jt._frame(msg)

    def test_large_frames_deflate_and_roundtrip(self):
        small = {"a": "x"}
        assert pt._frame(small)[pt._LEN.size] == pt._FLAG_RAW
        big = {"blob": "word " * (pt.COMPRESS_MIN // 4)}
        comp = pt._frame(big)
        assert comp[pt._LEN.size] == pt._FLAG_DEFLATE
        assert len(comp) < pt.COMPRESS_MIN
        for callee in (pt, jt):
            a = pt.TransportService("ca").start()
            b = callee.TransportService("cb").start()
            try:
                b.register_handler("echo", lambda p: p)
                assert a.send(b.address, "echo", big) == big
            finally:
                a.close()
                b.close()

    @pytest.mark.parametrize("mod", [pt, jt], ids=["port", "jax"])
    def test_decompression_bomb_rejected(self, mod):
        """A small compressed frame inflating past `MAX_FRAME` is refused
        before full inflation, by both packages alike."""
        huge = json.dumps({"z": "a" * (mod.MAX_FRAME + 1024)}).encode()
        comp = zlib.compress(huge, 9)
        frame = mod._LEN.pack(len(comp) + 1) + bytes([mod._FLAG_DEFLATE]) + comp

        class FakeReader:
            def __init__(self, data):
                self.data, self.pos = data, 0

            async def readexactly(self, n):
                out = self.data[self.pos:self.pos + n]
                self.pos += n
                return out

        async def run():
            with pytest.raises(mod.TransportError):
                await mod._read_frame(FakeReader(frame))

        asyncio.run(run())

    def test_oversized_frame_header_rejected(self):
        """A frame whose length prefix exceeds `MAX_FRAME` is refused
        without reading its body (the whole-shard recovery frame of a
        large shard meets this bound in both packages)."""
        head = pt._LEN.pack(pt.MAX_FRAME + 1)

        class FakeReader:
            async def readexactly(self, n):
                assert n == pt._LEN.size, "the body must not be read"
                return head

        async def run():
            with pytest.raises(pt.TransportError, match="exceeds limit"):
                await pt._read_frame(FakeReader())

        asyncio.run(run())
