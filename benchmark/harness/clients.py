"""Closed-loop HTTP clients in a process of their own.

Each client is a thread holding one persistent HTTP/1.1 connection; it
sends its next request as soon as its last reply has arrived (what Rally
runs). The clients run in one spawned process, on a CPU of their own
(run.py's `split_cpus`), so that they take neither the server's interpreter lock
nor its cores. The process talks to the harness over one
`multiprocessing` Pipe only (a Queue or a Lock would put semaphores in
/dev/shm).

Each request is recorded as (client, i, start, end, ok, digest): the
times are `time.monotonic()`, which is one clock for every process of
the machine; the digest keeps what the correctness check reads (the
hits' ids and scores, the total), or the error.
"""

from __future__ import annotations

import http.client
import json
import multiprocessing
import os
import threading
import time

from .traffic import QueryMaker

PATH_TIMEOUT_S = 120.0


def _digest(resp: dict) -> dict:
    hits = resp.get("hits", {})
    total = hits.get("total")
    if isinstance(total, dict):
        total = [total.get("value"), total.get("relation")]
    return {"hits": [[h.get("_id"), h.get("_score")] for h in hits.get("hits", [])],
            "total": total}


def _client_thread(port: int, path: str, maker, client: int, t_end: float,
                   stop: threading.Event, out: list) -> None:
    conn = None
    i = 0
    while time.monotonic() < t_end and not stop.is_set():
        data = json.dumps(maker.body(client, i)).encode()
        t0 = time.monotonic()
        try:
            if conn is None:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=PATH_TIMEOUT_S)
            conn.request("POST", path, body=data, headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            raw = r.read()
            t1 = time.monotonic()
            if r.status == 200:
                out.append((client, i, t0, t1, True, _digest(json.loads(raw))))
            else:
                out.append((client, i, t0, t1, False, {"error": f"HTTP {r.status}: {raw[:300]!r}"}))
        except (OSError, http.client.HTTPException, ValueError) as e:
            out.append((client, i, t0, time.monotonic(), False, {"error": repr(e)[:300]}))
            if conn is not None:
                conn.close()
            conn = None
        i += 1
    if conn is not None:
        conn.close()


def client_process(conn, port: int, path: str, traffic: dict, config: dict, context: dict,
                   seed: int, clients: list, cpus, bench_dir) -> None:
    """The client process: moves to `cpus`, builds its bodies'
    generator, reports ready, waits for ("run", t_end), runs its clients
    until `t_end` or until it receives "stop", and sends back their
    records."""
    if cpus:
        os.sched_setaffinity(0, cpus)
    maker = QueryMaker(traffic, config, context, seed, bench_dir)
    conn.send(("ready", None))
    msg = conn.recv()
    if msg is None:
        return
    _, t_end = msg
    records: list = []
    per = [[] for _ in clients]
    stop = threading.Event()
    threads = [threading.Thread(target=_client_thread, daemon=True,
                                args=(port, path, maker, c, t_end, stop, per[k]))
               for k, c in enumerate(clients)]
    for th in threads:
        th.start()
    while time.monotonic() < t_end:
        if conn.poll(min(0.05, max(0.0, t_end - time.monotonic()))):
            conn.recv()
            break
    stop.set()
    for th in threads:
        th.join(timeout=t_end - time.monotonic() + PATH_TIMEOUT_S + 10)
    for k, th in enumerate(threads):
        if th.is_alive():
            records.append((clients[k], -1, 0.0, 0.0, False, {"error": "client thread hung"}))
        records.extend(per[k])
    conn.send(("done", records))
    conn.close()


class ClientPool:
    """The mix's `traffic["clients"]` clients, in one spawned process
    that runs on `cpus` (all this process may use where None), their
    bodies from `bench_dir`'s `bodies/`."""

    def __init__(self, port: int, path: str, traffic: dict, config: dict, context: dict,
                 seed: int, bench_dir, cpus=None):
        n = int(traffic["clients"])
        ctx = multiprocessing.get_context("spawn")
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=client_process, daemon=True,
                           args=(child, port, path, traffic, config, context, seed,
                                 list(range(n)), cpus, bench_dir))
        proc.start()
        child.close()
        self.conn, self.proc = parent, proc
        tag, _ = parent.recv()
        if tag != "ready":
            raise RuntimeError(f"client process: {tag}")

    def start(self, t_end: float) -> None:
        """Every client starts now and sends until `t_end`."""
        self.conn.send(("run", t_end))

    def stop(self) -> None:
        """Every client stops after its request in flight."""
        try:
            self.conn.send(("stop", None))
        except OSError:  # the process already ran out its time
            pass

    def collect(self) -> list:
        """Every record, once the process has finished."""
        tag, records = self.conn.recv()
        if tag != "done":
            raise RuntimeError(f"client process: {tag}")
        self.close()
        return records

    def close(self) -> None:
        if self.proc is None:
            return
        try:
            self.conn.send(None)
        except OSError:
            pass
        self.conn.close()
        self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=10)
        self.proc = None
