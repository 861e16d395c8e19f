"""Per-shard durable write-ahead log (the translog).

Reference analog: org.elasticsearch.index.translog — `Translog.add`
appends every accepted operation before it is acknowledged,
`index.translog.durability` selects fsync-per-request vs async,
generations roll at flush and are trimmed once a Lucene commit covers
their sequence numbers, and an atomic `Checkpoint` file records the
durable state (server/.../index/translog/Translog.java, Checkpoint.java).

TPU-native redesign notes: ops are JSON-lines (host-side durability is
CPU work; there is no device involvement), one file per generation
(``translog-<gen>.log``), with an atomically-replaced ``translog.ckp``
holding {generation, min_retained_seq_no}. Recovery replays every op
with seq_no > the commit's max_seq_no (InternalEngine#recoverFromTranslog
analog in engine.py).

Crash model (round 11): the log file is opened UNBUFFERED and every
record goes through an explicit in-memory pending tail — a byte only
counts as durable once `sync()` has written AND fsynced it. `request`
durability syncs inside every `add`; `async` lets the pending tail ride
until `sync_interval` elapses. A simulated power loss (`crash()`, driven
by the ``crash`` fault kind in common/faults.py) drops the pending tail
on the floor, exactly what the page cache loses when the box dies — so
the acked-but-volatile window of `async` mode is a REAL, testable loss
window instead of an accident of Python buffering.

Reopen hardening (round 11): `__init__` now (1) removes an orphaned
``translog.ckp.tmp`` left by a crash between checkpoint write and
`os.replace`, (2) deletes stale ``translog-<gen>.log`` files NEWER than
the checkpointed generation (a crash inside `roll_generation` between
new-file creation and checkpoint write leaves one; it holds no acked
ops), and (3) TRUNCATES a torn trailing record in the active generation
— previously a reopen appended after the garbage, so `_read_ops`
stopped at the corruption and silently dropped every later op in that
generation. All three are counted in the durability stats block.
"""

from __future__ import annotations

import json
import os
import threading
import time as _time
from typing import Iterator, List, Optional

from ..common.faults import SimulatedCrash, faults

DURABILITY_REQUEST = "request"  # fsync before ack (default)
DURABILITY_ASYNC = "async"  # fsync at most sync_interval behind
DEFAULT_SYNC_INTERVAL = 5.0  # index.translog.sync_interval default (5s)


# ---------------------------------------------------------------------------
# process-wide durability counters (the `translog`/`recovery` blocks of
# `_nodes/stats`; tests and scripts/durability_smoke.sh read them too).
# Kept here — translog.py has no heavy imports, so engine.py, node.py
# and rest/actions.py can all use it without cycles.
# ---------------------------------------------------------------------------

_DSTATS_LOCK = threading.Lock()

_DSTATS_ZERO = {
    # translog hygiene
    "torn_tails_truncated": 0,
    "torn_bytes_dropped": 0,
    "orphan_checkpoints_removed": 0,
    "orphan_manifests_removed": 0,
    "stale_generations_removed": 0,
    "translog_fsyncs": 0,
    "translog_appended_ops": 0,
    # engine recovery
    "replayed_ops": 0,
    "tail_replays": 0,
    "quarantined_segments": 0,
    # peer recovery (cluster/node.py)
    "recoveries_started": 0,
    "recoveries_completed": 0,
    "recoveries_failed": 0,
    "recovery_retries": 0,
    "recovered_files": 0,
    "recovered_ops": 0,
    "finalize_redelivered": 0,
}

DURABILITY_STATS = dict(_DSTATS_ZERO)


def bump_durability_stat(key: str, n: int = 1) -> None:
    with _DSTATS_LOCK:
        DURABILITY_STATS[key] = DURABILITY_STATS.get(key, 0) + n


def durability_stats_snapshot() -> dict:
    with _DSTATS_LOCK:
        return dict(DURABILITY_STATS)


class Translog:
    def __init__(
        self,
        path: str,
        durability: str = DURABILITY_REQUEST,
        sync_interval: float = DEFAULT_SYNC_INTERVAL,
        shard_id: int = 0,
    ):
        self.dir = path
        self.durability = durability
        self.sync_interval = sync_interval
        self.shard_id = shard_id
        os.makedirs(path, exist_ok=True)
        self._cleanup_orphan_checkpoint()
        ckp = self._read_checkpoint()
        self.generation = ckp.get("generation", 1)
        self.min_retained_seq_no = ckp.get("min_retained_seq_no", 0)
        self._cleanup_stale_generations()
        self._truncate_torn_tail(self._gen_path(self.generation))
        # unbuffered: what `_file.write` returns from is ON DISK (modulo
        # fsync); the acked-but-volatile window lives in _pending, never
        # in an invisible Python buffer
        self._file = open(self._gen_path(self.generation), "ab", buffering=0)
        self._pending: List[bytes] = []  # appended, not yet written+fsynced
        self._ops_in_gen = 0
        self._last_sync = _time.monotonic()
        # highest seq_no known written+fsynced THIS session (the async
        # durability bound the crash harness asserts against)
        self.last_synced_seq_no = -1
        self._max_seq_appended = -1
        # approximate WAL bytes not yet covered by a commit (reset when
        # the commit trims generations)
        self.bytes_since_trim = 0

    # ---- paths ----

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.dir, f"translog-{gen}.log")

    def _ckp_path(self) -> str:
        return os.path.join(self.dir, "translog.ckp")

    def _read_checkpoint(self) -> dict:
        try:
            with open(self._ckp_path(), encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def _write_checkpoint(self) -> None:
        tmp = self._ckp_path() + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "generation": self.generation,
                    "min_retained_seq_no": self.min_retained_seq_no,
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._ckp_path())

    # ---- reopen hygiene ----

    def _cleanup_orphan_checkpoint(self) -> None:
        """A crash between the checkpoint tmp-write and its os.replace
        leaves translog.ckp.tmp behind; it must not confuse the next
        recovery (the committed .ckp is the only truth)."""
        tmp = self._ckp_path() + ".tmp"
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
                bump_durability_stat("orphan_checkpoints_removed")
            except OSError:
                pass

    def _cleanup_stale_generations(self) -> None:
        """Deletes translog-<gen>.log files NEWER than the checkpointed
        generation. Only an interrupted roll_generation (crash between
        creating the new file and writing the checkpoint) produces one;
        no op is ever appended to a generation before its checkpoint is
        durable, so the file holds nothing acked."""
        for fname in os.listdir(self.dir):
            if not (fname.startswith("translog-") and fname.endswith(".log")):
                continue
            try:
                gen = int(fname[len("translog-") : -len(".log")])
            except ValueError:
                continue
            if gen > self.generation:
                try:
                    os.remove(os.path.join(self.dir, fname))
                    bump_durability_stat("stale_generations_removed")
                except OSError:
                    pass

    @staticmethod
    def _truncate_torn_tail(path: str) -> None:
        """Truncates a torn trailing record so the next append starts at
        a clean line boundary. Without this, a reopen in append mode
        concatenated new records onto the garbage and `_read_ops`
        stopped at the corruption — silently dropping every LATER op in
        the generation (the seed bug this round fixes)."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except (FileNotFoundError, OSError):
            return
        if not data:
            return
        pos = 0
        while True:
            nl = data.find(b"\n", pos)
            if nl == -1:
                break  # trailing bytes with no newline: torn
            seg = data[pos:nl].strip()
            if seg:
                try:
                    json.loads(seg)
                except ValueError:
                    break  # corrupt record: everything from here is torn
            pos = nl + 1
        if pos < len(data):
            with open(path, "r+b") as f:
                f.truncate(pos)
                os.fsync(f.fileno())
            bump_durability_stat("torn_tails_truncated")
            bump_durability_stat("torn_bytes_dropped", len(data) - pos)

    # ---- write path ----

    def add(self, op: dict) -> None:
        """Appends one operation (must carry ``seq_no``).

        ``async`` durability bounds the acked-but-volatile window to
        ``sync_interval`` (index.translog.sync_interval, default 5s) by
        checking the clock on every append — no timer thread, but an
        actively-written shard fsyncs at least every interval; an idle
        shard's tail syncs at the next op, roll, or close."""
        line = (json.dumps(op, separators=(",", ":")) + "\n").encode("utf-8")
        try:
            faults.check(
                "translog.append",
                shard=self.shard_id,
                gen=self.generation,
                seq_no=op.get("seq_no"),
                op=op.get("op"),
            )
        except SimulatedCrash as e:
            if e.torn:
                # power failed MID-write: a prefix of the record reaches
                # the platter — the torn tail recovery must truncate
                try:
                    self._file.write(line[: max(1, len(line) // 2)])
                except OSError:
                    pass
            raise
        self._pending.append(line)
        self._ops_in_gen += 1
        self.bytes_since_trim += len(line)
        seq = op.get("seq_no")
        if isinstance(seq, int):
            self._max_seq_appended = max(self._max_seq_appended, seq)
        bump_durability_stat("translog_appended_ops")
        if self.durability == DURABILITY_REQUEST:
            self.sync()
        elif _time.monotonic() - self._last_sync >= self.sync_interval:
            self.sync()

    def sync(self) -> None:
        # the crash site sits BEFORE the write: a power loss during an
        # fsync makes no promise about the pending tail
        faults.check("translog.fsync", shard=self.shard_id,
                     gen=self.generation)
        if self._pending:
            self._file.write(b"".join(self._pending))
            self._pending.clear()
        os.fsync(self._file.fileno())
        self.last_synced_seq_no = max(
            self.last_synced_seq_no, self._max_seq_appended
        )
        self._last_sync = _time.monotonic()
        bump_durability_stat("translog_fsyncs")

    @property
    def last_fsync_age(self) -> float:
        """Seconds since the last successful fsync."""
        return _time.monotonic() - self._last_sync

    # ---- generations ----

    def roll_generation(self) -> None:
        """Starts a new generation (called by flush before commit)."""
        self.sync()
        self._file.close()
        self.generation += 1
        self._file = open(self._gen_path(self.generation), "ab", buffering=0)
        self._ops_in_gen = 0
        self._write_checkpoint()

    def trim_unreferenced(self, committed_seq_no: int) -> None:
        """Deletes generations whose ops are all covered by the commit.

        Ordering contract (the crash matrix proves it): the caller's
        commit — segment files + manifest — is already DURABLE when this
        runs; a crash between the checkpoint write and the deletes below
        only leaves covered files behind, which the next recovery skips
        (ops <= committed) and the next trim removes."""
        self.min_retained_seq_no = committed_seq_no + 1
        self._write_checkpoint()
        for fname in os.listdir(self.dir):
            if not fname.startswith("translog-"):
                continue
            gen = int(fname[len("translog-") : -len(".log")])
            if gen >= self.generation:
                continue
            path = os.path.join(self.dir, fname)
            keep = False
            for op in self._read_ops(path):
                if op.get("seq_no", -1) > committed_seq_no:
                    keep = True
                    break
            if not keep:
                os.remove(path)
        self.bytes_since_trim = 0

    # ---- recovery ----

    @staticmethod
    def _read_ops(path: str) -> Iterator[dict]:
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        return  # torn tail write: stop at corruption
        except FileNotFoundError:
            return

    def read_ops_after(self, seq_no: int) -> Iterator[dict]:
        """All ops with seq_no > the given value, in log order."""
        gens = sorted(
            int(f[len("translog-") : -len(".log")])
            for f in os.listdir(self.dir)
            if f.startswith("translog-")
        )
        self.sync()
        for gen in gens:
            for op in self._read_ops(self._gen_path(gen)):
                if op.get("seq_no", -1) > seq_no:
                    yield op

    def stats(self) -> dict:
        return {
            "ops_in_generation": self._ops_in_gen,
            "pending_ops": len(self._pending),
            "uncommitted_bytes": self.bytes_since_trim,
            "last_fsync_age_ms": round(self.last_fsync_age * 1000.0, 1),
            "generation": self.generation,
            "durability": self.durability,
        }

    def close(self) -> None:
        try:
            self.sync()
        finally:
            self._file.close()

    def crash(self) -> None:
        """Simulated power loss: the pending (acked-but-unfsynced) tail
        is DROPPED, nothing is flushed, no checkpoint is written. The
        file handle itself is unbuffered, so closing it cannot leak the
        dropped bytes onto disk."""
        self._pending.clear()
        try:
            self._file.close()
        except OSError:
            pass
