"""Crash-matrix harness for the write path.

The read path got its deterministic fault harness in round 4
(common/faults.py); this module is the durability mirror. It drives a
SCRIPTED write workload (bulk index / update / delete / CAS + refresh +
flush + merge) against a ShardEngine while a ``crash``-kind fault rule
is armed at one write-path site, catches the resulting
:class:`~..common.faults.SimulatedCrash`, tears the engine down WITHOUT
running any close/flush path (``ShardEngine.crash()``), reopens the
shard directory through the real recovery path, and verifies the
durability contract:

* ``request`` durability: EVERY op acked before the crash is present in
  the recovered state (right version, right seq_no, right source).
* ``async`` durability: loss is bounded by the last completed fsync —
  every acked op with seq_no <= the translog's synced high-water mark
  at crash time must survive; newer acked ops MAY be lost but nothing
  may be reordered, duplicated, or invented.
* Recovery always terminates with a consistent engine: no torn
  segment/manifest state, a searchable reader, and (checked by the
  caller) the same pages from the port's TorchExecutor as from the
  numpy oracle on the recovered data.

The port's copy: engines open on `device` ("cuda" unless the caller
passes another) with the torch backend's device build preference, so a
recovery's replay refresh builds its segment on that device (the
`ES_TPU_DEVICE_BUILD` mode still decides). tests/test_torch_disk.py runs
the full site x durability matrix through these helpers on the CPU;
chip_smoke.py runs it on the card.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..analysis import AnalysisRegistry
from ..common.faults import SimulatedCrash, faults
from .engine import ShardEngine, VersionConflictError
from .mapping import Mappings
from .translog import DURABILITY_REQUEST

# the engine-level crash matrix: every write-path site the workload can
# reach, with the rule spec that pins the crash there. `torn` rides the
# translog.append site to leave a partial record on disk; `skip` moves
# the crash onset mid-workload (past the first flush, so the async
# durability bound is non-trivial in those cells — early-onset cells
# keep the before-any-commit shape covered too).
ENGINE_CRASH_SITES: List[Tuple[str, dict]] = [
    ("translog.append[first]", {"site": "translog.append"}),
    ("translog.append[mid]", {"site": "translog.append", "skip": 14}),
    ("translog.append[torn]",
     {"site": "translog.append", "torn": True, "skip": 20}),
    ("translog.fsync[first]", {"site": "translog.fsync"}),
    ("translog.fsync[late]", {"site": "translog.fsync", "skip": 2}),
    ("engine.refresh[first]", {"site": "engine.refresh"}),
    ("engine.refresh[late]", {"site": "engine.refresh", "skip": 2}),
    ("engine.flush[start]",
     {"site": "engine.flush", "match": {"stage": "start"}, "skip": 1}),
    ("engine.flush[pre_manifest]",
     {"site": "engine.flush", "match": {"stage": "pre_manifest"},
      "skip": 1}),
    ("engine.flush[post_manifest]",
     {"site": "engine.flush", "match": {"stage": "post_manifest"},
      "skip": 1}),
    ("engine.merge", {"site": "engine.merge", "skip": 1}),
]

WORKLOAD_MAPPING = {
    "properties": {
        "body": {"type": "text"},
        "tag": {"type": "keyword"},
        "n": {"type": "integer"},
    }
}

_WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot",
          "golf", "hotel", "india", "juliet"]


def _source(i: int, rev: int = 0) -> dict:
    return {
        "body": f"{_WORDS[i % len(_WORDS)]} shared "
                f"{_WORDS[(i * 3 + rev) % len(_WORDS)]} tok{i} rev{rev}",
        "tag": _WORDS[(i + rev) % 4],
        "n": i * 10 + rev,
    }


@dataclass
class _AckedOp:
    seq_no: int
    version: int
    deleted: bool
    source: Optional[dict]
    # translog durable high-water AT ACK TIME: under async durability an
    # op is only guaranteed once a LATER fsync covers its seq_no
    synced_seq_at_ack: int


@dataclass
class AckLedger:
    """What the client was told succeeded, in ack order."""

    ops: List[Tuple[str, _AckedOp]] = field(default_factory=list)

    def record(self, eng: ShardEngine, doc_id: str, result) -> None:
        tl = eng.translog
        self.ops.append((
            doc_id,
            _AckedOp(
                seq_no=result.seq_no,
                version=result.version,
                deleted=(result.result == "deleted"),
                source=None,
                synced_seq_at_ack=(
                    -1 if tl is None else tl.last_synced_seq_no
                ),
            ),
        ))

    def record_index(self, eng, doc_id, source, result):
        self.record(eng, doc_id, result)
        self.ops[-1][1].source = source

    @property
    def max_acked_seq(self) -> int:
        return max((op.seq_no for _, op in self.ops), default=-1)

    def acked_states(self, doc_id: str) -> List[_AckedOp]:
        return [op for d, op in self.ops if d == doc_id]

    def expected_after(self, durable_bound: int) -> Dict[str, _AckedOp]:
        """Per doc: the newest acked state with seq_no <= durable_bound
        — the FLOOR recovery must reach (newer acked states are also
        acceptable; older ones are lost acks)."""
        out: Dict[str, _AckedOp] = {}
        for doc_id, op in self.ops:
            if op.seq_no <= durable_bound:
                out[doc_id] = op
        return out


def run_workload(eng: ShardEngine, ledger: AckLedger,
                 n_docs: int = 24) -> None:
    """Deterministic scripted workload touching every write-path verb.
    Every ack is recorded BEFORE the next step so a crash mid-script
    leaves the ledger exactly at the acked prefix."""

    def idx(i: int, rev: int = 0, **kw):
        src = _source(i, rev)
        r = eng.index(f"d{i}", src, **kw)
        ledger.record_index(eng, f"d{i}", src, r)
        return r

    def delete(i: int, **kw):
        r = eng.delete(f"d{i}", **kw)
        if r.result == "deleted":
            ledger.record(eng, f"d{i}", r)
        return r

    half = n_docs // 2
    for i in range(half):
        idx(i)
    eng.refresh()
    # updates over the refreshed segment (live-bit flips + new buffer)
    for i in range(0, 4):
        idx(i, rev=1)
    delete(4)
    delete(5)
    eng.flush()
    # second epoch: ops living only in the WAL tail
    for i in range(half, half + 6):
        idx(i)
    # CAS update through the optimistic-concurrency path
    cur = eng.get("d1")
    try:
        r = eng.index("d1", _source(1, 2), if_seq_no=cur["_seq_no"],
                      if_primary_term=cur["_primary_term"])
        ledger.record_index(eng, "d1", _source(1, 2), r)
    except VersionConflictError:
        pass
    eng.refresh()
    delete(6)
    for i in range(half + 6, n_docs):
        idx(i)
    eng.refresh()
    eng.maybe_merge(max_segments=1)
    eng.flush()
    # third epoch: a fresh unflushed tail so post-flush sites still have
    # work in front of them
    for i in range(n_docs, n_docs + 4):
        idx(i)
    idx(0, rev=3)
    delete(7)
    eng.refresh()
    eng.maybe_merge(max_segments=1)
    eng.flush()


def verify_recovery(eng: ShardEngine, ledger: AckLedger, durability: str,
                    synced_seq_at_crash: int) -> dict:
    """Asserts the durability contract on a freshly-reopened engine."""
    durable_bound = (
        ledger.max_acked_seq
        if durability == DURABILITY_REQUEST
        else synced_seq_at_crash
    )
    floor = ledger.expected_after(durable_bound)
    lost_acks = 0
    for doc_id in {d for d, _ in ledger.ops}:
        states = ledger.acked_states(doc_id)
        acked_by_seq = {op.seq_no: op for op in states}
        newest = states[-1]
        doc = eng.get(doc_id)
        want = floor.get(doc_id)
        if doc is None:
            # absent is only legal if the floor state is a delete (or
            # the doc has no durable-bound state at all)
            assert want is None or want.deleted, (
                f"[{doc_id}] lost: acked (v{want.version}, seq "
                f"{want.seq_no}) is within the durable bound "
                f"{durable_bound} under [{durability}] durability"
            )
            if not newest.deleted:
                lost_acks += 1  # volatile acked write lost: allowed,
                # counted (the async bound already passed above)
            continue
        got_seq = doc["_seq_no"]
        # never an invented state: what recovery shows must be SOME
        # acked non-deleted state of this doc
        assert got_seq in acked_by_seq and not acked_by_seq[got_seq].deleted, (
            f"[{doc_id}] recovered to seq {got_seq}, which was never "
            f"acked as a live state"
        )
        got = acked_by_seq[got_seq]
        assert doc["_version"] == got.version, (
            f"[{doc_id}] seq {got_seq} acked as v{got.version} but "
            f"recovered as v{doc['_version']}"
        )
        assert doc["_source"] == got.source, (
            f"[{doc_id}] recovered source diverges from the acked "
            f"source at seq {got_seq}"
        )
        if want is not None:
            # never older than the durable floor
            assert got_seq >= want.seq_no, (
                f"[{doc_id}] recovered seq {got_seq} is OLDER than the "
                f"durable floor seq {want.seq_no} under [{durability}]"
            )
        if got_seq < newest.seq_no:
            lost_acks += 1
    return {
        "durable_bound": durable_bound,
        "max_acked_seq": ledger.max_acked_seq,
        "lost_acks_beyond_bound": lost_acks,
        "recovered_docs": eng.num_docs,
    }


def engine_state_checksum(eng: ShardEngine) -> str:
    """Checksum of the full logical replica state: live doc set +
    versions + seq_nos + sources. Two converged copies must be
    checksum-identical regardless of segment layout."""
    items = []
    with eng._lock:
        ids = sorted(
            d for d, ve in eng._versions.items() if not ve.deleted
        )
    for doc_id in ids:
        doc = eng.get(doc_id)
        if doc is None:
            continue
        items.append([
            doc_id, doc["_version"], doc["_seq_no"],
            json.dumps(doc["_source"], sort_keys=True),
        ])
    return hashlib.sha256(
        json.dumps(items, sort_keys=True).encode()
    ).hexdigest()


def run_engine_crash_case(
    path: str,
    rule: dict,
    durability: str,
    sync_interval: float = 5.0,
    seed: int = 0,
    times: int = 1,
    device="cuda",
) -> Tuple[ShardEngine, AckLedger, dict]:
    """One cell of the crash matrix: workload → injected crash →
    teardown-without-close → reopen → contract verification. Returns
    (recovered engine, ledger, report); the recovered engine is OPEN —
    the caller closes it (and can run search parity on it first). Both
    engines prefer the device build, as a torch index's do: they build
    their segments on `device` unless `ES_TPU_DEVICE_BUILD` says
    otherwise."""
    mappings = Mappings(WORKLOAD_MAPPING)
    on = {"device": device, "device_build": True}
    eng = ShardEngine(
        mappings, AnalysisRegistry(), path=path,
        durability=durability, sync_interval=sync_interval, **on,
    )
    ledger = AckLedger()
    faults.configure(
        {"seed": seed, "rules": [{**rule, "kind": "crash", "times": times}]}
    )
    crashed = False
    try:
        run_workload(eng, ledger)
    except SimulatedCrash:
        crashed = True
    finally:
        faults.clear()
    synced = (
        eng.translog.last_synced_seq_no if eng.translog is not None else -1
    )
    eng.crash()
    recovered = ShardEngine(
        mappings, AnalysisRegistry(), path=path,
        durability=durability, sync_interval=sync_interval, **on,
    )
    report = verify_recovery(recovered, ledger, durability, synced)
    report["crashed"] = crashed
    # no torn commit state: the manifest (if any) must reference only
    # fully-loadable segments — ShardEngine.__init__ would have raised —
    # and the shard dir must hold no unreferenced garbage
    if os.path.exists(os.path.join(path, "manifest.json")):
        with open(os.path.join(path, "manifest.json"),
                  encoding="utf-8") as f:
            manifest = json.load(f)
        referenced = {
            e if isinstance(e, str) else e["name"]
            for e in manifest["segments"]
        }
        on_disk = {
            d for d in os.listdir(path)
            if os.path.isdir(os.path.join(path, d)) and d != "translog"
        }
        assert on_disk == referenced, (
            f"recovery left torn segment state: disk {on_disk} vs "
            f"manifest {referenced}"
        )
    return recovered, ledger, report
