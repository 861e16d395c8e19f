"""MeshExecutor — the whole-index serving backend behind `_search`.

Counterpart of `elasticsearch_tpu/parallel/mesh_executor.py` (the JAX
package). A `MeshExecutor` materializes a stacked device-resident view
of an index's LIVE shards (every (shard, segment) pair is one entry of
the stack) and executes whole same-plan query groups as ONE step —
per-entry scoring + local top-k, the merge and the totals in the same
step — replacing S per-shard batcher jobs, S launches and S host round
trips with one packed download.

The mesh spans the devices `_devices` lists: the index's own device
first, then every other visible card, capped by ES_TPU_MESH_DEVICES (an
index on the CPU gets the CPU alone). `make_mesh` lays them out as a
(data, shards) grid of slots (parallel/mesh.py): slot (r, c) holds fold
c of every stacked view on its device (`sharded.Stacked`), each
``data`` row holds a full copy and takes its share of the query rows,
and a step launches each slot's part on its slot's device, then brings
the slots' pages to the index's device for the merge (parallel/
sharded.py). One process drives every slot, as the reference's single
controller does: no `torch.distributed`, no extra process. `auto`
engages with 2+ devices and 2+ shards, as the reference does;
`ES_TPU_MESH=force` takes the mesh on one device too.

Design contract (float-exactness with the per-shard path):

  * entries are (shard, segment) pairs in (shard asc, segment asc)
    order, so per-entry scoring is the SAME computation the per-segment
    scorers run — same block-aligned tilings (ops/wand.get_tiling),
    same shard-level BM25 weights (TorchExecutor._segment_weights via
    BlockMaxIndex), same `w - w/(1 + tf·inv)` accumulation in the same
    tile order, same live-doc masking — and the merge's (score desc,
    slot asc) order equals the coordinator's (score desc, shard asc,
    segment asc, doc asc) tie-break. The pages are bit for bit the
    per-shard path's, whatever the grid, on the CPU and the card alike
    (every float accumulation is the ordered scatter-add of
    ops/ordered_scatter.py, and the rescore multiplies each entry in the
    per-shard path's shapes), but for the kNN product on a ``data`` axis
    of 2+: the BLAS picks its kernel by the row count, so a score may
    move in its last ulp.
  * no pruning on the mesh path: totals come out exact (relation "eq"),
    which is the per-shard path's behavior whenever its capped-total
    proof does not fire.
  * a slot that fails to build or launch raises; nothing serves the
    stack on fewer slots than the grid has.

Lifecycle: the stacked view is rebuilt when any shard's engine
`change_generation` moves (refresh/merge/delete); stale snapshots keep
serving in-flight launches until the references die. A rebuild builds
again every view the previous snapshot had, copying the rows of
unchanged entries device to device from the previous stack (an entry
that now lands on another slot is copied to that slot's device; a
one-shard refresh re-extracts only that shard's rows), then lets the
previous stack go. Every other row is a device-to-device copy from the
owning executor's resident tensors, or one pinned asynchronous upload.
Every stacked view charges the device-memory ledger's ``mesh`` category
first, once for the whole stack as the reference does (not per slot or
per ``data`` copy), and the build DEGRADES to the per-shard path
(`MeshUnavailable`) instead of tripping the breaker when the budget
cannot fit it.

The reference's `_LAUNCH_LOCK` is not needed. It orders the
collectives' rendezvous across devices (two workers enqueueing
per-device programs in different orders would deadlock). The port has
no rendezvous: a slot's part is queued on its device's current stream,
and the copy of its pages to the coordinating device is stream-ordered
after it (PyTorch makes the destination stream wait on an event of the
source stream), so two workers' steps interleave freely and each merge
reads only its own step's pages.

Knobs (common/settings.py): ES_TPU_MESH (auto|force|off),
ES_TPU_MESH_DEVICES, ES_TPU_MESH_DATA, ES_TPU_MESH_T_MAX.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..common.settings import (
    batch_buckets,
    bucket_for,
    mesh_data_axis,
    mesh_devices_cap,
    mesh_mode,
    mesh_t_max,
)
from ..index.segment import INVALID_DOC, TILE
from ..ops import scoring
from ..ops.scoring import upload
from .mesh import DATA_AXIS, SHARD_AXIS, fold_factor, make_mesh
from .sharded import (
    Stacked,
    build_mesh_agg_step,
    build_mesh_ann_step,
    build_mesh_knn_step,
    build_mesh_rerank_step,
    build_mesh_sparse_step,
    build_mesh_text_step,
    unpack_page,
)

BPAD = scoring.BPAD

class MeshUnavailable(Exception):
    """The mesh path cannot serve this group (no devices, device-memory
    budget breach, slot overflow, unsupported plan shape). Callers
    degrade to the per-shard path — never an error surface. ``budget``
    marks the ledger degrade specifically."""

    def __init__(self, msg: str, budget: bool = False):
        super().__init__(msg)
        self.budget = budget


class MeshHit(NamedTuple):
    score: float
    shard: int
    segment: int
    local_doc: int
    doc_id: str


class MeshTopDocs(NamedTuple):
    """One query's globally merged mesh result. `snapshot` pins the
    reader generation the hits were scored against so the fetch phase
    reads the same point-in-time sources."""

    total: int
    relation: str
    max_score: Optional[float]
    hits: List[MeshHit]
    snapshot: "_MeshSnapshot"


def _on(device, x, dtype=None) -> torch.Tensor:
    """A row source on `device`: a resident tensor as it is (a device to
    device copy follows), a host array through one pinned upload."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    t = upload(np.ascontiguousarray(x), device)
    return t if dtype is None else t.to(dtype)


class _MeshSnapshot:
    """One generation's stacked device view of the index's shards."""

    def __init__(self, mesh, fold, entries, readers, executors, gens, device):
        self.mesh = mesh
        self.fold = fold
        self.device = device
        self.entries = entries  # [(sid, si)] in (shard, segment) asc order
        self.readers = readers  # sid -> ShardReader
        self.executors = executors  # sid -> TorchExecutor
        self.gens = gens
        g = mesh.shape[SHARD_AXIS]
        self.e_pad = g * fold
        self.n_docs_max = max(
            (readers[sid].segments[si].num_docs for sid, si in entries),
            default=1,
        )
        self.charges: List[Tuple[str, int]] = []
        self.live: Optional[Stacked] = None  # bool[E_pad, Nmax] (live ∧ in-range)
        self.text: Dict[object, dict] = {}  # field -> stacked text arrays
        self.knn: Dict[object, dict] = {}  # field -> stacked vector arrays
        self.aggs: Dict[tuple, dict] = {}  # stacked agg column views
        self.steps: Dict[tuple, object] = {}
        self.closed = False
        # ---- incremental rebuild state: per-entry identity keys
        # ((sid, shard generation, si) — a bumped shard invalidates ALL
        # its entries, since inverse norms / idf weights are shard-level
        # stats), every stacked view's device rows by key, and how to
        # build each view again on the next generation ----
        gen_of = dict(gens)
        self.entry_keys = [
            (sid, gen_of.get(sid), si) for sid, si in entries
        ]
        self.stacks: Dict[object, dict] = {}
        self.recipes: Dict[object, tuple] = {}
        # (prev entry_keys, prev stacks) while this snapshot is being
        # built; dropped at the end of the build so the previous
        # generation's device rows die on schedule
        self.reuse_src: Optional[tuple] = None

    @property
    def device_ids(self) -> Tuple[int, ...]:
        """One id per slot: a card's index (a card holding several
        slots repeats), a slot's position for the CPU."""
        return tuple(
            d.index if d.index is not None else i
            for i, d in enumerate(self.mesh.devices.ravel())
        )

    def alloc(self, tail, dtype, fill=0) -> Stacked:
        """A [E_pad, *tail] stack filled with `fill`, one fold per slot."""
        return Stacked.full(self.mesh, self.fold, tail, dtype, fill)

    def put(self, host: np.ndarray) -> Stacked:
        """A host [E_pad, ...] array, each slot's fold uploaded to it."""
        return Stacked.put(self.mesh, self.fold, host)

    @property
    def nbytes(self) -> int:
        return int(sum(n for _c, n in self.charges))

    def charge(self, nbytes: int) -> None:
        from ..common.memory import hbm_ledger

        if not hbm_ledger.would_fit(nbytes):
            hbm_ledger.note_degraded()
            raise MeshUnavailable(
                f"mesh stack of {nbytes} bytes exceeds the device-memory budget",
                budget=True,
            )
        hbm_ledger.add("mesh", nbytes, breaker=False)
        self.charges.append(("mesh", nbytes))

    def release(self) -> None:
        from ..common.memory import hbm_ledger

        self.closed = True
        charges, self.charges = self.charges, []
        for cat, nbytes in charges:
            hbm_ledger.release(cat, nbytes)


class MeshAggPlan:
    """A compiled mesh agg body — the batcher's ``mesh_agg`` job plan.
    ``sig`` groups structurally identical dashboard shapes into one
    launch; the query (match plan terms / match_all) varies per row.
    ``terms``/``boost``/``msm`` delegate to the match plan so the mesh
    text packers can treat agg jobs like match jobs."""

    def __init__(self, nodes, specs, mplan):
        self.nodes = nodes
        self.specs = specs
        self.mplan = mplan  # batcher MatchPlan | None (match_all)
        self.sig = (tuple(specs), mplan is not None)

    @property
    def terms(self):
        return self.mplan.terms if self.mplan is not None else ()

    @property
    def boost(self) -> float:
        return self.mplan.boost if self.mplan is not None else 1.0

    @property
    def msm(self) -> int:
        return self.mplan.msm if self.mplan is not None else 1


class MeshExecutor:
    """Whole-index serving engine of ONE index (owned by IndexService).

    The QueryBatcher routes same-plan query groups here (job kinds
    ``mesh_match`` / ``mesh_serve`` / ``mesh_knn`` / ``mesh_sparse`` /
    ``mesh_agg``): `dispatch_*` launches the step asynchronously,
    `collect_*` performs the one packed download and finishes the
    waiters — the same dispatch/collect split (and pipeline depth) as
    the per-shard families.
    """

    def __init__(self, service):
        self.service = service
        self._lock = threading.RLock()
        self._snapshot: Optional[_MeshSnapshot] = None
        self.stats = {
            "routed": 0,  # requests served start-to-finish by the mesh
            "launches": 0,  # steps dispatched
            "jobs": 0,  # queries carried by those steps
            "rebuilds": 0,  # snapshot rebuilds on generation bumps
            "incremental_rebuilds": 0,  # rebuilds that reused prev rows
            "entries_reused": 0,  # stacked rows copied, not re-extracted
            "degraded": 0,  # device-memory budget degrades to per-shard
            "fallbacks": 0,  # routed requests that fell back mid-flight
        }

    # ---- routing predicate ----

    def available(self) -> bool:
        mode = mesh_mode()
        if mode == "off":
            return False
        svc = self.service
        if svc.routing is not None and not self._all_shards_local():
            # distributed mode: the stack can only serve when every
            # shard has a queryable copy on this node
            return False
        if str(svc.settings.get("search.backend", "torch")) != "torch":
            return False
        if mode == "force":
            return True
        return len(self._devices()) >= 2 and svc.num_shards >= 2

    def _all_shards_local(self) -> bool:
        """Distributed-mode gate: every shard of the index must have a
        QUERYABLE copy here — an installed engine whose node is the
        primary or an in-sync replica."""
        svc = self.service
        if svc.local_node is None:
            return True
        for sid in range(svc.num_shards):
            if sid not in svc._local:
                return False
            e = svc._entry(sid) or {}
            if (e.get("primary") != svc.local_node
                    and svc.local_node not in (e.get("in_sync") or [])):
                return False
        return True

    def _devices(self) -> List[torch.device]:
        """The devices the mesh may span: the index's own device first
        (the coordinating device), then every other visible card,
        capped by ES_TPU_MESH_DEVICES. An index on the CPU gets the CPU
        alone."""
        own = torch.device(self.service.device)
        if own.type != "cuda":
            return [own]
        if own.index is None:
            own = torch.device("cuda", torch.cuda.current_device())
        devs = [own] + [
            torch.device("cuda", i)
            for i in range(torch.cuda.device_count())
            if i != own.index
        ]
        cap = mesh_devices_cap()
        return devs[:cap] if cap else devs

    @property
    def device_ids(self) -> Tuple[int, ...]:
        snap = self._snapshot
        if snap is not None and not snap.closed:
            return snap.device_ids
        return tuple(
            d.index if d.index is not None else i
            for i, d in enumerate(self._devices())
        )

    # ---- snapshot lifecycle ----

    def _gens(self) -> tuple:
        svc = self.service
        try:
            return tuple(
                (sid, svc.local_shard(sid).change_generation)
                for sid in range(svc.num_shards)
            )
        except KeyError as e:
            # a shard relocated away between available() and here: the
            # caller degrades to the per-shard path for this request
            raise MeshUnavailable(str(e))

    def ensure_snapshot(self) -> _MeshSnapshot:
        gens = self._gens()
        snap = self._snapshot
        if snap is not None and not snap.closed and snap.gens == gens:
            return snap
        with self._lock:
            snap = self._snapshot
            gens = self._gens()
            if snap is not None and not snap.closed and snap.gens == gens:
                return snap
            new = self._build_snapshot(gens)
            old, self._snapshot = self._snapshot, new
            if old is not None:
                self.stats["rebuilds"] += 1
                # in-flight launches hold their own snapshot reference;
                # the ledger charge is released now, the tensors die with
                # the last reference (same contract as executor close)
                old.release()
            return new

    def _build_snapshot(self, gens) -> _MeshSnapshot:
        from ..search.executor_torch import TorchExecutor

        svc = self.service
        readers = {}
        executors = {}
        entries = []
        for sid in range(svc.num_shards):
            try:
                shard = svc.local_shard(sid)
            except KeyError as e:
                raise MeshUnavailable(str(e))
            ex = svc._executor(shard)
            if not isinstance(ex, TorchExecutor):
                raise MeshUnavailable("numpy backend shard")
            executors[sid] = ex
            readers[sid] = ex.reader
            for si, seg in enumerate(ex.reader.segments):
                if seg.num_docs > 0:
                    entries.append((sid, si))
        if not entries:
            raise MeshUnavailable("index has no live segments")
        devices = self._devices()
        if not devices:
            raise MeshUnavailable("no devices")
        n_data = mesh_data_axis()
        if BPAD % n_data or n_data > len(devices):
            n_data = 1
        mesh = make_mesh(len(entries), n_data=n_data, devices=devices)
        fold = fold_factor(mesh, len(entries))
        snap = _MeshSnapshot(
            mesh, fold, entries, readers, executors, gens, devices[0]
        )
        # incremental rebuild: the PREVIOUS snapshot's stacks lend the
        # rows of unchanged entries while this one builds
        old = self._snapshot
        if old is not None and not old.closed and old.stacks:
            snap.reuse_src = (old.entry_keys, old.stacks)
        # live ∧ in-range mask, shared by every family (one small upload)
        live = np.zeros((snap.e_pad, snap.n_docs_max), bool)
        for e, (sid, si) in enumerate(entries):
            n = readers[sid].segments[si].num_docs
            lv = readers[sid].live_docs[si]
            live[e, :n] = True if lv is None else lv
        snap.charge(live.nbytes)
        snap.live = snap.put(live)
        try:
            if old is not None and not old.closed:
                # every view the previous generation served is built
                # again now, while its rows can still be copied
                for key, (name, args) in list(old.recipes.items()):
                    try:
                        getattr(self, name)(snap, *args)
                    except MeshUnavailable as e:
                        if e.budget:
                            raise
        except MeshUnavailable:
            snap.release()
            raise
        finally:
            snap.reuse_src = None
        return snap

    def _fill_stack(self, snap, key, arrays, fill_entry) -> int:
        """Fills the leading-entry-axis rows of a stacked view (row 0's
        copy, then `replicate` to the other ``data`` rows):
        entries whose (sid, shard-generation, si) key is unchanged from
        the previous snapshot copy their previous row device to device
        (same row envelope required); everything else fills through
        `fill_entry`. Registers the stack for the NEXT rebuild and
        returns the reused row count."""
        prev_map = None
        prev_arrays = None
        if snap.reuse_src is not None:
            prev_keys, prev_stacks = snap.reuse_src
            got = prev_stacks.get(key)
            # ROW-shape compatibility only: appending a segment changes
            # the entry padding (leading axis) but unchanged shards'
            # rows still copy over as long as the per-row envelope
            # (t_max / n_docs_max / dims) is stable
            if got is not None and set(got) >= set(arrays) and all(
                got[name].shape[1:] == arr.shape[1:]
                and got[name].dtype == arr.dtype
                for name, arr in arrays.items()
            ):
                prev_arrays = got
                prev_map = {k: i for i, k in enumerate(prev_keys)}
        reused = 0
        for e in range(len(snap.entries)):
            pi = (
                prev_map.get(snap.entry_keys[e])
                if prev_map is not None
                else None
            )
            if pi is not None:
                # the previous stack's row may sit on another slot's
                # device: copy_ moves it device to device
                for name, arr in arrays.items():
                    arr[e].copy_(prev_arrays[name][pi])
                reused += 1
            else:
                fill_entry(e)
        for arr in arrays.values():
            arr.replicate()
        if reused:
            self.stats["entries_reused"] += reused
            if not getattr(snap, "_counted_incremental", False):
                snap._counted_incremental = True
                self.stats["incremental_rebuilds"] += 1
        snap.stacks[key] = arrays
        return reused

    def close(self) -> None:
        with self._lock:
            snap, self._snapshot = self._snapshot, None
            if snap is not None:
                snap.release()

    # ---- stacked field views (lazy, per snapshot) ----

    def _text_view(self, snap: _MeshSnapshot, field: str) -> dict:
        view = snap.text.get(field)
        if view is not None:
            return view
        with self._lock:
            view = snap.text.get(field)
            if view is not None:
                return view
            bmxs = []
            t_max = 1
            for sid, si in snap.entries:
                bmx = snap.executors[sid].block_index(si, field)
                bmxs.append(bmx)
                if bmx is not None:
                    t_max = max(t_max, int(bmx.tiling.doc_ids.shape[0]))
            E, n_max = snap.e_pad, snap.n_docs_max
            snap.charge(E * t_max * TILE * 8 + E * n_max * 4)
            doc_ids = snap.alloc((t_max, TILE), torch.int32, INVALID_DOC)
            tfs = snap.alloc((t_max, TILE), torch.int32)
            inv = snap.alloc((n_max,), torch.float32)

            def _fill_text(e: int) -> None:
                sid, si = snap.entries[e]
                bmx = bmxs[e]
                dev = doc_ids[e].device
                if bmx is not None:
                    nt = int(bmx.tiling.doc_ids.shape[0])
                    doc_ids[e, :nt].copy_(_on(dev, bmx.tiling.doc_ids))
                    tfs[e, :nt].copy_(_on(dev, bmx.tiling.tfs))
                n = snap.readers[sid].segments[si].num_docs
                inv[e, :n].copy_(_on(dev, snap.executors[sid]._inv_norm(si, field, n)))

            # unchanged-shard rows copy from the previous generation's
            # stack (no tiling or norm re-extract)
            self._fill_stack(
                snap,
                ("text", field),
                {"doc_ids": doc_ids, "tfs": tfs, "inv": inv},
                _fill_text,
            )
            view = {
                "doc_ids": doc_ids,
                "tfs": tfs,
                "inv_norm": inv,
                "bmxs": bmxs,
            }
            snap.text[field] = view
            snap.recipes[("text", field)] = ("_text_view", (field,))
            return view

    def _knn_view(self, snap: _MeshSnapshot, field: str) -> dict:
        view = snap.knn.get(field)
        if view is not None:
            return view
        with self._lock:
            view = snap.knn.get(field)
            if view is not None:
                return view
            mats = []
            for sid, si in snap.entries:
                vf = snap.readers[sid].segments[si].vectors.get(field)
                if vf is None:
                    mats.append(None)
                    continue
                mat = (
                    vf.unit_vectors
                    if vf.similarity == "cosine" and vf.unit_vectors is not None
                    else vf.vectors
                )
                mats.append((mat, vf))
            present = [m for m in mats if m is not None]
            if not present:
                raise MeshUnavailable(f"no entry has vector field [{field}]")
            dims = int(present[0][0].shape[1])
            similarity = present[0][1].similarity
            dtype = np.result_type(*[m[0].dtype for m in present])
            n_per_entry = np.zeros(snap.e_pad, np.int64)
            for e, (sid, si) in enumerate(snap.entries):
                got = mats[e]
                if got is None:
                    continue
                mat, vf = got
                if int(mat.shape[1]) != dims or vf.similarity != similarity:
                    raise MeshUnavailable(
                        f"vector field [{field}] has mixed dims/similarity"
                    )
                n_per_entry[e] = snap.readers[sid].segments[si].num_docs
            E, n_max = snap.e_pad, snap.n_docs_max
            tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
            snap.charge(E * n_max * dims * np.dtype(dtype).itemsize + E * n_max)
            vectors = snap.alloc((n_max, dims), tdtype)
            cand = snap.alloc((n_max,), torch.bool)

            def _fill_knn(e: int) -> None:
                if mats[e] is None:
                    return
                sid, si = snap.entries[e]
                ex = snap.executors[sid]
                n = int(n_per_entry[e])
                dev = vectors[e].device
                # the executor's resident column (uploaded once per
                # generation): a device-to-device copy
                mat_dev, _exists = ex.device_segments[si].vectors[field]
                vectors[e, :n].copy_(_on(dev, mat_dev, tdtype))
                cand[e, :n].copy_(_on(dev, ex.knn_candidates(si, field)))

            self._fill_stack(
                snap,
                ("knn", field, dims, similarity),
                {"vectors": vectors, "cand": cand},
                _fill_knn,
            )
            view = {
                "vectors": vectors,
                "cand": cand,
                "dims": dims,
                "similarity": similarity,
                "n_per_entry": n_per_entry,
            }
            snap.knn[field] = view
            snap.recipes[("knn", field)] = ("_knn_view", (field,))
            return view

    def _sparse_view(
        self, snap: _MeshSnapshot, field: str, quantized: bool
    ) -> dict:
        """Stacked impact-ordered postings for one `sparse_vector`
        field: each entry's tile planes padded to the widest tile count,
        plus the per-entry SparseField handles (each entry has its OWN
        term dictionary / tile layout / dequant scales, so plan packing
        resolves per entry). Only the serving column for this
        `quantized` mode is stacked."""
        key = ("sparse", field, bool(quantized))
        view = snap.text.get(key)
        if view is not None:
            return view
        with self._lock:
            view = snap.text.get(key)
            if view is not None:
                return view
            sfs = []
            t_max = 1
            for sid, si in snap.entries:
                sf = (
                    getattr(snap.readers[sid].segments[si], "sparse", None)
                    or {}
                ).get(field)
                sfs.append(sf)
                if sf is not None:
                    t_max = max(t_max, int(sf.n_tiles))
            if all(sf is None for sf in sfs):
                raise MeshUnavailable(
                    f"no entry has sparse_vector field [{field}]"
                )
            vdtype = torch.int8 if quantized else torch.float32
            E = snap.e_pad
            snap.charge(E * t_max * TILE * (4 + (1 if quantized else 4)))
            doc_ids = snap.alloc((t_max, TILE), torch.int32, INVALID_DOC)
            values = snap.alloc((t_max, TILE), vdtype)

            def _fill_sparse(e: int) -> None:
                sf = sfs[e]
                if sf is None or not sf.n_tiles:
                    return
                sid, si = snap.entries[e]
                nt = int(sf.n_tiles)
                # the executor's resident impact planes when it has them
                sc = snap.executors[sid].impact_scorer(si, field, quantized)
                src_d = sc.doc_ids if sc is not None else sf.doc_ids
                src_v = sc.values if sc is not None else (
                    sf.qweights if quantized else sf.weights
                )
                dev = doc_ids[e].device
                doc_ids[e, :nt].copy_(_on(dev, src_d))
                values[e, :nt].copy_(_on(dev, src_v))

            self._fill_stack(
                snap, key, {"doc_ids": doc_ids, "values": values}, _fill_sparse,
            )
            view = {"doc_ids": doc_ids, "values": values, "sfs": sfs}
            snap.text[key] = view
            snap.recipes[key] = ("_sparse_view", (field, bool(quantized)))
            return view

    def _ann_view(self, snap: _MeshSnapshot, field: str, spec) -> dict:
        """Stacked IVF view: per-entry centroids, cluster-major permuted
        blocks + CSR bounds (ops/ivf.py's layout), each entry's block
        copied device to device from its OWNING executor's
        IvfSegmentIndex, so the mesh probes the exact same centroids and
        permutation as the per-shard path — parity by construction. Any
        entry without an index (small-segment floor, budget degrade)
        raises MeshUnavailable and the per-shard coordinator serves the
        request with its own exact floor."""
        key = ("ann", field, spec)
        view = snap.knn.get(key)
        if view is not None:
            return view
        with self._lock:
            view = snap.knn.get(key)
            if view is not None:
                return view
            idxs = []
            for sid, si in snap.entries:
                idx = snap.executors[sid].ann_index(si, field, spec)
                if idx is None:
                    raise MeshUnavailable(
                        f"entry [{sid}][{si}] has no IVF index for "
                        f"[{field}] (exact floor / budget degrade)"
                    )
                idxs.append(idx)
            dims = idxs[0].dims
            similarity = idxs[0].similarity
            for idx in idxs:
                if idx.dims != dims or idx.similarity != similarity:
                    raise MeshUnavailable(
                        f"vector field [{field}] has mixed dims/similarity"
                    )
            quant = bool(spec.quantized) and all(
                i.qvecs_flat is not None for i in idxs
            )
            E, n_max = snap.e_pad, snap.n_docs_max
            nlist_max = max(i.nlist for i in idxs)
            fmax = max(int(i.perm.shape[0]) for i in idxs)
            vdt = torch.int8 if quant else idxs[0].vecs_flat.dtype
            for i in idxs:
                if not quant and i.vecs_flat.dtype != vdt:
                    raise MeshUnavailable(f"vector field [{field}] has mixed dtypes")
            l2 = similarity == "l2_norm"
            itemsize = torch.zeros(0, dtype=vdt).element_size()
            snap.charge(
                E * nlist_max * (dims * 4 + 8)
                + E * fmax * (4 + dims * itemsize)
                + E * n_max
                + (E * fmax * 4 if quant else 0) + (E * fmax * 4 if l2 else 0)
            )
            cents = snap.alloc((nlist_max, dims), torch.float32)
            starts = snap.alloc((nlist_max,), torch.int32)
            counts = snap.alloc((nlist_max,), torch.int32)
            perm = snap.alloc((fmax,), torch.int32)
            vecs = snap.alloc((fmax, dims), vdt)
            scales = snap.alloc((fmax,), torch.float32) if quant else None
            v2 = snap.alloc((fmax,), torch.float32) if l2 else None
            cand = snap.alloc((n_max,), torch.bool)
            n_per_entry = np.zeros(E, np.int64)
            layout = []
            for e, ((sid, si), idx) in enumerate(zip(snap.entries, idxs)):
                nl, F = idx.nlist, int(idx.perm.shape[0])
                n = snap.readers[sid].segments[si].num_docs
                cents[e, :nl].copy_(idx.centroids)
                starts[e, :nl].copy_(idx.starts)
                counts[e, :nl].copy_(idx.counts)
                perm[e, :F].copy_(idx.perm)
                if quant:
                    vecs[e, :F].copy_(idx.qvecs_flat)
                    scales[e, :F].copy_(idx.scales_flat)
                else:
                    vecs[e, :F].copy_(idx.vecs_flat)
                if l2:
                    v2[e, :F].copy_(idx.v2_flat)
                # exists ∧ live in doc order (the probe permutes it)
                cand[e, :n].copy_(snap.executors[sid].knn_candidates(si, field))
                n_per_entry[e] = n
                layout.append((int(idx.n), nl, F, int(idx.cmax)))
            for arr in (cents, starts, counts, perm, vecs, scales, v2, cand):
                if arr is not None:
                    arr.replicate()
            view = {
                "centroids": cents,
                "starts": starts,
                "counts": counts,
                "perm": perm,
                "vecs": vecs,
                "scales": scales,
                "v2": v2,
                "cand": cand,
                "dims": dims,
                "similarity": similarity,
                "cmax": max(i.cmax for i in idxs),
                "layout": layout,
                "nlists": [i.nlist for i in idxs],
                "n_per_entry": n_per_entry,
            }
            snap.knn[key] = view
            snap.recipes[key] = ("_ann_view", (field, spec))
            return view

    def _ann_step(self, snap, field, spec, kc):
        key = ("ann_step", field, spec, kc)
        step = snap.steps.get(key)
        if step is None:
            with self._lock:
                step = snap.steps.get(key)
                if step is None:
                    view = self._ann_view(snap, field, spec)
                    step = build_mesh_ann_step(
                        snap.mesh,
                        view["centroids"],
                        view["starts"],
                        view["counts"],
                        view["perm"],
                        view["vecs"],
                        view["scales"],
                        view["v2"],
                        view["cand"],
                        view["similarity"],
                        spec.nprobe,
                        kc,
                        view["layout"],
                    )
                    snap.steps[key] = step
        return step

    # ---- stacked aggregation views (lazy, per snapshot) ----

    def _agg_num_view(self, snap: _MeshSnapshot, field: str) -> dict:
        """Stacked float64 doc-value column (min/max — the dtype the
        per-shard engine keeps), exact int32 copy (sums), and exists
        mask [E, Nmax]."""
        from ..search import aggs_device

        key = ("num", field)
        view = snap.aggs.get(key)
        if view is not None:
            return view
        with self._lock:
            view = snap.aggs.get(key)
            if view is not None:
                return view
            vals = np.zeros((snap.e_pad, snap.n_docs_max), np.float64)
            ivals = np.zeros((snap.e_pad, snap.n_docs_max), np.int32)
            exists = np.zeros((snap.e_pad, snap.n_docs_max), bool)
            for e, (sid, si) in enumerate(snap.entries):
                nf = snap.readers[sid].segments[si].numerics.get(field)
                if nf is None:
                    continue
                n = len(nf.values)
                vals[e, :n] = nf.values.astype(np.float64)
                exists[e, :n] = nf.exists
                p = aggs_device.col_profile(snap.executors[sid], si, field)
                if p.sum_exact and p.n_exist:
                    col = np.zeros(n, np.int32)
                    col[nf.exists] = (
                        nf.values[nf.exists].astype(np.int64).astype(np.int32)
                    )
                    ivals[e, :n] = col
            snap.charge(vals.nbytes + ivals.nbytes + exists.nbytes)
            view = {
                "values": snap.put(vals),
                "ivalues": snap.put(ivals),
                "exists": snap.put(exists),
            }
            snap.aggs[key] = view
            snap.recipes[("agg",) + key] = ("_agg_num_view", (field,))
            return view

    def _agg_ord_view(self, snap: _MeshSnapshot, field: str) -> dict:
        """GLOBAL ordinal table + stacked per-entry multi-value CSR
        mapped onto it: the ordinal-table union across the entries
        happens here at snapshot build, so the step only scatter-adds
        per-entry count vectors and sums them."""
        key = ("ord", field)
        view = snap.aggs.get(key)
        if view is not None:
            return view
        with self._lock:
            view = snap.aggs.get(key)
            if view is not None:
                return view
            per_entry = []
            vocab = set()
            l_max = 1
            for sid, si in snap.entries:
                of = snap.readers[sid].segments[si].ordinals.get(field)
                per_entry.append(of)
                if of is not None:
                    vocab.update(of.ord_terms)
                    l_max = max(l_max, len(of.mv_ords))
            gterms = sorted(vocab)
            gmap = {t: i for i, t in enumerate(gterms)}
            gords = np.zeros((snap.e_pad, l_max), np.int32)
            edocs = np.zeros((snap.e_pad, l_max), np.int32)
            evalid = np.zeros((snap.e_pad, l_max), bool)
            for e, of in enumerate(per_entry):
                if of is None or not len(of.mv_ords):
                    continue
                L = len(of.mv_ords)
                remap = np.array([gmap[t] for t in of.ord_terms], np.int32)
                gords[e, :L] = remap[of.mv_ords]
                edocs[e, :L] = np.repeat(
                    np.arange(len(of.mv_offsets) - 1, dtype=np.int32),
                    np.diff(of.mv_offsets),
                )
                evalid[e, :L] = True
            snap.charge(gords.nbytes + edocs.nbytes + evalid.nbytes)
            view = {
                "gterms": gterms,
                "gords": snap.put(gords),
                "edocs": snap.put(edocs),
                "evalid": snap.put(evalid),
            }
            snap.aggs[key] = view
            snap.recipes[("agg",) + key] = ("_agg_ord_view", (field,))
            return view

    def _agg_histo_view(
        self, snap: _MeshSnapshot, field: str, interval: int, offset: int
    ) -> dict:
        """Stacked GLOBAL-relative histogram bucket ids (host int64
        floor-division, exact at any span) + exists [E, Nmax]."""
        key = ("histo", field, int(interval), int(offset))
        view = snap.aggs.get(key)
        if view is not None:
            return view
        with self._lock:
            view = snap.aggs.get(key)
            if view is not None:
                return view
            qs = []
            for sid, si in snap.entries:
                nf = snap.readers[sid].segments[si].numerics.get(field)
                if nf is None or not nf.exists.any():
                    qs.append(None)
                    continue
                qs.append(
                    (nf.values[nf.exists].astype(np.int64) - offset) // interval
                )
            qmins = [int(q.min()) for q in qs if q is not None]
            if not qmins:
                raise MeshUnavailable(f"no entry has field [{field}]")
            qmin = min(qmins)
            nb = max(int(q.max()) for q in qs if q is not None) - qmin + 1
            from ..search.aggs_device import MAX_DEVICE_BUCKETS

            if nb > MAX_DEVICE_BUCKETS:
                raise MeshUnavailable(f"histogram would make {nb} buckets")
            ids = np.zeros((snap.e_pad, snap.n_docs_max), np.int32)
            exists = np.zeros((snap.e_pad, snap.n_docs_max), bool)
            for e, ((sid, si), q) in enumerate(zip(snap.entries, qs)):
                if q is None:
                    continue
                nf = snap.readers[sid].segments[si].numerics.get(field)
                n = len(nf.values)
                col = np.zeros(n, np.int32)
                col[nf.exists] = (q - qmin).astype(np.int32)
                ids[e, :n] = col
                exists[e, :n] = nf.exists
            snap.charge(ids.nbytes + exists.nbytes)
            view = {
                "qmin": qmin,
                "nb": nb,
                "nbpad": scoring.next_bucket(nb, 16),
                "ids": snap.put(ids),
                "exists": snap.put(exists),
            }
            snap.aggs[key] = view
            snap.recipes[("agg",) + key] = (
                "_agg_histo_view", (field, int(interval), int(offset))
            )
            return view

    # ---- step cache ----

    def _text_step(self, snap, fields, kb, t_shapes, with_cnt,
                   count_signed, combine, tie):
        key = ("text", fields, kb, t_shapes, with_cnt, count_signed,
               combine, tie)
        step = snap.steps.get(key)
        if step is None:
            with self._lock:
                step = snap.steps.get(key)
                if step is None:
                    views = [self._text_view(snap, f) for f in fields]
                    step = build_mesh_text_step(
                        snap.mesh,
                        [v["doc_ids"] for v in views],
                        [v["tfs"] for v in views],
                        [v["inv_norm"] for v in views],
                        snap.live,
                        kb,
                        with_cnt=with_cnt,
                        count_signed=count_signed,
                        combine=combine,
                        tie=tie,
                    )
                    snap.steps[key] = step
        return step

    def _rerank_view(self, snap: _MeshSnapshot, model) -> dict:
        """Stacked `rank_vectors` view for one RerankModel: per-entry
        CSR bounds over LOCAL doc ids plus each entry's flat token
        block (tail-padded with `tmax` zero rows, the ops/ivf gather
        trick), int8 + per-token scales for quantized models. Entries
        without the field read as zero-token docs (maxsim 0) — exactly
        the per-shard column's semantics."""
        key = ("rerank", model)
        view = snap.text.get(key)
        if view is not None:
            return view
        with self._lock:
            view = snap.text.get(key)
            if view is not None:
                return view
            from ..models import rerank as rerank_model

            n_max = snap.n_docs_max
            # per entry, the per-shard column's gather width (one live
            # segment per shard: the segment's own max tokens per doc)
            entry_tmax = [1] * snap.e_pad
            flat_max = 1
            mvfs = []
            for e, (sid, si) in enumerate(snap.entries):
                mvf = snap.readers[sid].segments[si].multi_vectors.get(model.field)
                mvfs.append(mvf)
                if mvf is not None and len(mvf.tok_vectors):
                    entry_tmax[e] = max(1, mvf.max_tokens)
                    flat_max = max(flat_max, int(len(mvf.tok_vectors)))
            tmax = max(entry_tmax)
            dims = int(model.dims) or next(
                (
                    int(m.tok_vectors.shape[1])
                    for m in mvfs
                    if m is not None and len(m.tok_vectors)
                ),
                1,
            )
            fmax = flat_max + tmax
            starts = np.zeros((snap.e_pad, n_max), np.int32)
            counts = np.zeros((snap.e_pad, n_max), np.int32)
            toks = np.zeros((snap.e_pad, fmax, dims), np.float32)
            for e, mvf in enumerate(mvfs):
                if mvf is None or not len(mvf.tok_vectors):
                    continue
                n = len(mvf.tok_offsets) - 1
                offs = mvf.tok_offsets.astype(np.int64)
                starts[e, :n] = offs[:-1]
                counts[e, :n] = np.diff(offs)
                toks[e, : len(mvf.tok_vectors)] = mvf.tok_vectors
            scales_dev = None
            if model.quantized:
                flat = toks.reshape(-1, dims)
                qv, scales = rerank_model.quantize_tokens(flat)
                toks_q = qv.reshape(snap.e_pad, fmax, dims)
                scales = scales.reshape(snap.e_pad, fmax)
                snap.charge(starts.nbytes + counts.nbytes + toks_q.nbytes + scales.nbytes)
                toks_dev = snap.put(toks_q)
                scales_dev = snap.put(scales)
            else:
                snap.charge(starts.nbytes + counts.nbytes + toks.nbytes)
                toks_dev = snap.put(toks)
            view = {
                "starts": snap.put(starts),
                "counts": snap.put(counts),
                "toks": toks_dev,
                "scales": scales_dev,
                "tmax": int(tmax),
                "entry_tmax": tuple(entry_tmax),
                "dims": dims,
            }
            snap.text[key] = view
            snap.recipes[key] = ("_rerank_view", (model,))
            return view

    def _rerank_step(self, snap, field, kb, t_shape, with_cnt, model,
                     k_req, window, qb):
        key = ("rerank", field, model, kb, t_shape, with_cnt, k_req,
               window, qb)
        step = snap.steps.get(key)
        if step is None:
            with self._lock:
                step = snap.steps.get(key)
                if step is None:
                    view = self._text_view(snap, field)
                    rview = self._rerank_view(snap, model)
                    step = build_mesh_rerank_step(
                        snap.mesh,
                        view["doc_ids"],
                        view["tfs"],
                        view["inv_norm"],
                        snap.live,
                        rview["starts"],
                        rview["counts"],
                        rview["toks"],
                        rview["scales"],
                        kb,
                        k_req,
                        window,
                        rview["entry_tmax"],
                        with_cnt=with_cnt,
                    )
                    snap.steps[key] = step
        return step

    def _knn_step(self, snap, field, kc):
        key = ("knn", field, kc)
        step = snap.steps.get(key)
        if step is None:
            with self._lock:
                step = snap.steps.get(key)
                if step is None:
                    view = self._knn_view(snap, field)
                    step = build_mesh_knn_step(
                        snap.mesh,
                        view["vectors"],
                        view["cand"],
                        view["similarity"],
                        kc,
                        n_per_entry=view["n_per_entry"],
                    )
                    snap.steps[key] = step
        return step

    def _sparse_step(self, snap, field, quantized, kb, t_shape):
        key = ("sparse", field, bool(quantized), kb, t_shape)
        step = snap.steps.get(key)
        if step is None:
            with self._lock:
                step = snap.steps.get(key)
                if step is None:
                    view = self._sparse_view(snap, field, quantized)
                    step = build_mesh_sparse_step(
                        snap.mesh,
                        view["doc_ids"],
                        view["values"],
                        snap.live,
                        kb,
                    )
                    snap.steps[key] = step
        return step

    # ---- plan packing (host side; mirrors the per-shard builders) ----

    def _rows_for(self, snap, n_jobs: int) -> int:
        """The launch's query-row bucket: the same pad-bucket ladder as
        the per-shard batcher, constrained to a multiple of the mesh
        ``data`` axis, so routing a single query through the mesh doesn't
        reintroduce the full BPAD-row floor."""
        n_data = int(snap.mesh.shape.get(DATA_AXIS, 1))
        return min(
            bucket_for(n_jobs, batch_buckets(BPAD), multiple_of=n_data),
            max(BPAD, n_data),
        )

    @staticmethod
    def _lay_out(snap, lists, t_max, rows):
        T = scoring.next_bucket(t_max)
        ti_a = np.zeros((snap.e_pad, rows, T), np.int32)
        tw_a = np.zeros((snap.e_pad, rows, T), np.float32)
        tv_a = np.zeros((snap.e_pad, rows, T), bool)
        for e, row in enumerate(lists):
            for ji, (ti, tw) in enumerate(row):
                if ti is None or not len(ti):
                    continue
                ti_a[e, ji, : len(ti)] = ti
                tw_a[e, ji, : len(ti)] = tw
                tv_a[e, ji, : len(ti)] = True
        return ti_a, tw_a, tv_a, T

    def _pack_match(self, snap, view, jobs, t_cap, rows: int):
        """Per-(entry, job) tile plans in EXACTLY the per-shard
        _run_group order: BlockMaxIndex.plan term order, all tiles
        essential (no pruning on the mesh path)."""
        lists: List[List[Tuple[np.ndarray, np.ndarray]]] = []
        t_max = 1
        slots = 0
        for e in range(len(snap.entries)):
            bmx = view["bmxs"][e]
            row = []
            for j in jobs:
                if bmx is None:
                    row.append((None, None))
                    continue
                plans = bmx.plan(list(j.plan.terms), j.plan.boost)
                tl = [
                    np.arange(p.tile_start, p.tile_start + p.tile_count, dtype=np.int64)
                    for p in plans
                ]
                wl = [np.full(p.tile_count, p.weight, np.float32) for p in plans]
                ti = np.concatenate(tl) if tl else np.empty(0, np.int64)
                tw = np.concatenate(wl) if wl else np.empty(0, np.float32)
                if len(ti) > t_cap:
                    raise MeshUnavailable(
                        f"match plan overflows mesh tile cap [{t_cap}]"
                    )
                t_max = max(t_max, len(ti))
                slots += len(ti)
                row.append((ti, tw))
            lists.append(row)
        ti_a, tw_a, tv_a, T = self._lay_out(snap, lists, t_max, rows)
        return ti_a, tw_a, tv_a, T, slots

    def _pack_serve_field(self, snap, view, jobs, field, t_cap, rows: int):
        """One field's signed-weight tile plans (the MultiFusedScorer
        weight-sign convention of TorchExecutor.fused_plan_field: w =
        weights[tid] * boost * term_boost, negated when the term only
        scores)."""
        lists = []
        t_max = 1
        slots = 0
        for e in range(len(snap.entries)):
            bmx = view["bmxs"][e]
            row = []
            for j in jobs:
                group = next(g for g in j.plan.groups if g.field == field)
                if bmx is None:
                    row.append((None, None))
                    continue
                tiling = bmx.tiling
                tl: List[np.ndarray] = []
                wl: List[np.ndarray] = []
                for t, tb, counted in group.terms:
                    tid = bmx._term_index.get(t)
                    if tid is None or not int(tiling.term_tile_count[tid]):
                        continue
                    w = float(bmx.weights[tid]) * j.plan.boost * tb
                    if w < 0.0:
                        raise MeshUnavailable("negative term weight")
                    if w == 0.0:
                        w = 1e-30
                    if not counted:
                        w = -w
                    s0 = int(tiling.term_tile_start[tid])
                    c = int(tiling.term_tile_count[tid])
                    tl.append(np.arange(s0, s0 + c, dtype=np.int64))
                    wl.append(np.full(c, w, np.float32))
                ti = np.concatenate(tl) if tl else np.empty(0, np.int64)
                tw = np.concatenate(wl) if wl else np.empty(0, np.float32)
                if len(ti) > t_cap:
                    raise MeshUnavailable(
                        f"serve plan overflows mesh tile cap [{t_cap}]"
                    )
                t_max = max(t_max, len(ti))
                slots += len(ti)
                row.append((ti, tw))
            lists.append(row)
        ti_a, tw_a, tv_a, T = self._lay_out(snap, lists, t_max, rows)
        return ti_a, tw_a, tv_a, T, slots

    def _pack_sparse(self, snap, view, jobs, quantized, t_cap, rows: int):
        """Per-(entry, job) impact-tile plans in EXACTLY the per-shard
        _dispatch_sparse_group order: ops/impact.impact_tile_lists term
        order with each entry's dequant scales folded on host, every
        tile essential (no pruning on the mesh path)."""
        from ..ops import impact as impact_ops

        lists: List[List[Tuple[Optional[np.ndarray], Optional[np.ndarray]]]] = []
        t_max = 1
        slots = 0
        for e in range(len(snap.entries)):
            sf = view["sfs"][e]
            row = []
            for j in jobs:
                if sf is None or not sf.n_tiles:
                    row.append((None, None))
                    continue
                _tids, tws, _bws, starts, counts = impact_ops.impact_tile_lists(
                    sf, j.plan.terms, j.plan.weights, quantized
                )
                tl = [
                    np.arange(s0, s0 + c, dtype=np.int64)
                    for s0, c in zip(starts, counts)
                ]
                wl = [np.full(int(c), w, np.float32) for c, w in zip(counts, tws)]
                ti = np.concatenate(tl) if tl else np.empty(0, np.int64)
                tw = np.concatenate(wl) if wl else np.empty(0, np.float32)
                if len(ti) > t_cap:
                    raise MeshUnavailable(
                        f"sparse plan overflows mesh tile cap [{t_cap}]"
                    )
                t_max = max(t_max, len(ti))
                slots += len(ti)
                row.append((ti, tw))
            lists.append(row)
        ti_a, tw_a, tv_a, T = self._lay_out(snap, lists, t_max, rows)
        return ti_a, tw_a, tv_a, T, slots

    def _launched(self, jobs) -> None:
        with self._lock:
            self.stats["launches"] += 1
            self.stats["jobs"] += len(jobs)

    # ---- dispatch / collect (batcher worker entry points) ----

    def dispatch_match(self, jobs, kb: int):
        snap = self.ensure_snapshot()
        field = jobs[0].plan.field
        view = self._text_view(snap, field)
        rows = self._rows_for(snap, len(jobs))
        ti, tw, tv, T, slots = self._pack_match(
            snap, view, jobs, mesh_t_max(), rows
        )
        msm = np.ones(rows, np.int32)
        msm[: len(jobs)] = [j.plan.msm for j in jobs]
        with_cnt = any(j.plan.msm > 1 for j in jobs)
        rescore = getattr(jobs[0].plan, "rescore", None)
        if rescore is not None:
            return self._dispatch_match_rescore(
                snap, jobs, field, kb, rows, ti, tw, tv, msm, with_cnt,
                slots, rescore,
            )
        step = self._text_step(
            snap, (field,), kb, (T,), with_cnt, False, "sum", 0.0
        )
        out = step((ti,), (tw,), (tv,), msm)
        self._launched(jobs)
        flops = scoring.text_plan_flops(slots, 0, 0)
        return {"snap": snap, "out": out, "tail": 1, "flops": flops, "rows": rows}

    def _dispatch_match_rescore(self, snap, jobs, field, kb, rows,
                                ti, tw, tv, msm, with_cnt, slots,
                                rescore):
        """The fused first-stage + rerank launch: each entry rescores
        its own local top-k BEFORE the merge, so the merge sees
        already-reranked candidates. Routing precondition: one live
        segment per shard — that makes the per-entry window identical to
        the per-shard path's post-merge window, so the two paths
        agree."""
        from ..common.faults import faults as _faults
        from ..models import rerank as rerank_model
        from ..ops import rerank as rerank_ops

        model, spec = rescore
        _faults.check("rerank.score", field=model.field, mesh=1)
        sids = [sid for sid, _si in snap.entries]
        if len(set(sids)) != len(sids):
            raise MeshUnavailable(
                "mesh rescore needs one live segment per shard"
            )
        rview = self._rerank_view(snap, model)
        k_req = int(jobs[0].k)
        window = min(int(spec.window_size), k_req)
        qv = rerank_model.prepare_query_vectors(
            spec.query_vectors, model.dims, model.similarity
        )
        qb = max(4, scoring.next_bucket(max(len(qv), 1), 4))
        qtoks = np.zeros((rows, qb, rview["dims"]), np.float32)
        qvalid = np.zeros((rows, qb), bool)
        qtoks[:, : len(qv)] = qv[None, :, :]
        qvalid[:, : len(qv)] = True
        weights = np.asarray(
            [spec.query_weight, spec.rescore_query_weight], np.float32
        )
        T = int(ti.shape[2])
        step = self._rerank_step(
            snap, field, kb, T, with_cnt, model, k_req, window, qb
        )
        out = step(ti, tw, tv, msm, qtoks, qvalid, weights)
        self._launched(jobs)
        flops = scoring.text_plan_flops(slots, 0, 0) + (
            rerank_ops.rerank_flops(
                len(jobs), qb, min(kb, snap.n_docs_max),
                rview["tmax"], rview["dims"],
            )
            * snap.e_pad
        )
        return {
            "snap": snap, "out": out, "tail": 1, "flops": flops, "rows": rows,
            "rescored": (model, spec, window),
        }

    def dispatch_serve(self, jobs, kb: int):
        snap = self.ensure_snapshot()
        plan0 = jobs[0].plan
        fields = plan0.fields
        t_cap = mesh_t_max()
        rows = self._rows_for(snap, len(jobs))
        ti_f, tw_f, tv_f, t_shapes = [], [], [], []
        slots = 0
        for f in fields:
            view = self._text_view(snap, f)
            ti, tw, tv, T, s = self._pack_serve_field(
                snap, view, jobs, f, t_cap, rows
            )
            ti_f.append(ti)
            tw_f.append(tw)
            tv_f.append(tv)
            t_shapes.append(T)
            slots += s
        msm = np.ones(rows, np.int32)
        msm[: len(jobs)] = [j.plan.msm for j in jobs]
        step = self._text_step(
            snap, fields, kb, tuple(t_shapes), True, True,
            plan0.combine, float(plan0.tie),
        )
        out = step(tuple(ti_f), tuple(tw_f), tuple(tv_f), msm)
        self._launched(jobs)
        flops = scoring.text_plan_flops(slots, 0, 0)
        return {"snap": snap, "out": out, "tail": 1, "flops": flops, "rows": rows}

    def collect_match(self, jobs, pend):
        self._collect_text(jobs, pend)

    collect_serve = collect_match

    @staticmethod
    def _unpack(pend):
        """The ONE packed download of a page step."""
        width = int(pend["out"].shape[1])
        k = (width - pend["tail"]) // 3
        return unpack_page(pend["out"], k)

    def _collect_text(self, jobs, pend):
        snap = pend["snap"]
        ms, me, md, tail = self._unpack(pend)
        tot = tail[:, 0]
        rescored = pend.get("rescored")
        if rescored is not None:
            from ..models import rerank as rerank_model

            _model, _spec, window = rescored
        for ji, j in enumerate(jobs):
            finite = np.isfinite(ms[ji])
            hits = [
                self._hit(snap, float(s), int(e), int(d))
                for s, e, d in zip(
                    ms[ji][finite][: j.k],
                    me[ji][finite][: j.k],
                    md[ji][finite][: j.k],
                )
            ]
            if rescored is not None:
                rerank_model.note_rescore(window, device=True)
            j.result = MeshTopDocs(
                total=int(tot[ji]),
                relation="eq",
                max_score=hits[0].score if hits else None,
                hits=hits,
                snapshot=snap,
            )
            j.event.set()

    def dispatch_sparse(self, jobs, kb: int):
        """One learned-sparse launch for a same-(field, spec) job group.
        The `sparse.score` fault site fires with mesh=1 here — an
        injected error degrades the whole request to the per-shard path
        (indices._mesh_search's fallback), where the site fires again
        per segment with the host dense oracle as the terminal
        backstop."""
        from ..common.faults import faults as _faults
        from ..ops import impact as impact_ops
        from ..search import sparse as sparse_mod

        snap = self.ensure_snapshot()
        plan0 = jobs[0].plan
        field = plan0.field
        quantized = bool(plan0.spec.quantized)
        _faults.check("sparse.score", field=field, mesh=1)
        view = self._sparse_view(snap, field, quantized)
        rows = self._rows_for(snap, len(jobs))
        ti, tw, tv, T, slots = self._pack_sparse(
            snap, view, jobs, quantized, mesh_t_max(), rows
        )
        step = self._sparse_step(snap, field, quantized, kb, T)
        out = step(ti, tw, tv)
        self._launched(jobs)
        sparse_mod.note_search(len(jobs), quantized, slots, 0)
        flops = impact_ops.sparse_flops(slots)
        return {"snap": snap, "out": out, "tail": 1, "flops": flops, "rows": rows}

    def collect_sparse(self, jobs, pend):
        self._collect_text(jobs, pend)

    def dispatch_knn(self, jobs, kb: int):
        snap = self.ensure_snapshot()
        field = jobs[0].plan.field
        if any(j.plan.boost <= 0.0 for j in jobs):
            # a zero/negative boost would reorder under the
            # post-selection multiply — same host-merge rule as the
            # per-shard collect
            raise MeshUnavailable("non-positive knn boost")
        spec = jobs[0].plan.ann  # shared: ann rides the group key
        if spec is not None:
            # IVF tier on the mesh: the `ann.probe` fault site fires
            # here too (ctx mesh=1) — an injected error surfaces to
            # _mesh_search, which degrades to the per-shard path
            from ..common.faults import faults as _faults

            _faults.check("ann.probe", field=field, mesh=1)
            view = self._ann_view(snap, field, spec)
        else:
            view = self._knn_view(snap, field)
        dims = view["dims"]
        n_max = snap.n_docs_max
        rows = self._rows_for(snap, len(jobs))
        q = np.zeros((rows, dims), np.float32)
        nc = np.zeros((snap.e_pad, rows), np.int32)
        max_nc = 1
        for ji, j in enumerate(jobs):
            if len(j.plan.vector) != dims:
                raise MeshUnavailable("query vector dims mismatch")
            q[ji] = np.asarray(j.plan.vector, np.float32)
            for e in range(len(snap.entries)):
                n = int(view["n_per_entry"][e])
                if n:
                    nc[e, ji] = min(j.plan.num_candidates, n)
            max_nc = max(max_nc, min(j.plan.num_candidates, n_max))
        kc = min(max(scoring.next_bucket(max_nc, 16), 16), n_max)
        tail = snap.e_pad
        if spec is not None:
            from ..ops import ivf
            from ..search import ann as ann_mod

            step = self._ann_step(snap, field, spec, kc)
            out = step(q, nc)
            self._launched(jobs)
            flops = sum(
                ivf.ann_flops(len(jobs), nl, spec.nprobe, view["cmax"], dims)
                for nl in view["nlists"]
            )
            for nl in view["nlists"]:
                ann_mod.note_search(spec.nprobe, nl, jobs=len(jobs))
            return {"snap": snap, "out": out, "tail": tail, "flops": flops,
                    "rows": rows}
        step = self._knn_step(snap, field, kc)
        out = step(q, nc)
        self._launched(jobs)
        total_docs = int(view["n_per_entry"].sum())
        flops = scoring.knn_flops(len(jobs), total_docs, dims)
        return {"snap": snap, "out": out, "tail": tail, "flops": flops,
                "rows": rows}

    def collect_knn(self, jobs, pend):
        from ..common.faults import faults

        faults.check("knn.collect", jobs=len(jobs), mesh=1)
        snap = pend["snap"]
        ms, me, md, counts = self._unpack(pend)
        shard_of = [sid for sid, _si in snap.entries]
        n_entries = len(shard_of)
        for ji, j in enumerate(jobs):
            boost = j.plan.boost
            # the per-shard path cuts at k PER SHARD (each shard's page
            # is its top min(plan.k, size) after the nc rank cut) before
            # the coordinator's global page: walk the ordered stream
            # applying the same per-shard caps
            cap_shard = min(j.plan.k, j.k)
            taken: Dict[int, int] = {}
            hits: List[MeshHit] = []
            row_s, row_e, row_d = ms[ji], me[ji], md[ji]
            for pos in range(len(row_s)):
                s = row_s[pos]
                if not np.isfinite(s):
                    break  # score-desc stream: only -inf padding left
                e = int(row_e[pos])
                if e >= n_entries:  # pragma: no cover - padded entry
                    continue
                sid = shard_of[e]
                got = taken.get(sid, 0)
                if got >= cap_shard:
                    continue
                taken[sid] = got + 1
                hits.append(self._hit(snap, float(s) * boost, e, int(row_d[pos])))
                if len(hits) >= j.k:
                    break
            # the per-shard coordinator's total is Σ per-shard totals,
            # each capped at k — reproduce it from the per-entry counts
            per_shard: Dict[int, int] = {}
            for e, sid in enumerate(shard_of):
                per_shard[sid] = per_shard.get(sid, 0) + int(counts[ji, e])
            total = sum(min(c, j.plan.k) for c in per_shard.values())
            j.result = MeshTopDocs(
                total=total,
                relation="eq",
                max_score=hits[0].score if hits else None,
                hits=hits,
                snapshot=snap,
            )
            j.event.set()

    # ---- mesh aggregations (one launch per agg-body group) ----

    def compile_agg(self, nodes, mplan, mappings) -> "MeshAggPlan":
        """Compiles a size:0 agg body for the mesh step. Supported on
        this path: metric leaves sum/avg/min/max/value_count/stats,
        keyword terms, histogram / date_histogram (fixed intervals) —
        all WITHOUT subs; anything else raises MeshUnavailable and the
        per-shard path (with its own device engine) serves the request.
        The same exactness profiles as search/aggs_device gate routing,
        with the sum window tightened to the GLOBAL Σ|v| since the
        int32 sums accumulate across the whole index."""
        from ..index.mapping import KEYWORD
        from ..search import aggs_device
        from ..search.aggs import PIPELINE_TYPES, _int_param, _norm_order
        from ..search.aggs_device import (
            I32_SUM_BOUND,
            _METRIC_KINDS,
            _NEEDS_CMP,
            _NEEDS_SUM,
            _parse_dh_interval,
        )

        snap = self.ensure_snapshot()
        specs = []
        for node in nodes:
            if node.type in PIPELINE_TYPES:
                continue
            if node.subs:
                raise MeshUnavailable("mesh aggs do not nest")
            if node.type in _METRIC_KINDS and node.type != "percentiles":
                field = node.params.get("field")
                if field is None:
                    raise MeshUnavailable("metric without a field")
                mf = mappings.get(field)
                if mf is not None and mf.type in ("keyword", "text"):
                    raise MeshUnavailable("keyword metric")
                abs_total = 0.0
                for sid, si in snap.entries:
                    p = aggs_device.col_profile(snap.executors[sid], si, field)
                    abs_total += p.abs_sum
                    if node.type in _NEEDS_SUM and not (
                        not p.present or p.n_exist == 0 or p.integer_valued
                    ):
                        raise MeshUnavailable("non-integer sum column")
                    if node.type in _NEEDS_CMP and not p.cmp_exact:
                        raise MeshUnavailable("non-f32-exact column")
                if node.type in _NEEDS_SUM and abs_total >= I32_SUM_BOUND:
                    raise MeshUnavailable("sum outside the int32 window")
                specs.append(("metric", node.name, node.type, field))
            elif node.type == "terms":
                field = node.params.get("field")
                mf = mappings.get(field) if field else None
                if mf is None or mf.type != KEYWORD:
                    raise MeshUnavailable("mesh terms needs keyword")
                order = _norm_order(node.params.get("order", {"_count": "desc"}))
                if next(iter(order)) not in ("_count", "_key"):
                    raise MeshUnavailable("terms order")
                size = _int_param(node, "size", 10)
                shard_size = _int_param(
                    node, "shard_size", max(int(size * 1.5) + 10, size)
                )
                specs.append(
                    ("terms_kw", node.name, field, size, shard_size,
                     tuple(order.items()))
                )
            elif node.type in ("histogram", "date_histogram"):
                field = node.params.get("field")
                if field is None:
                    raise MeshUnavailable("histogram without a field")
                date = node.type == "date_histogram"
                if date:
                    interval, cal = _parse_dh_interval(node.params)
                    if cal is not None:
                        raise MeshUnavailable("calendar interval")
                    offset = 0
                else:
                    interval = float(node.params.get("interval", 0))
                    offset = float(node.params.get("offset", 0))
                    if (
                        interval <= 0
                        or interval != int(interval)
                        or offset != int(offset)
                    ):
                        raise MeshUnavailable("non-integer interval")
                for sid, si in snap.entries:
                    p = aggs_device.col_profile(snap.executors[sid], si, field)
                    if p.present and p.n_exist and not p.integer_valued:
                        raise MeshUnavailable("non-integer histogram col")
                specs.append(
                    ("histo", node.name, field, int(interval), int(offset), date)
                )
            else:
                raise MeshUnavailable(f"mesh agg type [{node.type}]")
        return MeshAggPlan(nodes, specs, mplan)

    def dispatch_agg(self, jobs):
        snap = self.ensure_snapshot()
        plan0 = jobs[0].plan
        rows = self._rows_for(snap, len(jobs))
        node_descs = []
        collect_meta = []
        for spec in plan0.specs:
            kind = spec[0]
            if kind == "metric":
                view = self._agg_num_view(snap, spec[3])
                node_descs.append(
                    ("metric", view["values"], view["ivalues"], view["exists"])
                )
                collect_meta.append((spec, None))
            elif kind == "terms_kw":
                view = self._agg_ord_view(snap, spec[2])
                nbpad = scoring.next_bucket(max(len(view["gterms"]), 1), 16)
                node_descs.append(
                    ("counts_entry", view["gords"], view["edocs"],
                     view["evalid"], nbpad)
                )
                collect_meta.append((spec, view["gterms"]))
            else:  # histo
                view = self._agg_histo_view(snap, spec[2], spec[3], spec[4])
                node_descs.append(
                    ("counts_doc", view["ids"], view["exists"], view["nbpad"])
                )
                collect_meta.append((spec, view["qmin"]))
        with_cnt = any(j.plan.msm > 1 for j in jobs)
        if plan0.mplan is not None:
            field = plan0.mplan.field
            tview = self._text_view(snap, field)
            ti, tw, tv, T, slots = self._pack_match(
                snap, tview, jobs, mesh_t_max(), rows
            )
            text = (tview["doc_ids"], tview["tfs"], tview["inv_norm"])
        else:
            field = None
            T = 1
            slots = 0
            ti = np.zeros((snap.e_pad, rows, 1), np.int32)
            tw = np.zeros((snap.e_pad, rows, 1), np.float32)
            tv = np.zeros((snap.e_pad, rows, 1), bool)
            text = None
        msm = np.ones(rows, np.int32)
        msm[: len(jobs)] = [j.plan.msm for j in jobs]
        key = ("agg", plan0.sig, field, T, rows, with_cnt)
        step = snap.steps.get(key)
        if step is None:
            with self._lock:
                step = snap.steps.get(key)
                if step is None:
                    step = build_mesh_agg_step(
                        snap.mesh, snap.live, node_descs, text, with_cnt,
                    )
                    snap.steps[key] = step
        out = step(ti, tw, tv, msm)
        self._launched(jobs)
        n_total = sum(
            snap.readers[sid].segments[si].num_docs for sid, si in snap.entries
        )
        from ..ops.agg_kernels import agg_flops

        flops = scoring.text_plan_flops(slots, 0, 0) + agg_flops(
            n_total, len(node_descs)
        )
        widths = [4 if d[0] == "metric" else int(d[-1]) for d in node_descs]
        return {
            "snap": snap, "out": out, "meta": collect_meta, "widths": widths,
            "flops": flops, "rows": rows,
        }

    def collect_agg(self, jobs, pend):
        from ..search.aggs import _bkey, _order_buckets
        from ..search.aggs_device import _metric_partial

        snap = pend["snap"]
        out = pend["out"].cpu().numpy()  # the ONE download
        totals, maxs = out[:, 0], out[:, 1]
        for ji, j in enumerate(jobs):
            partials = {}
            col = 2
            for (spec, extra), width in zip(pend["meta"], pend["widths"]):
                kind, name = spec[0], spec[1]
                row = out[ji, col : col + width]
                col += width
                if kind == "metric":
                    c = int(row[0])
                    s = float(row[1])
                    mn = float(row[2])
                    mx = float(row[3])
                    partials[name] = _metric_partial(
                        spec[2], c, s if c else 0.0,
                        mn if c else None, mx if c else None,
                    )
                elif kind == "terms_kw":
                    row = row.astype(np.int64)
                    gterms = extra
                    counts = {
                        gterms[int(o)]: int(row[o])
                        for o in np.nonzero(row[: len(gterms)])[0]
                    }
                    _sp, _name, _field, size, shard_size, order_t = spec
                    order = dict(order_t)
                    top = _order_buckets(counts, order)[:shard_size]
                    shard_error = (
                        top[-1][1] if len(counts) > shard_size and top else 0
                    )
                    partials[name] = {
                        "t": "terms",
                        "buckets": {
                            _bkey(k): {"key": k, "doc_count": c2, "subs": {}}
                            for k, c2 in top
                        },
                        "sum_docs": sum(counts.values()),
                        "size": size,
                        "order": order,
                        "shard_error": shard_error,
                    }
                else:  # histo
                    row = row.astype(np.int64)
                    qmin = extra
                    _sp, _name, _field, interval, offset, date = spec
                    buckets = {}
                    for rel in np.nonzero(row)[0]:
                        raw = (qmin + int(rel)) * interval + offset
                        k = int(raw) if date else float(raw)
                        buckets[k] = {
                            "key": k,
                            "doc_count": int(row[rel]),
                            "subs": {},
                        }
                    partials[name] = {
                        "t": "date_histogram" if date else "histogram",
                        "buckets": buckets,
                    }
            mx = float(maxs[ji])
            j.result = {
                "total": int(totals[ji]),
                "max_score": mx if np.isfinite(mx) else None,
                "partials": partials,
                "snapshot": snap,
            }
            j.event.set()

    def _hit(self, snap, score, entry, doc) -> MeshHit:
        sid, si = snap.entries[entry]
        return MeshHit(
            score=score,
            shard=sid,
            segment=si,
            local_doc=doc,
            doc_id=snap.readers[sid].segments[si].doc_ids[doc],
        )

    def note_routed(self) -> None:
        with self._lock:
            self.stats["routed"] += 1

    def note_fallback(self) -> None:
        with self._lock:
            self.stats["fallbacks"] += 1

    def note_degraded(self) -> None:
        with self._lock:
            self.stats["degraded"] += 1

    def stats_snapshot(self) -> dict:
        with self._lock:
            out = dict(self.stats)
        snap = self._snapshot
        out["entries"] = len(snap.entries) if snap and not snap.closed else 0
        out["devices"] = len(self.device_ids)
        return out
