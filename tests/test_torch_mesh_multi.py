"""The port's serving mesh over a grid of several slots, on the CPU.

The reference's tests run its mesh on the 8 virtual CPU devices that
tests/conftest.py forces. The port's counterpart is a grid of CPU slots:
`MeshExecutor._devices` is substituted with `["cpu"] * G`, so each slot
holds its own fold of every stacked view, takes its part of each step
and sends its pages to the coordinating slot for the merge — every part
of the multi-card mesh except the copies between cards.

Layouts: G in {2, 3, 8} slots over E = 8 and E = 12 entries (folds
that pad unevenly), and ES_TPU_MESH_DATA=2 on a 2 × 2 (data × shards)
grid. Families: match/bool/multi_match, exact `knn` with
`num_candidates`, IVF unquantized and int8, int8 `sparse_vector`,
`rescore` f32 and int8, and size-0 aggregations. Every page is held to
the port's fan-out (`ES_TPU_MESH=off`) bit for bit, to the port's
one-slot mesh bit for bit (aggregations exactly too: the port's agg
columns sum in int32 and take float minima and maxima, which no fold
order changes), and to the JAX package's forced mesh on its 8 devices
by id position (tie runs as sets) with scores within rtol 1e-5 and
totals and aggregations exact. One exception to bit for bit: on the
2 × 2 grid the dense products of exact and IVF kNN run on a data row's
share of the query rows, and the CPU's BLAS picks its kernel by the
row count (one row takes a matrix-vector kernel), so a score's last
ulp may differ from the fan-out's product over the whole group; those
pages are held to the fan-out and the one-slot mesh by the JAX rule
(ids by position, tie runs as sets, scores within rtol 1e-5, totals
exact). The snapshot's `mesh.shape`, `fold` and
`e_pad` equal the JAX package's snapshot for the same grid (its
devices capped at G by ES_TPU_MESH_DEVICES). The IVF pages compared
with the JAX package probe every cluster (`nprobe` = `nlist`), since
each package clusters its own segments; the port's own comparisons
also run the index's `nprobe` 4. Also here: a rebuild after a one-shard
refresh that moves entries between slots, an injected fault in one
slot's part (falls back, as on one slot), a real error in one slot's
part (raises), the card list `_devices` gives on a CUDA index, and the
ShardedIndex steps over several slots.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from test_torch_mesh import (
    AGG_MAPPING,
    ANN_MAPPING,
    IVF,
    MAPPING,
    RR_MAPPING,
    SP_MAPPING,
    SP_VOCAB,
    TEXT_BODIES,
    agg_docs,
    ann_body,
    ann_queries,
    assert_parity,
    clustered_vectors,
    fill_waves,
    hits_of,
    jax_service,
    make_docs,
    port_service,
    qvecs,
    rescore_block,
    rr_fill,
    same_response,
    sparse_docs,
)

from elasticsearch_tpu_torch.common.faults import InjectedFault, faults
from elasticsearch_tpu_torch.parallel import sharded as port_sharded
from elasticsearch_tpu_torch.search.batcher import live_batchers

torch.set_num_threads(1)

pytestmark = pytest.mark.mesh

DIMS = 8
# name -> (slots, data axis)
LAYOUTS = {"g2": (2, 1), "g3": (3, 1), "g8": (8, 1), "d2x2": (4, 2)}
MESH_ENVS = ("ES_TPU_MESH", "ES_TPU_MESH_DATA", "ES_TPU_MESH_DEVICES")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _mesh_env():
    """No test may leak a mesh knob into the rest of tier-1."""
    old = {k: os.environ.get(k) for k in MESH_ENVS}
    yield
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    yield
    from elasticsearch_tpu_torch.search.admission import admission

    admission.reset()
    if faults.active:
        faults.clear()


@pytest.fixture(autouse=True, scope="module")
def _no_leaked_port_batcher_threads():
    yield
    leaked = []
    for b in list(live_batchers):
        if not getattr(b, "_closed", False):
            continue
        for t in list(b._threads):
            t.join(timeout=10.0)
            if t.is_alive():
                leaked.append(t.name)
    assert not leaked, f"closed port QueryBatcher left live worker threads: {leaked}"


def _setenv(name, value):
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = str(value)


@contextlib.contextmanager
def port_grid(svc, slots, n_data=1):
    """The port's mesh over `slots` CPU slots (the substituted device
    list) with a data axis of `n_data`; the one-slot default after."""
    mex = svc.mesh_executor()
    mex._devices = lambda: [CPU] * slots
    _setenv("ES_TPU_MESH_DATA", n_data if n_data > 1 else None)
    mex.close()
    try:
        yield mex
    finally:
        del mex._devices
        os.environ.pop("ES_TPU_MESH_DATA", None)
        mex.close()


def jax_layout(jsvc, slots, n_data=1):
    """(mesh.shape, fold, e_pad) of the JAX package's snapshot on `slots`
    of its 8 virtual devices."""
    mex = jsvc.mesh_executor()
    _setenv("ES_TPU_MESH_DEVICES", slots)
    _setenv("ES_TPU_MESH_DATA", n_data if n_data > 1 else None)
    mex.close()
    try:
        snap = mex.ensure_snapshot()
        return dict(snap.mesh.shape), snap.fold, snap.e_pad
    finally:
        os.environ.pop("ES_TPU_MESH_DEVICES", None)
        os.environ.pop("ES_TPU_MESH_DATA", None)
        mex.close()


def search(svc, body, mode):
    """One request with ES_TPU_MESH=`mode`; under force it must be
    mesh-routed with no fallback."""
    os.environ["ES_TPU_MESH"] = mode
    mex = svc.mesh_executor()
    r0, f0 = mex.stats["routed"], mex.stats["fallbacks"]
    resp = svc.search(json.loads(json.dumps(body)))
    if mode == "force":
        assert mex.stats["routed"] == r0 + 1, f"not mesh-routed: {body}"
        assert mex.stats["fallbacks"] == f0
    return resp


# ---------------------------------------------------------------------------
# the families: (JAX, port) services over the same docs, and their bodies
# ---------------------------------------------------------------------------


def _text_pair(name, batches):
    waves = make_docs(batches, 60, seed=batches)
    pair = (jax_service(name, 4), port_service(name, 4))
    for svc in pair:
        fill_waves(svc, waves)
    return pair


def _text_bodies():
    return [TEXT_BODIES[i] for i in (0, 1, 3, 5, 6)]


def _knn_bodies():
    rng = np.random.default_rng(3)
    return [
        {"knn": {"field": "vec", "query_vector": [float(x) for x in rng.normal(size=DIMS)],
                 "k": k, "num_candidates": nc}, "size": size}
        for k, nc, size in ((8, 20, 8), (5, 7, 5), (3, 10, 20))
    ]


def _ivf_pair(name, quantized):
    extra = {**IVF, "knn.quantization": "int8"} if quantized else IVF
    vecs = clustered_vectors(1200, seed=15)
    words = ["alpha", "beta", "gamma", "delta"]
    pair = (jax_service(name, 4, settings=extra, mapping=ANN_MAPPING),
            port_service(name, 4, settings=extra, mapping=ANN_MAPPING))
    for svc in pair:
        for lo, hi in ((0, 600), (600, 1200)):
            for i in range(lo, hi):
                svc.index_doc(str(i), {"body": words[i % 4],
                                       "vec": [float(x) for x in vecs[i]]})
            svc.refresh()
    return pair, vecs


def _ivf_bodies(vecs):
    """The index's nprobe 4 (port only) and every cluster probed (held
    to the JAX package too)."""
    out = []
    for qv in ann_queries(vecs, 3, seed=43):
        out.append((ann_body(qv), False))
        full = ann_body(qv)
        full["knn"]["nprobe"] = IVF["knn.nlist"]
        out.append((full, True))
    return out


def _sparse_pair(name):
    docs = sparse_docs(240, SP_VOCAB[:30], 11, 2, 8)
    settings = {"sparse.quantization": "int8"}
    pair = (jax_service(name, 4, settings=settings, mapping=SP_MAPPING),
            port_service(name, 4, settings=settings, mapping=SP_MAPPING))
    for svc in pair:
        fill_waves(svc, [docs[:120], docs[120:]])
    return pair


def _sparse_bodies():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(3):
        toks = [str(t) for t in rng.choice(SP_VOCAB[:30], size=int(rng.integers(2, 6)),
                                           replace=False)]
        out.append({"query": {"sparse_vector": {
            "field": "ml",
            "query_vector": {t: float(np.round(rng.random() * 2 + 0.1, 4)) for t in toks},
        }}, "size": 10})
    return out


def _rescore_pair(name, quantized):
    # one live segment per shard (the mesh rescore's precondition):
    # 8 shards give E = 8
    extra = {"rerank.quantization": "int8"} if quantized else None
    pair = (jax_service(name, 8, settings=extra, mapping=RR_MAPPING),
            port_service(name, 8, settings=extra, mapping=RR_MAPPING))
    rr_fill(pair, n=160)
    return pair


def _rescore_bodies():
    return [
        {"query": {"match": {"body": w}}, "size": 10,
         "rescore": rescore_block(qvecs(np.random.default_rng(s)), window=20)}
        for s, w in enumerate(("alpha", "beta", "gamma"))
    ]


def _agg_pair(name):
    docs = agg_docs(160, 41)
    pair = (jax_service(name, 4, mapping=AGG_MAPPING),
            port_service(name, 4, mapping=AGG_MAPPING))
    for svc in pair:
        fill_waves(svc, [docs[:80], docs[80:]])
    return pair


def _agg_bodies():
    return [
        {"size": 0, "request_cache": False, "aggs": {
            "s": {"stats": {"field": "qty"}},
            "cats": {"terms": {"field": "cat"}},
            "dh": {"date_histogram": {"field": "day", "fixed_interval": "7d"}}}},
        {"size": 0, "request_cache": False, "query": {"match": {"body": "alpha"}},
         "aggs": {"cats": {"terms": {"field": "tags"}}, "m": {"max": {"field": "qty"}}}},
        {"size": 0, "request_cache": False,
         "aggs": {"h": {"histogram": {"field": "qty", "interval": 10}},
                  "mn": {"min": {"field": "price"}}, "av": {"avg": {"field": "qty"}},
                  "sp": {"sum": {"field": "price"}}, "vc": {"value_count": {"field": "price"}}}},
    ]


class Family:
    """One family's services, bodies and reference pages: the port's
    fan-out, the port's one-slot mesh, the JAX package's mesh on its 8
    devices. `bodies` is [(body, held to JAX)]."""

    def __init__(self, name, pair, bodies, aggs=False):
        self.name = name
        self.pair = pair
        self.bodies = bodies
        self.aggs = aggs
        jsvc, psvc = pair
        self.fanout = [search(psvc, b, "off") for b, _ in bodies]
        self.one_slot = [search(psvc, b, "force") for b, _ in bodies]
        self.jax8 = [search(jsvc, b, "force") if held else None for b, held in bodies]
        os.environ.pop("ES_TPU_MESH", None)


def _build(name):
    if name in ("text8", "text12"):
        pair = _text_pair(f"mm-{name}", 2 if name == "text8" else 3)
        return Family(name, pair, [(b, True) for b in _text_bodies()])
    if name == "knn":
        pair = _text_pair("mm-knn", 2)
        return Family(name, pair, [(b, True) for b in _knn_bodies()])
    if name in ("ivf", "ivf_int8"):
        pair, vecs = _ivf_pair(f"mm-{name}", name == "ivf_int8")
        return Family(name, pair, _ivf_bodies(vecs))
    if name == "sparse_int8":
        return Family(name, _sparse_pair("mm-sparse"), [(b, True) for b in _sparse_bodies()])
    if name in ("rescore", "rescore_int8"):
        pair = _rescore_pair(f"mm-{name}", name == "rescore_int8")
        return Family(name, pair, [(b, True) for b in _rescore_bodies()])
    return Family(name, _agg_pair("mm-aggs"), [(b, True) for b in _agg_bodies()], aggs=True)


FAMILIES = ("text8", "text12", "knn", "ivf", "ivf_int8", "sparse_int8",
            "rescore", "rescore_int8", "aggs")
# families whose dense product runs on a data row's share of the rows
DENSE = ("knn", "ivf", "ivf_int8")


@pytest.fixture(scope="module")
def world():
    """Families built on first use and kept for the module; the IVF
    tier's small-segment floor lowered for its small corpora."""
    old_floor = os.environ.get("ES_TPU_ANN_MIN_DOCS")
    os.environ["ES_TPU_ANN_MIN_DOCS"] = "64"
    built = {}

    def get(name):
        if name not in built:
            built[name] = _build(name)
        return built[name]

    yield get
    for fam in built.values():
        for svc in fam.pair:
            svc.close()
    _setenv("ES_TPU_ANN_MIN_DOCS", old_floor)


def assert_same_aggs(got, ref, what):
    assert got["aggregations"] == ref["aggregations"], what
    assert got["hits"]["total"] == ref["hits"]["total"], what
    assert got["hits"]["max_score"] == ref["hits"]["max_score"], what


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("family", FAMILIES)
def test_family_on_grid(world, family, layout):
    fam = world(family)
    slots, n_data = LAYOUTS[layout]
    jsvc, psvc = fam.pair
    want = jax_layout(jsvc, slots, n_data)
    with port_grid(psvc, slots, n_data) as mex:
        snap = mex.ensure_snapshot()
        assert (dict(snap.mesh.shape), snap.fold, snap.e_pad) == want
        assert snap.mesh.shape["data"] * snap.mesh.shape["shards"] == slots
        assert snap.device_ids == tuple(range(slots))
        l0 = mex.stats["launches"]
        for i, (body, held) in enumerate(fam.bodies):
            what = f"{family} on {layout}, body {i}"
            got = search(psvc, body, "force")
            if fam.aggs:
                assert_same_aggs(got, fam.fanout[i], what)
                assert_same_aggs(got, fam.one_slot[i], what)
                assert_same_aggs(got, fam.jax8[i], what)
                continue
            if n_data > 1 and family in DENSE:
                same_response(fam.fanout[i], got, what)
                same_response(fam.one_slot[i], got, what)
            else:
                assert_parity(got, fam.fanout[i])
                assert_parity(got, fam.one_slot[i])
            if held:
                same_response(fam.jax8[i], got, what)
        # one step per group (each request here is a group of one),
        # whatever the grid
        assert mex.stats["launches"] == l0 + len(fam.bodies)


def test_entry_counts_of_the_layouts(world):
    """The layouts above cover folds that pad unevenly: E = 8 and 12
    entries over 2, 3 and 8 slots."""
    seen = set()
    for family in ("text8", "text12"):
        psvc = world(family).pair[1]
        for slots, n_data in LAYOUTS.values():
            with port_grid(psvc, slots, n_data) as mex:
                snap = mex.ensure_snapshot()
                seen.add((len(snap.entries), snap.mesh.shape["shards"], snap.fold, snap.e_pad))
    assert seen == {
        (8, 2, 4, 8), (8, 3, 3, 9), (8, 8, 1, 8),
        (12, 2, 6, 12), (12, 3, 4, 12), (12, 8, 2, 16),
    }


# ---------------------------------------------------------------------------
# lifecycle and failure on a grid
# ---------------------------------------------------------------------------


def test_rebuild_moves_entries_between_slots():
    """A one-shard refresh adds an entry in the middle of the stack, so
    the entries after it land on other slots: their rows are copied
    device to device from the previous stack, and the pages equal the
    fan-out's and the JAX package's."""
    from elasticsearch_tpu_torch.utils.murmur3 import shard_id

    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    mapping = {"properties": {"body": {"type": "text"}}}
    p = (jax_service("mm-incr", 4, mapping=mapping), port_service("mm-incr", 4, mapping=mapping))
    body = {"query": {"match": {"body": "alpha beta"}}, "size": 10}
    try:
        for svc in p:
            rng = np.random.default_rng(5)
            for i in range(200):
                svc.index_doc(f"d{i}", {"body": " ".join(
                    rng.choice(words, size=int(rng.integers(3, 8))))})
            svc.refresh()
        jsvc, psvc = p
        with port_grid(psvc, 3) as mex:
            first = search(psvc, body, "force")
            old = mex.ensure_snapshot()
            assert old.fold == 2 and len(old.entries) == 4
            old_slot = {k: e // old.fold for e, k in enumerate(old.entry_keys)}
            # a doc of shard 0: every later entry moves one place down
            extra = next(f"extra{i}" for i in range(100) if shard_id(f"extra{i}", 4) == 0)
            for svc in p:
                svc.index_doc(extra, {"body": "alpha zeta"})
                svc.local_shard(0).refresh()
            reused0 = mex.stats["entries_reused"]
            second = search(psvc, body, "force")
            new = mex.ensure_snapshot()
            assert len(new.entries) == 5 and new.fold == 2
            assert mex.stats["incremental_rebuilds"] >= 1
            assert mex.stats["entries_reused"] >= reused0 + 3
            moved = [k for e, k in enumerate(new.entry_keys)
                     if k in old_slot and e // new.fold != old_slot[k]]
            assert moved, "no unchanged entry changed slot"
            assert first["hits"]["hits"]
            assert_parity(second, search(psvc, body, "off"))
            same_response(search(jsvc, body, "force"), second)
    finally:
        for svc in p:
            svc.close()


@pytest.fixture(scope="module")
def small_pair():
    pair = _text_pair("mm-faults", 2)
    yield pair
    for svc in pair:
        svc.close()


def _fail_one_slot(monkeypatch, exc):
    """The second slot's part of the next text step raises `exc` when it
    uploads its plan."""
    real = port_sharded._up_plan
    calls = {"n": 0}

    def up_plan(device, ti, tw, tv):
        calls["n"] += 1
        if calls["n"] == 2:
            raise exc
        return real(device, ti, tw, tv)

    monkeypatch.setattr(port_sharded, "_up_plan", up_plan)
    return calls


def test_injected_fault_in_one_slot_falls_back(small_pair, monkeypatch):
    """An injected fault in one slot's part degrades the group to the
    fan-out, as an injected fault does on one slot."""
    psvc = small_pair[1]
    body = {"query": {"match": {"body": "alpha gamma"}}, "size": 10}
    ref = search(psvc, body, "off")
    with port_grid(psvc, 2) as mex:
        mex.ensure_snapshot()
        calls = _fail_one_slot(monkeypatch, InjectedFault("slot 1 dispatch"))
        os.environ["ES_TPU_MESH"] = "force"
        fb0, r0 = mex.stats["fallbacks"], mex.stats["routed"]
        got = psvc.search(dict(body))
        assert calls["n"] >= 2
        assert mex.stats["fallbacks"] == fb0 + 1 and mex.stats["routed"] == r0
        assert hits_of(got) == hits_of(ref) and got["_shards"]["failed"] == 0


def test_real_error_in_one_slot_raises(small_pair, monkeypatch):
    """A real error in one slot's part reaches the caller: nothing
    serves the stack on the other slots or falls back."""
    psvc = small_pair[1]
    with port_grid(psvc, 2) as mex:
        mex.ensure_snapshot()
        _fail_one_slot(monkeypatch, RuntimeError("slot 1 launch failed"))
        os.environ["ES_TPU_MESH"] = "force"
        fb0 = mex.stats["fallbacks"]
        with pytest.raises(Exception, match="slot 1 launch failed"):
            psvc.search({"query": {"match": {"body": "alpha"}}, "size": 5})
        assert mex.stats["fallbacks"] == fb0


def test_slot_build_error_raises(small_pair, monkeypatch):
    """A slot whose stack cannot be built fails the request."""
    from elasticsearch_tpu_torch.parallel import mesh_executor as port_mex

    psvc = small_pair[1]
    real = port_mex.Stacked.full

    def full(mesh, fold, tail, dtype, fill=0):
        raise RuntimeError("slot allocation failed")

    with port_grid(psvc, 2) as mex:
        mex.ensure_snapshot()
        monkeypatch.setattr(port_mex.Stacked, "full", staticmethod(full))
        os.environ["ES_TPU_MESH"] = "force"
        fb0 = mex.stats["fallbacks"]
        with pytest.raises(Exception, match="slot allocation failed"):
            psvc.search({"query": {"match": {"body": "delta"}}, "size": 5})
        assert mex.stats["fallbacks"] == fb0
        monkeypatch.setattr(port_mex.Stacked, "full", real)


def test_gather_counts_slot_pages(small_pair):
    """Pages of every slot but the first are counted as gathered; on one
    device none crosses between devices."""
    psvc = small_pair[1]
    with port_grid(psvc, 4) as mex:
        mex.ensure_snapshot()
        g0 = port_sharded.gather_stats()
        search(psvc, {"query": {"match": {"body": "beta"}}, "size": 5}, "force")
        g1 = port_sharded.gather_stats()
    assert g1["pages"] == g0["pages"] + 1
    assert g1["slot_bytes"] > g0["slot_bytes"]
    assert g1["peer_bytes"] == g0["peer_bytes"]


@pytest.mark.parametrize("slots,n_data", [(3, 1), (4, 2)])
def test_concurrent_groups_on_a_grid(small_pair, slots, n_data):
    """Concurrent requests group into launches of several jobs on a
    grid (no launch lock: each slot's part and its page copy are
    stream-ordered); every page equals the fan-out's, text bit for bit
    and kNN by the JAX rule (its groups differ from the fan-out's)."""
    from concurrent.futures import ThreadPoolExecutor

    psvc = small_pair[1]
    rng = np.random.default_rng(9)
    bodies = [dict(TEXT_BODIES[i % len(TEXT_BODIES)]) for i in range(14)] + [
        {"knn": {"field": "vec", "query_vector": [float(x) for x in rng.normal(size=DIMS)],
                 "k": 5, "num_candidates": 12}, "size": 5}
        for _ in range(10)
    ]
    refs = [search(psvc, b, "off") for b in bodies]
    with port_grid(psvc, slots, n_data) as mex:
        os.environ["ES_TPU_MESH"] = "force"
        r0, l0 = mex.stats["routed"], mex.stats["launches"]
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(lambda b: psvc.search(json.loads(json.dumps(b))), bodies * 2))
        assert mex.stats["routed"] == r0 + 2 * len(bodies)
        assert mex.stats["launches"] - l0 <= 2 * len(bodies)
    for i, g in enumerate(got):
        ref = refs[i % len(bodies)]
        if "knn" in bodies[i % len(bodies)]:
            same_response(ref, g, f"knn body {i}")
        else:
            assert_parity(g, ref)


# ---------------------------------------------------------------------------
# the device list on a CUDA index, and `auto` on a grid
# ---------------------------------------------------------------------------


class _CudaService:
    def __init__(self, device):
        self.device = device


@pytest.mark.parametrize("own,count,cap,want", [
    ("cuda:0", 4, 0, [0, 1, 2, 3]),
    ("cuda:2", 4, 0, [2, 0, 1, 3]),
    ("cuda:1", 4, 2, [1, 0]),
    ("cuda", 3, 0, [0, 1, 2]),
    ("cuda:0", 1, 0, [0]),
])
def test_devices_on_a_cuda_index(monkeypatch, own, count, cap, want):
    """The index's card first, then every other visible card, capped by
    ES_TPU_MESH_DEVICES."""
    from elasticsearch_tpu_torch.parallel.mesh_executor import MeshExecutor

    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    _setenv("ES_TPU_MESH_DEVICES", cap or None)
    devs = MeshExecutor(_CudaService(own))._devices()
    assert [d.type for d in devs] == ["cuda"] * len(want)
    assert [d.index for d in devs] == want


def test_devices_on_a_cpu_index(small_pair):
    assert small_pair[1].mesh_executor()._devices() == [CPU]


def test_auto_engages_on_a_grid(small_pair):
    """`auto` takes the mesh with 2+ devices and 2+ shards."""
    psvc = small_pair[1]
    os.environ.pop("ES_TPU_MESH", None)
    assert not psvc.mesh_executor().available()
    with port_grid(psvc, 2) as mex:
        assert mex.available()
        r0 = mex.stats["routed"]
        body = {"query": {"match": {"body": "alpha"}}, "size": 3}
        got = psvc.search(dict(body))
        assert mex.stats["routed"] == r0 + 1
        assert_parity(got, search(psvc, body, "off"))


# ---------------------------------------------------------------------------
# ShardedIndex over several slots (tests/test_sharded.py's grid)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sharded_segments():
    from test_torch_mesh import make_shards

    _, _, jsegs = make_shards("elasticsearch_tpu")
    _, _, segs = make_shards("elasticsearch_tpu_torch")
    return jsegs, segs


@pytest.mark.parametrize("slots,n_data", [(2, 1), (3, 1), (4, 2), (8, 2)])
def test_sharded_index_on_a_grid(sharded_segments, slots, n_data):
    """The ShardedIndex steps on a grid of slots equal the one-slot
    steps bit for bit and the JAX package's (data=2, shards=4) mesh."""
    from test_torch_mesh import SH_QUERIES

    from elasticsearch_tpu.parallel import ShardedIndex as JSharded
    from elasticsearch_tpu.parallel import build_sharded_bm25_step as jbm25
    from elasticsearch_tpu.parallel import build_sharded_knn_step as jknn
    from elasticsearch_tpu.parallel import make_mesh as jmake

    from elasticsearch_tpu_torch.parallel import (
        ShardedIndex,
        build_sharded_bm25_step,
        build_sharded_knn_step,
        make_mesh,
    )

    jsegs, segs = sharded_segments
    jidx = JSharded(jmake(n_shards=4, n_data=2), jsegs, "body", vector_field="embedding")
    one = ShardedIndex(make_mesh(4, devices=[CPU]), segs, "body", vector_field="embedding")
    grid = ShardedIndex(make_mesh(4, n_data=n_data, devices=[CPU] * slots), segs, "body",
                        vector_field="embedding")
    assert grid.mesh.shape == {"data": n_data, "shards": min(4, slots // n_data)}
    term_lists = [t for t, _ in SH_QUERIES]
    ops = [o for _, o in SH_QUERIES]
    plans = grid.compile_queries(term_lists, ops)
    q = np.random.default_rng(3).standard_normal((8, 8)).astype(np.float32)
    for got, ref, jref in (
        (build_sharded_bm25_step(grid, k=10)(*plans),
         build_sharded_bm25_step(one, k=10)(*one.compile_queries(term_lists, ops)),
         jbm25(jidx, k=10)(*jidx.compile_queries(term_lists, ops))),
        (build_sharded_knn_step(grid, k=10)(q), build_sharded_knn_step(one, k=10)(q),
         jknn(jidx, k=10)(q)),
    ):
        for a, b, j in zip(got, ref, jref):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            if a.dtype == torch.float32:
                np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=1e-5)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(j))


def test_stacked_folds_and_replicas():
    """A Stacked array puts fold c of the stack on every data row's slot
    c; writes land on row 0 and replicate to the other rows."""
    from elasticsearch_tpu_torch.parallel import make_mesh
    from elasticsearch_tpu_torch.parallel.sharded import Stacked

    mesh = make_mesh(3, n_data=2, devices=[CPU] * 6)
    host = np.arange(9 * 2, dtype=np.int32).reshape(9, 2)
    st = Stacked.put(mesh, 3, host)
    assert st.shape == (9, 2) and st.dtype == torch.int32
    for r in range(2):
        for c in range(3):
            np.testing.assert_array_equal(st.at(r, c).numpy(), host[3 * c : 3 * c + 3])
    z = Stacked.full(mesh, 3, (2,), torch.int32, -1)
    for e in range(9):
        z[e, :].copy_(torch.from_numpy(host[e]))
    assert (z.at(1, 2).numpy() == -1).all()
    z.replicate()
    for r in range(2):
        np.testing.assert_array_equal(
            torch.cat([z.at(r, c) for c in range(3)]).numpy(), host
        )
    assert z.entry(7, r=1).tolist() == host[7].tolist()
