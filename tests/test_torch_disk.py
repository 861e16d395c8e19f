"""The port's on-disk shards against the JAX package, on the CPU.

Contract under test:
  * the postings codec (`native/`): the C++ library is built into the
    port's `_build/`, its bytes equal the NumPy fallback's and the JAX
    package's on the same seeded input, streams round-trip, and a
    corrupt stream raises `ValueError`;
  * `Segment.save`/`load` keep every column family bit for bit (text
    with positions and impacts, keyword ordinals, numerics, a cosine and
    an `l2_norm` dense_vector, rank_vectors, sparse_vector), under both
    codecs, and a segment directory written by either package loads in
    the other;
  * the crash matrix (`index/crashpoints.py`): every write-path site x
    both durabilities recovers the same state (ids, versions, seq_nos,
    sources) as the JAX package's crash matrix on the same workload and
    rule, and the recovered reader gives the same pages on
    `TorchExecutor(device="cpu")` as on the numpy oracle;
  * tests/test_durability.py's torn tail, reopen hygiene, async
    contract, segment quarantine and plumbing on the port's engines;
  * a translog replay builds its segment on the index's device; only an
    injected `build.device` fault or a ledger degrade builds it on the
    host, and a `RuntimeError` in a build op fails the shard's open;
  * a node with a data path recovers its indexes, cluster state,
    aliases, templates, pipelines and repositories after a restart, as
    the JAX package's node does.

The workloads are this file's own copies of tests/test_durability.py's
and tests/test_native_plugins_cli.py's. What `TestReplicaConvergence`
covers there (replica failure, peer recovery, node crash and restart
across nodes, primary promotion) is multi-node and lives in
tests/test_torch_replication.py, with the peer-recovery half of the
torn-transfer test.
"""

import json
import os

import numpy as np
import pytest
import torch

from elasticsearch_tpu.analysis import AnalysisRegistry as JAnalysisRegistry
from elasticsearch_tpu.cluster.service import ClusterService as JClusterService
from elasticsearch_tpu.index import crashpoints as jcrash
from elasticsearch_tpu.index.mapping import DocumentParser as JDocumentParser
from elasticsearch_tpu.index.mapping import Mappings as JMappings
from elasticsearch_tpu.index.segment import Segment as JSegment
from elasticsearch_tpu.index.segment import SegmentBuilder as JSegmentBuilder
from elasticsearch_tpu.native import codec as jcodec

from elasticsearch_tpu_torch.analysis import AnalysisRegistry
from elasticsearch_tpu_torch.cluster.indices import IndexService
from elasticsearch_tpu_torch.cluster.service import ClusterService
from elasticsearch_tpu_torch.common.faults import SimulatedCrash, faults
from elasticsearch_tpu_torch.common.memory import hbm_ledger
from elasticsearch_tpu_torch.index import crashpoints, segment_build
from elasticsearch_tpu_torch.index.crashpoints import (
    ENGINE_CRASH_SITES,
    WORKLOAD_MAPPING,
    AckLedger,
    run_engine_crash_case,
    run_workload,
    verify_recovery,
)
from elasticsearch_tpu_torch.index.engine import ShardEngine
from elasticsearch_tpu_torch.index.mapping import DocumentParser, Mappings
from elasticsearch_tpu_torch.index.segment import Segment, SegmentBuilder
from elasticsearch_tpu_torch.index.translog import Translog, durability_stats_snapshot
from elasticsearch_tpu_torch.native import codec
from elasticsearch_tpu_torch.native import (
    native_available,
    tiles_decode,
    tiles_encode,
    vb_decode,
    vb_encode,
)
from elasticsearch_tpu_torch.ops import index_build as ib
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.executor import NumpyExecutor
from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

torch.set_num_threads(1)

CPU = torch.device("cpu")
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]
DIMS = 8
RICH_MAPPINGS = {
    "properties": {
        "body": {"type": "text"},
        "title": {"type": "text"},
        "tag": {"type": "keyword"},
        "popularity": {"type": "integer"},
        "day": {"type": "date"},
        "emb": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
        "emb2": {"type": "dense_vector", "dims": 4, "similarity": "l2_norm"},
        "toks": {"type": "rank_vectors", "dims": 4, "similarity": "cosine"},
        "ml": {"type": "sparse_vector"},
    }
}
PARITY_BODIES = ({"match": {"body": "shared"}}, {"match": {"body": "alpha"}})


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    """The port's own fault registry and admission controller (the
    conftest resets only the JAX package's)."""
    yield
    from elasticsearch_tpu_torch.search.admission import admission

    admission.reset()
    if faults.active:
        faults.clear()


@pytest.fixture
def device_build_auto(monkeypatch):
    monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "auto")
    yield


def rich_docs(n=90, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        src = {
            "body": " ".join(rng.choice(WORDS, size=int(rng.integers(1, 10)))),
            "popularity": int(rng.integers(0, 100)),
        }
        if i % 3 == 0:
            src["title"] = " ".join(rng.choice(WORDS, size=3))
        if i % 2 == 0:
            src["tag"] = [str(t) for t in rng.choice(["a", "b", "c", "d"], size=int(rng.integers(1, 4)))]
        if i % 4 == 0:
            src["day"] = "2026-01-%02d" % (1 + i % 27)
        if i % 2 == 1:
            src["emb"] = rng.normal(size=DIMS).astype(np.float32).tolist()
        if i % 5 == 0:
            src["emb2"] = rng.normal(size=4).astype(np.float32).tolist()
        if i % 3 == 1:
            src["toks"] = rng.normal(size=(int(rng.integers(1, 5)), 4)).astype(np.float32).tolist()
        if i % 3 == 2:
            src["ml"] = {str(w): float(rng.random() * 3) for w in rng.choice(WORDS, size=3)}
        out.append((f"d{i}", src))
    return out


def build_pair(n=90, seed=0):
    """The same docs built into a segment by each package's host builder."""
    docs = rich_docs(n, seed)
    out = []
    for maps_cls, reg_cls, parser_cls, builder_cls in (
        (Mappings, AnalysisRegistry, DocumentParser, SegmentBuilder),
        (JMappings, JAnalysisRegistry, JDocumentParser, JSegmentBuilder),
    ):
        maps = maps_cls(RICH_MAPPINGS)
        parser = parser_cls(maps, reg_cls())
        builder = builder_cls(maps, 3)
        for doc_id, src in docs:
            builder.add(parser.parse(doc_id, src))
        out.append(builder.build())
    return out


def same_array(name, a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert np.array_equal(a, b), name


def assert_segments_identical(ref, got):
    """Every column of every family, dtype, shape and bits."""
    assert ref.num_docs == got.num_docs
    assert ref.generation == got.generation
    assert ref.doc_ids == got.doc_ids
    assert ref.sources == got.sources
    assert sorted(ref.postings) == sorted(got.postings)
    for f, rp in ref.postings.items():
        gp = got.postings[f]
        assert rp.terms == gp.terms, f
        for attr in (
            "term_df", "term_total_tf", "term_tile_start", "term_tile_count",
            "doc_ids", "tfs", "tile_max_tf", "tile_min_norm", "norms",
            "term_pos_start", "pos_offsets", "pos_data", "impacts", "impact_scales",
        ):
            ra, ga = getattr(rp, attr), getattr(gp, attr)
            if ra is None or ga is None:
                assert ra is None and ga is None, (f, attr)
                continue
            same_array(f"{f}.{attr}", ra, ga)
        assert vars(rp.stats) == vars(gp.stats), f
    assert sorted(ref.ordinals) == sorted(got.ordinals)
    for f, ro in ref.ordinals.items():
        go = got.ordinals[f]
        assert ro.ord_terms == go.ord_terms, f
        for attr in ("ords", "mv_ords", "mv_offsets"):
            same_array(f"{f}.{attr}", getattr(ro, attr), getattr(go, attr))
    assert sorted(ref.vectors) == sorted(got.vectors)
    for f, rv in ref.vectors.items():
        gv = got.vectors[f]
        assert rv.similarity == gv.similarity
        for attr in ("vectors", "exists", "unit_vectors"):
            ra, ga = getattr(rv, attr), getattr(gv, attr)
            if ra is None or ga is None:
                assert ra is None and ga is None, (f, attr)
                continue
            same_array(f"{f}.{attr}", ra, ga)
    assert sorted(ref.multi_vectors) == sorted(got.multi_vectors)
    for f, rm in ref.multi_vectors.items():
        gm = got.multi_vectors[f]
        assert rm.similarity == gm.similarity
        for attr in ("tok_vectors", "tok_offsets", "exists"):
            same_array(f"{f}.{attr}", getattr(rm, attr), getattr(gm, attr))
    assert sorted(ref.numerics) == sorted(got.numerics)
    for f, rn in ref.numerics.items():
        gn = got.numerics[f]
        same_array(f"{f}.values", rn.values, gn.values)
        same_array(f"{f}.exists", rn.exists, gn.exists)
    assert sorted(ref.sparse) == sorted(got.sparse)
    for f, rs in ref.sparse.items():
        gs = got.sparse[f]
        assert rs.terms == gs.terms and rs.pruned == gs.pruned, f
        for attr in ("term_df", "term_tile_start", "term_tile_count", "doc_ids", "weights",
                     "qweights", "scales", "tile_max", "tile_qmax", "exists"):
            same_array(f"{f}.{attr}", getattr(rs, attr), getattr(gs, attr))


def seeded_tiles(seed, n_tiles=64, universe=1_000_000):
    rng = np.random.default_rng(seed)
    tiles = np.full((n_tiles, 128), -1, np.int32)
    for t in range(n_tiles):
        k = int(rng.integers(1, 129))
        tiles[t, :k] = np.sort(rng.choice(universe, size=k, replace=False)).astype(np.int32)
    return tiles


# ---------------------------------------------------------------------------
# the postings codec
# ---------------------------------------------------------------------------


def test_native_lib_builds_into_build_dir():
    """g++ is on this host, so the native path is live; the library sits
    in the port's `_build/` under a digest of source and flags, never
    beside the sources."""
    assert native_available()
    lib = codec._lib_path()
    assert os.path.dirname(lib) == str(codec.BUILD_DIR)
    assert os.path.isfile(lib)
    assert os.path.basename(lib).startswith("libpostings_")
    assert codec._source_path().endswith(os.path.join("csrc", "postings_codec.cpp"))
    assert not [f for f in os.listdir(os.path.dirname(codec.__file__)) if f.endswith(".so")]


def test_codec_source_is_the_repo_native_source():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "native", "postings_codec.cpp"), "rb") as f:
        ref = f.read()
    with open(codec._source_path(), "rb") as f:
        assert f.read() == ref


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cpp_python_parity(seed):
    tiles = seeded_tiles(seed, 8, 10_000)
    enc = tiles_encode(tiles)
    assert codec._py_tiles_encode(tiles) == enc
    same_array("tiles", codec._py_tiles_decode(enc, 8, 128), tiles_decode(enc, 8, 128))
    v = np.random.default_rng(seed).integers(-300, 100_000, size=512).astype(np.int32)
    assert codec._py_vb_encode(v) == vb_encode(v)
    same_array("vb", codec._py_vb_decode(vb_encode(v), len(v)), v)


@pytest.mark.parametrize("seed", [4, 5])
def test_codec_bytes_equal_jax_package(seed):
    tiles = seeded_tiles(seed)
    assert tiles_encode(tiles) == jcodec.tiles_encode(tiles)
    v = np.random.default_rng(seed).integers(-5, 100_000, size=4096).astype(np.int32)
    assert vb_encode(v) == jcodec.vb_encode(v)
    # and the port decodes the reference's bytes
    same_array("tiles", tiles_decode(jcodec.tiles_encode(tiles), *tiles.shape), tiles)


def test_varint_roundtrip():
    v = np.random.default_rng(1).integers(-5, 100000, size=4096).astype(np.int32)
    same_array("vb", vb_decode(vb_encode(v), len(v)), v)


def test_tiles_roundtrip_and_compression():
    tiles = seeded_tiles(2)
    enc = tiles_encode(tiles)
    same_array("tiles", tiles_decode(enc, 64, 128), tiles)
    assert len(enc) < tiles.nbytes / 2  # delta+varint actually shrinks


@pytest.mark.parametrize("native", [True, False])
def test_corrupt_stream_rejected(native, monkeypatch):
    if not native:
        monkeypatch.setattr(codec, "_load", lambda: None)
    with pytest.raises(ValueError):
        vb_decode(b"\xff\xff", 4)
    with pytest.raises(ValueError):
        tiles_decode(b"\x02\x80", 1, 128)
    unsorted = np.full((1, 128), -1, np.int32)
    unsorted[0, :3] = [5, 3, 9]
    with pytest.raises(ValueError):
        tiles_encode(unsorted)


# ---------------------------------------------------------------------------
# Segment.save / load: bit for bit, across packages
# ---------------------------------------------------------------------------


def test_rich_segment_has_every_family():
    seg, jseg = build_pair()
    assert_segments_identical(jseg, seg)
    body = seg.postings["body"]
    assert body.has_positions and body.impacts is not None
    assert set(seg.ordinals) >= {"tag"} and set(seg.numerics) >= {"popularity", "day"}
    assert {v.similarity for v in seg.vectors.values()} == {"cosine", "l2_norm"}
    assert set(seg.multi_vectors) == {"toks"} and set(seg.sparse) == {"ml"}


@pytest.mark.parametrize("codec_name", ["default", "best_compression"])
@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_segment_save_load_bit_for_bit(tmp_path, codec_name, writer, reader):
    seg, jseg = build_pair()
    src = seg if writer == "port" else jseg
    path = str(tmp_path / "seg")
    src.save(path, codec=codec_name)
    names = set(os.listdir(path))
    assert {"segment.json", "arrays.npz"} <= names
    assert ("docs.json.gz" in names) == (codec_name == "best_compression")
    with open(os.path.join(path, "segment.json")) as f:
        manifest = json.load(f)
    assert manifest["format_version"] == 1 and manifest["codec"] == codec_name
    arrays = set(np.load(os.path.join(path, "arrays.npz")).files)
    assert ("body.doc_ids_vb" in arrays) == (codec_name == "best_compression")
    loaded = (Segment if reader == "port" else JSegment).load(path)
    assert_segments_identical(seg if reader == "port" else jseg, loaded)


@pytest.mark.parametrize("codec_name", ["default", "best_compression"])
def test_both_packages_write_the_same_arrays(tmp_path, codec_name):
    seg, jseg = build_pair()
    seg.save(str(tmp_path / "port"), codec=codec_name)
    jseg.save(str(tmp_path / "jax"), codec=codec_name)
    with open(tmp_path / "port" / "segment.json") as a, open(tmp_path / "jax" / "segment.json") as b:
        assert json.load(a) == json.load(b)
    pa = np.load(str(tmp_path / "port" / "arrays.npz"))
    ja = np.load(str(tmp_path / "jax" / "arrays.npz"))
    assert sorted(pa.files) == sorted(ja.files)
    for k in pa.files:
        same_array(k, ja[k], pa[k])


def test_shard_written_by_jax_engine_opens_in_port(tmp_path):
    from elasticsearch_tpu.index.engine import ShardEngine as JShardEngine

    path = str(tmp_path / "shard")
    jeng = JShardEngine(JMappings(RICH_MAPPINGS), JAnalysisRegistry(), path=path)
    for doc_id, src in rich_docs(40, 7):
        jeng.index(doc_id, src)
    jeng.refresh()
    jeng.delete("d3")
    jeng.flush()
    jeng.index("tail", {"body": "alpha tail"})
    jstate = jcrash.engine_state_checksum(jeng)
    jeng.crash()
    eng = ShardEngine(Mappings(RICH_MAPPINGS), AnalysisRegistry(), path=path, device=CPU)
    try:
        assert crashpoints.engine_state_checksum(eng) == jstate
        assert eng.get("d3") is None and eng.get("tail") is not None
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the crash matrix
# ---------------------------------------------------------------------------


def recovered_state(eng):
    out = {}
    for doc_id in sorted(d for d, ve in eng._versions.items() if not ve.deleted):
        doc = eng.get(doc_id)
        if doc is not None:
            out[doc_id] = (doc["_version"], doc["_seq_no"], doc["_source"])
    return out


def assert_search_parity(eng):
    """The recovered reader serves the same pages on the port's executor
    (CPU tensors) as on the numpy oracle: ids, scores and totals."""
    reader = eng.reader()
    nex = NumpyExecutor(reader)
    tex = TorchExecutor(reader, device="cpu")
    try:
        for body in PARITY_BODIES:
            q = dsl.parse_query(body)
            nt, tt = nex.search(q, size=50), tex.search(q, size=50)
            assert [(h.doc_id, h.score) for h in nt.hits] == [(h.doc_id, h.score) for h in tt.hits], body
            assert nt.total == tt.total
    finally:
        tex.close()


class TestCrashMatrix:
    @pytest.mark.parametrize("durability", ["request", "async"])
    @pytest.mark.parametrize(
        "label,rule", ENGINE_CRASH_SITES,
        ids=[label for label, _ in ENGINE_CRASH_SITES],
    )
    def test_crash_site_contract(self, tmp_path, device_build_auto, label, rule, durability):
        """Each cell recovers what the JAX package's cell recovers, builds
        its replay on the device, and serves the oracle's pages."""
        before = dict(segment_build.INGEST_STATS)
        eng, ledger, report = run_engine_crash_case(
            str(tmp_path / "shard"), rule, durability, sync_interval=3600.0, device=CPU,
        )
        jeng, jledger, jreport = jcrash.run_engine_crash_case(
            str(tmp_path / "jshard"), rule, durability, sync_interval=3600.0,
        )
        try:
            assert report["crashed"], f"{label}: the crash never fired"
            assert report == jreport
            assert [(d, vars(op)) for d, op in ledger.ops] == [(d, vars(op)) for d, op in jledger.ops]
            assert recovered_state(eng) == recovered_state(jeng)
            assert crashpoints.engine_state_checksum(eng) == jcrash.engine_state_checksum(jeng)
            if durability == "request":
                assert report["lost_acks_beyond_bound"] == 0
                assert report["durable_bound"] == report["max_acked_seq"]
            assert segment_build.INGEST_STATS["host_builds"] == before["host_builds"]
            assert_search_parity(eng)
            r = eng.index("post", {"body": "post crash write", "n": 1})
            assert r.seq_no > report["durable_bound"] - 1
            eng.refresh()
            assert eng.get("post") is not None
        finally:
            eng.close()
            jeng.close()

    def test_engine_remains_recoverable_after_repeated_crashes(self, tmp_path):
        path = str(tmp_path / "shard")
        eng, _, _ = run_engine_crash_case(
            path, {"site": "engine.flush", "match": {"stage": "pre_manifest"}}, "request", device=CPU,
        )
        eng.close()
        eng2, _, report2 = run_engine_crash_case(
            path, {"site": "translog.append", "skip": 5}, "request", device=CPU,
        )
        try:
            assert report2["crashed"]
            assert report2["lost_acks_beyond_bound"] == 0
            assert_search_parity(eng2)
        finally:
            eng2.close()


def make_engine(path=None, **kw):
    kw.setdefault("device", CPU)
    return ShardEngine(Mappings(WORKLOAD_MAPPING), AnalysisRegistry(), path=path, **kw)


# ---------------------------------------------------------------------------
# torn tails
# ---------------------------------------------------------------------------


class TestTornTail:
    def test_reopen_truncates_torn_tail_and_keeps_later_ops(self, tmp_path):
        tl_dir = str(tmp_path / "tl")
        tl = Translog(tl_dir)
        tl.add({"op": "index", "id": "a", "seq_no": 0, "version": 1, "source": {"n": 1}})
        tl.close()
        with open(os.path.join(tl_dir, "translog-1.log"), "ab") as f:
            f.write(b'{"op":"index","id":"b","se')
        before = durability_stats_snapshot()["torn_tails_truncated"]
        tl2 = Translog(tl_dir)
        assert durability_stats_snapshot()["torn_tails_truncated"] == before + 1
        tl2.add({"op": "index", "id": "c", "seq_no": 1, "version": 1, "source": {"n": 3}})
        assert [o["id"] for o in tl2.read_ops_after(-1)] == ["a", "c"]
        tl2.close()

    def test_torn_garbage_with_newline_also_truncated(self, tmp_path):
        tl_dir = str(tmp_path / "tl")
        tl = Translog(tl_dir)
        tl.add({"op": "index", "id": "a", "seq_no": 0, "version": 1})
        tl.close()
        with open(os.path.join(tl_dir, "translog-1.log"), "ab") as f:
            f.write(b"\x00\x17garbage{{{\nmore-garbage\n")
        tl2 = Translog(tl_dir)
        tl2.add({"op": "index", "id": "b", "seq_no": 1, "version": 1})
        assert [o["id"] for o in tl2.read_ops_after(-1)] == ["a", "b"]
        tl2.close()

    def test_engine_level_torn_crash_recovers(self, tmp_path):
        p = str(tmp_path / "shard")
        eng = make_engine(p)
        eng.index("a", {"body": "full record"})
        faults.configure({"seed": 0, "rules": [
            {"site": "translog.append", "kind": "crash", "torn": True, "times": 1},
        ]})
        with pytest.raises(SimulatedCrash):
            eng.index("b", {"body": "torn record"})
        faults.clear()
        eng.crash()
        eng2 = make_engine(p)
        assert eng2.get("a") is not None
        assert eng2.get("b") is None  # never acked, never durable
        eng2.index("c", {"body": "post recovery"})
        eng2.close()
        eng3 = make_engine(p)
        assert eng3.get("c") is not None
        eng3.close()


# ---------------------------------------------------------------------------
# reopen hygiene
# ---------------------------------------------------------------------------


class TestReopenHygiene:
    def test_orphan_checkpoint_tmp_removed(self, tmp_path):
        tl_dir = str(tmp_path / "tl")
        tl = Translog(tl_dir)
        tl.add({"op": "index", "id": "a", "seq_no": 0, "version": 1})
        tl.close()
        with open(os.path.join(tl_dir, "translog.ckp.tmp"), "w") as f:
            f.write('{"generation": 999}')
        before = durability_stats_snapshot()["orphan_checkpoints_removed"]
        tl2 = Translog(tl_dir)
        assert not os.path.exists(os.path.join(tl_dir, "translog.ckp.tmp"))
        assert durability_stats_snapshot()["orphan_checkpoints_removed"] == before + 1
        assert tl2.generation == 1
        tl2.close()

    def test_stale_generation_newer_than_checkpoint_removed(self, tmp_path):
        tl_dir = str(tmp_path / "tl")
        tl = Translog(tl_dir)
        tl.add({"op": "index", "id": "a", "seq_no": 0, "version": 1})
        tl.close()
        with open(os.path.join(tl_dir, "translog-2.log"), "wb") as f:
            f.write(b'{"op":"index","id":"phantom","se')
        before = durability_stats_snapshot()["stale_generations_removed"]
        tl2 = Translog(tl_dir)
        assert not os.path.exists(os.path.join(tl_dir, "translog-2.log"))
        assert durability_stats_snapshot()["stale_generations_removed"] == before + 1
        assert [o["id"] for o in tl2.read_ops_after(-1)] == ["a"]
        tl2.roll_generation()
        tl2.add({"op": "index", "id": "b", "seq_no": 1, "version": 1})
        assert [o["id"] for o in tl2.read_ops_after(-1)] == ["a", "b"]
        tl2.close()

    def test_orphan_manifest_tmp_removed_on_recover(self, tmp_path):
        p = str(tmp_path / "shard")
        eng = make_engine(p)
        eng.index("a", {"body": "committed"})
        eng.flush()
        eng.close()
        with open(os.path.join(p, "manifest.json.tmp"), "w") as f:
            f.write('{"generation": 999, "segments": []')
        before = durability_stats_snapshot()["orphan_manifests_removed"]
        eng2 = make_engine(p)
        assert not os.path.exists(os.path.join(p, "manifest.json.tmp"))
        assert durability_stats_snapshot()["orphan_manifests_removed"] == before + 1
        assert eng2.get("a") is not None
        eng2.close()

    def test_trim_crash_between_checkpoint_and_delete(self, tmp_path):
        p = str(tmp_path / "shard")
        eng = make_engine(p)
        eng.index("a", {"body": "epoch one"})
        eng.flush()
        tl_dir = os.path.join(p, "translog")
        with open(os.path.join(tl_dir, "translog-1.log"), "w") as f:
            f.write(json.dumps({"op": "index", "id": "a", "seq_no": 0, "version": 1,
                                "source": {"body": "epoch one"}}) + "\n")
        eng.close()
        eng2 = make_engine(p)
        assert eng2.num_docs == 1
        assert eng2.get("a")["_version"] == 1  # the covered op is not re-applied
        eng2.index("b", {"body": "epoch two"})
        eng2.flush()
        logs = sorted(f for f in os.listdir(tl_dir) if f.startswith("translog-"))
        assert "translog-1.log" not in logs
        eng2.close()


# ---------------------------------------------------------------------------
# the async-durability contract
# ---------------------------------------------------------------------------


class TestAsyncDurabilityContract:
    def test_request_never_loses_acked_ops(self, tmp_path):
        p = str(tmp_path / "shard")
        eng = make_engine(p, durability="request")
        for i in range(10):
            eng.index(f"d{i}", {"body": f"doc {i}"})
        eng.crash()
        eng2 = make_engine(p)
        for i in range(10):
            assert eng2.get(f"d{i}") is not None, f"lost acked d{i}"
        eng2.close()

    def test_async_window_bounded_by_fsync(self, tmp_path):
        p = str(tmp_path / "shard")
        eng = make_engine(p, durability="async", sync_interval=3600.0)
        eng.index("durable", {"body": "before the fsync"})
        eng.translog.sync()
        synced = eng.translog.last_synced_seq_no
        eng.index("volatile", {"body": "after the fsync"})
        assert eng.translog.last_synced_seq_no == synced
        eng.crash()
        eng2 = make_engine(p)
        assert eng2.get("durable") is not None
        assert eng2.get("volatile") is None
        eng2.close()

    def test_async_interval_clock_bounds_staleness(self, tmp_path):
        import time

        p = str(tmp_path / "shard")
        eng = make_engine(p, durability="async", sync_interval=0.05)
        t0 = time.monotonic()
        acks = []
        i = 0
        while time.monotonic() - t0 < 0.5:
            r = eng.index(f"d{i}", {"body": f"doc {i}"})
            acks.append((r.seq_no, eng.translog.last_synced_seq_no, time.monotonic()))
            i += 1
            time.sleep(0.002)
        assert eng.translog.last_synced_seq_no >= 0
        for seq, _, t_ack in acks:
            for _, synced2, t2 in acks:
                if t2 - t_ack >= 0.12:  # > 2x interval later
                    assert synced2 >= seq, f"op seq {seq} unfsynced {t2 - t_ack:.3f}s after its ack"
                    break
        eng.close()

    def test_roll_generation_crash_window(self, tmp_path):
        p = str(tmp_path / "shard")
        eng = make_engine(p, durability="request")
        for i in range(6):
            eng.index(f"d{i}", {"body": f"doc {i}"})
        faults.configure({"seed": 0, "rules": [
            {"site": "translog.fsync", "kind": "crash", "times": 1},
        ]})
        with pytest.raises(SimulatedCrash):
            eng.flush()
        faults.clear()
        eng.crash()
        eng2 = make_engine(p)
        assert eng2.num_docs == 6
        for i in range(6):
            assert eng2.get(f"d{i}") is not None
        eng2.flush()
        eng2.close()


# ---------------------------------------------------------------------------
# segment quarantine
# ---------------------------------------------------------------------------


class TestSegmentQuarantine:
    def test_torn_transfer_marker_blocks_engine_open(self, tmp_path):
        """A shard dir still holding the `_recovering` marker of a peer
        recovery is a half-copied transfer: no engine opens it, in the
        port as in the JAX package (local mode; re-running the transfer
        is peer recovery, tests/test_torch_replication.py)."""
        from elasticsearch_tpu.cluster.indices import IndexService as JIndexService

        opened = []
        for cls, kw in ((IndexService, {"device": CPU}), (JIndexService, {})):
            base = str(tmp_path / cls.__module__.split(".")[0] / "idx")
            shard_dir = os.path.join(base, "0")
            os.makedirs(shard_dir)
            with open(os.path.join(shard_dir, "_recovering"), "w") as f:
                f.write("node-1")
            with open(os.path.join(shard_dir, "manifest.json"), "w") as f:
                json.dump({"format_version": 2, "generation": 1,
                           "segments": [{"name": "seg_0_0", "live_gen": None}],
                           "max_seq_no": 4, "primary_term": 1}, f)
            idx = cls("torn", settings={"number_of_shards": 2}, base_path=base, **kw)
            try:
                opened.append(sorted(idx.local_shards))
                assert os.path.exists(os.path.join(shard_dir, "manifest.json"))
            finally:
                idx.close()
        assert opened == [[1], [1]]

    def test_crashed_flush_segment_dirs_quarantined(self, tmp_path):
        p = str(tmp_path / "shard")
        eng = make_engine(p)
        eng.index("a", {"body": "alpha one"})
        eng.index("b", {"body": "alpha two"})
        eng.refresh()
        eng.index("c", {"body": "alpha three"})
        eng.refresh()
        faults.configure({"seed": 0, "rules": [
            {"site": "engine.flush", "kind": "crash", "match": {"stage": "pre_manifest"}, "times": 1},
        ]})
        with pytest.raises(SimulatedCrash):
            eng.flush()
        faults.clear()
        eng.crash()
        leftover = [d for d in os.listdir(p) if os.path.isdir(os.path.join(p, d)) and d != "translog"]
        assert leftover
        before = durability_stats_snapshot()["quarantined_segments"]
        eng2 = make_engine(p)
        assert durability_stats_snapshot()["quarantined_segments"] >= before + len(leftover)
        assert eng2.num_docs == 3
        eng2.flush()
        eng2.close()
        eng3 = make_engine(p)
        assert eng3.num_docs == 3
        for doc_id in ("a", "b", "c"):
            assert eng3.get(doc_id) is not None
        assert_search_parity(eng3)
        eng3.close()


# ---------------------------------------------------------------------------
# the replay refresh builds on the index's device
# ---------------------------------------------------------------------------


def crashed_shard_with_tail(path, n=12):
    """A shard with a committed segment and an unflushed tail of n ops."""
    eng = make_engine(path, device_build=True)
    eng.index("committed", {"body": "alpha committed", "tag": "a", "n": 1})
    eng.flush()
    for i in range(n):
        eng.index(f"t{i}", {"body": f"alpha tail {i}", "tag": "b", "n": i})
    eng.crash()


class TestReplayBuild:
    def test_replay_refresh_builds_on_the_device(self, tmp_path, device_build_auto):
        p = str(tmp_path / "shard")
        crashed_shard_with_tail(p)
        before = dict(segment_build.INGEST_STATS)
        eng = make_engine(p, device_build=True)
        try:
            after = segment_build.INGEST_STATS
            assert after["device_builds"] == before["device_builds"] + 1
            assert after["host_builds"] == before["host_builds"]
            assert eng.num_docs == 13
            assert_search_parity(eng)
        finally:
            eng.close()

    @pytest.mark.parametrize("op", ["postings_tiles_device", "ordinals_device", "text_impacts_device"])
    def test_runtime_error_in_a_build_op_fails_the_open(self, tmp_path, device_build_auto, monkeypatch, op):
        p = str(tmp_path / "shard")
        crashed_shard_with_tail(p)

        def boom(*a, **k):
            raise RuntimeError("device build op failed")

        monkeypatch.setattr(ib, op, boom)
        before = dict(segment_build.INGEST_STATS)
        with pytest.raises(RuntimeError, match="device build op failed"):
            make_engine(p, device_build=True)
        assert segment_build.INGEST_STATS["host_builds"] == before["host_builds"]
        assert segment_build.INGEST_STATS["fallbacks"] == before["fallbacks"]
        monkeypatch.undo()
        monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "auto")
        # nothing was lost: the translog still holds the tail
        eng = make_engine(p, device_build=True)
        try:
            assert eng.num_docs == 13
        finally:
            eng.close()

    def test_injected_fault_takes_the_host_build(self, tmp_path, device_build_auto):
        p = str(tmp_path / "shard")
        crashed_shard_with_tail(p)
        faults.configure({"seed": 0, "rules": [{"site": "build.device", "kind": "error", "times": 1}]})
        before = dict(segment_build.INGEST_STATS)
        try:
            eng = make_engine(p, device_build=True)
        finally:
            faults.clear()
        try:
            after = segment_build.INGEST_STATS
            assert after["fallbacks"] == before["fallbacks"] + 1
            assert after["host_builds"] == before["host_builds"] + 1
            assert after["device_builds"] == before["device_builds"]
            assert eng.num_docs == 13
        finally:
            eng.close()

    def test_ledger_degrade_takes_the_host_build(self, tmp_path, device_build_auto):
        p = str(tmp_path / "shard")
        crashed_shard_with_tail(p)
        before = dict(segment_build.INGEST_STATS)
        old_budget = hbm_ledger.budget
        hbm_ledger.budget = 1
        try:
            eng = make_engine(p, device_build=True)
        finally:
            hbm_ledger.budget = old_budget
        try:
            after = segment_build.INGEST_STATS
            assert after["degraded"] == before["degraded"] + 1
            assert after["host_builds"] == before["host_builds"] + 1
            assert eng.num_docs == 13
        finally:
            eng.close()


# ---------------------------------------------------------------------------
# plumbing, and a node's restart held to the JAX package's
# ---------------------------------------------------------------------------


class TestDurabilityPlumbing:
    def test_index_setting_reaches_engine(self, tmp_path):
        idx = IndexService(
            "dur",
            settings={"number_of_shards": 1, "translog.durability": "async",
                      "translog.sync_interval": "200ms"},
            base_path=str(tmp_path / "dur"), device=CPU,
        )
        try:
            eng = idx.local_shard(0)
            assert eng.translog.durability == "async"
            assert eng.translog.sync_interval == pytest.approx(0.2)
            assert eng.device == CPU and eng.device_build
        finally:
            idx.close()

    def test_dynamic_durability_update_reaches_open_engines(self, tmp_path):
        c = ClusterService(data_path=str(tmp_path / "node"), device=CPU)
        try:
            c.create_index("flip", {"settings": {
                "number_of_shards": 1, "translog.durability": "async",
                "translog.sync_interval": "1h",
            }})
            idx = c.get_index("flip")
            eng = idx.local_shard(0)
            idx.index_doc("1", {"f": "volatile until the flip"})
            assert eng.translog.last_synced_seq_no == -1
            c.update_settings("flip", {"index": {"translog.durability": "request"}})
            assert eng.translog.durability == "request"
            assert eng.translog.last_synced_seq_no >= 0
            idx.index_doc("2", {"f": "fsynced per request now"})
            assert eng.translog.stats()["pending_ops"] == 0
        finally:
            c.close()

    def test_invalid_durability_rejected(self):
        from elasticsearch_tpu_torch.common.settings import SettingsError, validate_index_settings

        with pytest.raises(SettingsError):
            validate_index_settings({"translog.durability": "sometimes"}, creating=True)

    def test_nodes_stats_durability_blocks(self, tmp_path):
        from elasticsearch_tpu_torch.rest.actions import RestActions

        c = ClusterService(data_path=str(tmp_path / "node"), device=CPU)
        try:
            c.create_index("st", {"settings": {"number_of_shards": 1}})
            idx = c.get_index("st")
            idx.index_doc("1", {"f": "one"})
            actions = RestActions(c)
            _, resp = actions.nodes_stats(None, {}, {})
            node = resp["nodes"]["node-0"]
            tb = node["translog"]
            assert tb["uncommitted_ops"] >= 1 and tb["appended_ops"] >= 1 and tb["fsyncs"] >= 1
            assert "torn_tails_truncated" in tb and "stale_generations_removed" in tb
            rb = node["recovery"]
            assert "replayed_ops" in rb and "quarantined_segments" in rb
            idx.flush()
            _, resp2 = actions.nodes_stats(None, {}, {})
            assert resp2["nodes"]["node-0"]["translog"]["uncommitted_ops"] == 0
        finally:
            c.close()

    def test_crash_workload_ledger_tracks_acks(self, tmp_path):
        p = str(tmp_path / "shard")
        eng = make_engine(p)
        ledger = AckLedger()
        run_workload(eng, ledger)
        assert ledger.max_acked_seq > 20
        eng.close()
        eng2 = make_engine(p)
        report = verify_recovery(eng2, ledger, "request", eng.translog.last_synced_seq_no)
        assert report["lost_acks_beyond_bound"] == 0
        assert_search_parity(eng2)
        eng2.close()


def drive_node(c):
    """The same cluster-level writes on either package's node."""
    c.create_index("docs", {"settings": {"number_of_shards": 2, "codec": "best_compression"},
                            "mappings": {"properties": {"body": {"type": "text"}, "n": {"type": "integer"}}}})
    c.create_index("other", {"settings": {"number_of_shards": 1}})
    c.update_aliases({"actions": [{"add": {"index": "docs", "alias": "live", "is_write_index": True}}]})
    c.put_template("tpl", {"index_patterns": ["logs-*"], "priority": 3,
                           "template": {"settings": {"number_of_shards": 1}}})
    c.ingest.put_pipeline("up", {"processors": [{"uppercase": {"field": "tag"}}]})
    c.put_repository("r", {"type": "fs", "settings": {"location": "unused-location"}})
    idx = c.get_index("docs")
    for i in range(30):
        idx.index_doc(f"d{i}", {"body": f"alpha doc {i} {'beta' if i % 3 else 'gamma'}", "n": i})
    idx.flush()
    for i in range(30, 40):
        idx.index_doc(f"d{i}", {"body": f"alpha late {i}", "n": i})
    idx.delete_doc("d4")
    idx.refresh()


def node_view(c):
    body = {"query": {"match": {"body": "alpha beta"}}, "size": 50}
    page = c.search("live", body)
    return {
        "indices": sorted(c.indices),
        "aliases": c.get_aliases(),
        "templates": c.get_templates("tpl"),
        "pipelines": c.ingest.bodies(),
        "repositories": c.get_repository("r"),
        "total": page["hits"]["total"],
        "hits": [(h["_id"], h["_score"]) for h in page["hits"]["hits"]],
        "d7": {k: v for k, v in c.get_index("docs").get_doc("d7").items() if k != "_index"},
    }


def test_node_restart_recovers_state_as_the_jax_node(tmp_path):
    views = []
    for name, make in (("port", lambda p: ClusterService(data_path=p, device=CPU)),
                       ("jax", lambda p: JClusterService(data_path=p))):
        path = str(tmp_path / name)
        c = make(path)
        drive_node(c)
        before = node_view(c)
        c.close()
        c2 = make(path)
        try:
            after = node_view(c2)
            assert after == before, name
            assert c2.get_index("docs").get_doc("d4") is None
        finally:
            c2.close()
        views.append(after)
    port, ref = views
    assert port["hits"] == [(i, pytest.approx(s, rel=1e-5)) for i, s in ref["hits"]]
    for key in ("indices", "aliases", "templates", "pipelines", "repositories", "total", "d7"):
        assert port[key] == ref[key], key
