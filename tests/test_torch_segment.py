"""The port's copies of the host-side index modules against the JAX
package's: the same documents give the same segment arrays, and
`segment_from_reference` carries a reference segment across intact."""

import dataclasses

import numpy as np
import pytest
import torch

from elasticsearch_tpu.analysis import AnalysisRegistry as JAnalysis
from elasticsearch_tpu.index.mapping import DocumentParser as JParser
from elasticsearch_tpu.index.mapping import Mappings as JMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JBuilder
from elasticsearch_tpu.utils import smallfloat as jsmallfloat

from elasticsearch_tpu_torch.analysis import AnalysisRegistry
from elasticsearch_tpu_torch.convert import segment_from_reference
from elasticsearch_tpu_torch.index import segment as tsegment
from elasticsearch_tpu_torch.index.mapping import DocumentParser, Mappings
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.utils import smallfloat

torch.set_num_threads(1)

MAPPING = {
    "properties": {
        "title": {"type": "text", "analyzer": "english"},
        "body": {"type": "text"},
        "tag": {"type": "keyword"},
        "views": {"type": "integer"},
        "vec": {"type": "dense_vector", "dims": 8, "similarity": "cosine"},
        "raw": {"type": "dense_vector", "dims": 4, "similarity": "dot_product"},
        "ml": {"type": "sparse_vector"},
    }
}

WORDS = (
    "Running runners ran quickly over the lazy dogs' backs; "
    "the QUICK brown fox jumps — naïve café déjà vu 2024-01-05 e-mail"
).split()


def docs(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        src = {
            "title": " ".join(rng.choice(WORDS, size=int(rng.integers(1, 6)))),
            "body": " ".join(rng.choice(WORDS, size=int(rng.integers(0, 30)))),
            "tag": [str(x) for x in rng.choice(["a", "b", "c"], size=int(rng.integers(1, 3)))],
            "views": int(rng.integers(0, 100)),
            "vec": rng.standard_normal(8).astype(np.float32).tolist(),
            "ml": {f"t{j}": float(rng.random()) for j in rng.choice(12, size=3, replace=False)},
        }
        if i % 7 == 0:
            src.pop("vec")
        if i % 5 == 0:
            src["raw"] = rng.standard_normal(4).astype(np.float32).tolist()
        out.append((f"d{i}", src))
    return out


def build_both(seed, n):
    jm, tm = JMappings(MAPPING), Mappings(MAPPING)
    jp, tp = JParser(jm, JAnalysis()), DocumentParser(tm, AnalysisRegistry())
    jb, tb = JBuilder(jm), SegmentBuilder(tm)
    for doc_id, src in docs(seed, n):
        jb.add(jp.parse(doc_id, src))
        tb.add(tp.parse(doc_id, src))
    return jb.build(), tb.build()


def assert_same_value(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if not f.name.startswith("_"):
                assert_same_value(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    else:
        assert a == b, where


def assert_same_segment(ref, seg):
    assert seg.num_docs == ref.num_docs
    assert list(seg.doc_ids) == list(ref.doc_ids)
    assert list(seg.sources) == list(ref.sources)
    for family in ("postings", "numerics", "ordinals", "vectors", "multi_vectors", "sparse"):
        a, b = getattr(ref, family), getattr(seg, family)
        assert sorted(a) == sorted(b), family
        for name in a:
            assert_same_value(a[name], b[name], f"{family}[{name}]")


@pytest.mark.parametrize("seed,n", [(0, 60), (1, 200), (2, 1)])
def test_builder_gives_the_same_arrays(seed, n):
    ref, seg = build_both(seed, n)
    assert isinstance(seg, tsegment.Segment)
    assert_same_segment(ref, seg)


@pytest.mark.parametrize("seed,n", [(3, 80), (4, 150)])
def test_segment_from_reference_round_trip(seed, n):
    ref, built = build_both(seed, n)
    seg = segment_from_reference(ref)
    assert isinstance(seg, tsegment.Segment)
    assert_same_segment(ref, seg)
    assert_same_segment(built, seg)
    # arrays are shared, not copied; objects are the port's own
    pf_ref, pf = ref.postings["body"], seg.postings["body"]
    assert pf.doc_ids is pf_ref.doc_ids
    assert type(pf) is tsegment.PostingsField and type(pf.stats) is tsegment.FieldStats
    assert pf.term_id(pf.terms[0]) == 0


def test_smallfloat_tables_identical():
    np.testing.assert_array_equal(smallfloat.LENGTH_TABLE, jsmallfloat.LENGTH_TABLE)
    lengths = np.arange(0, 5000, 7)
    np.testing.assert_array_equal(
        smallfloat.encode_norms(lengths), jsmallfloat.encode_norms(lengths)
    )


def test_segment_has_no_persistence_in_this_slice(tmp_path):
    """The port's Segment had no save/load while on-disk shards were cut;
    since they are ported it has both, in the reference's format: what
    the port saves loads in the JAX package and in the port as the
    reference's arrays."""
    from elasticsearch_tpu.index.segment import Segment as JSegment

    ref, seg = build_both(5, 60)
    seg.save(str(tmp_path / "s"))
    assert_same_segment(ref, JSegment.load(str(tmp_path / "s")))
    assert_same_segment(ref, tsegment.Segment.load(str(tmp_path / "s")))
