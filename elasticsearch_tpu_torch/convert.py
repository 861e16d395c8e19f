"""Carries index state from the JAX package into the port.

Both packages hold segments as numpy arrays and Python lists with the
same field names; these functions read them by duck typing (attribute
names only) and build the port's own objects around the same arrays.
Nothing from the other package is imported, so a test can hand the two
packages one index and compare what they score.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .index import segment as _seg
from .ops.int8_knn import QuantizedVectors
from .ops.ivf import IvfSegmentIndex


def _dataclass_from(cls, ref):
    """An instance of the port's dataclass `cls` with every public field
    read from `ref` (fields `ref` lacks keep their defaults)."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name.startswith("_") or not hasattr(ref, f.name):
            continue
        kwargs[f.name] = getattr(ref, f.name)
    return cls(**kwargs)


def _postings_from(ref) -> _seg.PostingsField:
    pf = _dataclass_from(_seg.PostingsField, ref)
    pf.stats = _dataclass_from(_seg.FieldStats, ref.stats)
    return pf


def segment_from_reference(seg) -> _seg.Segment:
    """The port's `Segment` over the arrays of a reference `Segment`
    (`elasticsearch_tpu.index.segment.Segment`, or anything with its
    attributes). Arrays are shared, not copied: segments are immutable."""
    return _seg.Segment(
        num_docs=seg.num_docs,
        doc_ids=list(seg.doc_ids),
        sources=list(seg.sources),
        postings={f: _postings_from(pf) for f, pf in seg.postings.items()},
        numerics={
            f: _dataclass_from(_seg.NumericField, v) for f, v in seg.numerics.items()
        },
        ordinals={
            f: _dataclass_from(_seg.OrdinalField, v) for f, v in seg.ordinals.items()
        },
        vectors={
            f: _dataclass_from(_seg.VectorField, v) for f, v in seg.vectors.items()
        },
        generation=getattr(seg, "generation", 0),
        multi_vectors={
            f: _dataclass_from(_seg.MultiVectorField, v)
            for f, v in (getattr(seg, "multi_vectors", None) or {}).items()
        },
        sparse={
            f: _dataclass_from(_seg.SparseField, v)
            for f, v in (getattr(seg, "sparse", None) or {}).items()
        },
    )


def quantized_from_reference(qv, device="cuda") -> QuantizedVectors:
    """The port's `QuantizedVectors` over the int8 rows and scales of a
    reference `QuantizedVectors` (its `qvecs`, `scales`, `n`, `dims`,
    `similarity`; device arrays are read back through numpy)."""
    return QuantizedVectors.from_quantized(
        np.asarray(qv.qvecs),
        np.asarray(qv.scales),
        n=qv.n,
        dims=qv.dims,
        similarity=qv.similarity,
        device=device,
    )


def ivf_index_from_reference(idx, device="cuda") -> IvfSegmentIndex:
    """The port's `IvfSegmentIndex` over the cluster-major layout of a
    reference `IvfSegmentIndex` (its `centroids`, `starts`, `counts`,
    `perm`, `vecs_flat`, `v2_flat`, `qvecs_flat`, `scales_flat`, `n`,
    `similarity`; device arrays are read back through numpy), so a probe
    can be held to the reference's on one index, whatever k-means did."""

    def host(a):
        return None if a is None else np.array(a)

    return IvfSegmentIndex.from_layout(
        idx.similarity, idx.n, host(idx.centroids), host(idx.starts),
        host(idx.counts), host(idx.perm), host(idx.vecs_flat),
        host(idx.v2_flat), host(idx.qvecs_flat), host(idx.scales_flat),
        device=device,
    )
