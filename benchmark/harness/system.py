"""The system under test: the port's REST server in this process, with
one index whose one shard holds the generated corpus as one segment.

This is the only module of the benchmark that imports the port
(`elasticsearch_tpu_torch`). The segment is handed over the way a
force-merged shard holds it (chip_smoke.py's `install_segment`
pattern): `_bulk` of millions of documents through host analysis would
be set-up, not what is served. The postings are laid out on the device
from the token stream and copied to the host, where the port's
`Segment` keeps its columns; the port uploads and derives the rest.
"""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import torch

from .traffic import term_name

INDEX = "bench"


def postings(stream: torch.Tensor, lengths: torch.Tensor, vocab: int):
    """The port's `PostingsField` over a token stream: postings
    term-major and doc-ascending in tiles of 128 lanes, norms as Lucene's
    one-byte lengths. Laid out on the stream's device."""
    from elasticsearch_tpu_torch.index.segment import INVALID_DOC, TILE, FieldStats, PostingsField
    from elasticsearch_tpu_torch.utils.smallfloat import encode_norms

    dev = stream.device
    n = int(lengths.numel())
    doc_of = torch.repeat_interleave(torch.arange(n, device=dev), lengths)
    key = stream.to(torch.int64) * n + doc_of
    del doc_of
    uniq, counts = torch.unique(key, sorted=True, return_counts=True)
    del key
    u_t = uniq // n
    u_d = (uniq % n).to(torch.int32)
    del uniq
    tf = counts.to(torch.int32)
    term_df = torch.bincount(u_t, minlength=vocab)
    term_total_tf = torch.zeros(vocab, dtype=torch.int64, device=dev).index_add_(0, u_t, counts)
    tile_count = (term_df + TILE - 1) // TILE
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    n_tiles = int(tile_count.sum())
    post_start = torch.cumsum(term_df, 0) - term_df
    rank = torch.arange(len(u_t), device=dev) - post_start[u_t]
    slot = tile_start[u_t] * TILE + rank
    del rank
    doc_ids = torch.full((n_tiles * TILE,), INVALID_DOC, dtype=torch.int32, device=dev)
    tfs = torch.zeros(n_tiles * TILE, dtype=torch.int32, device=dev)
    doc_ids[slot] = u_d
    tfs[slot] = tf
    del slot, u_t, u_d, tf, counts
    doc_ids = doc_ids.view(n_tiles, TILE)
    tfs = tfs.view(n_tiles, TILE)
    norms = encode_norms(lengths.cpu().numpy())
    norms_dev = torch.from_numpy(norms.astype(np.int32)).to(dev)
    valid = doc_ids >= 0
    tile_norms = torch.where(valid, norms_dev[doc_ids.clamp(min=0)], 255)
    tile_min_norm = tile_norms.amin(1).to(torch.uint8)
    del tile_norms, valid, norms_dev
    host = lambda t: t.cpu().numpy()  # noqa: E731
    return PostingsField(
        terms=[term_name(i) for i in range(vocab)],
        term_df=host(term_df.to(torch.int32)),
        term_total_tf=host(term_total_tf),
        term_tile_start=host(tile_start.to(torch.int32)),
        term_tile_count=host(tile_count.to(torch.int32)),
        doc_ids=host(doc_ids),
        tfs=host(tfs),
        tile_max_tf=host(tfs.amax(1)),
        tile_min_norm=host(tile_min_norm),
        norms=norms,
        stats=FieldStats(doc_count=n, sum_total_term_freq=int(lengths.sum()),
                         sum_doc_freq=int(term_df.sum())),
    )


def segment(config: dict, corpus: dict):
    """The port's `Segment` of the configuration's corpus."""
    from elasticsearch_tpu_torch.index.segment import Segment, VectorField

    field = config["field"]
    post, vecs = {}, {}
    if config["kind"] == "text":
        n = int(corpus["lengths"].numel())
        post[field] = postings(corpus["stream"], corpus["lengths"], corpus["vocab"])
    else:
        rows = corpus["vectors"].cpu().numpy()
        n = rows.shape[0]
        # the rows are unit vectors already: one array serves both
        vecs[field] = VectorField(vectors=rows, exists=np.ones(n, bool),
                                  similarity=config["similarity"], unit_vectors=rows)
    return Segment(num_docs=n, doc_ids=[str(i) for i in range(n)], sources=[None] * n,
                   postings=post, numerics={}, ordinals={}, vectors=vecs)


def mapping(config: dict) -> dict:
    f = config["field"]
    if config["kind"] == "text":
        return {"properties": {f: {"type": "text"}}}
    return {"properties": {f: {"type": "dense_vector", "dims": int(config["dims"]),
                               "similarity": config["similarity"]}}}


def http_json(port: int, method: str, path: str, body=None) -> dict:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


class System:
    """The port's server with the corpus installed, on `device`."""

    def __init__(self, config: dict, seg, device):
        from elasticsearch_tpu_torch.rest.server import ElasticsearchTpuServer
        from elasticsearch_tpu_torch.search.admission import admission

        admission.configure(enabled=False)
        self.srv = ElasticsearchTpuServer(port=0, device=device)
        self.srv.start_background()
        self.port = self.srv.port
        d = config["deployment_shape"]
        http_json(self.port, "PUT", f"/{INDEX}", {
            "settings": {"number_of_shards": d["shards"], "number_of_replicas": d["replicas"],
                         "search.backend": "torch", "refresh_interval": "-1"},
            "mappings": mapping(config)})
        eng = self.srv.cluster.get_index(INDEX).shards[0]
        n = seg.num_docs
        eng.segments = [seg]
        eng.live_docs = [None]
        eng.seg_versions = [np.ones(n, np.int64)]
        eng.seg_seqnos = [np.arange(n, dtype=np.int64)]
        eng.seg_names = ["seg_0_0"]
        eng._next_seq = n
        eng.change_generation += 1

    def prewarm(self) -> None:
        """What the port's refresher does after a generation swap
        (`IndexService` calls the new executor's `prewarm`): the uploads,
        the block-max tiling and the chunked scorers; then each text
        field's fused scorer (its dense rows), which the first fused
        request would build. A segment installed by hand skips the
        refresher, so set-up does it here; otherwise the first request
        of each path would build it inside the window."""
        idx = self.srv.cluster.get_index(INDEX)
        ex = idx._executor(idx.shards[0])
        ex.prewarm(idx.settings)
        for si, seg in enumerate(ex.reader.segments):
            for field in seg.postings:
                ex.fused_scorer(si, field)

    @property
    def path(self) -> str:
        return f"/{INDEX}/_search"

    def search(self, body: dict) -> dict:
        return http_json(self.port, "POST", self.path, body)

    def wait_warm(self, timeout: float = 600.0) -> None:
        """Until the batcher's bucket warm-up (every launch width of the
        family, compiled on its first dispatch) has finished."""
        b = getattr(self.srv.cluster.get_index(INDEX), "_batcher", None)
        if b is not None and not b.wait_warm_idle(timeout):
            raise RuntimeError("the batcher's bucket warm-up did not finish")

    def stats(self) -> dict:
        return http_json(self.port, "GET", "/_nodes/stats")

    def traces(self) -> list:
        return http_json(self.port, "GET", "/_internal/traces?n=100000")["traces"]

    def close(self) -> None:
        self.srv.close()
        self.srv = None
