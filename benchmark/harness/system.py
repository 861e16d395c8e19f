"""The system under test: the port's REST server in this process, with
one index whose one shard holds the generated corpus as one segment.

This module and the kinds' `segment` are the only code of the benchmark
that imports the port (`elasticsearch_tpu_torch`). The segment is handed
over the way a force-merged shard holds it (chip_smoke.py's
`install_segment` pattern): `_bulk` of millions of documents through
host analysis would be set-up, not what is served. The configuration's
kind (`kinds/<kind>.py`) lays its columns out and names its mapping and
any index settings of its own; the port uploads and derives the rest.
"""

from __future__ import annotations

import json
import urllib.request

import numpy as np

from .spec import BENCH_DIR, kind

INDEX = "bench"


def whole_segment(n: int, postings=None, vectors=None, **columns):
    """The port's `Segment` of `n` docs (ids "0".."n-1", no sources)
    holding the given columns (`postings`, `vectors`, `sparse`, ...)."""
    from elasticsearch_tpu_torch.index.segment import Segment

    return Segment(num_docs=n, doc_ids=[str(i) for i in range(n)], sources=[None] * n,
                   postings=postings or {}, numerics={}, ordinals={}, vectors=vectors or {},
                   **columns)


def segment(config: dict, corpus: dict, bench_dir=BENCH_DIR):
    """The port's `Segment` of the configuration's corpus."""
    return kind(config, bench_dir).segment(config, corpus)


def index_body(config: dict, bench_dir=BENCH_DIR) -> dict:
    """The index's `PUT` body: the deployment's shape and the shared
    settings, then the kind's own settings and its mapping."""
    own = kind(config, bench_dir).index(config)
    d = config["deployment_shape"]
    return {"settings": {"number_of_shards": d["shards"], "number_of_replicas": d["replicas"],
                         "search.backend": "torch", "refresh_interval": "-1",
                         **own.get("settings", {})},
            "mappings": own["mappings"]}


def http_json(port: int, method: str, path: str, body=None) -> dict:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


class System:
    """The port's server with the corpus installed, on `device`."""

    def __init__(self, config: dict, seg, device, bench_dir):
        from elasticsearch_tpu_torch.rest.server import ElasticsearchTpuServer
        from elasticsearch_tpu_torch.search.admission import admission

        admission.configure(enabled=False)
        self.srv = ElasticsearchTpuServer(port=0, device=device)
        self.srv.start_background()
        self.port = self.srv.port
        http_json(self.port, "PUT", f"/{INDEX}", index_body(config, bench_dir))
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
