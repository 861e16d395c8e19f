"""elasticsearch_tpu_torch — Elasticsearch-shaped serving in PyTorch for NVIDIA GPUs.

The counterpart of `elasticsearch_tpu` (the JAX package, which stays the
reference): the same tiled columnar segments and the same query
semantics, with device code written as PyTorch functions over tensors
and the one hand-written kernel (`ops/int8_knn.py`, source in
`csrc/int8_knn.cu`) in CUDA C++ for Hopper (sm_90a).

Layout mirrors the reference package module for module, so a reader
finds each counterpart under the same relative path:

  utils/, analysis/, index/, models/, common/, tasks/, ingest/,
  script/, plugins.py, reindex.py, search/{dsl,executor,admission,
  aggs,coordinator,failures,query_cache,ann,rescorer,highlight}.py,
  rest/router.py
                       host-side copies (numpy / pure Python);
                       models/rerank.py is the rerank model registry and
                       its host maxsim oracle, search/rescorer.py the
                       `rescore` phase's parsing, plans and host blend
  ops/scoring.py       BM25 tile scoring, single- and multi-field fused
                       scorers, chunked scorer, cross-segment merges, kNN
  ops/fusion.py        reciprocal-rank fusion of hybrid legs
  ops/wand.py          block-max tiling and bounds (host numpy, device
                       tiles)
  ops/int8_knn.py      int8 kNN scoring: CUDA kernel + plain version
  ops/ivf.py           IVF ANN: seeded k-means on the device, probed search
  ops/impact.py, ops/agg_kernels.py
                       learned-sparse impact tiles; device aggregations
  ops/rerank.py        late-interaction (maxsim) rescore of a window
  ops/index_build.py   segment-build ops (postings tiles, impacts,
                       ordinal CSRs, vector columns, agg tables) on the
                       index's device; index/segment_build.py drives them
  search/executor_torch.py   TorchExecutor (counterpart of JaxExecutor)
  search/batcher.py    QueryBatcher: the match, serve, knn, sparse, agg and
                       rerank families
  cluster/, rest/      IndexService, ClusterService, the REST server
  index/segment.py, index/engine.py, index/crashpoints.py, native/,
  snapshots/           on-disk shards: Segment.save/load (the same format
                       as the reference), flush and crash recovery, the
                       crash matrix, the postings codec (host C++ from
                       csrc/postings_codec.cpp, built with g++ into
                       _build/), fs snapshots and restore
  cli.py, __main__.py  `python -m elasticsearch_tpu_torch
                       {serve,version,check,plugin}`
  parallel/            the serving mesh: MeshExecutor, one stacked launch
                       over every (shard, segment) entry of an index
  convert.py           carries segments / quantized corpora across

Nothing here imports `jax` or `elasticsearch_tpu`. Entry points run on
`cuda` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
