"""The `text` kind: one BM25 `text` field over passages of Zipf tokens.

  * corpus: passage lengths from a clipped log-normal, tokens from a Zipf
    law over the vocabulary. Every seed gets the same sizes (the work of
    a query is set by its terms' document frequencies): the lengths are
    the log-normal's quantiles, and term t occurs its expected number of
    times (the largest remainders rounded up); the seed permutes which
    passage gets which length and where each token falls. Returns the
    token stream (int32, passages in order) and the lengths.
  * segment: the port's `PostingsField`, laid out on the device from the
    token stream and copied to the host.
  * check: plain BM25 (`reference/bm25.py`) in float64; the control is
    the same in bfloat16.

torch and the port are imported inside the functions.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.harness.check import _page
from benchmark.harness.traffic import term_name


def make(config: dict, seed: int, device) -> dict:
    import torch

    from benchmark.harness.corpus import generator

    a = config["assumed"]
    n = int(config["passages"])
    vocab = int(a["vocab"])
    ln = a["length"]
    g = generator(seed, device, 1)
    sigma = float(ln["sigma"])
    mu = math.log(float(ln["mean"])) - sigma * sigma / 2
    q = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    lengths = torch.exp(mu + sigma * torch.special.ndtri(q)).round_()
    lengths = lengths.clamp_(int(ln["min"]), int(ln["max"])).to(torch.int64)
    lengths = lengths[torch.randperm(n, generator=g, device=device)]
    total = int(lengths.sum())
    p = torch.arange(1, vocab + 1, dtype=torch.float64, device=device) ** -float(a["zipf_s"])
    expected = p / p.sum() * total
    counts = expected.floor().to(torch.int64)
    short = total - int(counts.sum())
    counts[torch.topk(expected - counts, short).indices] += 1
    tokens = torch.repeat_interleave(torch.arange(vocab, dtype=torch.int32, device=device), counts)
    stream = tokens[torch.randperm(total, generator=g, device=device)]
    return {"stream": stream, "lengths": lengths, "vocab": vocab}


def client_context(config: dict, corpus: dict) -> dict:
    """Nothing: a `match` body's terms follow from the configuration."""
    return {}


def postings(stream, lengths, vocab: int):
    """The port's `PostingsField` over a token stream: postings
    term-major and doc-ascending in tiles of 128 lanes, norms as Lucene's
    one-byte lengths. Laid out on the stream's device."""
    import torch

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
    from benchmark.harness.system import whole_segment

    n = int(corpus["lengths"].numel())
    field = postings(corpus["stream"], corpus["lengths"], corpus["vocab"])
    return whole_segment(n, postings={config["field"]: field})


def index(config: dict) -> dict:
    return {"mappings": {"properties": {config["field"]: {"type": "text"}}}}


def _reference(config: dict, corpus: dict, dtype=None):
    import torch

    from benchmark.reference.bm25 import Bm25

    return Bm25(corpus["stream"], corpus["lengths"], corpus["vocab"], config["k1"], config["b"],
                dtype=dtype or torch.float64)


def judge_pages(ref, maker, sampled: list, size: int) -> dict:
    worst = {"score_err": 0.0, "hit_gap": 0.0, "total_err": 0}
    for client, i, _t0, _t1, _ok, dig in sampled:
        terms = maker.terms(client, i)
        _docs, vals, count, s, hit = ref.top(terms, size)
        vals = vals.double().cpu().numpy()
        s_host = {}

        def score_of(d):
            if d < 0 or d >= ref.n:
                return None
            if d not in s_host:
                s_host[d] = float(s[d]) if bool(hit[d]) else None
            return s_host[d]

        e, g = _page(vals, score_of, dig["hits"], min(size, count))
        worst["score_err"] = max(worst["score_err"], e)
        worst["hit_gap"] = max(worst["hit_gap"], g)
        total = dig.get("total")
        if isinstance(total, list):
            value, rel = total
            bad = (value != count) if rel == "eq" else not (value is not None and value <= count)
        else:
            bad = total != count
        worst["total_err"] += int(bad)
    return worst


def judge(config: dict, corpus: dict, maker, sampled: list, size: int) -> dict:
    ref = _reference(config, corpus)
    del corpus
    return judge_pages(ref, maker, sampled, size)


def control(config: dict, traffic: dict, corpus: dict, maker, n: int) -> dict:
    """BM25 in bfloat16 in the program's place."""
    import torch

    from benchmark.control import records

    size, clients = int(traffic["size"]), int(traffic["clients"])
    low = _reference(config, corpus, torch.bfloat16)

    def pages(c, i):
        docs, vals, count, *_ = low.top(maker.terms(c, i), size)
        return docs, vals.float(), count

    recs = records(maker, n, clients, pages)
    del low
    return judge_pages(_reference(config, corpus), maker, recs, size)
