"""The `sparse` kind: one `sparse_vector` field of learned token weights
(ELSER's shape) over passages.

  * corpus: token t is held by a fixed number of passages, df_t =
    round(p_t * N) with p_t = min(cap, c * (t + 1)^-exponent) and c
    fitted to the configuration's mean tokens a passage (`doc_freqs`),
    so every seed gets the same sizes; the seed chooses which passages
    hold each token (a uniform sample without replacement) and the
    weights, log-normal, clipped, then truncated to the significant bits
    Lucene's FeatureField stores. Returns the (passage, token, weight)
    triples term-major, passages ascending within a token: `docs`
    (int32), `weights` (float32) and `df` (int64, a token's run length).
  * segment: the port's `SparseField`, laid out on the device in the
    port's impact order (term-major; weight descending, then doc
    ascending, within a term; tiles of 128 padded with doc -1 and
    weight 0; weights positive, as the law draws them) with its sidecars
    exactly as `index/segment.py`'s `sparse_plan` and `sparse_from_plan`
    define them, then copied to the host. The term-sorted work goes by ranges of terms, so no sort holds
    the whole corpus.
  * check: plain `reference/sparse.py` in float64, judged by the text
    kind's page rules (`gte` totals included); the control is the same
    in bfloat16.

NumPy at the top (the body imports `doc_freqs` in the client
processes); torch and the port inside the functions.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from benchmark.harness.traffic import term_name

TILE = 128
# candidates drawn (or keys sorted) a range of terms, at most
RANGE = 1 << 26


def doc_freqs(config: dict) -> np.ndarray:
    """int64[vocab]: the number of passages holding each token, the same
    for every seed."""
    a = config["assumed"]
    n = int(config["passages"])
    law = a["doc_freq"]
    r = np.arange(1, int(a["vocab"]) + 1, dtype=np.float64) ** -float(law["exponent"])
    cap, mean = float(law["cap"]), float(a["tokens_per_passage"])
    lo, hi = 0.0, mean
    for _ in range(200):
        c = (lo + hi) / 2
        if np.minimum(cap, c * r).sum() < mean:
            lo = c
        else:
            hi = c
    return np.floor(np.minimum(cap, hi * r) * n + 0.5).astype(np.int64)


def ranges(counts: np.ndarray, budget: int = RANGE):
    """[(t0, t1)]: consecutive terms whose counts sum to at most `budget`
    (a term alone may exceed it)."""
    out, t0, acc = [], 0, 0
    for t, c in enumerate(counts.tolist()):
        if acc and acc + c > budget:
            out.append((t0, t))
            t0, acc = t, 0
        acc += c
    if t0 < len(counts):
        out.append((t0, len(counts)))
    return out


def _sample(g, n: int, d, device):
    """For each term of a range, d[j] distinct passages drawn uniformly
    without replacement: (term index in the range, passage), sorted by
    both. Draws more than d[j] passages with replacement (the distinct
    ones of those are a uniform subset), then keeps a uniform d[j] of
    them; draws again, with twice the margin, for a range where a term
    came short."""
    import torch

    m = d + torch.ceil(d.double() ** 2 / n).long() + torch.ceil(8 * d.double().sqrt()).long() + 16
    while True:
        term = torch.repeat_interleave(torch.arange(len(d), device=device), m)
        key = term * n + torch.randint(n, (int(m.sum()),), generator=g, device=device)
        del term
        uniq = torch.unique(key, sorted=True)
        del key
        ut = uniq // n
        u = torch.bincount(ut, minlength=len(d))
        if bool((u >= d).all()):
            break
        m = torch.where(u < d, 2 * m, m)
    # a uniform d[j] of term j's u[j]: the d[j] smallest random keys
    pri = torch.randint(1 << 40, (len(uniq),), generator=g, device=device)
    order = torch.sort((ut << 40) | pri, stable=True).indices
    del pri
    ts = ut[order]
    rank = torch.arange(len(uniq), device=device) - (torch.cumsum(u, 0) - u)[ts]
    keep = torch.empty(len(uniq), dtype=torch.bool, device=device)
    keep[order] = rank < d[ts]
    return uniq[keep] % n


def make(config: dict, seed: int, device) -> dict:
    import torch

    from benchmark.harness.corpus import generator

    n = int(config["passages"])
    law = config["assumed"]["weight"]
    g = generator(seed, device, 1)
    df_host = doc_freqs(config)
    df = torch.from_numpy(df_host).to(device)
    start = np.cumsum(df_host) - df_host
    p = int(df_host.sum())
    docs = torch.empty(p, dtype=torch.int32, device=device)
    weights = torch.empty(p, dtype=torch.float32, device=device)
    for t0, t1 in ranges(df_host):
        lo, hi = int(start[t0]), int(start[t1 - 1] + df_host[t1 - 1])
        docs[lo:hi] = _sample(g, n, df[t0:t1], device).to(torch.int32)
        z = torch.randn(hi - lo, generator=g, dtype=torch.float64, device=device)
        w = torch.exp(math.log(float(law["median"])) + float(law["sigma"]) * z)
        w = w.clamp_(max=float(law["max"])).to(torch.float32)
        # the significant bits FeatureField stores: floatToIntBits(w) >>> 15 << 15 for 9
        weights[lo:hi] = (w.view(torch.int32) & -(1 << (24 - int(law["stored_bits"])))).view(
            torch.float32)
        del z, w
    return {"docs": docs, "weights": weights, "df": df, "passages": n}


def client_context(config: dict, corpus: dict) -> dict:
    """Nothing: a query's tokens follow from the configuration."""
    return {}


def sparse_field(docs, weights, df, n: int):
    """The port's `SparseField` of term-major triples: laid out on their
    device, copied to the host."""
    import torch

    from elasticsearch_tpu_torch.index.segment import INVALID_DOC, SparseField

    dev = docs.device
    df_host = df.cpu().numpy()
    tile_count = (df + TILE - 1) // TILE
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    n_tiles = int(tile_count.sum())
    post_start = torch.cumsum(df, 0) - df
    doc_plane = torch.full((n_tiles * TILE,), INVALID_DOC, dtype=torch.int32, device=dev)
    w_plane = torch.zeros(n_tiles * TILE, dtype=torch.float32, device=dev)
    for t0, t1 in ranges(df_host):
        lo, hi = int(post_start[t0]), int(post_start[t1 - 1] + df[t1 - 1])
        term = torch.repeat_interleave(torch.arange(t0, t1, device=dev), df[t0:t1])
        # weight descending within a term (a positive float's bits order
        # as its value); the sort is stable, so equal weights keep the
        # triples' doc-ascending order
        key = (term << 32) | (0x7FFFFFFF - weights[lo:hi].view(torch.int32).long())
        order = torch.sort(key, stable=True).indices
        del key
        rank = torch.arange(hi - lo, device=dev) - (post_start[term] - lo)
        slot = tile_start[term] * TILE + rank
        del term, rank
        doc_plane[slot] = docs[lo:hi][order]
        w_plane[slot] = weights[lo:hi][order]
        del order, slot
    doc_ids = doc_plane.view(n_tiles, TILE)
    w_tiles = w_plane.view(n_tiles, TILE)
    tile_max = w_tiles.amax(1)
    tids = torch.nonzero(df > 0).flatten()
    # impact order puts every term's maximum in its first tile
    scales = tile_max[tile_start[tids]] / torch.tensor(127.0, dtype=torch.float32, device=dev)
    tile_term = torch.repeat_interleave(torch.arange(len(tids), device=dev), tile_count[tids])
    qweights = torch.empty((n_tiles, TILE), dtype=torch.int8, device=dev)
    tile_qmax = torch.empty(n_tiles, dtype=torch.float32, device=dev)
    step = max(1, RANGE // TILE)
    for a in range(0, n_tiles, step):
        sc = scales[tile_term[a:a + step]]
        safe = torch.where(sc == 0, torch.ones_like(sc), sc)
        # torch.round is half-to-even, like the host build's np.rint
        q = torch.clamp(torch.round(w_tiles[a:a + step] / safe[:, None]), -127, 127).to(torch.int8)
        qweights[a:a + step] = q
        tile_qmax[a:a + step] = q.amax(1).to(torch.float32) * sc
        del q, sc, safe
    exists = torch.zeros(n, dtype=torch.bool, device=dev)
    for a in range(0, len(docs), RANGE):
        exists[docs[a:a + RANGE].long()] = True
    host = lambda x: x.cpu().numpy()  # noqa: E731
    i32 = lambda x: host(x.to(torch.int32))  # noqa: E731
    return SparseField(
        terms=[term_name(int(t)) for t in tids.tolist()],
        term_df=i32(df[tids]),
        term_tile_start=i32(tile_start[tids]),
        term_tile_count=i32(tile_count[tids]),
        doc_ids=host(doc_ids),
        weights=host(w_tiles),
        qweights=host(qweights),
        scales=host(scales),
        tile_max=host(tile_max),
        tile_qmax=host(tile_qmax),
        exists=host(exists),
        pruned=0,
    )


def segment(config: dict, corpus: dict):
    import torch

    from benchmark.harness.system import whole_segment

    n = int(corpus["passages"])
    field = sparse_field(corpus["docs"], corpus["weights"], corpus["df"], n)
    if corpus["docs"].is_cuda:
        print(f"sparse build: {int(corpus['df'].sum())} postings, {field.n_tiles} tiles, device "
              f"peak {torch.cuda.max_memory_allocated()} B", file=sys.stderr)
    return whole_segment(n, sparse={config["field"]: field})


def index(config: dict) -> dict:
    return {"settings": dict(config["index_settings"]),
            "mappings": {"properties": {config["field"]: {"type": "sparse_vector"}}}}


def _reference(corpus: dict, dtype=None):
    import torch

    from benchmark.reference.sparse import SparseRef

    return SparseRef(corpus["docs"], corpus["weights"], corpus["df"], corpus["passages"],
                     dtype=dtype or torch.float64)


def judge(config: dict, corpus: dict, maker, sampled: list, size: int) -> dict:
    from benchmark.kinds.text import judge_pages

    ref = _reference(corpus)
    del corpus
    return judge_pages(ref, maker, sampled, size)


def control(config: dict, traffic: dict, corpus: dict, maker, n: int) -> dict:
    """The reference in bfloat16 in the program's place."""
    import torch

    from benchmark.control import records
    from benchmark.kinds.text import judge_pages

    size, clients = int(traffic["size"]), int(traffic["clients"])
    low = _reference(corpus, torch.bfloat16)

    def pages(c, i):
        docs, vals, count, *_ = low.top(maker.terms(c, i), size)
        return docs, vals.float(), count

    recs = records(maker, n, clients, pages)
    del low
    return judge_pages(_reference(corpus), maker, recs, size)
