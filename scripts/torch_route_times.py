"""Device time of the served routes that sum BM25 and sparse scores, for
one checkout of the repository: route (a), one `match` body through
`TorchExecutor.search`; route (b), 32 `match` bodies in one fused
launch; route (e), 32 `multi_match` bodies in one multi-field fused
launch; route (f), a batcher `sparse_vector` group of 32, int8 and
fp32; a batcher `match` group of 8; and route (i), one sorted body's
first and second page through `execute_sorted_device`, as
`chip_smoke.py` drives them
on its corpus (1M docs from `--seed`). Each route runs once to warm,
then `--repeat` times under `torch.profiler`; the device time is the
sum over kernels and copies (chip_smoke.profile_routes).

    python scripts/torch_route_times.py [--root DIR] [--repeat 3]

`--root` names the checkout whose `chip_smoke.py` and
`elasticsearch_tpu_torch` are imported (default: this one), so that one
call on the card can time two commits in turns. Prints the card's name
and power limit, then one JSON line. Needs a CUDA device."""

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--vocab", type=int, default=50_000)
    ap.add_argument("--dims", type=int, default=768)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_route_times: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.batcher import (
        QueryBatcher, extract_match_plan, extract_serve_plan)
    from elasticsearch_tpu_torch.search.executor import parse_sort
    from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

    device = torch.device("cuda", 0)
    card = cs.gpu_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    reader, _vecs, _pairs, _raw = cs.build_corpus(args.seed, args.docs, args.vocab, args.dims)
    corpus_s = time.perf_counter() - t0
    tex = TorchExecutor(reader, device=device)
    fs = tex.fused_scorer(0, "body")
    fs_mf = tex.fused_scorer_mf(0, ("title", "body"))
    analyzer = reader.analysis.get(reader.mappings.get("body").analyzer)
    texts = cs.match_texts(reader.segments[0].postings["body"].term_df, cs.BATCH, args.seed)
    plans_b = [tex.fused_plan(fs, 0, "body", analyzer.terms(s), 1.0, 1) for s in texts]
    mm_texts = cs.match_texts(reader.segments[0].postings["title"].term_df, cs.BATCH, args.seed + 13, hi=6000)
    splans = [extract_serve_plan(dsl.parse_query({"multi_match": {
        "query": s, "fields": ["title^2", "body"], "tie_breaker": 0.3}}), reader.mappings, reader.analysis)
        for s in mm_texts]
    plans_e = [([tex.fused_plan_field(0, g.field, tex.fused_parts(0, g.field), g.terms, p.boost)
                 for g in p.groups], p.msm) for p in splans]
    gb = QueryBatcher(workers=1)
    gb._ensure_thread = lambda: None  # groups run on this thread
    sparse = {name: [cs.sparse_job(dsl.parse_query({"sparse_vector": {"field": "ml", "query_vector": v}}),
                                   reader.mappings, quantized)
                     for v in cs.sparse_vectors(cs.BATCH, args.seed + 43)]
              for name, quantized in (("int8", True), ("fp32", False))}
    mplans = [extract_match_plan(dsl.parse_query({"match": {"body": s}}), reader.mappings, reader.analysis)
              for s in texts[: cs.CLIENTS]]

    def route_b():
        pend = fs.search_async(plans_b, cs.K, False, rows=cs.BATCH)
        scoring.merge_segment_topk([(0, *fs.device_result(pend))], cs.K)

    def route_e():
        pend = fs_mf.search_async(plans_e, cs.K, "max_tie", 0.3, rows=cs.BATCH)
        scoring.merge_segment_topk([(0, *fs_mf.device_result(pend))], cs.K)

    def route_f(name):
        def run():
            jobs = [gb.submit_nowait(tex, p, cs.K, kind="sparse", query=q) for p, q in sparse[name]]
            gb._collect_sparse_group(jobs, 16, gb._dispatch_sparse_group(jobs, 16, rows=cs.BATCH))
        return run

    def batcher_match():
        jobs = [gb.submit_nowait(tex, p, cs.K) for p in mplans]
        gb._run_group(jobs, "body", 16, rows=cs.CLIENTS)

    q_a = dsl.parse_query({"match": {"body": texts[0]}})
    body_i = cs.sort_bodies(reader.segments[0].postings["body"].term_df, args.seed)["popularity_desc"][0]
    q_i, specs_i = dsl.parse_query(body_i["query"]), parse_sort(body_i["sort"])
    after_i = tex.execute_sorted_device(q_i, specs_i, size=cs.K)[1][-1]  # sets up the rank column

    def route_i():
        tex.execute_sorted_device(q_i, specs_i, size=cs.K)
        tex.execute_sorted_device(q_i, specs_i, size=cs.K, search_after=after_i)

    fns = {"a_match_one_query": lambda: tex.search(q_a, size=cs.K), "b_match_fused_batch32": route_b,
           "e_multi_match_fused_batch32": route_e, "f_sparse_int8_group32": route_f("int8"),
           "f_sparse_fp32_group32": route_f("fp32"), "batcher_match_group_8": batcher_match,
           "i_sorted_two_pages": route_i}
    runs = [cs.profile_routes(fns, device) for _ in range(args.repeat)]
    gb.close()
    out = {"card": card, "root": str(root), "corpus_s": corpus_s,
           "device_us": {name: [r[name]["device_us"] for r in runs] for name in fns},
           "wall_us": {name: [r[name]["wall_us"] for r in runs] for name in fns},
           "top_kernels_us": {name: runs[-1][name]["top_kernels_us"] for name in fns}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
