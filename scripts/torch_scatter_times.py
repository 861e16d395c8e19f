"""Times `ops/ordered_scatter.ordered_scatter_add` on the card over drawn
slots, for one checkout of the repository: `chip_smoke.scatter_kernel_row`
holds each case bit for bit to the plain version and times the kernel,
the plain version and one `scatter_add_` (two with the count plane) by
CUDA events, with its bound; this script adds the device time of one
call from `torch.profiler`, split by kernel (the events' time is the
wrapper's host time where that exceeds the card's).

Cases, at the valid-slot share of a launch that `chip_smoke.py` captured
on its routes: route (b)'s [32, 1,000,001] x 32,768 slots (its first
launch, 7% valid); route (f)'s [32, 1,000,001] x 65,536 with the count
plane (its group's first launch, 0.6% valid, and its densest, 87%);
route (a)'s one row of 2,048 slots (half valid, one launch) and of
262,144. And one row past one window, 2^25 + 2^17 slots (half valid),
which no route of the smoke sends: `score_tiles` over an expansion of
many terms on a large segment would. A valid slot aims at a random doc,
distinct within its 128-slot tile as in the served paths (a doc occurs
once in a term's postings; the kernel's earlier one-launch design relied
on it), the rest at the overflow column with +0.0; slots are drawn on
the card from `--seed`.

    python scripts/torch_scatter_times.py [--root DIR] [--impact-only]

Then the BM25 tile add (`ops/scoring.py:bm25_tile_add`, one call a
chunked scoring pass) at the MS MARCO passage cell's width (8,841,823
docs and the overflow column): one row of 10,784 tiles (the cell's median
second pass) and 32 ragged rows, on postings drawn on the card. Each is
held bit for bit to the plain version on the CPU and to the path it
replaced on the card (`tests/scatter_cases.py:parent_chunk_pass`: a
host step a 512-tile chunk, each a packed upload, PyTorch's gathers and
formula and the ordered scatter-add); each is timed by CUDA events (the
wrapper's host time included), with the plain version on the card
(PyTorch's gathers, formula and `scatter_add_`), the replaced path, the
device time by kernel, the bound (`chip_smoke.tile_add_bytes`: the
postings and the plan read once, each valid doc's inv_norm read once,
each touched cell read and written once) and the scratch. A checkout without the
entry skips these.

Then the impact tile add (`ops/impact.py:impact_tile_add`, one call a
learned-sparse scoring pass) at the ELSER cell's shape, f32 and int8:
`chip_smoke.impact_cell_rows` (one row of about 68,352 tiles over
8,841,823 docs, held bit for bit to the plain version and the replaced
512-tile loop, each timed, with the bound), plus the device time by
kernel. A checkout without the entry skips it; `--impact-only` runs it
alone.

`--root` names the checkout whose `chip_smoke.py` and
`elasticsearch_tpu_torch` are imported (default: this one), so that one
call on the card can time two commits in turns. Prints the card's name
and power limit, then one JSON line. Needs a CUDA device."""

import argparse
import json
import sys
from pathlib import Path

CASES = [
    # (name, R, C, S, count plane, share of valid slots)
    ("b_first", 32, 1_000_001, 32_768, False, 0.069),
    ("f_first", 32, 1_000_001, 65_536, True, 0.0063),
    ("f_densest", 32, 1_000_001, 65_536, True, 0.87),
    ("a_row_2048", 1, 1_000_001, 2_048, True, 0.5),
    ("a_row_262144", 1, 1_000_001, 262_144, True, 0.5),
    ("row_past_one_window", 1, 1_000_001, (1 << 25) + (1 << 17), True, 0.5),
]
PROFILED = 10
MSMARCO_CELLS = 8_841_824
TILE_CASES = [
    # (name, C, rows' tiles)
    ("pass_cell", MSMARCO_CELLS, (10_784,)),
    ("pass_ragged32", MSMARCO_CELLS, (10_784, 0, 511, 512, 513, 1_025, 16, 17) + tuple(range(0, 12_000, 500))),
]


def kernel_us(fn, n):
    """Device us of one of `n` calls of fn by kernel, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if e.device_type != DeviceType.CPU and us > 0:
            out[e.key[:60]] = us / n
    return out


def tile_pass_row(cs, scoring, osc, C, lengths, dev, gen) -> dict:
    """`chip_smoke.tile_add_kernel_row` (bits against the plain version,
    kernel and plain times, bound) on one drawn pass, plus the replaced
    path (`tests/scatter_cases.py:parent_chunk_pass`): its bits and its
    time, the kernel's device time by kernel, and the scratch."""
    import torch

    from scatter_cases import parent_chunk_pass

    R, n = len(lengths), C - 1
    table = max(lengths) + 1000
    lane = torch.arange(128, device=dev)
    step = n // 128
    doc = (lane * step)[None, :] + torch.randint(0, step, (table, 128), device=dev, generator=gen)
    pad = (torch.rand(table, 1, device=dev, generator=gen) < 0.1) & (
        lane[None, :] >= torch.randint(1, 128, (table, 1), device=dev, generator=gen))
    d = torch.where(pad, -1, doc).int()
    f = torch.where(pad, 0, torch.randint(1, 41, (table, 128), device=dev, generator=gen)).int()
    iv = torch.rand(n, device=dev, generator=gen) * 2.95 + 0.05
    tiles = [torch.randint(0, table, (m,), device=dev, generator=gen).cpu().numpy() for m in lengths]
    weights = [(torch.rand(m, device=dev, generator=gen) * 7.9 + 0.1).cpu().numpy() for m in lengths]
    acc0 = torch.rand(R, C, device=dev, generator=gen)
    acc0[:, -1] = 0.0
    lay = osc.tile_layout(C, list(lengths))

    row = cs.tile_add_kernel_row((acc0, None, d, f, iv, tiles, weights), dev)
    a, old = acc0.clone(), acc0.clone()
    scoring.bm25_tile_add(a, None, d, f, iv, tiles, weights)
    parent_chunk_pass(old, None, d, f, iv, tiles, weights)
    torch.cuda.synchronize(dev)
    differ_replaced = int((old.view(torch.int32) != a.view(torch.int32)).sum())
    cs.check(differ_replaced == 0, f"bm25_tile_add {R} rows x {C}: {differ_replaced} cells differ from the "
                                   f"replaced path")
    replaced_ms = cs.device_ms(lambda: parent_chunk_pass(a, None, d, f, iv, tiles, weights), dev, iters=5)
    kernels = kernel_us(lambda: scoring.bm25_tile_add(a, None, d, f, iv, tiles, weights), PROFILED)
    row = {**row, "layout": lay._asdict(), "cells_differing_replaced": differ_replaced,
           "device_us": sum(kernels.values()), "kernels_us": kernels, "replaced_ms": replaced_ms}
    print(f"bm25_tile_add {R} x {C}, {lay.tiles} tiles: device {row['device_us']:.1f} us, replaced "
          f"{replaced_ms:.4f} ms, scratch {row['scratch_bytes']} B", file=sys.stderr, flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--impact-only", action="store_true", help="time the impact tile add alone")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_scatter_times: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(root / "tests"))

    import chip_smoke as cs
    from elasticsearch_tpu_torch.ops import ordered_scatter as osc

    dev = torch.device("cuda", 0)
    card = cs.gpu_line()
    print(card, flush=True)
    _, compiler = osc.build()  # registers and spills of each kernel, to stderr
    print("\n".join(x for x in compiler.splitlines() if "registers" in x or "spill" in x),
          file=sys.stderr, flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    out = {}
    for name, R, C, S, with_cnt, share in [] if args.impact_only else CASES:
        valid = torch.rand(R, S, device=dev, generator=gen) < share
        lane = torch.arange(S, device=dev, dtype=torch.int32) % 128  # distinct within a tile
        doc = torch.randint(0, (C - 1) // 128, (R, S), device=dev, generator=gen, dtype=torch.int32) * 128 + lane
        tgt = torch.where(valid, doc, C - 1).int()
        mags = 10.0 ** torch.randint(-3, 4, (R, S), device=dev, generator=gen).float()
        src = torch.where(valid, torch.randn(R, S, device=dev, generator=gen) * mags, 0.0)
        inc = valid.int() if with_cnt else None
        acc = torch.randn(R, C, device=dev, generator=gen)
        acc[:, C - 1] = 0.0
        cnt = torch.zeros(R, C, dtype=torch.int32, device=dev) if with_cnt else None
        if R == 1:  # score_tiles' form: one [C] row
            acc, tgt, src = acc[0], tgt[0], src[0]
            cnt, inc = (cnt[0], inc[0]) if with_cnt else (None, None)
        row = cs.scatter_kernel_row((acc, tgt, src, cnt, inc), dev)
        a, c = acc.clone(), None if cnt is None else cnt.clone()
        kernels = kernel_us(lambda: osc.ordered_scatter_add(a, tgt, src, c, inc), PROFILED)
        out[name] = {**row, "share": share, "device_us": sum(kernels.values()), "kernels_us": kernels}
        print(f"{name}: device {sum(kernels.values()):.1f} us {kernels}", file=sys.stderr, flush=True)
    from elasticsearch_tpu_torch.ops import scoring

    passes = {}
    if hasattr(scoring, "bm25_tile_add") and not args.impact_only:
        for name, C, lengths in TILE_CASES:
            passes[name] = tile_pass_row(cs, scoring, osc, C, lengths, dev, gen)
    impact = {}
    if hasattr(cs, "impact_cell_rows"):
        from elasticsearch_tpu_torch.ops import impact as impact_ops

        for name, quantized in (("fp32", False), ("int8", True)):
            a, c, d, v, tiles, weights = pass_args = cs.impact_cell_pass(args.seed, dev, quantized)
            row = cs.impact_add_kernel_row(pass_args, dev)
            kernels = kernel_us(lambda: impact_ops.impact_tile_add(a, c, d, v, tiles, weights), PROFILED)
            impact[name] = {**row, "kernels_us": kernels}
            print(f"impact_tile_add {name}: {kernels}", file=sys.stderr, flush=True)
    print(json.dumps({"card": card, "root": str(root), "cases": out, "passes": passes, "impact": impact}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
