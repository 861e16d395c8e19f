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

    python scripts/torch_scatter_times.py [--root DIR]

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_scatter_times: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    for name, R, C, S, with_cnt, share in CASES:
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
        osc.ordered_scatter_add(a, tgt, src, c, inc)  # warm
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                osc.ordered_scatter_add(a, tgt, src, c, inc)
            torch.cuda.synchronize(dev)
        kernels = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            if e.device_type != DeviceType.CPU and us > 0:
                kernels[e.key[:60]] = us / PROFILED
        out[name] = {**row, "share": share, "device_us": sum(kernels.values()), "kernels_us": kernels}
        print(f"{name}: device {sum(kernels.values()):.1f} us {kernels}", file=sys.stderr, flush=True)
    print(json.dumps({"card": card, "root": str(root), "cases": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
