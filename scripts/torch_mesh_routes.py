"""Routes (n1), (o), (p), (o2) and (p2) of chip_smoke.py alone, at full width.

    python3 scripts/torch_mesh_routes.py [--seed 42] [--out result.json]

Builds chip_smoke.py's 1M-doc corpus from `--seed`, splits it into its 8
shard segments and runs route (n1) (the fan-out over three in-process
nodes and over one), route (o) (the serving mesh on one slot), route (p)
(the mesh over a grid of several slots: every card when there are two or
more, else 4 slots on the one card), then routes (o2) and (p2) (a
4-shard index's mesh rescore and IVF probe on one slot and on a 2 x 2
grid), with every check those routes make. It prints the card line, the
grid lines, a summary of route (p) and writes the whole result as JSON
to `--out`. A quicker way than the whole smoke to run the mesh on a
machine with several cards. Exits non-zero without a CUDA device.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_routes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(f"{card} cards {torch.cuda.device_count()}", flush=True)
    device = torch.device("cuda", 0)
    reader, _vecs, _pairs, raw = cs.build_corpus(args.seed, 1_000_000, 50_000, 768)
    segs, owner = cs.shard_segments(raw, cs.CLUSTER_SHARDS)
    out = {"card": card, "cards": torch.cuda.device_count()}
    with cs.MeshEnv("off"):
        out["n1"] = cs.cluster_full_width(segs, owner, reader.segments[0], 768, args.seed, device)
    out["o2"] = cs.route_mesh_small(args.seed, device)
    if args.out:
        Path(args.out).write_text(json.dumps(out, default=str))
    p = out["n1"]["p"]
    print(json.dumps({k: v for k, v in p.items() if k not in ("rows", "profile")}, default=str))
    print(json.dumps({
        k: {m: v[m] for m in ("qps", "p50_ms", "p99_ms", "server_cpu_ms_per_request")}
        for k, v in p["rows"].items()
    }))
    print(json.dumps(out["o2"]["p2"], default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
