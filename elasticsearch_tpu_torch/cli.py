"""CLI entry point: `python -m elasticsearch_tpu_torch <command>`.

Reference analogs (SURVEY.md §1 L10): distribution/tools/server-cli
(ServerCli → Elasticsearch.main), elasticsearch-plugin, and the
BootstrapChecks that gate startup.

The port's copy of the JAX package's `cli.py`: `version` reports
PyTorch and its CUDA build, `check` asks for a CUDA device (it never
checks the CPU instead), and `serve` is the port's `rest/server.py`
`main`, which serves on the card.
"""

from __future__ import annotations

import argparse
import json
import sys

ES_VERSION = "8.x-tpu"


def cmd_serve(argv) -> int:
    from .rest import server

    server.main(list(argv))
    return 0


def cmd_version(_argv) -> int:
    import torch

    print(
        json.dumps(
            {
                "version": ES_VERSION,
                "distribution": "elasticsearch-tpu-torch",
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
            }
        )
    )
    return 0


def cmd_check(_argv) -> int:
    """Bootstrap checks (BootstrapChecks analog): a CUDA device, one
    small op on it with a known result, and a positive device-memory
    budget. Without a CUDA device the check fails."""
    failures = []
    import numpy as np
    import torch

    try:
        if not torch.cuda.is_available():
            failures.append(
                "no CUDA device available: the node serves on the card"
            )
        else:
            device = torch.device("cuda", 0)
            print(
                f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}",
                file=sys.stderr,
            )
            out = int(torch.as_tensor(np.arange(8), device=device).sum().item())
            if out != 28:
                failures.append(f"device smoke op wrong result: {out}")
    except RuntimeError as e:
        failures.append(f"CUDA initialization failed: {e}")
    budget = None
    if not failures:
        from .common.memory import hbm_ledger

        budget = hbm_ledger.budget
        if budget <= 0:
            failures.append("device memory budget is not positive")
    print(
        json.dumps(
            {
                "checks_passed": not failures,
                "failures": failures,
                "hbm_budget_bytes": budget,
            }
        )
    )
    return 1 if failures else 0


def cmd_plugin(argv) -> int:
    from .plugins import plugins_service

    ap = argparse.ArgumentParser(prog="elasticsearch-tpu-torch plugin")
    ap.add_argument("action", choices=["list", "load"])
    ap.add_argument("spec", nargs="?", help="module.path:ClassName for load")
    args = ap.parse_args(argv)
    try:
        if args.action == "load":
            if not args.spec:
                print("plugin load requires a spec", file=sys.stderr)
                return 2
            plugins_service.load_spec(args.spec)
        # load_spec/load_env are idempotent per spec, so a spec that is
        # also in ES_TPU_PLUGINS installs once
        plugins_service.load_env()
    except (ValueError, TypeError, ImportError, AttributeError) as e:
        print(f"plugin error: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"plugins": plugins_service.info()}))
    return 0


COMMANDS = {
    "serve": cmd_serve,
    "version": cmd_version,
    "check": cmd_check,
    "plugin": cmd_plugin,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(
            "usage: python -m elasticsearch_tpu_torch "
            f"{{{'|'.join(COMMANDS)}}} [args]\n\n"
            "  serve    start the REST server on the card (see --help for flags)\n"
            "  version  print version info\n"
            "  check    run bootstrap checks (CUDA device, a device op, memory budget)\n"
            "  plugin   list/load plugins",
        )
        return 0 if argv else 2
    cmd = COMMANDS.get(argv[0])
    if cmd is None:
        print(f"unknown command [{argv[0]}]", file=sys.stderr)
        return 2
    return cmd(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
