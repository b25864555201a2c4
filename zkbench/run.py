"""The port's benchmark, one run of one cell:

    python3 zkbench/run.py --workload fib-core.prove-n58218 --seed 7 --seconds 45 --trace 0

from the root of a checkout (`python3 -m zkbench.run ...` is the same). The
cell is found by name in BENCHMARK.json, and its configuration, traffic,
guest and metrics in this directory (cells.py). The run needs as many CUDA
cards as the cell asks for, and fails without them; it never falls back to
the CPU. Its last line on standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device` and, traced, `breakdown`; last in
it, `checks`, each number compared beside its limit, which also end
standard error. A run that ends with jax, jaxlib, flax or ziren_tpu loaded
prints no result and exits 3."""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if not __package__:  # run as a file: the checkout's root holds zkbench and the port
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def since_start() -> float:
    """Seconds since this process started: from /proc (the interpreter's own
    start included), else from this module's first line."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _STARTED


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zkbench/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from zkbench.cells import Bench
    from zkbench.guard import forbidden

    cell = Bench().cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"zkbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from zkbench.harness import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", since_start)
    found = forbidden()
    if found:
        print(f"zkbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for why in result.get("why_not", []):
        print(f"wrong: {why}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
