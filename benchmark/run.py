"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with `--trace 0`, its per-layer metrics with `--trace 1`),
`device`, with `--trace 1` `breakdown`, and last `checks`: each number of
the comparison with the plain reference beside its limit. The same
numbers end standard error. Without a card, or with fewer cards than the
cell asks for, it exits 2 and prints no result.
"""

from __future__ import annotations

import os
import time


def process_start() -> float:
    """When this process started, on the time.time() clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the kernel caches live at fixed paths inside the checkout: nvcc's in the
# program's csrc/build/, Triton's here
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    spec = harness.load_json(HERE.parent / "BENCHMARK.json")
    chips = harness.cell_of(spec, args.workload)["chips"]
    import torch

    if "WORLD_SIZE" in os.environ:  # a rank started by `harness.launch`
        rank = int(os.environ["RANK"])
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        started = float(os.environ["BENCHMARK_STARTED"])
    else:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < chips:
            print(f"the cell {args.workload} needs {chips} CUDA card(s); "
                  f"found {found}", file=sys.stderr)
            return 2
        if chips > 1:
            return harness.launch(chips, ["benchmark.run", *sys.argv[1:]],
                                  STARTED)
        rank, device, started = 0, torch.device("cuda", 0), STARTED
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), device, started)
    return finish(result if rank == 0 else None)


def finish(result) -> int:
    """The run's end: exit 1 with no result if a JAX module is loaded now;
    else print the result line (rank 0), its checks last on standard
    error."""
    from benchmark import harness

    found = harness.jax_modules()
    if found:
        print(f"JAX modules loaded in the run: {found}", file=sys.stderr)
        return 1
    if result is not None:
        for name, (value, limit) in result["checks"].items():
            print(f"check {name}: {value!r} (limit {limit!r})",
                  file=sys.stderr)
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
