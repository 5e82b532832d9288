"""Read the comparison's numbers on many seeds in one process, for setting
the limits of `limits/<cell>.json`: the program's (the lower readings),
the control's (the reference in the program's place at a precision below
the configuration's) and a planted fault's (the upper readings).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \\
        --what program|control|half_batch|frozen

A train cell reads the checked steps of set-up and needs no window; a
sampling cell runs one request (a window of 0 s) and reads the program and
the control on it. One JSON line per seed: each reading's numbers, and
under `correct` what the harness's comparison (`harness.judge`) makes of
them against the cell's committed `limits/<cell>.json`: the program's
have to come out true, the control's and each fault's false.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")


def readings(spec, cell_name: str, seed: int, what: str, device,
             dirs=(HERE,), runner_kw=None):
    """{reading: numbers} of one seed."""
    from benchmark import harness

    fault = what if what in ("half_batch", "frozen", "no_exchange",
                             "altered_answer") else None
    _, _, traffic, runner = harness.runner_of(
        spec, cell_name, seed, device, dirs, fault=fault, **(runner_kw or {}))
    out = {}
    if traffic["mode"] == "train" and what == "control":
        out["control"] = runner.check(control=True)
        return out
    runner.setup()
    if traffic["mode"] == "sample":
        runner.window(0.0)
    runner.free()
    gc.collect()
    out[what] = runner.check(control=what == "control")
    if traffic["mode"] == "sample" and what == "program":
        out["control"] = runner.check(control=True)
    return out


def judged(out, limits):
    """{reading: whether the harness's comparison finds it correct}."""
    from benchmark import harness

    return {k: harness.judge(v, limits)[0] for k, v in out.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="program",
                   choices=("program", "control", "half_batch", "frozen",
                            "no_exchange", "altered_answer"))
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    spec = harness.load_json(HERE.parent / "BENCHMARK.json")
    chips = harness.cell_of(spec, args.workload)["chips"]
    limits = harness.limits_of(args.workload)
    rank = int(os.environ.get("RANK", "0"))
    if "WORLD_SIZE" in os.environ:  # a rank started by `harness.launch`
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    else:
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 2
        if chips > 1 and args.what != "control":
            # the control is the reference alone, on one card
            return harness.launch(chips, ["benchmark.calibrate",
                                          *sys.argv[1:]], time.time())
        dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(spec, args.workload, seed, args.what, dev)
        torch.cuda.empty_cache()
        if rank == 0:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "seconds": time.perf_counter() - t0, **out,
                              "correct": judged(out, limits)}), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
