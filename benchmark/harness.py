"""The general part of a run: find the cell's files by name, drive its mode
through set-up, the measured window, the traced segment and the check, and
put the result line together.

A cell of `BENCHMARK.json` names a configuration and a traffic mix. The
harness reads `configs/<config>.json` and `traffic/<traffic>.json`, loads
the runner of the traffic's `mode` from `modes/<mode>.py`, the reader of
each per-layer metric from `metrics/<metric>.py` (or, without that file,
the function of `readings.py` named by the metric's name up to its first
dot), and the limits of the cell's comparison from `limits/<cell>.json`.
It knows no cell by name.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
JAX_NAMES = ("jax", "jaxlib", "flax", "video_diffusion_speedrun_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def find(kind: str, name: str, dirs: Sequence[Path]) -> Path:
    """`<dir>/<kind>/<name>.<ext>` in the first of `dirs` that has it."""
    for d in dirs:
        for ext in (".json", ".py"):
            p = Path(d) / kind / f"{name}{ext}"
            if p.exists():
                return p
    raise FileNotFoundError(f"no {kind} named {name!r} under "
                            f"{[str(d) for d in dirs]}")


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def runner_of(spec: Dict, cell_name: str, seed: int, device: torch.device,
              dirs: Sequence[Path] = (HERE,), **runner_kw):
    """(cell, configuration, traffic, the traffic mode's Runner) of a cell
    of `spec`, its files found under `dirs`."""
    cell = cell_of(spec, cell_name)
    config = load_json(find("configs", cell["config"], dirs))
    traffic = load_json(find("traffic", cell["traffic"], dirs))
    mode = load_module(find("modes", traffic["mode"], dirs))
    return cell, config, traffic, mode.Runner(config, traffic, seed, device,
                                               **runner_kw)


def reader_of(name: str, dirs: Sequence[Path] = (HERE,)):
    """The reader of per-layer metric `name`: `read` of
    `metrics/<name>.py`, or where no such file is found, the function of
    `readings.py` named by `name` up to its first dot
    (`step_mfu.train` → `readings.step_mfu`)."""
    try:
        return load_module(find("metrics", name, dirs)).read
    except FileNotFoundError:
        from benchmark import readings

        base = name.split(".")[0]
        if not hasattr(readings, base):
            raise FileNotFoundError(f"no reader of the metric {name!r}: no "
                                    f"metrics/{name}.py and no readings."
                                    f"{base}") from None
        return getattr(readings, base)


def limits_of(cell_name: str, dirs: Sequence[Path] = (HERE,)) -> Dict:
    return load_json(find("limits", cell_name, dirs))["limits"]


def judge(numbers: Dict[str, float], limits: Dict[str, float],
          failed: int = 0):
    """(`correct`, the checks): each limited number beside its limit; the
    run is correct where nothing failed in the window and every number is
    a number at or under its limit. A number that is missing fails."""
    checks = {k: [numbers.get(k, float("nan")), lim]
              for k, lim in limits.items()}
    correct = failed == 0 and all(v == v and v <= lim
                                  for v, lim in checks.values())
    return correct, checks


def applies(metric: Dict, cell: str, e2e_of_cell: Sequence[str]) -> bool:
    """Whether `cell` reports `metric`: the cells it lists, or without a
    list every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_of_cell


def jax_modules() -> List[str]:
    """The top-level names among JAX_NAMES that this process has loaded
    (names compared whole: the program's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in JAX_NAMES})


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# across the ranks of a cell on several cards (one process a card)

def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(world: int) -> None:
    if world > 1:
        dist.barrier()


def _reduce(x: float, op) -> float:
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([float(x)], device=dev)
    dist.all_reduce(t, op=op)
    return float(t.item())


def mean_over_ranks(x: float, world: int) -> float:
    return x if world == 1 else _reduce(x, dist.ReduceOp.SUM) / world


def max_over_ranks(x: float, world: int) -> float:
    return x if world == 1 else _reduce(x, dist.ReduceOp.MAX)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A sharded parameter or moment gathered whole (every rank calls)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def launch(chips: int, argv: Sequence[str], started: float) -> int:
    """Run `python3 -m <argv>` as `chips` ranks, one a card (the
    environment `torch.distributed` reads, a free port on localhost), and
    wait for them; if one fails the others are stopped. Rank 0's standard
    output is printed only if every rank ended well, and its checks again
    last on standard error; the ranks' standard error passes through.
    Returns the worst exit code."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE=str(chips), MASTER_ADDR="localhost",
               MASTER_PORT=str(port), BENCHMARK_STARTED=repr(started))
    with tempfile.TemporaryFile("w+") as out:
        procs = [subprocess.Popen(
            [sys.executable, "-m", *argv],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=out if r == 0 else subprocess.DEVNULL)
            for r in range(chips)]
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        rc = max(abs(p.returncode) for p in procs)
        out.seek(0)
        text = out.read()
    found = jax_modules()
    if found:
        print(f"JAX modules loaded in the launcher: {found}",
              file=sys.stderr)
        rc = max(rc, 1)
    if rc == 0:
        sys.stdout.write(text)
        lines = [line for line in text.splitlines() if line.startswith("{")]
        checks = json.loads(lines[-1]).get("checks", {}) if lines else {}
        for name, (value, limit) in checks.items():
            print(f"check {name}: {value!r} (limit {limit!r})",
                  file=sys.stderr)
    return rc


class SetupParts(dict):
    """The seconds of each part of a mode's set-up, in order: `mark(part)`
    closes the part that began at the last mark (after a sync)."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device, self._t = device, time.perf_counter()

    def mark(self, part: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self[part], self._t = now - self._t, now


class HostWatch:
    """What else took the host's time during a window: the share of CPU
    time the hypervisor stole (/proc/stat), the garbage collector's pauses,
    and how often the main thread was preempted (/proc/self/status)."""

    def __enter__(self):
        self.gc_s, self.gcs, self._t = 0.0, 0, None
        gc.callbacks.append(self._gc)
        self._cpu, self._pre = self._read(), self._preempted()
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        after = self._read()
        d = [b - a for a, b in zip(self._cpu, after)]
        self.steal = d[7] / sum(d) if len(d) > 7 and sum(d) else 0.0
        self.preempted = self._preempted() - self._pre
        self.affinity = sorted(os.sched_getaffinity(0))

    def report(self) -> str:
        return (f"{self.steal:.2%} of CPU time stolen by the hypervisor, "
                f"{1e3 * self.gc_s:.1f} ms in {self.gcs} garbage "
                f"collections, main thread preempted {self.preempted} "
                f"times, on CPUs {self.affinity}")

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gcs += 1

    @staticmethod
    def _read():
        try:
            with open("/proc/stat") as f:
                return [int(x) for x in f.readline().split()[1:]]
        except (OSError, ValueError):
            return []

    @staticmethod
    def _preempted() -> int:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("nonvoluntary_ctxt_switches"):
                        return int(line.split()[1])
        except (OSError, ValueError):
            pass
        return 0


class Reading:
    """What a per-layer metric's reader may read: the mode, the window,
    the trace of the traced segment, the launch counts in it and the
    shapes of the work."""

    def __init__(self, mode: str, window: Dict, traced: Optional[Dict],
                 shapes: Dict, config: Dict, chips: int, device_name: str):
        self.mode = mode
        self.window = window
        self.trace = None if traced is None else traced["trace"]
        self.traced_steps = 0 if traced is None else traced["steps"]
        self.launches = {} if traced is None else traced["launches"]
        self.shapes = shapes
        self.config = config
        self.chips = chips
        self.device_name = device_name


def run_cell(spec: Dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, started: float,
             dirs: Sequence[Path] = (HERE,), runner_kw: Optional[Dict] = None
             ) -> Dict:
    """One run of one cell: the result line's dict (None on a rank other
    than 0 of a cell on several cards). `started` is the run's start
    (time.time() clock); `dirs` the folders searched for the cell's
    files."""
    cell, config, traffic, runner = runner_of(spec, cell_name, seed, device,
                                              dirs, **(runner_kw or {}))

    t_setup = time.time()
    runner.setup()
    device = runner.device  # under several cards: this rank's own
    sync(device)
    setup_s = time.time() - started
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in
                      getattr(runner, "setup_parts", {}).items())
    print(f"[bench] set-up: {t_setup - started:.1f} s to the runner "
          f"(start, imports), then {parts}", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with HostWatch() as host:
        window = runner.window(seconds)
    t_window = time.time()
    print(f"[bench] host in the window: {host.report()}", file=sys.stderr)
    world = _world()
    peak = int(max_over_ranks(torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else 0, world))
    values = dict(runner.end_to_end(window), setup_s=setup_s,
                  peak_mem_gb=peak / 1e9)

    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    metrics = {}
    traced = None
    if not trace:
        for m in e2e:
            if m["name"] not in values:
                raise KeyError(f"mode {traffic['mode']} gives no "
                               f"{m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        traced = runner.traced()
        name = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu")
        reading = Reading(traffic["mode"], window, traced, runner.shapes(),
                          config, cell["chips"], name)
        e2e_names = [m["name"] for m in e2e]
        for m in spec["per_layer"]:
            if not applies(m, cell_name, e2e_names):
                continue
            value = reader_of(m["name"], dirs)(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell["chips"], "memory_peak_bytes": peak}
    breakdown = None
    if traced is not None and traced["trace"] is not None:
        tr = traced["trace"]
        device_info["busy_s"] = traced.get("busy_s", tr.busy_s)
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}

    t_check = time.time()
    runner.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = runner.check()
    getattr(runner, "close", lambda: None)()
    # last, on every rank: the check and the reference ran in this process
    found = jax_modules()
    if found:
        raise RuntimeError(f"JAX modules loaded in the run: {found}")
    if numbers is None:  # a rank other than 0
        return None
    print(f"[bench] set-up {setup_s:.1f} s, window {window['seconds']:.1f} s"
          f", after it {t_check - t_window:.1f} s, check "
          f"{time.time() - t_check:.1f} s", file=sys.stderr)
    limits = limits_of(cell_name, dirs)
    for k in sorted(set(numbers) - set(limits)):
        print(f"[bench] {k}: {numbers[k]!r} (not compared: no upper reading)",
              file=sys.stderr)
    correct, checks = judge(numbers, limits, window["failed"])
    out = {"correct": correct, "attempted": window["attempted"],
           "failed": window["failed"], "metrics": metrics,
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
