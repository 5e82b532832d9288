"""A cell on several cards, rehearsed on the CPU: four gloo processes run
the train mode under FSDP2 (`--mesh_fsdp 4`) at a tiny size through the
harness, rank 0 holding the reference at the global batch. A sound run is
correct; with the gradients' exchange between the ranks left out
(FSDP2's reduce-scatter off) it is not."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest

from benchmark import harness
from conftest import LR, TINY, TRAIN

WORKER = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from benchmark import harness
spec = json.load(open(sys.argv[2]))
out = harness.run_cell(spec, "tiny-fsdp4", 2 ** 31 + 5, 0.3,
                       sys.argv[4] == "1", torch.device("cpu"), time.time(),
                       dirs=(sys.argv[3], harness.HERE),
                       runner_kw={"fault": sys.argv[5] or None})
if out is not None:
    json.dump(out, open(sys.argv[6], "w"))
"""


def run_ranks(tiny, tmp_path, trace: bool, fault: str = ""):
    tiny.write("configs", "tiny-128", dict(TINY, hidden_size=128))
    tiny.write("traffic", "tiny-fsdp4", dict(
        TRAIN, batch=8, train_argv=LR + ["--mesh_fsdp", "4"]))
    tiny.add_cell("tiny-fsdp4", "tiny-128", "tiny-fsdp4",
                  "train_tokens_per_s")
    spec, result = tmp_path / "spec.json", tmp_path / "result.json"
    spec.write_text(json.dumps(tiny.spec))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE="4", MASTER_ADDR="localhost",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(harness.ROOT), str(spec),
         str(tiny.dir), "1" if trace else "0", fault, str(result)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(4)]
    assert [p.wait(timeout=600) for p in procs] == [0, 0, 0, 0]
    return json.loads(result.read_text())


@pytest.mark.parametrize("trace", [False, True])
def test_four_ranks_under_fsdp2(tiny, tmp_path, trace):
    out = run_ranks(tiny, tmp_path, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_the_exchange_left_out_fails(tiny, tmp_path):
    out = run_ranks(tiny, tmp_path, False, "no_exchange")
    assert not out["correct"]
    assert out["checks"]["grad_gap"][0] > 0.5
