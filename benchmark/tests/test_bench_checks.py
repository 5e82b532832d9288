"""The comparison that decides `correct` fails what it has to fail: a run
with the timed path broken underneath (the harness's look for a chip
skipped, the rest of the run driven on the CPU), and the control, the
reference in the program's place a precision step below the configured
one, judged against the committed limits. A run that has loaded JAX by its
end prints no result."""

from __future__ import annotations

import json
import sys
import types

import pytest
import torch

from benchmark import calibrate, harness


def limits_of(cell: str):
    return harness.load_json(harness.find("limits", cell,
                                          (harness.HERE,)))["limits"]


def with_real_limits(tiny, cell, real):
    """The tiny cell held to the limits of the benchmark's cell `real`."""
    tiny.write("limits", cell, {"limits": limits_of(real)})


def test_a_step_that_leaves_the_state_unchanged_fails(tiny):
    out = tiny.run("tiny-train", fault="frozen")
    assert not out["correct"]
    assert out["checks"]["update_gap"][0] > 0.9


def test_half_the_batch_left_out_fails(tiny):
    for cell in ("tiny-train", "tiny-inbwd"):
        with_real_limits(tiny, cell, "canonical-train-b64-l528")
        out = tiny.run(cell, fault="half_batch")
        assert not out["correct"], out["checks"]


def test_an_altered_answer_fails(tiny):
    with_real_limits(tiny, "tiny-sample", "demo-sample-512px-l8208")
    assert tiny.run("tiny-sample")["correct"]
    out = tiny.run("tiny-sample", fault="altered_answer")
    assert not out["correct"]
    assert out["checks"]["trajectory_gap"][0] > 1e-3


def test_the_control_reads_above_the_program(tiny):
    """At the tiny size the control reads at least three times the
    program on one of each cell's numbers."""
    cpu = torch.device("cpu")
    for cell in ("tiny-train", "tiny-inbwd", "tiny-sample"):
        got = calibrate.readings(tiny.spec, cell, 7, "program", cpu,
                                 dirs=(tiny.dir, harness.HERE))
        if "control" not in got:
            got.update(calibrate.readings(tiny.spec, cell, 7, "control",
                                          cpu, dirs=(tiny.dir,
                                                     harness.HERE)))
        prog, ctrl = got["program"], got["control"]
        assert max(ctrl[k] / max(prog[k], 1e-30) for k in prog) >= 3, got


@pytest.mark.parametrize("cell,real", [
    ("tiny-train", "canonical-train-b64-l528"),
    ("tiny-inbwd", "demo-train-inbwd-b16-l1040"),
    ("tiny-sample", "demo-sample-512px-l8208")])
def test_the_control_is_not_correct_under_the_committed_limits(tiny, cell,
                                                               real):
    """The control, through the comparison a run makes, against the limits
    of the benchmark's cell that the tiny cell stands for: not correct."""
    cpu = torch.device("cpu")
    got = calibrate.readings(tiny.spec, cell, 2 ** 31 + 23, "control", cpu,
                             dirs=(tiny.dir, harness.HERE))
    verdict = calibrate.judged(got, harness.limits_of(real))
    assert verdict == {"control": False}, got


JAXY = """
import sys, types
from benchmark import harness
_train = harness.load_module(harness.find("modes", "train", (harness.HERE,)))


class Runner(_train.Runner):
    def check(self, control=False):
        sys.modules.setdefault("jax", types.ModuleType("jax"))
        return super().check(control)
"""


def test_jax_loaded_after_the_window_gives_no_result(tiny, capsys):
    """A check that loads a module named `jax` fails the run; and the
    run's last look, on a result already made, prints nothing."""
    from conftest import TRAIN
    from benchmark import run

    prior = sys.modules.pop("jax", None)
    try:
        (tiny.dir / "modes").mkdir()
        (tiny.dir / "modes" / "jaxy.py").write_text(JAXY)
        tiny.write("traffic", "tiny-jaxy", dict(TRAIN, mode="jaxy"))
        tiny.add_cell("tiny-jaxy", "tiny", "tiny-jaxy", "train_tokens_per_s")
        with pytest.raises(RuntimeError, match="jax"):
            tiny.run("tiny-jaxy")
        del sys.modules["jax"]

        out = tiny.run("tiny-train")
        assert run.finish(out) == 0
        assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
        sys.modules["jax"] = types.ModuleType("jax")
        assert run.finish(out) == 1
        assert run.finish(None) == 1  # a rank other than 0
        assert capsys.readouterr().out == ""
    finally:
        sys.modules.pop("jax", None)
        if prior is not None:
            sys.modules["jax"] = prior
