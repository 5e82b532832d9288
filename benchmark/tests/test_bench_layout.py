"""The harness finds every configuration, traffic mix, mode, metric and
limits file by its name, and a cell added as files runs end to end on the
CPU (a dry run: the program's plain paths, no device metric)."""

from __future__ import annotations

import json
import math

import pytest

from benchmark import harness
from benchmark.reference.dit import param_shapes

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    w = harness.cell_of(SPEC, cell)
    config = harness.load_json(harness.find("configs", w["config"],
                                            (harness.HERE,)))
    traffic = harness.load_json(harness.find("traffic", w["traffic"],
                                             (harness.HERE,)))
    mode = harness.load_module(harness.find("modes", traffic["mode"],
                                            (harness.HERE,)))
    assert hasattr(mode, "Runner")
    limits = harness.load_json(harness.find("limits", cell,
                                            (harness.HERE,)))["limits"]
    assert limits and all(v > 0 for v in limits.values())
    assert sum(math.prod(s) for s in param_shapes(config).values()) \
        == config["parameters"]


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader_of(metric, (harness.HERE,)))


def test_configs_and_cells_agree():
    names = {c["name"] for c in SPEC["configs"]}
    assert {w["config"] for w in SPEC["workloads"]} == names
    for c in SPEC["configs"]:
        assert (harness.ROOT / c["file"]).exists()
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = next(x for x in SPEC["end_to_end"]
                         if x["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("cell,trace", [
    ("tiny-train", False), ("tiny-train", True), ("tiny-inbwd", False),
    ("tiny-sample", False), ("tiny-sample", True)])
def test_added_cell_runs_dry(tiny, cell, trace):
    out = tiny.run(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    if trace:
        # no device, so no device metric: the readers return nothing
        assert out["metrics"] == {}
        assert out["device"]["busy_s"] == 0.0
    else:
        e2e = "euler_step_ms" if "sample" in cell else "train_tokens_per_s"
        assert set(out["metrics"]) == {e2e, "peak_mem_gb", "setup_s"}
        assert out["metrics"][e2e]["value"] > 0


def test_a_new_config_traffic_and_metric_are_files_alone(tiny):
    """A configuration, a traffic mix and a per-layer metric that the
    benchmark has never seen, added as files and spec entries only."""
    from conftest import TINY, TRAIN

    tiny.write("configs", "tiny-wide", dict(TINY, hidden_size=96,
                                            num_heads=3))
    tiny.write("traffic", "tiny-short", dict(TRAIN, batch=2,
                                             latent=[16, 3, 4, 4]))
    (tiny.dir / "metrics").mkdir()
    (tiny.dir / "metrics" / "window_steps.train.py").write_text(
        "def read(r):\n    return float(r.window['steps'])\n")
    tiny.spec["per_layer"].append({
        "name": "window_steps.train", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "step",
        "moves": "train_tokens_per_s", "workloads": ["tiny-wide-short"]})
    tiny.add_cell("tiny-wide-short", "tiny-wide", "tiny-short",
                  "train_tokens_per_s")
    out = tiny.run("tiny-wide-short", trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["window_steps.train"]["value"] >= 1


NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"
UNIT = r"^[A-Za-z0-9_/%.-]{1,16}$"


def test_the_spec_keeps_to_its_format():
    import re

    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["benchmark"]
    assert len(json.dumps(SPEC)) <= 64 * 1024
    line = [c["why"] for c in SPEC["configs"] + SPEC["workloads"]] \
        + [m["layer"] for m in SPEC["per_layer"]]
    assert all(0 < len(s) <= 200 and "\n" not in s and "\t" not in s
               for s in line)
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        names = [x["name"] for x in SPEC[group]]
        assert len(set(names)) == len(names)
        for x in SPEC[group]:
            assert set(x) == keys
            assert re.match(NAME, x["name"])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert re.match(NAME, m["name"]) and re.match(UNIT, m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4)
        assert any(w["name"] in m["workloads"] for m in SPEC["per_layer"])
