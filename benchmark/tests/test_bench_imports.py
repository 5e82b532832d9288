"""What a run loads: no module with the top-level name jax, jaxlib, flax
or video_diffusion_speedrun_tpu (the port's name begins with the JAX
package's, so names are compared whole), and a reference that imports
nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "video_diffusion_speedrun_tpu"}

PROBE = """
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import benchmark.run, benchmark.calibrate
from benchmark import harness
spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
for m in spec["per_layer"]:
    harness.reader_of(m["name"], (harness.HERE,))
for mode in ("train", "sample"):
    harness.load_module(harness.find("modes", mode, (harness.HERE,)))
from conftest import Tiny
import pathlib, tempfile
t = Tiny(pathlib.Path(tempfile.mkdtemp()))
t.run("tiny-train"); t.run("tiny-sample")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(harness.ROOT),
         str(harness.HERE / "tests")], capture_output=True, text=True,
        check=True, timeout=600)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "video_diffusion_speedrun_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top in {"torch", "math", "typing", "__future__"}, \
                    (path.name, name)
