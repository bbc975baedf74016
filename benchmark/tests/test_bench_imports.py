"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the port: checked in fresh interpreters,
comparing each loaded module's top-level name whole (the port's name
begins with the JAX package's)."""
import json
import subprocess
import sys

from benchmark import harness

FORBIDDEN = ("jax", "jaxlib", "flax", "flexflow_tpu")

RUN_A_CELL = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness
from benchmark.tests import tiny
cell = tiny.cell("gpt2-medium.offline-closed")
harness.run_cell(cell, 3, 1.0, False, "cpu")
cell = tiny.cell("bert-large.train-s128")
harness.run_cell(cell, 3, 0.5, False, "cpu")
for m in (harness.HERE / "metrics").glob("*.py"):
    harness.load_module(m)
for m in ("sweep", "calibrate"):
    harness.load_module(harness.HERE / (m + ".py"))
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

REFERENCES_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness
for f in sorted((harness.HERE / "reference").glob("*.py")):
    harness.load_module(f)
import benchmark.judge, benchmark.flops, benchmark.stats
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _top_level(RUN_A_CELL)
    assert "flexflow_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_references_load_nothing_of_the_port():
    loaded = _top_level(REFERENCES_ONLY)
    assert not loaded & {"flexflow_tpu_torch", *FORBIDDEN}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "flexflow_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    found = harness.forbidden_modules()
    assert "flexflow_tpu_torchx" not in found and "jaxish" not in found
    monkeypatch.setitem(sys.modules, "flexflow_tpu.model", sys)
    assert "flexflow_tpu.model" in harness.forbidden_modules()
