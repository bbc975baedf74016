"""The harness: finds everything a cell needs by the names that
BENCHMARK.json gives it, runs the cell's runner once, reads its metrics
and prints the result line.

A cell `<config>.<traffic>` is made of files found by name:
 - `configs/<config>.json`: the configuration as it is run (the file
   BENCHMARK.json names), and `configs/<config>.py`, which builds it
   through the port's FFModel layer API;
 - `reference/<config>.py`: the plain reference (plain torch, f32), which
   imports nothing of the port, and the seeded weights both sides get;
 - `traffic/<traffic>.json`: the traffic mix, whose `kind` picks the
   runner (`runners/train.py` or `runners/serve.py`) and which the one
   general generator, `traffic.py`, reads;
 - `limits/<workload>.json`: the limit of each number the correctness
   check compares;
 - `metrics/<metric>.py`: one reader a metric, `read(obs)`, which returns
   the number or None when it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that may not be loaded when a run's window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "flexflow_tpu")
RUNNERS = {"train": "train", "open_loop": "serve", "closed_loop": "serve"}


def read_json(path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path):
    """The module in `path` (a file under the benchmark, whose name may
    hold dots and dashes), imported once a process."""
    rel = path.resolve().relative_to(HERE).with_suffix("")
    name = "benchmark_file." + "__".join(rel.parts).replace(
        ".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


def _reported_in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    """One entry of BENCHMARK.json's `workloads`, with its files read."""
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    def model_file(self):
        return load_module(HERE / "configs" / f"{self.config_name}.py")

    def reference(self):
        return load_module(HERE / "reference" / f"{self.config_name}.py")

    def runner(self):
        return load_module(HERE / "runners"
                           / f"{RUNNERS[self.traffic['kind']]}.py")


def load_cell(name: str, spec: dict = None) -> Cell:
    spec = spec if spec is not None else read_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    e2e = [m for m in spec["end_to_end"] if _reported_in(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(
        name=name, config_name=entry["config"],
        traffic_name=entry["traffic"], chips=int(entry["chips"]),
        config=read_json(ROOT / conf["file"]),
        traffic=read_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=read_json(HERE / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer)


def read_metric(name: str, obs):
    return load_module(HERE / "metrics" / f"{name}.py").read(obs)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None) -> dict:
    """Run the cell once and return its result line as a dict (the
    checks last)."""
    out = cell.runner().run(cell, int(seed), float(seconds), bool(trace),
                            device, t_start)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = read_metric(m["name"], out.obs)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} found "
                                   "nothing to read")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {k: {"value": float(v), "limit": float(lim)}
              for k, (v, lim) in out.checks.items()}
    correct = not out.problems and all(
        c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics,
              "device": out.device}
    if trace and out.obs.device is not None:
        result["device"] = dict(out.device,
                                busy_s=out.obs.device.busy_s,
                                window_s=out.obs.device.window_s)
        result["breakdown"] = out.obs.device.breakdown()
    result["notes"] = dict(out.notes, problems=out.problems[:20])
    result["checks"] = checks
    return result


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (the port's own name begins with the JAX package's)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def emit(result: dict) -> None:
    """Print the compared numbers with their limits as the last lines of
    standard error, and the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
