"""The harness finds every cell's files by name, a cell added as files
alone is found, and BENCHMARK.json keeps to the benchmark's rules."""
import json
import re
import shutil

import pytest

from benchmark import harness
from benchmark.tests import tiny

SPEC = harness.read_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden_size|intermediate|latent|state_size|proj|"
                   r"_dim$|_rank$|head_size|n_embd|n_inner|expansion|"
                   r"per_tok)")


@pytest.mark.parametrize("name", [w["name"]
                                  for w in tiny.spec()["workloads"]])
def test_every_cell_found_by_name(name):
    cell = harness.load_cell(name, tiny.spec())
    assert cell.model_file() and cell.reference() and cell.runner()
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_module(
            harness.HERE / "metrics" / f"{m['name']}.py").read)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert {m["moves"] for m in cell.per_layer} <= names


def test_benchmark_json_rules():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = SPEC["workloads"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        cfg = harness.read_json(harness.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]
        assert not [k for k in c["reduced"] if WIDTH.search(k)]
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in cells:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_cell_added_as_files_is_found(tmp_path, monkeypatch):
    """A new traffic mix, its limits, a new metric reader and the entries
    naming them: the harness finds them with no file of its own edited."""
    here = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    mix = harness.read_json(here / "traffic" / "chat-poisson.json")
    mix["arrivals"]["rate"] = 3.0
    (here / "traffic" / "chat-slow.json").write_text(json.dumps(mix))
    (here / "limits" / "gpt2-medium.chat-slow.json").write_text(
        json.dumps({"logit_gap": 0.5}))
    (here / "metrics" / "ttft_p50_ms.py").write_text(
        "def read(obs):\n    return 7.0\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "gpt2-medium.chat-slow",
                              "config": "gpt2-medium",
                              "traffic": "chat-slow", "chips": 1,
                              "why": "slow chat"})
    spec["end_to_end"].append({"name": "ttft_p50_ms", "unit": "ms",
                               "better": "lower", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["gpt2-medium.chat-slow"]})
    spec["per_layer"].append({"name": "decode_iter_ms.chat", "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "dispatch", "moves": "ttft_p50_ms",
                              "workloads": ["gpt2-medium.chat-slow"]})
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    cell = harness.load_cell("gpt2-medium.chat-slow", spec)
    assert cell.traffic["arrivals"]["rate"] == 3.0
    assert cell.limits == {"logit_gap": 0.5}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "ttft_p50_ms"]
    assert [m["name"] for m in cell.per_layer] == ["decode_iter_ms.chat"]
    assert harness.read_metric("ttft_p50_ms", None) == 7.0


def test_emit_puts_checks_last(capsys):
    harness.emit({"correct": True, "attempted": 1, "failed": 0,
                  "metrics": {}, "device": {},
                  "checks": {"logit_gap": {"value": 0.01, "limit": 0.1}}})
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1] == "check logit_gap 0.01 limit 0.1"
