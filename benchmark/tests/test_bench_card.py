"""On the card only (marked `cuda`; each decides in its fixture): a whole
run of each cell through the command, short, with its result line and
its checks; and the command's refusal where the card is missing."""
import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

SPEC = harness.read_json(harness.ROOT / "BENCHMARK.json")


def _command(*args, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=str(harness.ROOT), capture_output=True,
                          text=True, timeout=900, env=env)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_a_short_run_of_each_cell(card, name):
    out = _command("--workload", name, "--seed", str(2 ** 31 + 3),
                   "--seconds", "3", "--trace", "0")
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


def test_no_card_no_result():
    """With every card hidden the command exits non-zero and prints no
    result (decided by the command itself, on any machine)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _command("--workload", SPEC["workloads"][0]["name"], "--seed",
                   "1", "--seconds", "1", "--trace", "0", env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
