"""`serve-bench` of the port (serving/sched/bench.py `run_bench` and the
fleet front ends of serving/fleet/bench.py) against the JAX package's
`run_bench` on the same argv, on the CPU at tiny sizes: for each of the
nine workloads the same exit code, the same `FAIL:` checks and the same
key tree in `--report`; each wall-clock ratio flag failed at 1e9 by both
(met at 0 where its run is cheap); and the mixed workload's greedy
tokens identical to JAX's from JAX's weights. The JAX side compiles with XLA's optimisations
off (`unoptimised_xla`): its many small serving dispatches compile
several times faster so, and these tiny models run no slower."""
import json

import jax
import numpy as np
import pytest

import flexflow_tpu.serving.sched.bench as jbench
import flexflow_tpu_torch.serving.sched.bench as pbench
from flexflow_tpu_torch import params_from_jax
from tests.test_torch_zoo import one_torch_thread

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(scope="module", autouse=True)
def unoptimised_xla():
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)


TINY = ["--requests", "4", "--prompt-min", "4", "--prompt-max", "16",
        "--out-min", "2", "--out-max", "8", "--layers", "1", "--hidden",
        "16", "--heads", "2"]
PREFIX = ["--prefix-len", "16", "--prefix-groups", "2"]
# each workload's argv past TINY; every wall-clock ratio at 0, which
# both packages always meet
WORKLOADS = {
    "mixed": [],
    "shared-prefix": PREFIX + ["--ttft-ratio", "0"],
    "long-prefill": ["--long-prompt", "64", "--decoder-out", "16",
                     "--itl-ratio", "0"],
    "mesh-resize": [],
    # the two dearest workloads hold their ratio at 1e9 in the same run
    # (RATIOS): it fails that check alone, so every other check passes
    "speculative": ["--spec-speedup", "1e9", "--repeats", "1"],
    "moe": [],
    # at these sizes no queue builds, so the autoscaler never grows and
    # both packages fail the autoscale cycle: exit 1 with that check. The
    # run already fails, so it holds its ratio at 1e9 too (RATIOS)
    "fleet": PREFIX + ["--affine-margin", "1e9", "--repeats", "1"],
    "chaos": PREFIX + ["--requests", "8", "--repeats", "1"],
    "disagg": ["--disagg-margin", "1e9", "--repeats", "1"],
}
# the workloads whose exit is 1 at these sizes, and the checks that fail
EXPECTED_FAILS = {"fleet": ["autoscale cycle incomplete",
                            "prefix-affine routing did not beat"],
                  "speculative": ["speculative speedup"],
                  "disagg": ["disaggregation did not protect"]}
# a ratio flag at a value no run meets, in a run of its own: its check
# fails in both
RATIOS = {
    "shared-prefix": ("--ttft-ratio", "hit TTFT only"),
    "long-prefill": ("--itl-ratio", "chunked prefill only bounded"),
    "mixed": ("--assert-speedup", "speedup"),
}
# the port's report keys that JAX's has not: the argv's --device; in the
# batcher's stats the CUDA graph counts, the mean decode iteration beside
# JAX's EWMA, the chunk and iteration counts and the admission's
# rejections by reason; a resize's bytes moved; the disagg run's log of
# handoffs
PORT_ONLY = {"device", "graphs", "decode_iter_s_mean", "prefill_chunks",
             "decode_iterations", "rejections", "bytes_moved",
             "handoff_log"}


# maps keyed by random trace ids: compared by their sizes
BY_TRACE_ID = {"multi_track_traces"}


def _keys(tree):
    if isinstance(tree, dict):
        return {k: len(v) if k in BY_TRACE_ID else _keys(v)
                for k, v in tree.items() if k not in PORT_ONLY}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_keys(tree[0])]
    return None


def _fails(out: str):
    return [ln.split("FAIL: ", 1)[1] for ln in out.splitlines()
            if "[serve-bench] FAIL: " in ln]


def _both(argv, tmp_path, capsys):
    runs = {}
    for name, run, extra in (("jax", jbench.run_bench, []),
                             ("port", pbench.run_bench,
                              ["--device", "cpu"])):
        report = str(tmp_path / f"{name}.json")
        rc = run(argv + extra + ["--report", report])
        out = capsys.readouterr().out
        runs[name] = (rc, _fails(out), json.load(open(report)))
    return runs["jax"], runs["port"]


def _matches(fails, wanted):
    return sorted(w for w in wanted if any(w in f for f in fails))


WORKLOAD_CASES = [pytest.param(w, marks=pytest.mark.slow) if w == "chaos"
                  else w for w in WORKLOADS]


@pytest.mark.parametrize("workload", WORKLOAD_CASES)
def test_workload_like_jax(workload, tmp_path, capsys):
    """Chaos is marked slow: its checks ride wall-clock windows (JAX's
    heartbeat defaults, 2 s suspect and 10 s dead; the crash must land
    while requests are in flight), and with shorter windows JAX's drill
    ran to its 120 s deadline at these sizes."""
    argv = ["--workload", workload] + TINY + WORKLOADS[workload]
    if workload == "chaos":  # the drill's trace, events, flight bundle
        argv += ["--artifacts", str(tmp_path / "artifacts")]
    (jrc, jfails, jrep), (prc, pfails, prep) = _both(argv, tmp_path, capsys)
    wanted = EXPECTED_FAILS.get(workload, [])
    assert prc == jrc == (1 if wanted else 0), (pfails, jfails)
    assert _matches(pfails, wanted) == _matches(jfails, wanted) == \
        sorted(wanted)
    assert len(pfails) == len(jfails) == len(wanted), (pfails, jfails)
    assert _keys(prep) == _keys(jrep)
    assert set(prep["config"]) - set(jrep["config"]) == {"device"}


@pytest.mark.parametrize("workload", RATIOS)
def test_ratio_flag_fails_like_jax(workload, tmp_path, capsys):
    flag, text = RATIOS[workload]
    argv = (["--workload", workload] + TINY + WORKLOADS[workload]
            + [flag, "1e9"])
    if workload == "mixed":  # the lockstep baseline runs here
        argv[argv.index("--requests") + 1] = "2"
    (jrc, jfails, _), (prc, pfails, _) = _both(argv, tmp_path, capsys)
    assert prc == jrc == 1
    wanted = [text] + EXPECTED_FAILS.get(workload, [])
    assert _matches(pfails, wanted) == _matches(jfails, wanted) == \
        sorted(wanted)
    assert len(pfails) == len(jfails) == len(wanted), (pfails, jfails)


def test_bad_shrink_target_exits_like_jax():
    argv = ["--workload", "mesh-resize", "--slots", "2", "--shrink-to", "2"]
    for run, extra in ((jbench.run_bench, []),
                       (pbench.run_bench, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="--shrink-to 2 must be in"):
            run(argv + extra)


def test_mixed_greedy_tokens_equal_jax(monkeypatch):
    """The mixed workload's model from `build_tiny_lm` in both packages,
    JAX's weights carried across: `run_continuous` emits the same tokens
    for every request."""
    slots, window, vocab = 4, 16, 64
    work = pbench.make_workload(6, 4, window, 2, 8, vocab, seed=3)
    assert all(np.array_equal(a["prompt"], b["prompt"])
               for a, b in zip(work, jbench.make_workload(
                   6, 4, window, 2, 8, vocab, seed=3)))
    jm = jbench.build_tiny_lm(slots, window, vocab=vocab)
    pm = pbench.build_tiny_lm(slots, window, vocab=vocab, device="cpu")
    params_from_jax(pm, jm.params)
    tokens = {}
    for name, mod, model in (("jax", jbench, jm), ("port", pbench, pm)):
        submit = mod._submit_with_backpressure
        seen = []

        def record(*a, submit=submit, seen=seen, **kw):
            handles, retries = submit(*a, **kw)
            seen.extend(handles)
            return handles, retries

        monkeypatch.setattr(mod, "_submit_with_backpressure", record)
        res = mod.run_continuous(model, work, window + 8, slots, 4, 60.0)
        assert res["dropped"] == 0
        tokens[name] = [[int(t) for t in h.tokens] for h in seen]
    assert tokens["port"] == tokens["jax"]
    assert [len(t) for t in tokens["port"]] == [w["max_new"] for w in work]
