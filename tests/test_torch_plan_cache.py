"""The plan cache of the port (search/plan_cache.py) against the JAX
package's, on the CPU: the three fingerprints, the key's stability and
sensitivity, hits that skip the enumeration and still run the analysis
gate, LRU eviction and the disk tier, warm starts, the background planner,
plan files written by one package read by the other as exact hits, and
strategy files exported by one package imported by the other.

Scenarios adapted from tests/test_search_cache.py. Fingerprints are equal
as strings; costs of a hit equal the cold search's exactly.
"""
import dataclasses
import json
import os

import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu.core.graph import Graph as JGraph
from flexflow_tpu.search import machine_model as jmm
from flexflow_tpu.search import plan_cache as jpc
from flexflow_tpu.search import unity as junity
from flexflow_tpu_torch.core.graph import Graph as PGraph
from flexflow_tpu_torch.obs.registry import REGISTRY
from flexflow_tpu_torch.search import machine_model as pmm
from flexflow_tpu_torch.search import plan_cache as ppc
from flexflow_tpu_torch.search import unity as punity
from tests.test_torch_zoo import one_torch_thread

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(autouse=True)
def _fresh_plan_caches():
    jpc.reset_plan_cache()
    ppc.reset_plan_cache()
    yield
    jpc.reset_plan_cache()
    ppc.reset_plan_cache()


def _config(pkg, n_devices=8, budget=4, native=False, **kw):
    """Both packages on their Python search paths unless `native`, which
    leaves `use_native_search` at its default (the native cores)."""
    if pkg is pt:
        cfg = pt.FFConfig(device="cpu")
    else:
        cfg = ff.FFConfig()
    if not native:
        cfg.use_native_search = False
    cfg.batch_size = 64
    cfg.search_budget = budget
    cfg.num_devices = n_devices
    cfg.measure_op_costs = False
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _mlp(pkg, cfg, width=128, layers=2):
    m = pkg.FFModel(cfg)
    t = m.create_tensor([cfg.batch_size, 32])
    for _ in range(layers):
        t = m.dense(t, width, pkg.ActiMode.AC_MODE_RELU)
    t = m.dense(t, 10)
    m.softmax(t)
    return m


def _graph(pkg, **kw):
    cfg = _config(pkg, **kw)
    G = PGraph if pkg is pt else JGraph
    return G(_mlp(pkg, cfg, **{k: kw[k] for k in ("width",) if k in kw}
                  ).ops), cfg


def _search(pkg, n=8, machine=None, **kw):
    graph, cfg = _graph(pkg, n_devices=n, **kw)
    mm, un = (pmm, punity) if pkg is pt else (jmm, junity)
    machine = machine or mm.TpuPodModel(n)
    return un.unity_optimize(graph, cfg, machine, 64, n), graph


def _by_name(result, graph):
    return {graph.ops[g].name: dataclasses.astuple(s)
            for g, s in result.strategies.items() if g in graph.ops}


def _multipod(mm, ici=4, pods=2):
    return mm.HierarchicalMachineModel([
        mm.TierSpec("ici", ici, 45.0, links=2),
        mm.TierSpec("dcn", pods, 3.125, links=1, latency_us=10.0)])


def _counter(name, **labels):
    fam = REGISTRY.get(name)
    return fam.value(**labels) if fam is not None else 0.0


# -- fingerprints and keys -------------------------------------------------
def test_fingerprints_equal_jax_s():
    for kw in ({}, {"width": 64}, {"native": True}):
        (pg, pc), (jg, jc) = _graph(pt, **kw), _graph(ff, **kw)
        assert ppc.graph_fingerprint(pg) == jpc.graph_fingerprint(jg)
        assert ppc.knobs_fingerprint(pc) == jpc.knobs_fingerprint(jc)
    for n in (4, 8):
        assert ppc.machine_fingerprint(pmm.TpuPodModel(n)) == \
            jpc.machine_fingerprint(jmm.TpuPodModel(n))
    assert ppc.machine_fingerprint(_multipod(pmm)) == \
        jpc.machine_fingerprint(_multipod(jmm))
    pg, pc = _graph(pt)
    jg, jc = _graph(ff)
    assert ppc.plan_key(pg, pc, pmm.TpuPodModel(8), 64, 8).to_dict() == \
        jpc.plan_key(jg, jc, jmm.TpuPodModel(8), 64, 8).to_dict()


@pytest.mark.parametrize("name", ["bert", "resnet", "nmt", "dlrm", "moe"])
def test_zoo_graph_fingerprints_equal_jax_s(name):
    from tests.test_torch_search import _model

    jm, pm_ = _model(ff, name), _model(pt, name)
    assert ppc.graph_fingerprint(PGraph(pm_.ops)) == \
        jpc.graph_fingerprint(JGraph(jm.ops))


def test_plan_key_stability_and_sensitivity():
    g1, cfg = _graph(pt)
    g2, _ = _graph(pt)
    assert ppc.graph_fingerprint(g1) == ppc.graph_fingerprint(g2)
    g3, _ = _graph(pt, width=64)
    assert ppc.graph_fingerprint(g1) != ppc.graph_fingerprint(g3)
    m8, m4 = pmm.TpuPodModel(8), pmm.TpuPodModel(4)
    assert ppc.machine_fingerprint(m8) != ppc.machine_fingerprint(m4)
    m8b = pmm.TpuPodModel(8)
    m8b.step_time_scale = 1.25
    assert ppc.machine_fingerprint(m8) != ppc.machine_fingerprint(m8b)
    assert ppc.knobs_fingerprint(cfg) == ppc.knobs_fingerprint(
        _config(pt))
    assert ppc.knobs_fingerprint(cfg) != ppc.knobs_fingerprint(
        _config(pt, budget=9))
    # the live plan and the port's device are not knobs
    assert ppc.knobs_fingerprint(cfg) == ppc.knobs_fingerprint(
        _config(pt, replan_live_plan=object()))
    assert ppc.knobs_fingerprint(cfg) == ppc.knobs_fingerprint(
        dataclasses.replace(cfg, device="cuda"))
    k = ppc.plan_key(g1, cfg, m8, 64, 8)
    assert k == ppc.plan_key(g2, _config(pt), pmm.TpuPodModel(8), 64, 8)
    assert k != ppc.plan_key(g1, cfg, m8, 128, 8)


def test_search_is_deterministic_and_matches_jax():
    runs = []
    for _ in range(2):
        ppc.reset_plan_cache()
        r, g = _search(pt)
        assert r.cache_mode == "cold"
        runs.append((_by_name(r, g), r.mesh_axes, r.cost_us,
                     r.memory_bytes, r.candidates_simulated,
                     r.candidates_pruned, r.graph_hash, r.machine_hash))
    assert runs[0] == runs[1]
    j, jg = _search(ff)
    assert runs[0] == (_by_name(j, jg), j.mesh_axes, j.cost_us,
                       j.memory_bytes, j.candidates_simulated,
                       j.candidates_pruned, j.graph_hash, j.machine_hash)


# -- hits -------------------------------------------------------------------
def test_cache_hit_skips_enumeration_and_matches_cold():
    before = _counter("ff_search_cache_hits_total", tier="memory")
    cold, g = _search(pt)
    assert cold.cache_mode == "cold" and cold.candidates_simulated > 0
    hit, g2 = _search(pt)
    assert hit.cache_mode == "hit"
    assert hit.candidates_simulated == 0 and hit.candidates_pruned == 0
    assert (hit.cost_us, hit.mesh_axes, hit.predicted_step_us) == (
        cold.cost_us, cold.mesh_axes, cold.predicted_step_us)
    assert _by_name(hit, g2) == _by_name(cold, g)
    assert _counter("ff_search_cache_hits_total",
                    tier="memory") == before + 1


def test_cache_hit_still_runs_analysis_gate(monkeypatch):
    _search(pt)
    calls = {"n": 0}
    import flexflow_tpu_torch.analysis as analysis

    real = analysis.check_plan

    def spy(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(analysis, "check_plan", spy)
    hit, _ = _search(pt)
    assert hit.cache_mode == "hit" and calls["n"] >= 1


def test_stale_entry_falls_back_to_cold():
    cold, _ = _search(pt)
    g, cfg = _graph(pt)
    cache = ppc.get_plan_cache(cfg)
    key = ppc.plan_key(g, cfg, pmm.TpuPodModel(8), 64, 8)
    data = cache.get(key, count=False)
    data["ops"] = {"not_a_real_op": {"dp": 8}}
    cache.put(key, data)
    r, _ = _search(pt)
    assert r.cache_mode == "cold" and r.cost_us == cold.cost_us


def test_cache_lru_eviction_and_disk_persistence(tmp_path):
    before = _counter("ff_search_cache_evictions_total")
    cache = ppc.PlanCache(capacity=2, cache_dir=str(tmp_path))
    keys = [ppc.PlanKey(f"g{i}", "m", "k", 1, 1) for i in range(3)]
    for i, k in enumerate(keys):
        cache.put(k, {"cost_us": float(i)})
    assert len(cache) == 2
    assert _counter("ff_search_cache_evictions_total") == before + 1
    assert cache.get(keys[0])["cost_us"] == 0.0
    cache2 = ppc.PlanCache(capacity=4, cache_dir=str(tmp_path))
    assert cache2.get(keys[2])["cost_us"] == 2.0
    cache2.invalidate(keys[2])
    assert cache2.get(keys[2]) is None


def test_plan_cache_dir_roundtrip_and_no_cache_flag(tmp_path):
    cold, _ = _search(pt, plan_cache_dir=str(tmp_path))
    assert any(f.startswith("plan_") for f in os.listdir(tmp_path))
    ppc.reset_plan_cache()
    hit, _ = _search(pt, plan_cache_dir=str(tmp_path))
    assert hit.cache_mode == "hit" and hit.cost_us == cold.cost_us
    _search(pt, plan_cache=False)
    r, _ = _search(pt, plan_cache=False)
    assert r.cache_mode == "cold" and r.candidates_simulated > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_plan_files_are_exact_hits_across_packages(tmp_path, writer):
    """A plan the one package's search wrote to --plan-cache-dir is an
    exact hit in the other's, with the same plan and costs."""
    w, r = (ff, pt) if writer == "jax" else (pt, ff)
    cold, wg = _search(w, plan_cache_dir=str(tmp_path))
    assert cold.cache_mode == "cold"
    jpc.reset_plan_cache()
    ppc.reset_plan_cache()
    hit, rg = _search(r, plan_cache_dir=str(tmp_path))
    assert hit.cache_mode == "hit"
    assert _by_name(hit, rg) == _by_name(cold, wg)
    assert (hit.cost_us, hit.memory_bytes, hit.mesh_axes) == (
        cold.cost_us, cold.memory_bytes, cold.mesh_axes)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_native_plan_files_are_exact_hits_across_packages(tmp_path, writer):
    """With the default flags both packages search in their native cores:
    the same plan, and a plan the one cached natively is an exact hit in
    the other's; the flag is a knob (a Python-path plan misses)."""
    w, r = (ff, pt) if writer == "jax" else (pt, ff)
    cold, wg = _search(w, plan_cache_dir=str(tmp_path), native=True)
    assert cold.cache_mode == "cold" and "native ffcore search" in cold.log
    jpc.reset_plan_cache()
    ppc.reset_plan_cache()
    hit, rg = _search(r, plan_cache_dir=str(tmp_path), native=True)
    assert hit.cache_mode == "hit"
    assert _by_name(hit, rg) == _by_name(cold, wg)
    assert (hit.cost_us, hit.memory_bytes, hit.mesh_axes) == (
        cold.cost_us, cold.memory_bytes, cold.mesh_axes)
    ppc.reset_plan_cache()
    jpc.reset_plan_cache()
    other, _ = _search(r, plan_cache_dir=str(tmp_path))
    assert other.cache_mode == "cold"


# -- warm starts -------------------------------------------------------------
def test_warm_start_after_shrink_matches_cold_quality_and_jax():
    before = _counter("ff_search_warm_starts_total")
    out = {}
    for pkg, mm in ((pt, pmm), (ff, jmm)):
        _search(pkg, n=16, machine=_multipod(mm, ici=8, pods=2))
        warm, g = _search(pkg, n=8, machine=_multipod(mm, ici=8, pods=1))
        assert warm.cache_mode == "warm"
        out[pkg] = (_by_name(warm, g), warm.mesh_axes, warm.cost_us)
    assert out[pt] == out[ff]
    assert _counter("ff_search_warm_starts_total") == before + 1
    ppc.reset_plan_cache()
    cold, _ = _search(pt, n=8, machine=_multipod(pmm, ici=8, pods=1))
    assert cold.cache_mode == "cold"
    assert out[pt][2] <= 1.02 * cold.cost_us


def test_warm_result_is_cached_and_the_flag_disables():
    _search(pt, n=8)
    warm, _ = _search(pt, n=4)
    assert warm.cache_mode == "warm"
    hit, _ = _search(pt, n=4)
    assert hit.cache_mode == "hit" and hit.cost_us == warm.cost_us
    ppc.reset_plan_cache()
    _search(pt, n=8)
    r, _ = _search(pt, n=4, search_warm_start=False)
    assert r.cache_mode == "cold"


def test_search_wall_histogram_by_mode():
    _search(pt)
    _search(pt)
    fam = REGISTRY.get("ff_search_wall_time_ms")
    assert fam.count(mode="cold") >= 1 and fam.count(mode="hit") >= 1


# -- the background planner ---------------------------------------------------
def test_background_planner_runs_jobs_and_survives_errors():
    bp = ppc.BackgroundPlanner(idle_timeout_s=0.2)
    seen = []
    bp.submit("a", lambda: seen.append("a") or "ok")
    bp.submit("boom", lambda: 1 / 0)
    bp.submit("b", lambda: seen.append("b") or "ok")
    assert bp.join(timeout=10)
    assert seen == ["a", "b"]
    recs = {r["tag"]: r for r in bp.completed}
    assert recs["a"]["result"] == "ok"
    assert "ZeroDivisionError" in recs["boom"]["error"]
    assert all(r["wall_ms"] >= 0 for r in bp.completed)


def test_background_planner_precomputes_a_hit():
    bp = ppc.BackgroundPlanner(idle_timeout_s=0.2)
    bp.submit("plan", lambda: _search(pt, n=4)[0].cache_mode)
    assert bp.join(timeout=60)
    assert bp.completed[-1]["result"] == "cold"
    assert _search(pt, n=4)[0].cache_mode == "hit"


# -- export and import across packages --------------------------------------
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("graph", ["mlp", "mlp_split"])
def test_strategy_files_import_across_packages(tmp_path, writer, graph):
    """A strategy JSON exported by one package imports into the other with
    the same strategies, axes and replayed rewrites (mlp_split's greedy
    activation fusion and, where the search took it, the parallel-linear
    merge)."""
    from tests.test_torch_search import _model

    w, r = (ff, pt) if writer == "jax" else (pt, ff)
    G = {ff: JGraph, pt: PGraph}
    un = {ff: junity, pt: punity}
    mm = {ff: jmm, pt: pmm}
    if graph == "mlp":
        wm = _mlp(w, _config(w, n_devices=8))
        rm = _mlp(r, _config(r, n_devices=8))
    else:
        wm = _model(w, "mlp_split", search_budget=50)
        rm = _model(r, "mlp_split", search_budget=50)
    batch = wm.input_ops[0].outputs[0].dims[0]
    wg = G[w](wm.ops)
    res = un[w].unity_optimize(wg, wm.config, mm[w].TpuPodModel(8), batch,
                               8)
    path = str(tmp_path / "strategy.json")
    un[w].export_strategy(res, wg, path)
    rg = G[r](rm.ops)
    strategies, axes = un[r].rewrite_and_import_strategy(
        rg, rm.config, path)
    assert axes == res.mesh_axes
    assert {rg.ops[g].name: dataclasses.astuple(s)
            for g, s in strategies.items()} == _by_name(res, wg)
    assert sorted(o.name for o in rg.ops.values()) == \
        sorted(o.name for o in wg.ops.values())
    with open(path) as f:
        data = json.load(f)
    assert data["provenance"]["graph_hash"] == res.graph_hash
