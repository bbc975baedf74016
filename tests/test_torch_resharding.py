"""Live resharding of the port (flexflow_tpu_torch/resharding/, the
analysis's FFTA06x checks, the search's reshard pricing) against the JAX
package's, on the CPU. Adapted from tests/test_resharding.py:44-356.

 - the planner (plan_move, plan_redistribution, plan_slot_migration,
   uncovered_arrays), the FFTA060-063 gate (redistribution_diagnostics,
   survivor_diagnostics, check_redistribution, the reshard program) and
   the pricing (schedule_cost_us, search.simulator.reshard_cost_us, the
   plan-distance term) give JAX's answers on the same specs: the same
   moves, codes and messages, and costs within 1e-12 relative;
 - the executor on four gloo ranks: a seeded random-case property test
   (meshes of 1, 2 and 4 ranks, f32 and bf16 leaves, a 4 KB round bound
   that forces chunking), each rank's new shards bit-exact against numpy
   slicing of the whole array and against JAX's `redistribute` of the
   same tree on four CPU devices, the observed round scratch within the
   planned one; a same-mesh pure gather through the axis groups; and a
   trained model's weights and Adam moments moved from {"data": 4} to
   {"data": 2, "model": 2} (tools/tp_train.py `reshard_to`), every leaf
   the gathered whole's slice, then trained on.

The ranks' jobs run in one spawn under one time limit.
"""
import numpy as np
import pytest

from flexflow_tpu import resharding as J
from flexflow_tpu.analysis import PlanAnalysisError as JPlanAnalysisError
from flexflow_tpu.analysis import check_redistribution as jcheck
from flexflow_tpu.analysis import interp as jinterp
from flexflow_tpu.analysis import passes as jpasses
from flexflow_tpu.search import machine_model as jmm
from flexflow_tpu_torch import resharding as P
from flexflow_tpu_torch.analysis import PlanAnalysisError
from flexflow_tpu_torch.analysis import check_redistribution as pcheck
from flexflow_tpu_torch.analysis import interp as pinterp
from flexflow_tpu_torch.analysis import passes as ppasses
from flexflow_tpu_torch.search import machine_model as pmm

JOIN_S = 240
REL = 1e-12


def _mesh(pkg, n=8, axes=(("data", 4), ("model", 2))):
    return pkg.MeshSpec(device_ids=tuple(range(n)), axes=axes)


def _plan(pkg, arrays, mesh=None):
    return pkg.ShardingPlan(
        mesh=mesh or _mesh(pkg),
        arrays={k: pkg.ArraySpec(*v) for k, v in arrays.items()})


def _machine(pkg, n=8, hbm_gb=16.0):
    mm = pmm if pkg is P else jmm
    return mm.SimpleMachineModel(n, mm.ChipSpec(hbm_gb=hbm_gb))


def _move_sig(m):
    return (m.path, m.shape, m.rounds, m.chunk_dim, m.peak_scratch_bytes,
            m.infeasible_peak, m.noop, m.total_bytes_moved(),
            [(s.kind, s.axis, s.dim, s.participants, s.bytes_per_chip,
              s.scratch_bytes) for s in m.steps])


def _both(fn):
    """fn(pkg) for the JAX package and the port."""
    return fn(J), fn(P)


MOVE_CASES = {
    "noop": ({"w": ((4, 1), ("data", None))},
             {"w": ((4, 1), ("data", None))}, (16, 8), 1 << 30),
    "gather_slice": ({"w": ((4, 1), ("data", None))},
                     {"w": ((1, 2), (None, "model"))}, (16, 8), 1 << 30),
    "kept_dim": ({"w": ((4, 2), ("data", "model"))},
                 {"w": ((1, 2), (None, "model"))}, (16, 8), 1 << 30),
    "chunked": ({"w": ((4, 1), ("data", None))}, {}, (64, 16),
                2 * 64 * 16 * 4 // 4),
    "infeasible": ({"w": ((4, 1), ("data", None))}, {}, (8, 4), 8),
}


@pytest.mark.parametrize("case", sorted(MOVE_CASES))
def test_plan_move_like_jax(case):
    old, new, shape, peak = MOVE_CASES[case]
    j, p = _both(lambda pkg: pkg.plan_move(
        "w", shape, 4, "float32", _plan(pkg, old), _plan(pkg, new), peak))
    assert _move_sig(p) == _move_sig(j)
    if case == "chunked":
        assert p.rounds >= 4 and not p.infeasible_peak
    if case == "infeasible":
        assert p.infeasible_peak


def test_plan_rejects_indivisible_degree():
    for pkg in (J, P):
        with pytest.raises(pkg.ReshardPlanError, match="does not divide"):
            pkg.plan_move("w", (10, 4), 4, "float32", _plan(pkg, {}),
                          _plan(pkg, {"w": ((4, 1), ("data", None))}),
                          1 << 30)


def _sched(pkg, old, new, tree, peak=1 << 30, mesh=None):
    return pkg.plan_redistribution(tree, _plan(pkg, old, mesh),
                                   _plan(pkg, new, mesh), peak_bytes=peak)


GATE_CASES = {
    "ffta060": ({}, {"a": ((8, 1), ("expert", None)),
                     "b": ((2, 1), ("data", None))},
                {"a": (8, 4), "b": (8, 4)}, 16.0),
    "ffta061_hbm": ({}, {"w": ((4, 1), ("data", None))}, {"w": (64, 16)},
                    1e-6),
    "ffta062": ({}, {"w": ((4, 1), ("data", None))}, {"w": (64, 16)},
                2 * 64 * 16 * 4 * 1.1 / 1e9),
    "ffta061_bound": ({"w": ((4, 1), ("data", None))}, {}, {"w": (8, 4)},
                      16.0),
    "clean": ({"w": ((4, 1), ("data", None))}, {}, {"w": (16, 8)}, 16.0),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_redistribution_gate_like_jax(case):
    """FFTA060-062 and the reshard program's check: the same findings,
    and check_redistribution raises where JAX's does."""
    old, new, shapes, hbm = GATE_CASES[case]
    peak = 8 if case == "ffta061_bound" else 1 << 30
    out = {}
    for pkg, passes, interp, check, err in (
            (J, jpasses, jinterp, jcheck, JPlanAnalysisError),
            (P, ppasses, pinterp, pcheck, PlanAnalysisError)):
        tree = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
        sched = _sched(pkg, old, new, tree, peak)
        machine = _machine(pkg, hbm_gb=hbm)
        diags = [d.format() for d in passes.redistribution_diagnostics(
            sched, machine)]
        program = [(e.kind, e.tag, e.phase, e.groups)
                   for e in interp.build_reshard_program(sched)[0]]
        flow = [d.format() for d in interp.verify_reshard_program(sched)]
        try:
            rep = check(sched, machine=machine, record=False)
            raised = None
            passes_run = rep.passes_run
        except err as exc:
            raised = sorted(d.code for d in exc.report.errors())
            passes_run = None
        out[pkg] = (diags, program, flow, raised, passes_run)
    assert out[P] == out[J]
    if case == "clean":
        assert out[P][4] == ["redistribution", "flow"]
    if case == "ffta060":
        assert out[P][3].count("FFTA060") == 2


COVER_CASES = [
    ({}, {"w": 2}, [6, 7], None),
    ({"w": ((4, 1), ("data", None))}, {"w": 2}, [6, 7], None),
    ({"w": ((4, 1), ("data", None))}, {"w": 2}, [7], None),
    ({}, {"w": 1}, [0], (3,)),
    ({}, {"w": 1}, [], (3,)),
]


@pytest.mark.parametrize("i", range(len(COVER_CASES)))
def test_survivor_coverage_like_jax(i):
    arrays, leaves, lost, meshless = COVER_CASES[i]

    def run(pkg):
        mesh = (pkg.MeshSpec(device_ids=meshless) if meshless
                else _mesh(pkg))
        plan = _plan(pkg, arrays, mesh)
        passes = ppasses if pkg is P else jpasses
        return (pkg.uncovered_arrays(plan, leaves, lost),
                [d.format() for d in passes.survivor_diagnostics(
                    plan, leaves, lost)])

    j, p = _both(run)
    assert p == j


def test_schedule_cost_and_reshard_cost_like_jax():
    """resharding.cost and search.simulator.reshard_cost_us price JAX's
    schedules' counterparts alike, on a flat and a two-tier machine."""
    from flexflow_tpu.search import simulator as jsim
    from flexflow_tpu_torch.search import simulator as psim

    from tests.test_torch_collectives import SPEC_2x2, tiered_machine

    tree = {"w": np.zeros((64, 16), np.float32),
            "b": np.zeros((16,), np.float32)}
    old = {"w": ((4, 1), ("data", None))}
    new = {"w": ((1, 2), (None, "model")), "b": ((2,), ("model",))}
    for peak in (1 << 30, 2048):
        for tiered in (False, True):
            costs = {}
            for pkg, sim in ((J, jsim), (P, psim)):
                machine = (tiered_machine(pkg is P) if tiered
                           else _machine(pkg))
                sched = _sched(pkg, old, new, tree, peak)
                other = _sched(pkg, old, new, tree, peak, mesh=pkg.MeshSpec(
                    device_ids=(0, 1, 2, 3), axes=(("data", 4),)))
                costs[pkg] = (pkg.schedule_cost_us(sched, machine),
                              sim.reshard_cost_us(sched, machine),
                              pkg.schedule_cost_us(other, machine))
            assert all(c > 0 for c in costs[P][:2])
            for a, b in zip(costs[P], costs[J]):
                assert a == pytest.approx(b, rel=REL)
    assert SPEC_2x2["tiers"]


def test_slot_migration_like_jax():
    kv = {"kv/l0/k": ((4, 64, 4, 8), 4), "kv/l0/v": ((4, 64, 4, 8), 4)}
    j, p = _both(lambda pkg: pkg.plan_slot_migration(kv, 4, 2,
                                                     migrated_rows=96))
    assert [_move_sig(m) for m in p.moves] == [_move_sig(m) for m in j.moves]
    assert p.summary() == j.summary()


def test_verify_live_tree():
    import torch

    clean = {"a": torch.ones(4), "b": {"c": torch.zeros(2, 2)}}
    assert P.verify_live_tree(clean) is None
    bad = {"a": torch.ones(4), "b": {"c": torch.tensor([1.0, float("nan")])}}
    reason = P.verify_live_tree(bad)
    assert reason is not None and "b/c" in reason
    assert P.verify_live_tree({"i": torch.zeros(3, dtype=torch.int32)}) \
        is None


# -- the executor on four ranks --------------------------------------------
AXES_POOL = [(), (("data", 2), ("model", 2)), (("data", 2),),
             (("model", 2), ("data", 2)), (("data", 4),)]
SHAPES = {"params/op/w": (16, 8), "params/op/b": (8,),
          "opt_state/v/op/w": (16, 8), "state/scalar": ()}
N_CASES = 12
PEAK = 4096


def _random_cases():
    """Seeded (old axes, new axes, specs, values, bf16 leaves) cases over
    meshes of the first 1, 2 or 4 ranks."""
    rng = np.random.RandomState(0)
    cases = []
    for case in range(N_CASES):
        old_axes = AXES_POOL[rng.randint(len(AXES_POOL))]
        new_axes = AXES_POOL[rng.randint(len(AXES_POOL))]
        lone = int(rng.randint(4))

        def rand_spec(shape, axes):
            degrees, names, free = [], [], dict(axes)
            for size in shape:
                picked = None
                for name, deg in list(free.items()):
                    if rng.rand() < 0.4 and size % deg == 0:
                        picked = (deg, name)
                        del free[name]
                        break
                degrees.append(picked[0] if picked else 1)
                names.append(picked[1] if picked else None)
            return tuple(degrees), tuple(names)

        old, new, values, bf16 = {}, {}, {}, []
        for i, (path, shape) in enumerate(SHAPES.items()):
            if shape:
                old[path] = rand_spec(shape, old_axes)
                new[path] = rand_spec(shape, new_axes)
            values[path] = np.asarray(rng.randn(*shape), np.float32)
            if shape and (case + i) % 3 == 0:
                bf16.append(path)
        cases.append({"old_axes": old_axes, "new_axes": new_axes,
                      "lone": lone, "old": old, "new": new,
                      "values": values, "bf16": bf16})
    return cases


def _mesh_of(pkg, axes, lone):
    if not axes:
        return pkg.MeshSpec(device_ids=(lone,))
    n = int(np.prod([s for _, s in axes]))
    return pkg.MeshSpec(device_ids=tuple(range(n)), axes=axes)


def _whole(case, path):
    """The leaf's whole value as a torch tensor (bf16 where the case says,
    rounded from the f32 values)."""
    import torch

    t = torch.from_numpy(case["values"][path])
    return t.to(torch.bfloat16) if path in case["bf16"] else t


def _plans(pkg, case):
    old = pkg.ShardingPlan(mesh=_mesh_of(pkg, case["old_axes"], 0),
                           arrays={k: pkg.ArraySpec(*v)
                                   for k, v in case["old"].items()})
    new = pkg.ShardingPlan(mesh=_mesh_of(pkg, case["new_axes"],
                                         case["lone"]),
                           arrays={k: pkg.ArraySpec(*v)
                                   for k, v in case["new"].items()})
    return old, new


def _bits(t):
    import torch

    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _cut(t, box):
    for d, (lo, hi) in enumerate(box):
        t = t.narrow(d, lo, hi - lo)
    return t


def _rank_case(case, rank):
    """This rank's local old shards, redistributed."""
    from flexflow_tpu_torch.resharding.executor import shard_box

    old, new = _plans(P, case)
    tree = {}
    for path, shape in SHAPES.items():
        whole = _whole(case, path)
        spec = old.spec_for(path, len(shape))
        box = shard_box(spec, old.mesh, rank, shape)
        if box is None:  # outside the old mesh: a leaf of the local shape
            box = shard_box(spec, old.mesh, old.mesh.device_ids[0], shape)
            tree[path] = _cut(whole, box).clone().zero_()
        else:
            tree[path] = _cut(whole, box).clone()
    res = P.redistribute(P.unflatten_tree(tree), old, new, peak_bytes=PEAK,
                         machine=_machine(P, 4))
    return {"leaves": {k: _bits(v) for k, v in
                       P.flatten_tree(res.tree).items()},
            "observed": res.observed_peak_bytes,
            "planned": res.schedule.peak_scratch_bytes,
            "rounds": (res.allgather_rounds, res.transfer_rounds)}


def _rank_gather(rank):
    """A same-mesh pure gather with the mesh's axis groups at hand."""
    import torch

    from flexflow_tpu_torch.core.machine import make_mesh

    mesh = make_mesh({"data": 2, "model": 2})
    spec = P.MeshSpec(device_ids=(0, 1, 2, 3),
                      axes=(("data", 2), ("model", 2)))
    old = P.ShardingPlan(mesh=spec, arrays={"w": P.ArraySpec(
        (2, 2), ("data", "model"))})
    new = P.ShardingPlan(mesh=spec, arrays={})
    whole = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    d, m = mesh.index("data"), mesh.index("model")
    local = whole[d * 8:(d + 1) * 8, m * 4:(m + 1) * 4].clone()
    res = P.redistribute({"w": local}, old, new, peak_bytes=1 << 30,
                         machine=_machine(P, 4), mesh=mesh,
                         collect_timings=True)
    return {"equal": bool(torch.equal(res.tree["w"], whole)),
            "allgather_rounds": res.allgather_rounds,
            "rows": [(r.op, r.participants) for r in res.calibration_rows],
            "observed": res.observed_peak_bytes,
            "planned": res.schedule.peak_scratch_bytes}


def _rank(rank, world, init, cases, jobs):
    import torch

    from flexflow_tpu_torch.runtime import distributed
    from flexflow_tpu_torch.tools.tp_train import run_job

    distributed.initialize(init, world_size=world, rank=rank, device="cpu")
    torch.set_num_threads(1)
    try:
        return {"cases": [_rank_case(c, rank) for c in cases],
                "gather": _rank_gather(rank),
                "jobs": [run_job(j, "cpu") for j in jobs]}
    finally:
        distributed.shutdown()


def _jax_redistribute(case):
    """JAX's redistribute of the same tree on four CPU devices: each
    leaf's whole result (bits)."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from flexflow_tpu.resharding.executor import _target_sharding

    old, new = _plans(J, case)
    tree = {}
    for path, shape in SHAPES.items():
        v = case["values"][path]
        if path in case["bf16"]:
            v = v.astype(ml_dtypes.bfloat16)
        spec = old.spec_for(path, len(shape))
        tree[path] = jax.device_put(jnp.asarray(v),
                                    _target_sharding(old.mesh, spec))
    res = J.redistribute(J.unflatten_tree(tree), old, new, peak_bytes=PEAK,
                         machine=_machine(J, 4))
    out = {}
    for path, leaf in J.flatten_tree(res.tree).items():
        a = np.asarray(leaf)
        out[path] = a.view(np.int16) if a.dtype.itemsize == 2 else a
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from flexflow_tpu_torch.runtime.distributed import spawn
    from flexflow_tpu_torch.tools.tp_train import bench_batch

    cases = _random_cases()
    x, y = bench_batch(batch=8, seq=12, vocab=64)
    widths = dict(hidden_size=16, embedding_size=16, num_heads=2,
                  num_layers=2, sequence_length=12, vocab_size=64)
    jobs = [dict(model="encoder", widths=widths, batch=8, mixed=False,
                 adam=(1e-2, None), x=x, y=y, steps=2, axes={"data": 4},
                 reshard_to={"data": 2, "model": 2}, reshard_peak=4096)]
    init = "file://" + str(tmp_path_factory.mktemp("rdv") / "rdv")
    ranks = spawn(_rank, 4, (4, init, cases, jobs), timeout_s=JOIN_S)
    return cases, ranks


def test_redistribute_property_bit_exact(runs):
    """Every rank's new shards equal numpy's slice of the whole and JAX's
    redistribute of the same tree, to the bit; the observed round
    scratch stays within the planned one."""
    import torch

    from flexflow_tpu_torch.resharding.executor import shard_box

    cases, ranks = runs
    for i, case in enumerate(cases):
        _, new = _plans(P, case)
        jax_whole = _jax_redistribute(case)
        for rank, r in enumerate(ranks):
            got = r["cases"][i]
            assert got["observed"] <= got["planned"], (i, got)
            want_paths = set()
            for path, shape in SHAPES.items():
                box = shard_box(new.spec_for(path, len(shape)), new.mesh,
                                rank, shape)
                if box is None:
                    continue
                want_paths.add(path)
                want = _bits(_cut(_whole(case, path), box))
                assert np.array_equal(got["leaves"][path], want), (i, path)
                jw = torch.from_numpy(np.array(jax_whole[path]))
                assert np.array_equal(got["leaves"][path],
                                      _cut(jw, box).numpy()), (i, path)
            assert set(got["leaves"]) == want_paths, i
    # the cases move something through exchanges
    assert sum(r["cases"][i]["rounds"][1] for r in ranks
               for i in range(len(cases))) > 0


def test_same_mesh_gather_uses_the_axis_groups(runs):
    for r in runs[1]:
        g = r["gather"]
        assert g["equal"] and g["allgather_rounds"] >= 1
        assert g["rows"] and all(op == "allgather" and n == 4
                                 for op, n in g["rows"])
        assert g["observed"] <= g["planned"]


def test_trained_model_reshards_data4_to_data2_model2(runs):
    """There: every rank holds the whole replicated tree, so each new
    shard is a local cut (no buffer). Back: the model shards are gathered
    across the ranks, within the planned scratch."""
    for r in runs[1]:
        rs = r["jobs"][0]["reshard"]
        assert rs["old_axes"] == {"data": 4}
        assert rs["new_axes"] == {"data": 2, "model": 2}
        assert rs["mismatched"] == []
        assert rs["observed_peak_bytes"] <= rs["planned_scratch_bytes"]
        assert rs["transfer_rounds"] > 0
        assert len(rs["losses_after"]) == 2
        assert all(np.isfinite(rs["losses_after"]))
        back = rs["back"]
        assert back["new_axes"] == {"data": 4} and back["mismatched"] == []
        assert 0 < back["observed_peak_bytes"] <= \
            back["planned_scratch_bytes"]
    assert len({tuple(r["jobs"][0]["reshard"]["losses_after"])
                for r in runs[1]}) == 1


def test_plan_distance_and_live_plan_like_jax():
    """plan_distance_us of a live plan onto candidate plans, and the warm
    re-plan that ranks with it, give JAX's numbers."""
    from tests.test_torch_search import plan_distance_both

    plan_distance_both()
