"""The calibration loop on the CPU (ROADMAP A7.5, A5.8): FittedProfile,
refit, the fits and DriftDetector, `calibrate`, `fit(drift_detector=)`
and the derived serving slots of the port against the JAX package's
(tests/test_refit.py, tests/test_continuous_batching.py:104-120), on the
same graphs from the same builder code and the same rows.

Tolerance: predicted costs and fitted coefficients 1e-9 relative (the
same float expressions); slot counts, verdicts, steps and greedy tokens
identical. Measured times are never compared (they are each host's).
"""
import dataclasses
import importlib
import json
import math

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as pt
from flexflow_tpu_torch import params_from_jax
from tests.test_torch_zoo import one_torch_thread

jcal = importlib.import_module("flexflow_tpu.obs.calibration")
jrefit = importlib.import_module("flexflow_tpu.obs.refit")
pcal = importlib.import_module("flexflow_tpu_torch.obs.calibration")
prefit = importlib.import_module("flexflow_tpu_torch.obs.refit")

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

REL = 1e-9
TIERED = {"tiers": [{"name": "ici", "degree": 4, "gbps": 45.0, "links": 2},
                    {"name": "dcn", "degree": 2, "gbps": 3.125, "links": 1,
                     "latency_us": 10.0}]}


def _coeffs(mod):
    return mod.FittedCoefficients(
        compute_scale={"bf16": 0.125, "f32": 0.5}, hbm_scale=0.75,
        link_bw_scale=2.0, tier_link_scales={"dcn": 0.25},
        dispatch_latency_us=42.5, collective_latency_us=3.25,
        step_scale=11.0)


# -- FittedProfile ---------------------------------------------------------
@pytest.mark.parametrize("writer,reader", [(jrefit, prefit),
                                           (prefit, jrefit)])
def test_profile_loads_in_the_other_package(tmp_path, writer, reader):
    """Same JSON format and spec hash: a profile written by either package
    loads into the other, field for field, and overlays the same
    machine."""
    path = str(tmp_path / "p.json")
    writer.FittedProfile(
        chip="tpu-v5e", backend="cpu", coefficients=_coeffs(writer),
        fitted_steps=7, fitted_ops=4, rounds=2, step_ratio=1.01,
        num_chips=8, op_family_residuals={"layernorm": 1.5},
        kernel_residual_thresholds={"softmax": 1.2}).save(path)
    got = reader.FittedProfile.load(path, expect_chip="tpu-v5e",
                                    expect_backend="cpu")
    want = writer.FittedProfile.load(path, expect_chip="tpu-v5e",
                                     expect_backend="cpu")
    assert got.to_dict() == want.to_dict()
    assert reader.spec_hash("h100-sxm", "gpu") == \
        writer.spec_hash("h100-sxm", "gpu")


def _load_error(mod, path, **kw):
    try:
        mod.FittedProfile.load(path, **kw)
    except mod.FittedProfileError as e:
        return type(e).__name__, str(e)
    return None


def test_profile_mismatches_are_typed_like_jax(tmp_path):
    good = str(tmp_path / "good.json")
    jrefit.FittedProfile(chip="tpu-v5e", backend="cpu",
                         coefficients=_coeffs(jrefit)).save(good)
    d = json.load(open(good))
    cases = {"chip": (good, {"expect_chip": "h100-sxm"}),
             "backend": (good, {"expect_backend": "gpu"})}
    for name, edit in (("stale", {"spec_hash": "0" * 16}),
                       ("future", {"version": 99}),
                       ("malformed", {"coefficients": None}),
                       ("missing", None)):
        p = str(tmp_path / f"{name}.json")
        dd = dict(d)
        if edit is None:
            del dd["chip"]
        else:
            dd.update(edit)
        json.dump(dd, open(p, "w"))
        cases[name] = (p, {})
    bad = str(tmp_path / "unreadable.json")
    open(bad, "w").write("{")
    cases["unreadable"] = (bad, {})
    cases["absent"] = (str(tmp_path / "nope.json"), {})
    kinds = {}
    for name, (p, kw) in cases.items():
        got, want = _load_error(prefit, p, **kw), _load_error(jrefit, p, **kw)
        assert got is not None and got[0] == want[0], name
        kinds[name] = got[0]
    assert kinds["chip"] == kinds["backend"] == kinds["stale"] == \
        "FittedProfileMismatch"
    assert kinds["future"] == kinds["unreadable"] == "FittedProfileError"


@pytest.mark.parametrize("writer", [jrefit, prefit])
def test_bare_load_checks_the_process_backend_like_jax(tmp_path, writer):
    """With no expect_backend, both packages check the process's backend
    ("cpu" here): the other backend's profile raises the typed mismatch,
    this one's loads."""
    here, other = str(tmp_path / "cpu.json"), str(tmp_path / "gpu.json")
    for path, backend in ((here, "cpu"), (other, "gpu")):
        writer.FittedProfile(chip="h100-sxm", backend=backend,
                             coefficients=_coeffs(writer)).save(path)
    assert prefit._current_backend() == "cpu"
    for mod in (prefit, jrefit):
        assert mod.FittedProfile.load(here).backend == "cpu"
        with pytest.raises(mod.FittedProfileMismatch, match="'gpu'"):
            mod.FittedProfile.load(other)


def test_make_machine_model_applies_profile_like_jax(tmp_path):
    path = str(tmp_path / "p.json")
    prefit.FittedProfile(chip="tpu-v5e", backend="cpu",
                         coefficients=_coeffs(prefit)).save(path)
    from flexflow_tpu.search.machine_model import make_machine_model as jmk
    from flexflow_tpu_torch.search.machine_model import \
        make_machine_model as pmk

    jc = ff.FFConfig()
    jc.fitted_profile_file = path
    pc = pt.FFConfig(device="cpu", fitted_profile_file=path)
    jm, pm_ = jmk(jc, 8), pmk(pc, 8)
    assert dataclasses.asdict(pm_.chip) == dataclasses.asdict(jm.chip)
    assert (pm_.dispatch_overhead_us, pm_.collective_latency_us,
            pm_.step_time_scale) == (jm.dispatch_overhead_us,
                                     jm.collective_latency_us,
                                     jm.step_time_scale)
    # a CUDA config prices the H100, so a v5e profile refuses to load
    with pytest.raises(prefit.FittedProfileMismatch, match="h100-sxm"):
        pmk(dataclasses.replace(pc, device="cuda"), 1)


# -- the fits and the drift detector ---------------------------------------
class _Row:
    def __init__(self, pred, meas, dtype="f32", op="x", op_type="linear"):
        self.predicted_us, self.measured_us = pred, meas
        self.dtype, self.op, self.op_type = dtype, op, op_type

    @property
    def ratio(self):
        return self.measured_us / self.predicted_us


def test_linear_fit_and_compute_coefficients_like_jax():
    rng = np.random.RandomState(3)
    for n in (1, 2, 3, 9):
        xs = list(rng.uniform(1, 100, n))
        ys = [3.0 * x + 7.0 + rng.randn() for x in xs]
        ys[0] *= 5.0  # an outlier
        assert prefit._trimmed_linear_fit(xs, ys) == pytest.approx(
            jrefit._trimmed_linear_fit(xs, ys), rel=REL)
    rows = [_Row(p, 2.5 * p + 11.0, dt) for p, dt in
            zip(rng.uniform(2, 500, 12), ["f32", "bf16"] * 6)]
    rows += [_Row(0.0, 5.0), _Row(4.0, float("nan")), _Row(3.0, -1.0)]
    assert len(prefit.usable_rows(rows)) == len(jrefit.usable_rows(rows))
    from flexflow_tpu.search.machine_model import TpuPodModel as JPod
    from flexflow_tpu_torch.search.machine_model import TpuPodModel as PPod

    got = prefit.fit_compute_coefficients(rows, _coeffs(prefit), PPod(4))
    want = jrefit.fit_compute_coefficients(rows, _coeffs(jrefit), JPod(4))
    _same(got.to_dict(), want.to_dict())


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, float):
        if math.isnan(a):
            assert math.isnan(b)
        else:
            assert a == pytest.approx(b, rel=REL, abs=0.0)
    else:
        assert a == b


def test_fit_collective_and_kernel_thresholds_like_jax():
    from flexflow_tpu.search.machine_model import \
        HierarchicalMachineModel as JH
    from flexflow_tpu_torch.search.machine_model import \
        HierarchicalMachineModel as PH

    def rows(mod):
        out = []
        for tier, slope in (("ici", 2e-4), ("dcn", 3e-3), ("mesh", 1e-3)):
            for b in (1e5, 1e6, 4e6, 1.6e7):
                out.append(mod.CollectiveCalibration(
                    "psum", "tier_ring", tier, b, 4, b * slope / 2.0,
                    b * slope + 12.0))
        out.append(mod.CollectiveCalibration("allreduce", "auto", "ici", 1e6,
                                             8, 10.0, 30.0))
        return out

    got = prefit.fit_collective_coefficients(rows(pcal), PH.from_json(TIERED))
    want = jrefit.fit_collective_coefficients(rows(jcal),
                                              JH.from_json(TIERED))
    _same(got.to_dict(), want.to_dict())
    d = rows(pcal)[0].to_dict()
    assert pcal.CollectiveCalibration.from_dict(d).to_dict() == \
        jcal.CollectiveCalibration.from_dict(d).to_dict()
    prow = [_Row(10.0, 14.0, op_type="layernorm"),
            _Row(10.0, 9.0, op_type="layernorm"),
            _Row(5.0, 8.0, op_type="softmax"),
            _Row(2.0, 7.0, op_type="multihead_attention"),
            _Row(2.0, 0.0, op_type="rms_norm")]
    assert prefit.fit_kernel_thresholds(prow) == \
        jrefit.fit_kernel_thresholds(prow)
    assert pcal.op_family_residuals(prow) == jcal.op_family_residuals(prow)
    assert pcal.KERNEL_TIER_FAMILIES == jcal.KERNEL_TIER_FAMILIES


@pytest.mark.parametrize("series", [
    [100.0] * 3 + [200.0] * 6 + [100.0] * 6,
    [0.0, float("nan"), 90.0, 110.0, 400.0, 400.0, 400.0, 90.0, 400.0, 400.0,
     400.0, 400.0],
    [1000.0] * 12,
])
def test_drift_detector_verdicts_like_jax(series):
    from flexflow_tpu.obs.registry import MetricsRegistry as JR
    from flexflow_tpu_torch.obs.registry import MetricsRegistry as PR

    kw = dict(threshold=0.5, alpha=0.25, warmup_steps=2, patience=2,
              max_replans=1)
    jd = jrefit.DriftDetector(100.0, registry=JR(), **kw)
    pd = prefit.DriftDetector(100.0, registry=PR(), **kw)
    for i, v in enumerate(series):
        got, want = pd.observe(v), jd.observe(v)
        assert got == want, i
        if got and i % 2:
            pd.note_replan()
            jd.note_replan()
        assert pd.drift == pytest.approx(jd.drift, rel=REL)
        if i == 8:
            pd.rearm(150.0)
            jd.rearm(150.0)
    assert pd.measured_step_us == jd.measured_step_us
    with pytest.raises(ValueError):
        prefit.DriftDetector(0.0)


# -- calibrate and refit on the same graph ---------------------------------
def _net(pkg, mixed=False, spec_path=None, version=0):
    if pkg is pt:
        c = pt.FFConfig(batch_size=8, allow_mixed_precision=mixed,
                        device="cpu")
    else:
        c = ff.FFConfig()
        c.batch_size = 8
        c.num_devices = 1
        c.allow_mixed_precision = mixed
    m = pkg.FFModel(c)
    t = m.create_tensor([8, 6, 32])
    a = m.multihead_attention(t, t, t, 32, 4, name="attn")
    t = m.layer_norm(m.add(t, a), [-1], name="ln")
    t = m.dense(t, 64, pkg.ActiMode.AC_MODE_GELU, name="ff1")
    t = m.dense(t, 10, name="ff2")
    m.softmax(t, name="sm")
    kw = {} if pkg is ff else {"generator": torch.Generator().manual_seed(0)}
    m.compile(optimizer=pkg.SGDOptimizer(m, lr=0.05),
              loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              **kw)
    # the pricing knobs after compile (JAX's compile plans one device)
    c.machine_model_file = spec_path
    c.machine_model_version = version
    return m


def _rows(mod, report):
    """The report's rows with a synthetic measured side, the same in both
    packages: the fit input is then a function of the predictions
    alone."""
    return [mod.OpCalibration(o.op, o.op_type, o.strategy, o.predicted_us,
                              3.0 * o.predicted_us + 20.0 + 5.0 * i,
                              dtype=o.dtype)
            for i, o in enumerate(report.ops)]


@pytest.mark.parametrize("mixed", [False, True])
def test_calibrate_predicts_like_jax(mixed):
    """The same rows (op, type, strategy, dtype) and predicted numbers as
    JAX's calibrate; the step measured from fit's StepStats; the gauge."""
    jm, pm_ = _net(ff, mixed), _net(pt, mixed)
    rng = np.random.RandomState(0)
    x = rng.randn(16, 6, 32).astype(np.float32)
    y = rng.randint(0, 10, size=(16, 6, 1)).astype(np.int32)
    pm_.fit(x, y, epochs=1)
    jr, pr = jcal.calibrate(jm, max_ops=4), pcal.calibrate(pm_, max_ops=4)
    assert pr.backend == jr.backend == "cpu"
    assert [(o.op, o.op_type, o.strategy, o.dtype) for o in pr.ops] == \
        [(o.op, o.op_type, o.strategy, o.dtype) for o in jr.ops]
    for p, j in zip(pr.ops, jr.ops):
        assert p.predicted_us == pytest.approx(j.predicted_us, rel=REL)
        assert p.measured_us > 0 and p.error is None
    assert pr.predicted_step_us == pytest.approx(jr.predicted_step_us,
                                                 rel=REL)
    assert pr.measured_steps == 2 and pr.measured_step_us > 0
    assert pr.step_ratio == pr.measured_step_us / pr.predicted_step_us
    from flexflow_tpu_torch.obs import REGISTRY

    assert REGISTRY.gauge("ff_sim_step_calibration_ratio").value() == \
        pr.step_ratio
    d = pr.to_dict()
    assert set(d) == set(jr.to_dict())
    assert {c["family"] for c in d["kernel_candidates"]} == \
        {c["family"] for c in jr.kernel_candidates()}
    assert "simulator calibration (cpu backend" in pr.format()
    assert "kernel candidates" in pr.format_kernel_report()


def test_calibrate_leaves_weights_state_and_generator_alone():
    """Every weight, every state buffer (batch norm's running statistics)
    and the model's generator keep their bits through calibrate and
    profile_ops."""
    from flexflow_tpu_torch.runtime.profiling import profile_ops

    m = pt.FFModel(pt.FFConfig(batch_size=4, device="cpu"))
    t = m.create_tensor([4, 3, 8, 8])
    t = m.batch_norm(m.conv2d(t, 4, 3, 3, 1, 1, 1, 1))
    t = m.dense(m.dropout(m.flat(t), 0.5), 10)
    m.softmax(t)
    m.compile(generator=torch.Generator().manual_seed(1))
    m.fit(np.random.RandomState(0).randn(8, 3, 8, 8).astype(np.float32),
          np.zeros((8, 1), np.int32), epochs=1)
    snap = [(op.name, n, v.clone()) for op in m.ops
            for n, v in list(op.named_parameters())
            + list(op.named_buffers())]
    gen = m.executor.generator.get_state().clone()
    rep = pcal.calibrate(m)
    rows = profile_ops(m, warmup=1, repeats=1)
    assert len(rows) == len(rep.ops) == len(m.ops) - 1
    assert all(r["forward_us"] > 0 for r in rows)
    for name, n, v in snap:
        now = dict(list(m.get_layer_by_name(name).named_parameters())
                   + list(m.get_layer_by_name(name).named_buffers()))[n]
        assert torch.equal(now, v), (name, n)
    assert torch.equal(gen, m.executor.generator.get_state())


@pytest.mark.parametrize("machine", ["simple", "tiered"])
def test_refit_fits_like_jax(tmp_path, machine):
    """refit on the same graph with the same rows: the same coefficient
    history, coefficients and profile; the tiered case prices a dp = 8
    plan, so the per-tier link fit runs too."""
    spec = None
    if machine == "tiered":
        spec = str(tmp_path / "spec.json")
        json.dump(TIERED, open(spec, "w"))
    jm, pm_ = _net(ff, True, spec), _net(pt, True, spec)
    if machine == "tiered":
        from flexflow_tpu.search.simulator import OpStrategy as JS
        from flexflow_tpu_torch.search.simulator import OpStrategy as PS

        jm._op_strategies = {op.guid: JS(dp=8) for op in jm.ops}
        pm_._op_strategies = {op.guid: PS(dp=8) for op in pm_.ops}
        jm.config.num_devices = pm_.config.num_devices = 8
    jrep, prep = jcal.calibrate(jm), pcal.calibrate(pm_)
    measured = 40.0 * jrep.predicted_step_us
    for rounds, tol in ((3, 0.15), (1, 1e-6)):
        jp, jh = jrefit.refit(jm, measured, _rows(jcal, jrep),
                              rounds=rounds, tol=tol)
        pp, ph = prefit.refit(pm_, measured, _rows(pcal, prep),
                              rounds=rounds, tol=tol)
        assert [(h.round, h.predicted_step_us, h.measured_step_us)
                for h in ph] == pytest.approx(
            [(h.round, h.predicted_step_us, h.measured_step_us)
             for h in jh], rel=REL)
        _same(pp.coefficients.to_dict(), jp.coefficients.to_dict())
        pd, jd = pp.to_dict(), jp.to_dict()
        del pd["coefficients"], jd["coefficients"]
        _same(pd, jd)
    if machine == "tiered":
        assert pp.coefficients.tier_link_scales
    with pytest.raises(prefit.FittedProfileError):
        prefit.refit(pm_, 0.0, [])
    # the saved profile reprices the converged step through the factory
    path = pp.save(str(tmp_path / "fitted.json"))
    from flexflow_tpu_torch.search.machine_model import make_machine_model
    from flexflow_tpu_torch.search.simulator import Simulator

    cfg = dataclasses.replace(pm_.config, fitted_profile_file=path)
    sim = Simulator(make_machine_model(cfg, cfg.total_devices), cfg)
    assert sim.simulate(pm_.graph, pcal.op_strategies(pm_)) == \
        pytest.approx(ph[-1].predicted_step_us, rel=1e-6)


# -- fit(drift_detector=) --------------------------------------------------
def _drift_run(pkg, fit_kw):
    """fit with a detector whose prediction every real step breaches
    (1e-3 us): the steps it fires at, from the obs.drift instants."""
    from tests.test_torch_watchdog import _dense_net

    mod = jrefit if pkg is ff else prefit
    tr_mod = importlib.import_module(
        "flexflow_tpu.obs.tracing" if pkg is ff
        else "flexflow_tpu_torch.obs.tracing")
    tr = tr_mod.get_tracer()
    tr.clear()
    tr.enable()
    try:
        det = mod.DriftDetector(1e-3, warmup_steps=1, patience=2,
                                max_replans=1)
        rng = np.random.RandomState(0)
        x = rng.randn(64, 32).astype(np.float32)
        y = rng.randint(0, 10, size=(64, 1)).astype(np.int32)
        _dense_net(pkg).fit(x, y, epochs=2, drift_detector=det, **fit_kw)
        steps = [e["args"]["step"] for e in tr.events("obs.drift")]
    finally:
        tr.disable()
        tr.clear()
    return steps, det._seen, det.replans


@pytest.mark.parametrize("fit_kw", [{}, {"steps_per_execution": 2},
                                    {"accum_steps": 2}])
def test_fit_drift_detector_fires_at_jax_steps(fit_kw):
    """Each committed step (update, K-step dispatch) feeds the detector
    once; it fires at JAX's steps, and fit never spends the budget."""
    got, want = _drift_run(pt, fit_kw), _drift_run(ff, fit_kw)
    assert got == want
    assert got[0] and got[2] == 0


# -- derived serving slots -------------------------------------------------
@pytest.fixture(scope="module")
def lms():
    from flexflow_tpu_torch.serving.sched.bench import build_tiny_lm
    from tests.test_generate import _build_lm

    jm = _build_lm(2, 12)
    pm_ = build_tiny_lm(2, 12, vocab=50, device="cpu")
    params_from_jax(pm_, jm.params)
    jd = _build_lm(2, 12, hidden=16, heads=2, layers=1)
    pd = build_tiny_lm(2, 12, vocab=50, hidden=16, heads=2, layers=1,
                       device="cpu")
    params_from_jax(pd, jd.params)
    return jm, pm_, jd, pd


def _chips(mm):
    return {"big": mm.SimpleMachineModel(1, mm.ChipSpec()),
            "tiny": mm.SimpleMachineModel(1, mm.ChipSpec(hbm_gb=1e-9)),
            "mid": mm.SimpleMachineModel(1, mm.ChipSpec(hbm_gb=3e-4))}


def test_derive_num_slots_like_jax(lms):
    """JAX tests/test_continuous_batching.py:104-120 in both packages:
    the ceiling, the floor and the arithmetic between (the same plan
    memory model)."""
    from flexflow_tpu.analysis import plan_memory_bytes as jplan
    from flexflow_tpu.search import machine_model as jmm
    from flexflow_tpu.serving.sched.kvpool import \
        derive_num_slots as jderive
    from flexflow_tpu_torch.analysis import plan_memory_bytes as pplan
    from flexflow_tpu_torch.search import machine_model as pmm
    from flexflow_tpu_torch.serving.sched.kvpool import derive_num_slots

    jm, pm_, _, _ = lms
    jc, pc = _chips(jmm), _chips(pmm)
    for name in jc:
        for max_len, max_slots in ((64, 16), (24, 64), (64, 10**9)):
            got = derive_num_slots(pm_, max_len, machine=pc[name],
                                   max_slots=max_slots)
            assert got == jderive(jm, max_len, machine=jc[name],
                                  max_slots=max_slots), (name, max_len)
        jb = jplan(jm.graph, jc[name], jm.config, optimizer_state_factor=1.0)
        pb = pplan(pm_.graph, pc[name], pm_.config,
                   optimizer_state_factor=1.0)
        assert pb[0] == jb[0] and pb[2] == jb[2]
        assert pb[1].name == jb[1].name
    assert derive_num_slots(pm_, 64, machine=pc["tiny"]) == 1
    assert derive_num_slots(pm_, 64, machine=pc["big"], max_slots=10**9) \
        == jderive(jm, 64, machine=jc["big"], max_slots=10**9) > 64
    # no machine given: the config's (the CPU prices JAX's default chip;
    # JAX's own default reads config.num_devices, unset here)
    assert derive_num_slots(pm_, 24) == jderive(
        jm, 24, machine=jmm.make_machine_model(jm.config, 1))


@pytest.mark.parametrize("case", ["plain", "band", "draft", "oneshot"])
def test_batcher_derives_jax_slots_and_tokens(lms, case):
    """ContinuousBatcher(num_slots=None): JAX's slot count (the prefix
    band's slots carved out, a draft's caches scaled in) and JAX's greedy
    tokens."""
    from flexflow_tpu.search import machine_model as jmm
    from flexflow_tpu.serving.sched import ContinuousBatcher as JaxBatcher
    from flexflow_tpu_torch.search import machine_model as pmm
    from flexflow_tpu_torch.serving.sched import ContinuousBatcher

    jm, pm_, jd, pd = lms
    kw = dict(max_len=24, page_size=4, max_queue=8)
    if case == "plain":
        kw["prefix_cache_pages"] = 0
    elif case == "band":
        kw["prefix_cache_pages"] = 7
    elif case == "oneshot":
        kw["prefill_chunk_tokens"] = 0
    jkw, pkw = dict(kw), dict(kw)
    if case == "draft":
        jkw.update(draft_model=jd, spec_tokens=2)
        pkw.update(draft_model=pd, spec_tokens=2)
    rng = np.random.RandomState(15)
    prompts = [rng.randint(1, 50, size=(n,)).astype(np.int32)
               for n in (4, 9, 3, 7)]
    jmach, pmach = _chips(jmm)["mid"], _chips(pmm)["mid"]
    with JaxBatcher(jm, num_slots=None, machine=jmach, **jkw) as jcb:
        want = [r.result(timeout=300).tolist()
                for r in [jcb.submit(p, 6) for p in prompts]]
        want_slots = jcb.num_slots
    with ContinuousBatcher(pm_, num_slots=None, machine=pmach, **pkw) as cb:
        got = [r.result(timeout=300).tolist()
               for r in [cb.submit(p, 6) for p in prompts]]
        assert cb.num_slots == want_slots >= 1
    assert got == want
