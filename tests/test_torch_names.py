"""The package-level names of the port (flexflow_tpu_torch/__init__.py,
obs/, parallel/, serving/sched/) against the JAX package's: every name
JAX exports resolves in the port, and the ones that compute something
(MachineView's addressing and hash, MachineResource, FFIterationConfig,
FFConfig.workers_per_node and get_current_time, the enums, obs.reset_all)
agree with JAX's on the same inputs. `obs.merge_timeline` comes with
obs/timeline.py (ROADMAP A11 item 2)."""
import time

import pytest

import flexflow_tpu as jff
import flexflow_tpu.obs as jobs
import flexflow_tpu.parallel as jpar
import flexflow_tpu.serving.sched as jsched
import flexflow_tpu_torch as pff
import flexflow_tpu_torch.obs as pobs
import flexflow_tpu_torch.parallel as ppar
import flexflow_tpu_torch.serving.sched as psched
from flexflow_tpu import ffconst as jconst
from flexflow_tpu_torch import ffconst as pconst

LATER = {"merge_timeline"}


@pytest.mark.parametrize("jmod, pmod", [
    (jff, pff), (jobs, pobs), (jpar, ppar), (jsched, psched)],
    ids=["package", "obs", "parallel", "serving.sched"])
def test_every_jax_export_resolves(jmod, pmod):
    missing = [n for n in jmod.__all__
               if n not in LATER and not hasattr(pmod, n)]
    assert missing == []
    assert set(jmod.__all__) - LATER <= set(pmod.__all__)


def test_package_modules_and_classes():
    assert pff.ops.__name__ == "flexflow_tpu_torch.ops"
    assert pff.parallel is ppar
    for name in jpar.__all__:
        assert getattr(ppar, name).__name__ == name
    assert pobs.get_registry() is pobs.REGISTRY
    assert psched.derive_num_slots.__module__.endswith("kvpool")


@pytest.mark.parametrize("axes, start", [
    ((), 0), ((("data", 4),), 0), ((("data", 2), ("model", 4)), 8),
    ((("data", 2), ("model", 2), ("seq", 2)), 3)])
def test_machine_view_matches_jax(axes, start):
    jv = jff.MachineView(axes, start)
    pv = pff.MachineView(axes, start)
    assert pv.ndims == jv.ndims
    assert pv.num_devices == jv.num_devices
    assert pv.device_ids() == jv.device_ids()
    assert pv.hash() == jv.hash()
    assert str(pv) == str(jv)
    jw, pw = jv.with_axis("expert", 2), pv.with_axis("expert", 2)
    assert pw.axes == jw.axes and pw.hash() == jw.hash()
    assert pw.device_ids() == jw.device_ids()


def test_machine_resource_and_iteration_config():
    for kw in ({}, {"num_nodes": 2, "devices_per_node": 4,
                    "start_device_id": 1}):
        assert pff.MachineResource(**kw).num_devices == \
            jff.MachineResource(**kw).num_devices
    pi, ji = pff.FFIterationConfig(), jff.FFIterationConfig()
    assert pi == pff.FFIterationConfig(seq_length=-1)
    pi.seq_length = ji.seq_length = 7
    pi.reset()
    ji.reset()
    assert pi.seq_length == ji.seq_length == -1


@pytest.mark.parametrize("devices", [8, 4, 3, 1])
def test_workers_per_node_and_clock(devices):
    """One host: every device is a worker of it, as JAX's one node."""
    pc = pff.FFConfig(device="cpu", num_devices=devices)
    jc = jff.FFConfig()
    jc.num_devices = devices
    assert jc.num_nodes == 1
    assert pc.workers_per_node == jc.workers_per_node == devices
    t0 = jc.get_current_time()
    t = pc.get_current_time()
    assert t0 <= t <= time.time() * 1e6


def test_enums_match_jax():
    for name in ("ParameterSyncType", "ParallelDimKind"):
        assert [(m.name, m.value) for m in getattr(pconst, name)] == \
            [(m.name, m.value) for m in getattr(jconst, name)]
    assert pff.ParameterSyncType is pconst.ParameterSyncType


def test_obs_reset_all_zeroes_registry_and_tracer():
    c = pobs.REGISTRY.counter("ff_names_test_total", "names test")
    c.inc(3)
    tr = pobs.enable_tracing()
    with pobs.span("names.test"):
        pass
    assert c.value() == 3 and tr.span_names()
    pobs.reset_all()
    assert c.value() == 0
    assert not tr.enabled and tr.span_names() == []
