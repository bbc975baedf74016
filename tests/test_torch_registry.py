"""The port's kernel registry on the CPU (flexflow_tpu_torch/kernels/
registry.py) against the JAX package's: the same `--kernel-impl`
spellings and errors, the same selection order (param > override >
config > auto), overrides that restore, the port's auto policy (the CPU
always takes the reference lowering; a Hopper card takes the kernel),
`FFConfig.parse_args`, and the counter, which counts resolutions."""
import numpy as np
import pytest
import torch

import flexflow_tpu_torch as pt
from flexflow_tpu.kernels.registry import KernelRegistry as JaxRegistry
from flexflow_tpu_torch.kernels.registry import (FAMILIES, KERNELS,
                                                 KernelRegistry,
                                                 flash_crossover)
from flexflow_tpu_torch.obs import REGISTRY
from flexflow_tpu_torch.runtime.losses import reduce_scalar

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _default_knob():
    """compile() and configure() set the process default; give it back."""
    yield
    KERNELS.configure(pt.FFConfig(device="cpu"))


def _counter():
    return REGISTRY.counter(
        "ff_kernel_selected_total",
        "Kernel-tier selections by op family and implementation",
        labels=("op", "impl"))


def _hopper(reg):
    """A registry whose backend gate sees a compute-capability 9.0 card."""
    reg._has_kernels = lambda device: True
    return reg


@pytest.mark.parametrize("spec", [
    "auto", "", "pallas", "reference", " pallas ",
    "attention=pallas,softmax=reference", "layernorm=auto",
    "rmsnorm=pallas, reduction=reference"])
def test_parse_spec_accepts_what_jax_accepts(spec):
    assert KernelRegistry.parse_spec(spec) == JaxRegistry.parse_spec(spec)


@pytest.mark.parametrize("bad", [
    "nope", "attention=fused", "zzz=pallas", "attention", "pallas,",
    "softmax=pallas,bogus"])
def test_parse_spec_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError, match="kernel-impl") as port:
        KernelRegistry.parse_spec(bad)
    with pytest.raises(ValueError, match="kernel-impl") as jax_:
        JaxRegistry.parse_spec(bad)
    assert str(port.value) == str(jax_.value)


def test_families_are_the_jax_families():
    from flexflow_tpu.kernels.registry import FAMILIES as JAX_FAMILIES

    assert FAMILIES == JAX_FAMILIES


def test_selection_order_param_override_config_auto():
    reg = _hopper(KernelRegistry())
    ref_cfg = pt.FFConfig(kernel_impl="reference")
    # auto on a Hopper card: the kernel, for every family
    for fam in FAMILIES:
        c = reg.select(fam, device="cuda", record=False)
        assert c and c.reason == "default"
    # config beats auto
    c = reg.select("softmax", config=ref_cfg, device="cuda", record=False)
    assert not c and c.reason == "config"
    # override beats config
    with reg.override("softmax", "pallas"):
        c = reg.select("softmax", config=ref_cfg, record=False)
        assert c and c.reason == "override"
        # param beats override
        c = reg.select("softmax", param=False, record=False)
        assert not c and c.reason == "param"
    assert reg.select("attention", param=True, config=ref_cfg,
                      record=False).reason == "param"
    with pytest.raises(KeyError):
        reg.select("not_a_family")


def test_auto_on_the_cpu_is_the_reference_lowering():
    reg = KernelRegistry()
    for fam in FAMILIES:
        c = reg.select(fam, device=torch.zeros(1).device, record=False)
        assert not c and c.reason == "backend"
    # without a device: the config's, else the CPU
    assert reg.select("layernorm", config=pt.FFConfig(device="cpu"),
                      record=False).reason == "backend"
    assert reg.select("layernorm", record=False).reason == "backend"


def test_heuristic_gates_auto_on_the_card_only():
    reg = _hopper(KernelRegistry())
    c = reg.select("attention", device="cuda", heuristic=lambda: False,
                   record=False)
    assert not c and c.reason == "heuristic"
    assert reg.select("attention", device="cuda", heuristic=lambda: True,
                      record=False).reason == "heuristic"
    # the crossover is 0 bytes until an H100 measurement sets it: every
    # attention op takes the flash kernel
    assert flash_crossover(1, 1, 1, 1)
    assert flash_crossover(8, 16, 512, 512)


def test_overrides_restore_on_exit_and_on_error():
    reg = KernelRegistry()
    with reg.override("layernorm", "pallas"):
        with reg.override("layernorm", "reference"):
            assert reg.select("layernorm", record=False).reason == "override"
            assert not reg.select("layernorm", record=False)
        assert reg.select("layernorm", record=False)
        with pytest.raises(RuntimeError):
            with reg.override("layernorm", "reference"):
                raise RuntimeError("boom")
        assert reg.select("layernorm", record=False)
    assert reg.select("layernorm", record=False).reason == "backend"
    with pytest.raises(ValueError, match="pallas or reference"):
        with reg.override("layernorm", "fused"):
            pass
    with pytest.raises(KeyError):
        with reg.override("nope", "pallas"):
            pass


def test_configure_sets_the_default_of_config_less_callers_only():
    reg = KernelRegistry()
    reg.configure(pt.FFConfig(kernel_impl="layernorm=pallas"))
    c = reg.select("layernorm", record=False)
    assert c and c.reason == "config"
    # a caller with its own config reads its own knob, not the default
    assert not reg.select("layernorm", config=pt.FFConfig(device="cpu"),
                          record=False)
    reg.configure(pt.FFConfig())
    assert not reg.select("layernorm", record=False)


def test_parse_args_takes_the_jax_spellings():
    cfg = pt.FFConfig()
    cfg.parse_args(["--kernel-impl", "layernorm=pallas", "-b", "16",
                    "--epochs", "3", "--learning-rate", "0.5",
                    "--flash-block-q", "64", "--flash-block-k", "32"])
    assert (cfg.kernel_impl, cfg.batch_size, cfg.epochs, cfg.learning_rate,
            cfg.flash_block_q, cfg.flash_block_k) == (
        "layernorm=pallas", 16, 3, 0.5, 64, 32)
    cfg.parse_args(["--lr", "0.25", "--batch-size", "2", "-e", "1"])
    assert (cfg.learning_rate, cfg.batch_size, cfg.epochs) == (0.25, 2, 1)
    with pytest.raises(ValueError, match="kernel-impl"):
        pt.FFConfig().parse_args(["--kernel-impl", "bogus"])
    with pytest.raises(ValueError, match="'--budget'"):
        pt.FFConfig().parse_args(["--budget", "10"])
    with pytest.raises(ValueError, match="requires a value"):
        pt.FFConfig().parse_args(["--kernel-impl"])
    # the JAX package's FFConfig reads the same line the same way
    import flexflow_tpu as ff

    jcfg = ff.FFConfig()
    jcfg.parse_args(["--kernel-impl", "layernorm=pallas", "-b", "16"])
    assert (jcfg.kernel_impl, jcfg.batch_size) == ("layernorm=pallas", 16)


def test_counter_counts_resolutions_not_calls():
    fam = _counter()
    reg = KernelRegistry()
    memo = {}
    before = fam.value(op="rmsnorm", impl="reference")
    for _ in range(5):
        assert not reg.resolve(memo, "rmsnorm", device=CPU)
    assert fam.value(op="rmsnorm", impl="reference") == before + 1
    # an override moves the generation: one more resolution inside, one
    # after it is gone
    before_p = fam.value(op="rmsnorm", impl="pallas")
    with reg.override("rmsnorm", "pallas"):
        for _ in range(3):
            assert reg.resolve(memo, "rmsnorm", device=CPU)
    assert not reg.resolve(memo, "rmsnorm", device=CPU)
    assert fam.value(op="rmsnorm", impl="pallas") == before_p + 1
    assert fam.value(op="rmsnorm", impl="reference") == before + 2
    # a change of the caller's knob resolves again, so does configure()
    cfg = pt.FFConfig(device="cpu")
    reg.resolve(memo, "rmsnorm", device=CPU, config=cfg)
    n = fam.value(op="rmsnorm", impl="reference")
    cfg.kernel_impl = "rmsnorm=pallas"
    assert reg.resolve(memo, "rmsnorm", device=CPU, config=cfg)
    reg.configure(pt.FFConfig())
    assert reg.resolve(memo, "rmsnorm", device=CPU, config=cfg).reason \
        == "config"
    assert fam.value(op="rmsnorm", impl="pallas") == before_p + 3
    assert fam.value(op="rmsnorm", impl="reference") == n
    # record=False peeks never count
    reg.select("rmsnorm", record=False)
    assert fam.value(op="rmsnorm", impl="reference") == n


def test_ops_resolve_once_per_registry_generation():
    """A fit of three steps resolves each op's family once, not per step;
    an override makes the next step resolve again."""
    fam = _counter()
    m = pt.FFModel(pt.FFConfig(batch_size=2, device="cpu"))
    x = m.create_tensor([2, 3, 8])
    t = m.layer_norm(x, [-1])
    t = m.rms_norm(t, [-1])
    m.softmax(m.dense(t, 4))
    m.compile(metrics=[pt.MetricsType.METRICS_ACCURACY])
    rng = np.random.RandomState(0)
    data = rng.randn(6, 3, 8).astype(np.float32)
    labels = rng.randint(0, 4, size=(6, 3, 1)).astype(np.int32)

    def counts():
        return {f: fam.value(op=f, impl="reference")
                for f in ("layernorm", "rmsnorm", "softmax", "reduction")}

    before = counts()
    m.fit(data, labels, batch_size=2, epochs=1)
    after = counts()
    # the reduction family resolves once for the loss and the accuracy
    # together (one device, one cached choice) unless another model's
    # compile moved the generation in between
    assert {f: after[f] - before[f] for f in after} == {
        "layernorm": 1, "rmsnorm": 1, "softmax": 1, "reduction": 1}
    with KERNELS.override("rmsnorm", "pallas"):
        m.fit(data, labels, batch_size=2, epochs=1)
    assert fam.value(op="rmsnorm", impl="reference") == after["rmsnorm"]


def test_reduce_scalar_reads_the_configured_default():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    fam = _counter()
    before = fam.value(op="reduction", impl="pallas")
    assert float(reduce_scalar(x)) == pytest.approx(2.5)
    KERNELS.configure(pt.FFConfig(kernel_impl="reduction=pallas"))
    assert float(reduce_scalar(x, "sum")) == 15.0
    assert float(reduce_scalar(x, "mean")) == pytest.approx(2.5)
    assert fam.value(op="reduction", impl="pallas") == before + 1
    with pytest.raises(ValueError, match="unknown reduction"):
        reduce_scalar(x, "max")
