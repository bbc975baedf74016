"""KernelRegistry: one selection path for the port's kernel tier
(counterpart of flexflow_tpu/kernels/registry.py).

Each op family has a fused implementation, the hand-written CUDA kernel
of kernels/ (its plain PyTorch version on a CPU tensor), and a reference
lowering, the op's own torch code (ops/norm.py, ops/attention.py, the
plain reductions of runtime/losses.py, the optimizer's per-tensor loop
of kernels/optimizer.py). Every consumer asks the same
`KERNELS.select(family)`. The words of `--kernel-impl` stay the JAX
package's, so command lines carry over: `pallas` names the fused-kernel
tier, `reference` the reference lowering.

Selection order (first match wins), as in the JAX package:

 1. the op's own param (`use_flash=True/False` on the attention op);
 2. a test override, `KERNELS.override(family, impl)`;
 3. the config knob `--kernel-impl` (`pallas`/`reference` for every
    family, or `family=impl,...`). Ops pass their model's config
    (`select(config=ctx.config)`), so two models with different knobs in
    one process never mix; the config-less loss and metric reductions
    read the last `configure()`d default;
 4. auto, which differs from the JAX package step by step:
    - backend gate: JAX asks `jax.default_backend() == "tpu"`; the port
      asks that the op's device be CUDA with compute capability >= 9.0.
      Anything else, the CPU always, takes the reference lowering.
    - residual evidence, as in JAX: the fitted profile's
      (`config.fitted_profile_file`, obs/refit.py) per-family residuals
      (measured / predicted, `obs.calibrate`) against the profile's
      fitted threshold, else `config.kernel_residual_threshold`, else
      RESIDUAL_CANDIDATE_THRESHOLD; a family at or past it takes the
      kernel ("residual"), the heuristic still gating attention.
      `attention_decode*` read the `attention` family's residual. In the
      port this step cannot change a choice, only its reason: what it
      nominates is the kernel, which the heuristic or the port's
      no-evidence default picks all the same. It stays for JAX's
      reasons and for the day auto's default becomes the reference
      lowering (ROADMAP A7.3); `cost_factor` reads the impl alone.
    - heuristic (attention): the same `flash_crossover`; its crossover
      is the port's own (FLASH_SCORE_BYTES_CROSSOVER), not JAX's 1e8 (a
      v5e measurement).
    - no-evidence default: JAX takes the reference lowering; the port
      takes the kernel, for every family.

    The last step is deliberate. The TPU's reference default rests on TPU
    measurements (XLA fuses the unfused norms well there), which are no
    target for the port. The JAX reduction family is knob-only because
    its pallas_call has no GSPMD partitioning rule, a reason that does
    not exist on one device (revisit with ROADMAP A8). And the card's
    main path runs the kernels: the plain versions never run there.

`cost_factor` prices a family for the cost model (search/simulator.py
CostModel): PALLAS_COST_GAIN[family] where the kernel would be selected,
1.0 where the reference lowering would; it never counts.

The port runs eagerly, so an op does not select on every call: it
resolves its choice once through `resolve()`, which caches it in a memo
the caller owns, and resolves again only after `configure()` or an
override moved the registry's generation, or the config's knob, or the
device changed. `ff_kernel_selected_total{op,impl}` counts resolutions,
as the JAX package counts traces.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, Optional

import torch

from ..ffconst import OpType

FAMILIES = ("attention", "attention_decode", "attention_decode_mq",
            "layernorm", "rmsnorm", "softmax", "reduction")
# the port's own families: kernels with no Pallas counterpart, so no
# family of the JAX registry and no word of its `family=impl` spellings;
# the bare `pallas` / `reference` knobs and overrides reach them. The
# optimizer update (kernels/optimizer.py) is the card's counterpart of
# XLA's fusion of the JAX update: "reference" runs its per-tensor loop
PORT_FAMILIES = ("optimizer",)

# graph-op families the cost simulator can price (serving decode and the
# loss reduction never appear as graph ops)
OPTYPE_FAMILY = {
    OpType.MULTIHEAD_ATTENTION: "attention",
    OpType.LAYERNORM: "layernorm",
    OpType.RMSNORM: "rmsnorm",
    OpType.SOFTMAX: "softmax",
}

# families whose residual evidence comes from another family's rows (the
# decode steps are the attention core over the KV cache)
RESIDUAL_ALIAS = {"attention_decode": "attention",
                  "attention_decode_mq": "attention"}

# per-device f32 score-matrix bytes above which auto picks the flash
# kernel over the einsum core. 0: flash at every shape, as the H100 sweep
# measured it (chip_smoke.py phase 33: OpCostCache's times of the
# attention op with use_flash True and False, b 1 and 8, 16 heads of 64,
# l 16-512, bf16, the median of 5 rounds). Its rule, the largest score
# bytes under which the einsum core's forward + backward wins at every
# smaller shape, gave 0: flash won the smallest shape, and 11 of the 12
# (the 12th, b 8 l 16, within the rounds' spread). The forward alone is
# bound by the host's launches there and went either way at scattered
# shapes (PERF.md section 6)
FLASH_SCORE_BYTES_CROSSOVER = 0.0

# the JAX package's modeled step-time factor of the fused impl against
# the unfused lowering, which CostModel applies where the registry selects
# the kernel (and the lowering would emit it); refit's step_scale absorbs
# what these get wrong, uniformly
PALLAS_COST_GAIN = {
    "attention": 0.89,
    "attention_decode": 0.80,
    "attention_decode_mq": 0.75,
    "layernorm": 0.70,
    "rmsnorm": 0.70,
    "softmax": 0.75,
    "reduction": 0.85,
}

# the residual (measured / predicted) at which a family is a fusion
# candidate when neither the profile nor the config names a threshold
RESIDUAL_CANDIDATE_THRESHOLD = 1.10

# first compute capability the kernels are built for (sm_90a)
KERNEL_CAPABILITY = (9, 0)


def flash_crossover(batch: int, heads: int, q_len: int, k_len: int,
                    dp: int = 1) -> bool:
    score_bytes = (4.0 * batch * heads * q_len * k_len) / max(dp, 1)
    return score_bytes > FLASH_SCORE_BYTES_CROSSOVER


@dataclasses.dataclass(frozen=True)
class KernelChoice:
    """One selection verdict; truthy iff the kernel tier was chosen."""

    family: str
    impl: str    # "pallas" | "reference"
    reason: str  # param | override | config | backend | residual |
    #              heuristic | default

    def __bool__(self) -> bool:
        return self.impl == "pallas"


class KernelRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._config_overrides: Dict[str, str] = {}
        self._overrides: Dict[str, str] = {}
        self._spec_cache: Dict[str, Dict[str, str]] = {}
        self._capability: Dict[int, tuple] = {}
        # the configure()d profile's evidence: per-family residuals and
        # fitted thresholds (obs/refit.py FittedProfile)
        self._residuals: Dict[str, float] = {}
        self._threshold: float = RESIDUAL_CANDIDATE_THRESHOLD
        self._fitted_thresholds: Dict[str, float] = {}
        self.residual_source: Optional[str] = None
        # (path, mtime, size, backend) -> (residuals, fitted thresholds)
        self._residual_cache: Dict[tuple, tuple] = {}
        # bumped by configure() and by entering or leaving an override:
        # a choice resolved under an older generation is stale
        self.generation = 0

    # -- configuration -----------------------------------------------------
    @staticmethod
    def parse_spec(spec: str) -> Dict[str, str]:
        """`--kernel-impl` value -> per-family override map. Accepts
        `auto` (empty map), a bare `pallas`/`reference` (every family),
        or `family=impl[,family=impl...]` (impl `auto` clears one
        family)."""
        spec = (spec or "auto").strip()
        if spec == "auto":
            return {}
        if spec in ("pallas", "reference"):
            return {f: spec for f in FAMILIES}
        out: Dict[str, str] = {}
        for part in spec.split(","):
            fam, sep, impl = part.partition("=")
            fam, impl = fam.strip(), impl.strip()
            if (not sep or fam not in FAMILIES
                    or impl not in ("pallas", "reference", "auto")):
                raise ValueError(
                    f"bad --kernel-impl term {part!r}: want auto, pallas, "
                    "reference, or family=impl[,...] with families "
                    f"{FAMILIES}")
            if impl != "auto":
                out[fam] = impl
        return out

    def _spec_overrides(self, spec: str) -> Dict[str, str]:
        spec = (spec or "auto").strip()
        hit = self._spec_cache.get(spec)
        if hit is None:
            hit = self.parse_spec(spec)
            if spec in ("pallas", "reference"):
                hit = {**hit, **{f: spec for f in PORT_FAMILIES}}
            self._spec_cache[spec] = hit
        return hit

    def _profile_evidence(self, config) -> tuple:
        """(residuals, fitted thresholds) of `config`'s fitted profile,
        both {} when there is none or it does not load (JAX
        `_profile_evidence`; the machine model's load raises, the
        registry declines the evidence). Cached by the file's identity,
        so a refit that rewrites the file is read again."""
        path = getattr(config, "fitted_profile_file", None)
        if not path:
            return {}, {}
        import os

        from ..search.machine_model import config_backend

        backend = config_backend(config)
        try:
            st = os.stat(path)
            key = (path, st.st_mtime_ns, st.st_size, backend)
        except OSError:
            key = (path, -1, -1, backend)
        hit = self._residual_cache.get(key)
        if hit is not None:
            return hit
        from ..obs.refit import FittedProfile, FittedProfileError

        try:
            prof = FittedProfile.load(path, expect_backend=backend)
            out = ({k: float(v)
                    for k, v in (prof.op_family_residuals or {}).items()},
                   {k: float(v) for k, v in
                    (prof.kernel_residual_thresholds or {}).items()})
        except FittedProfileError:
            out = ({}, {})
        self._residual_cache[key] = out
        return out

    def configure(self, config) -> None:
        """Adopt a model config's `--kernel-impl` knob and its fitted
        profile's residual evidence as the process default, which only
        the config-less consumers (the loss and metric reductions) read.
        Called by FFModel.compile()."""
        with self._lock:
            self._config_overrides = self._spec_overrides(
                getattr(config, "kernel_impl", "auto"))
            self._threshold = float(getattr(
                config, "kernel_residual_threshold",
                RESIDUAL_CANDIDATE_THRESHOLD))
            self._residuals, self._fitted_thresholds = \
                self._profile_evidence(config)
            self.residual_source = (getattr(config, "fitted_profile_file",
                                            None)
                                    if self._residuals else None)
            self.generation += 1

    def residual(self, family: str) -> Optional[float]:
        return self._residuals.get(family)

    @contextlib.contextmanager
    def override(self, family: str, impl: str):
        """Force one family's impl for the duration; restores on exit."""
        if family not in FAMILIES + PORT_FAMILIES:
            raise KeyError(f"unknown kernel family {family!r}; "
                           f"families: {FAMILIES + PORT_FAMILIES}")
        if impl not in ("pallas", "reference"):
            raise ValueError(f"impl must be pallas or reference, got {impl!r}")
        with self._lock:
            prev = self._overrides.get(family)
            self._overrides[family] = impl
            self.generation += 1
        try:
            yield
        finally:
            with self._lock:
                if prev is None:
                    self._overrides.pop(family, None)
                else:
                    self._overrides[family] = prev
                self.generation += 1

    # -- selection ---------------------------------------------------------
    @staticmethod
    def _counter():
        # imported here: obs/ imports this module (obs/calibration.py)
        from ..obs.registry import REGISTRY

        return REGISTRY.counter(
            "ff_kernel_selected_total",
            "Kernel-tier selections by op family and implementation",
            labels=("op", "impl"))

    def _has_kernels(self, device) -> bool:
        """The backend gate: a CUDA device of compute capability >= 9.0."""
        device = torch.device(device)
        if device.type != "cuda" or not torch.cuda.is_available():
            return False
        idx = device.index if device.index is not None \
            else torch.cuda.current_device()
        cap = self._capability.get(idx)
        if cap is None:
            cap = self._capability[idx] = \
                torch.cuda.get_device_capability(idx)
        return cap >= KERNEL_CAPABILITY

    def select(self, family: str, *, param: Optional[bool] = None,
               config=None, device=None,
               heuristic: Optional[Callable[[], bool]] = None,
               record: bool = True) -> KernelChoice:
        """Pick the impl for one op instance. `param` is the op's own
        setting (attention's use_flash); `config` the model's FFConfig
        when the caller has one (its knob wins over the configure()d
        default); `device` where the op runs (default: the config's
        device, else the CPU); `heuristic` a zero-argument size policy
        consulted by auto on a kernel-capable device; `record=False`
        skips the counter."""
        if family not in FAMILIES + PORT_FAMILIES:
            raise KeyError(f"unknown kernel family {family!r}; "
                           f"families: {FAMILIES + PORT_FAMILIES}")
        config_overrides = (self._spec_overrides(
            getattr(config, "kernel_impl", "auto"))
            if config is not None else self._config_overrides)
        if device is None:
            device = getattr(config, "device", None) or "cpu"
        if param is not None:
            choice = KernelChoice(
                family, "pallas" if param else "reference", "param")
        elif family in self._overrides:
            choice = KernelChoice(family, self._overrides[family], "override")
        elif family in config_overrides:
            choice = KernelChoice(family, config_overrides[family], "config")
        elif not self._has_kernels(device):
            choice = KernelChoice(family, "reference", "backend")
        elif self._residual_nominates(family, config, heuristic):
            choice = KernelChoice(family, "pallas", "residual")
        elif heuristic is not None:
            choice = KernelChoice(
                family, "pallas" if heuristic() else "reference",
                "heuristic")
        else:
            choice = KernelChoice(family, "pallas", "default")
        if record:
            self._counter().inc(op=family, impl=choice.impl)
        return choice

    def _residual_nominates(self, family: str, config, heuristic) -> bool:
        """JAX's residual step: the evidence family's residual at or past
        its threshold (the profile's fitted one, else the config's knob,
        else the default), with the size heuristic still a gate. True
        only where the steps after it would pick the kernel too, so it
        sets the reason alone (module docstring)."""
        if config is not None:
            residuals, fitted = self._profile_evidence(config)
            knob = float(getattr(config, "kernel_residual_threshold",
                                 self._threshold))
        else:
            residuals, fitted = self._residuals, self._fitted_thresholds
            knob = self._threshold
        evidence_fam = RESIDUAL_ALIAS.get(family, family)
        threshold = fitted.get(family, fitted.get(evidence_fam))
        if threshold is None:
            threshold = knob
        r = residuals.get(evidence_fam)
        return (r is not None and r >= threshold
                and (heuristic is None or heuristic()))

    def cost_factor(self, family: Optional[str], *, param=None,
                    config=None, heuristic=None) -> float:
        """Step-time factor the simulator applies to an op of `family`:
        1.0 for the reference lowering (or a non-tier op),
        PALLAS_COST_GAIN[family] where the kernel would be selected (on
        the config's device). Never counts."""
        if family is None:
            return 1.0
        choice = self.select(family, param=param, config=config,
                             heuristic=heuristic, record=False)
        return PALLAS_COST_GAIN[family] if choice else 1.0

    def resolve(self, memo: dict, family: str, *, device, param=None,
                config=None, heuristic=None) -> KernelChoice:
        """select() once, then the cached choice from `memo` (a dict the
        caller owns) until the registry's generation, the config's knob or
        the device changes. Only a resolution counts."""
        spec = None if config is None else getattr(config, "kernel_impl",
                                                   "auto")
        key = (family, device)
        hit = memo.get(key)
        if hit is not None and hit[0] == self.generation and hit[1] == spec:
            return hit[2]
        gen = self.generation
        choice = self.select(family, param=param, config=config,
                             device=device, heuristic=heuristic)
        memo[key] = (gen, spec, choice)
        return choice


# THE process-wide registry: FFModel.compile() configures it from its
# FFConfig, every consumer selects through it
KERNELS = KernelRegistry()
