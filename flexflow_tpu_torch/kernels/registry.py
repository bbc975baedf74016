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
    - residual evidence: JAX reads the fitted profile's per-family
      residuals and thresholds; not ported (ROADMAP A7/A9), so none is
      consulted.
    - heuristic (attention): the same `flash_crossover`; its crossover
      is 0 bytes here, not JAX's 1e8 (a v5e measurement), until an H100
      measurement sets it.
    - no-evidence default: JAX takes the reference lowering; the port
      takes the kernel, for every family.

    The last step is deliberate. The TPU's reference default rests on TPU
    measurements (XLA fuses the unfused norms well there), which are no
    target for the port. The JAX reduction family is knob-only because
    its pallas_call has no GSPMD partitioning rule, a reason that does
    not exist on one device (revisit with ROADMAP A8). And the card's
    main path runs the kernels: the plain versions never run there.

`cost_factor` and `PALLAS_COST_GAIN` belong to the cost model (A7).

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

from ..obs.registry import REGISTRY

FAMILIES = ("attention", "attention_decode", "attention_decode_mq",
            "layernorm", "rmsnorm", "softmax", "reduction")
# the port's own families: kernels with no Pallas counterpart, so no
# family of the JAX registry and no word of its `family=impl` spellings;
# the bare `pallas` / `reference` knobs and overrides reach them. The
# optimizer update (kernels/optimizer.py) is the card's counterpart of
# XLA's fusion of the JAX update: "reference" runs its per-tensor loop
PORT_FAMILIES = ("optimizer",)

# per-device f32 score-matrix bytes above which auto picks the flash
# kernel over the einsum core; 0 (always flash) until an H100
# measurement sets it
FLASH_SCORE_BYTES_CROSSOVER = 0.0

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
    reason: str  # param | override | config | backend | heuristic | default

    def __bool__(self) -> bool:
        return self.impl == "pallas"


class KernelRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._config_overrides: Dict[str, str] = {}
        self._overrides: Dict[str, str] = {}
        self._spec_cache: Dict[str, Dict[str, str]] = {}
        self._capability: Dict[int, tuple] = {}
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

    def configure(self, config) -> None:
        """Adopt a model config's `--kernel-impl` knob as the process
        default, which only the config-less consumers (the loss and
        metric reductions) read. Called by FFModel.compile()."""
        with self._lock:
            self._config_overrides = self._spec_overrides(
                getattr(config, "kernel_impl", "auto"))
            self.generation += 1

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
        return REGISTRY.counter(
            "ff_kernel_selected_total",
            "Kernel-tier selections by op family and implementation",
            labels=("op", "impl"))

    def _has_kernels(self, device) -> bool:
        """The backend gate: a CUDA device of compute capability >= 9.0."""
        device = torch.device(device)
        if device.type != "cuda":
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
        elif heuristic is not None:
            choice = KernelChoice(
                family, "pallas" if heuristic() else "reference",
                "heuristic")
        else:
            choice = KernelChoice(family, "pallas", "default")
        if record:
            self._counter().inc(op=family, impl=choice.impl)
        return choice

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
