"""Model repository: directory-of-models loading for the inference server
(counterpart of flexflow_tpu/serving/repository.py, ROADMAP A5.10c).

A directory per model with a config file and the model artifact; the
server scans it, loads every model, and serves them by name. Entries are
built on `ModelRepository(path, device=...)`'s device, the card unless
the caller asks for the CPU. A repository is:

    repo/
      <model_name>/
        config.json          required
        model.onnx | model_spec.json   (per config["format"])
        weights.npz                    optional checkpoint

config.json fields:
  format         "onnx" (ONNX graph via the onnx importer, onnx/) or
                 "ff_cspec" (a model spec exported by the C API's
                 ffc_model_export_json)
  file           artifact filename inside the model dir
  inputs         [{"dims": [...], "dtype": "float32"|"int32"}, ...]
                 (onnx only: the importer needs built input tensors;
                 dims include the serving max batch)
  mixed_precision  optional (onnx only), default true: bf16 activations;
                 false serves in exact f32
  checkpoint     optional checkpoint file (runtime/checkpoint.py, the
                 format both packages write) restored after build
  max_batch_size optional; defaults to the batch the model was built for
  batch_buckets  optional; defaults to (1, 4, 16, ...) clamped to
                 max_batch_size — requests never pad past the built batch
  max_delay_ms   optional batching delay, default 2.0
  serving        optional {"mode": "fleet", ...}: register the entry as
                 a serving FLEET (serving/fleet/) instead of a
                 DynamicBatcher — N continuous-batching replicas of the
                 (generative) model behind a prefix-affine Router. Keys:
                 replicas (default 2), max_len (required), num_slots /
                 page_size / prefill_chunk_tokens / prefix_cache_pages /
                 max_queue (per-replica batcher knobs), policy
                 (default "affine"), slo_ttft_ms (optional SLO shed
                 budget), speculative (optional {"draft":
                 "<model entry name>", "tokens": k}: the named entry is
                 BUILT as the draft model (never registered by this
                 entry) and every replica's batcher proposes k
                 draft tokens per slot per iteration, verified by the
                 target in one fused multi-query dispatch; greedy output
                 stays token-identical).
                 A replica that fails to construct is recorded
                 (ff_model_load_failures_total under "<name>/<replica>",
                 /healthz degraded) while the rest keep serving.
                 {"mode": "disagg", ...} instead builds a DISAGGREGATED
                 fleet: prefill_replicas /
                 decode_replicas phase-specialized pools bridged by the
                 DisaggCoordinator's priced KV-handoff plane, with
                 machine_spec (path or inline dict) pricing each
                 shipment and handoff_wait_s bounding export/import
                 ticket waits. Same batcher knobs; policy defaults to
                 "least_loaded"; speculative is rejected (a prefill
                 replica never decodes).
"""
from __future__ import annotations

import json
import os
import sys
from typing import List, Optional

from ..config import FFConfig
from ..ffconst import DataType, LossType
from ..model import FFModel
from ..native.c_model import model_from_spec
from ..onnx.model import ONNXModel
from ..runtime.checkpoint import restore_checkpoint
from ..runtime.optimizers import SGDOptimizer
from ..search.machine_model import HierarchicalMachineModel, load_machine_spec
from .fleet import DisaggCoordinator, Replica, Router


_DTYPES = {"float32": "DT_FLOAT", "float": "DT_FLOAT", "int32": "DT_INT32",
           "int64": "DT_INT64", "int": "DT_INT32"}


def _build_onnx(model_dir: str, cfg: dict, device: str):
    config = FFConfig(device=device)
    inputs_spec = cfg.get("inputs")
    if not inputs_spec:
        raise ValueError(f"{model_dir}: onnx models need config 'inputs'")
    config.batch_size = int(inputs_spec[0]["dims"][0])
    # bf16 activations by default; a repository entry can pin exact f32
    # serving with "mixed_precision": false
    config.allow_mixed_precision = bool(cfg.get("mixed_precision", True))
    model = FFModel(config)
    tensors = []
    for spec in inputs_spec:
        dt = getattr(DataType,
                     _DTYPES.get(str(spec.get("dtype", "float32")).lower(),
                                 "DT_FLOAT"))
        tensors.append(model.create_tensor(list(spec["dims"]), dt))
    onnx_model = ONNXModel(os.path.join(model_dir, cfg["file"]))
    outs = onnx_model.apply(model, tensors)
    model.final_tensor = outs[-1] if isinstance(outs, (list, tuple)) else outs
    model.compile(optimizer=SGDOptimizer(model, lr=0.0),
                  loss_type=LossType.LOSS_IDENTITY)
    onnx_model.transfer_weights(model)  # warns on any shortfall
    return model


def _build_cspec(model_dir: str, cfg: dict, device: str):
    model = model_from_spec(os.path.join(model_dir, cfg["file"]),
                            config=FFConfig(device=device))
    model.compile(optimizer=SGDOptimizer(model, lr=0.0),
                  loss_type=LossType.LOSS_IDENTITY)
    return model


_BUILDERS = {"onnx": _build_onnx, "ff_cspec": _build_cspec}


class ModelRepository:
    """Scans a repository directory and loads/unloads models on a server."""

    def __init__(self, path: str, device: str = "cuda"):
        if not os.path.isdir(path):
            raise FileNotFoundError(f"model repository {path!r} not found")
        self.path = path
        self.device = device

    def model_names(self) -> List[str]:
        return sorted(
            d for d in os.listdir(self.path)
            if os.path.isfile(os.path.join(self.path, d, "config.json"))
        )

    def config(self, name: str) -> dict:
        with open(os.path.join(self.path, name, "config.json")) as f:
            return json.load(f)

    def build(self, name: str, cfg: Optional[dict] = None):
        """Build + compile (+ restore checkpoint) one model by name."""
        model_dir = os.path.join(self.path, name)
        if cfg is None:
            cfg = self.config(name)
        fmt = cfg.get("format")
        if fmt not in _BUILDERS:
            raise ValueError(
                f"{name}: unknown format {fmt!r} (have {sorted(_BUILDERS)})")
        model = _BUILDERS[fmt](model_dir, cfg, self.device)
        ckpt = cfg.get("checkpoint")
        if ckpt:
            restore_checkpoint(os.path.join(model_dir, ckpt), model)
        return model

    def load(self, server, names: Optional[List[str]] = None,
             strict: bool = False) -> List[str]:
        """Build and register models (all by default) on an InferenceServer.
        Returns the loaded names.

        One model's bad entry (missing artifact, torn/corrupt/foreign
        checkpoint, unknown format...) must not abort loading every OTHER
        model: failures are caught per model, logged to stderr, recorded
        on the server (surfaced in stats() under "_load_failures" and on
        /metrics as ff_model_load_failures_total), and the scan continues.
        strict=True restores raise-on-first-failure for callers that want
        a repository to be all-or-nothing."""
        loaded = []
        for name in names if names is not None else self.model_names():
            # the WHOLE per-model pipeline is isolated — a malformed
            # batching field (e.g. a non-numeric max_batch_size) must not
            # abort the scan any more than a corrupt checkpoint does
            try:
                cfg = self.config(name)
                model = self.build(name, cfg)
                serving = cfg.get("serving") or {}
                if serving.get("mode") == "disagg":
                    self._register_disagg(
                        server, name, model, serving,
                        model_dir=os.path.join(self.path, name))
                    loaded.append(name)
                    continue
                if serving.get("mode") == "fleet":
                    # speculative decoding: the draft is its OWN model
                    # entry (built, never registered here) scoring
                    # alongside the target in every replica's batcher.
                    # A broken draft entry fails THIS model's load —
                    # silently serving non-speculative would mask a
                    # config error
                    draft = None
                    spec = serving.get("speculative") or {}
                    if spec:
                        if "draft" not in spec:
                            raise ValueError(
                                f"{name}: serving.speculative needs"
                                " 'draft' (the draft model's repository"
                                " entry name)")
                        draft = self.build(str(spec["draft"]))
                    self._register_fleet(server, name, model, serving,
                                         draft)
                    loaded.append(name)
                    continue
                # batching defaults derive from the batch the model was
                # BUILT for — padding a request to a bucket larger than
                # the declared batch would run the executor at a shape the
                # graph never had
                built_batch = int(model.config.batch_size)
                # an explicit max_batch_size is clamped too: the executor
                # runs the graph at the shapes it was built for
                max_bs = min(int(cfg.get("max_batch_size", built_batch)),
                             built_batch)
                buckets = cfg.get("batch_buckets")
                if buckets is None:
                    buckets = [b for b in (1, 4, 16, 64)
                               if b < max_bs] + [max_bs]
                buckets = [min(int(b), max_bs) for b in buckets]
                server.register(
                    name,
                    model,
                    max_batch_size=max_bs,
                    max_delay_ms=float(cfg.get("max_delay_ms", 2.0)),
                    batch_buckets=tuple(buckets),
                )
            except Exception as exc:
                if strict:
                    raise
                print(f"[repository] failed to load model {name!r}: "
                      f"{type(exc).__name__}: {exc}", file=sys.stderr)
                record = getattr(server, "record_load_failure", None)
                if record is not None:
                    record(name, exc)
                continue
            loaded.append(name)
        return loaded

    @staticmethod
    def _register_fleet(server, name: str, model, serving: dict,
                        draft=None) -> None:
        """Build a serving fleet from one repository entry: N replicas of
        the built (generative) model behind a prefix-affine Router,
        registered through server.register_fleet so /metrics merges the
        per-replica registries and /healthz aggregates replica health.
        Replicas share the one built model: each carries its own KV
        pool, prefix cache, and registry (fleet/replica.py)."""
        if "max_len" not in serving:
            raise ValueError(
                f"{name}: fleet serving config needs 'max_len' (the"
                " per-slot KV cache span)")
        n = int(serving.get("replicas", 2))
        if n < 1:
            raise ValueError(f"{name}: replicas={n}: need >= 1")
        slo_ms = serving.get("slo_ttft_ms")
        router = Router(
            policy=str(serving.get("policy", "affine")),
            slo_ttft_s=None if slo_ms is None else float(slo_ms) / 1e3)
        batcher_kw = {
            k: serving[k]
            for k in ("max_len", "num_slots", "page_size",
                      "prefill_chunk_tokens", "prefix_cache_pages",
                      "max_queue")
            if k in serving
        }
        if draft is not None:
            # replicas share ONE draft model the same way they share the
            # target — each batcher carries its own draft KV caches
            batcher_kw["draft_model"] = draft
            batcher_kw["spec_tokens"] = int(
                (serving.get("speculative") or {}).get("tokens", 3))
        # register FIRST so the router's load-failure hook is wired
        # before any replica factory can fail
        server.register_fleet(name, router)
        for i in range(n):
            router.add_replica(
                f"r{i}",
                lambda i=i: Replica(f"r{i}", model, **batcher_kw))
        if not router.replica_names():
            # nothing came up: surface the entry itself as failed
            server.unregister(name)
            raise RuntimeError(
                f"{name}: all {n} fleet replicas failed to load")

    @staticmethod
    def _register_disagg(server, name: str, model, serving: dict,
                         model_dir: str) -> None:
        """Build a DISAGGREGATED serving fleet from one repository entry: a
        prefill pool and a
        decode pool of continuous-batching replicas behind one Router,
        bridged by the DisaggCoordinator's priced KV-handoff plane.
        Fresh requests route to the prefill pool, run chunked prefill to
        completion, and ship their finished KV pages to the least-loaded
        decode replica — token-identical to unified serving, with every
        failure mode degrading to local decode (zero-drop). Keys:
        prefill_replicas / decode_replicas (default 1 each), max_len
        (required), the per-replica batcher knobs the fleet mode shares,
        policy (default "least_loaded" — prefix affinity has no cross-
        pool meaning when every decode entry arrives with its KV), and
        machine_spec (optional hierarchical machine JSON — a path,
        resolved against the model dir, or an inline dict — pricing each
        handoff at the outermost tier the pools span; without it
        shipments are gated but unpriced)."""
        if "max_len" not in serving:
            raise ValueError(
                f"{name}: disagg serving config needs 'max_len' (the"
                " per-slot KV cache span)")
        if serving.get("speculative"):
            raise ValueError(
                f"{name}: serving.speculative is not supported with"
                " mode 'disagg' — a prefill replica never decodes, so a"
                " draft model there could never verify")
        n_pre = int(serving.get("prefill_replicas", 1))
        n_dec = int(serving.get("decode_replicas", 1))
        if n_pre < 1 or n_dec < 1:
            raise ValueError(
                f"{name}: prefill_replicas={n_pre},"
                f" decode_replicas={n_dec}: need >= 1 each")
        slo_ms = serving.get("slo_ttft_ms")
        router = Router(
            policy=str(serving.get("policy", "least_loaded")),
            slo_ttft_s=None if slo_ms is None else float(slo_ms) / 1e3)
        batcher_kw = {
            k: serving[k]
            for k in ("max_len", "num_slots", "page_size",
                      "prefill_chunk_tokens", "prefix_cache_pages",
                      "max_queue")
            if k in serving
        }
        machine = None
        spec = serving.get("machine_spec")
        if spec:
            if isinstance(spec, str) and not os.path.isabs(spec):
                spec = os.path.join(model_dir, spec)
            machine = HierarchicalMachineModel.from_json(
                load_machine_spec(spec))
        device_ids = tuple(range(machine.num_chips)) \
            if machine is not None else (0,)
        coordinator = DisaggCoordinator(
            router, machine=machine, device_ids=device_ids,
            wait_s=float(serving.get("handoff_wait_s", 30.0)))
        # register FIRST (load-failure hook), wire the coordinator into
        # the router's shutdown so unregister() drains the handoff plane
        # before stopping the replicas queued requests would resume on
        server.register_fleet(name, router)
        router.disagg = coordinator

        def prefill_factory(i: int) -> Replica:
            rep = Replica(f"prefill{i}", model, role="prefill",
                          **batcher_kw)
            coordinator.wire(rep)
            return rep

        for i in range(n_pre):
            router.add_replica(f"prefill{i}",
                               lambda i=i: prefill_factory(i))
        for i in range(n_dec):
            router.add_replica(
                f"decode{i}",
                lambda i=i: Replica(f"decode{i}", model, role="decode",
                                    **batcher_kw))
        roles = {n: router.replica(n).role for n in router.replica_names()}
        if "prefill" not in roles.values() \
                or "decode" not in roles.values():
            server.unregister(name)
            raise RuntimeError(
                f"{name}: a disagg fleet needs at least one prefill AND"
                f" one decode replica up (loaded: {roles})")
        # installs the priced-transfer SLO charge; prefill replicas are
        # already wired by their factories (re-wiring is idempotent)
        coordinator.attach_all()

    def unload(self, server, name: str) -> None:
        server.unregister(name)
