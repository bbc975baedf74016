"""Measure the explicit gradient-sync lowering on the ranks of a data
mesh (the port's copy of flexflow_tpu/obs/collective_bench.py).

    python -m flexflow_tpu_torch.obs.collective_bench [--world 4]
        [--device cuda|cpu] [--sizes-mb 0.25,1,4]
        [--strategies flat,rs_ar_ag,hier_ring] [--warmup 1] [--repeats 3]
        [--out DIR] [--fit-profile] [FFConfig flags, e.g. --machine-spec]

Starts `--world` ranks on this machine (runtime/distributed.py `spawn`;
gloo, host-staged, where the ranks share one card), lays them out as one
`data` axis (the surface runtime/collectives.py lowers the grad sync
onto), and sweeps {reduction strategy} x {bytes} of `lower_allreduce`
and, on a hierarchical machine spec, each tier's ring phase in
isolation (one all-reduce over that tier's groups). Each point is the
median of `--repeats` calls after `--warmup`, every rank starting
together (a barrier), timed on rank 0 with CUDA events on the card (the
host clock on the CPU). Every timing is an obs.calibrate row
(`CollectiveCalibration`: op, strategy, tier, bytes, measured_us beside
the machine model's prediction) in ``<out>/collective_calibration.json``,
the data `refit.fit_collective_coefficients` fits the per-tier link
scales from; ``--fit-profile`` runs that fit and writes
``<out>/fitted_profile.json``. A ``BENCH {...}`` line reports the
largest size per strategy; the last line is a JSON summary, and the
exit code is nonzero unless every point measured a positive time.

On ranks sharing one card over gloo these are the host's times of
staged collectives, not a mesh speed.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import sys
import tempfile
from typing import Any, Dict, List, Optional

DEFAULT_SIZES_MB = (0.25, 1.0, 4.0)
DEFAULT_STRATEGIES = ("flat", "rs_ar_ag", "hier_ring")


def _median_us(fn, x, warmup: int, repeats: int) -> float:
    """The median wall of `fn(x)` over `repeats` calls (after `warmup`),
    each started by every rank together."""
    import time

    import torch
    import torch.distributed as dist

    for _ in range(max(0, warmup)):
        fn(x)
    samples = []
    for _ in range(max(1, repeats)):
        dist.barrier()
        if x.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(x)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn(x)
            samples.append((time.perf_counter() - t0) * 1e6)
    return float(statistics.median(samples))


def sweep_collectives(config, sizes_bytes: List[int],
                      strategies: List[str], warmup: int = 1,
                      repeats: int = 3, mesh=None) -> Dict[str, Any]:
    """Run the sweep on the ranks of `mesh` (a core.machine.Mesh of one
    `data` axis; default: `make_mesh({"data": world})`, which every rank
    makes). Every rank of the world calls it, on `config.device` (the
    card unless the config asks for the CPU; no card raises). Returns {"rows": [...],
    "n_devices", "tiers", "group_sizes", "machine", "chip"} with rows as
    CollectiveCalibration objects, each rank's own timings (rank 0's are
    the record)."""
    import torch
    import torch.distributed as dist

    from ..core.machine import make_mesh
    from ..runtime.collectives import (all_reduce, lower_allreduce,
                                       make_tier_groups)
    from ..search.machine_model import make_machine_model
    from .calibration import CollectiveCalibration

    device = torch.device(config.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"sweep_collectives: config.device={config.device!r} but no "
                "CUDA device is visible; pass device='cpu' to sweep on the "
                "CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    n = dist.get_world_size()
    if mesh is None:
        mesh = make_mesh({"data": n}) if n > 1 else None
    if mesh is not None and mesh.device.type != device.type:
        raise ValueError(
            f"config.device={config.device!r}, but this rank was initialized"
            f" on {mesh.device}")
    machine = make_machine_model(config, n)
    tier_path = (machine.tier_path(n)
                 if hasattr(machine, "tier_path") else [])
    if tier_path and math.prod(ni for _, ni in tier_path) != n:
        print(f"collective-bench: machine spec tiers do not factor the"
              f" {n}-rank mesh; sweeping flat", file=sys.stderr)
        tier_path = []
    group_sizes = [ni for _, ni in tier_path] or [n]
    tier_names = [t.name for t, _ in tier_path] or ["mesh"]
    outer_tier = tier_names[-1]
    tiers = (make_tier_groups(mesh, group_sizes)
             if mesh is not None and len(group_sizes) > 1 else None)
    flat_group = mesh.group("data") if mesh is not None else None
    rows: List[CollectiveCalibration] = []
    for strategy in strategies:
        if n <= 1:
            break
        if strategy != "flat" and len(group_sizes) <= 1:
            continue  # nothing to decompose on a flat machine
        for size in sizes_bytes:
            elems = max(1, int(size) // 4)
            x = torch.ones(elems, dtype=torch.float32, device=device)
            measured = _median_us(
                lambda t, s=strategy: lower_allreduce(t, s, tiers,
                                                      flat_group),
                x, warmup, repeats)
            bytes_ = elems * 4.0
            if hasattr(machine, "tier_path"):
                predicted = machine.allreduce_time_us(bytes_, n,
                                                      strategy=strategy)
            else:
                predicted = machine.allreduce_time_us(bytes_, n)
            rows.append(CollectiveCalibration(
                op="allreduce", strategy=strategy, tier=outer_tier,
                bytes=bytes_, participants=n, predicted_us=predicted,
                measured_us=measured))
    # each tier's ring phase in isolation: the per-tier fit's evidence
    for level, (tname, nj) in enumerate(zip(tier_names, group_sizes)):
        if nj <= 1 or n <= 1:
            continue
        group = tiers.groups[level] if tiers is not None else flat_group
        for size in sizes_bytes:
            elems = max(1, int(size) // 4)
            x = torch.ones(elems, dtype=torch.float32, device=device)
            measured = _median_us(lambda t, g=group: all_reduce(t, g), x,
                                  warmup, repeats)
            bytes_ = elems * 4.0
            if tier_path:
                tier = next(t for t, _ in tier_path if t.name == tname)
                predicted = (2.0 * (nj - 1) / nj * bytes_
                             / machine.tier_bw(tier) * 1e6
                             + machine.tier_latency(tier))
            else:
                predicted = machine.allreduce_time_us(bytes_, n)
            rows.append(CollectiveCalibration(
                op="psum", strategy="tier_ring", tier=tname,
                bytes=bytes_, participants=nj, predicted_us=predicted,
                measured_us=measured))
    return {"rows": rows, "n_devices": n, "tiers": tier_names,
            "group_sizes": group_sizes,
            "machine": type(machine).__name__, "chip": machine.chip.name}


def _rank_sweep(rank: int, world: int, init: str, device: str,
                argv: List[str], sizes: List[int], strategies: List[str],
                warmup: int, repeats: int):
    """One spawned rank: join the group, sweep, leave; rank 0's result
    (rows as dicts) comes back."""
    from ..config import FFConfig
    from ..runtime import distributed

    distributed.initialize(init, world_size=world, rank=rank, device=device)
    try:
        config = FFConfig(device=device)
        config.parse_args(list(argv))
        result = sweep_collectives(config, sizes, strategies, warmup=warmup,
                                   repeats=repeats)
        result["rows"] = [r.to_dict() for r in result["rows"]]
        return result
    finally:
        distributed.shutdown()


def _take(argv: List[str], flag: str, default, cast=str):
    if flag not in argv:
        return default
    i = argv.index(flag)
    value = argv[i + 1]
    del argv[i:i + 2]
    return cast(value)


def run_collective_bench(argv: Optional[List[str]] = None) -> int:
    from ..runtime.distributed import spawn
    from .calibration import CollectiveCalibration

    argv = list(argv or [])
    out_dir = _take(argv, "--out", "collective_bench_out")
    warmup = _take(argv, "--warmup", 1, cast=int)
    repeats = _take(argv, "--repeats", 3, cast=int)
    world = _take(argv, "--world", 4, cast=int)
    device = _take(argv, "--device", "cuda")
    sizes_spec = _take(argv, "--sizes-mb",
                       ",".join(str(s) for s in DEFAULT_SIZES_MB))
    strategies_spec = _take(argv, "--strategies",
                            ",".join(DEFAULT_STRATEGIES))
    fit_profile = "--fit-profile" in argv
    if fit_profile:
        argv.remove("--fit-profile")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("collective-bench: no CUDA device visible (--device cpu "
                  "runs the ranks on the CPU)", file=sys.stderr)
            return 2
    try:
        sizes = [max(4, int(float(s) * 1e6))
                 for s in sizes_spec.split(",") if s.strip()]
    except ValueError:
        raise SystemExit(f"--sizes-mb: cannot parse {sizes_spec!r}") \
            from None
    strategies = [s.strip() for s in strategies_spec.split(",")
                  if s.strip()]
    bad = set(strategies) - set(DEFAULT_STRATEGIES)
    if bad:
        raise SystemExit(f"--strategies: unknown {sorted(bad)}; choices:"
                         f" {DEFAULT_STRATEGIES}")
    from ..config import FFConfig

    config = FFConfig(device=device)
    config.parse_args(list(argv))  # unknown flags raise here, not on ranks
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        result = spawn(_rank_sweep, world,
                       (world, init, device, argv, sizes, strategies,
                        warmup, repeats), timeout_s=900)[0]
    rows = [CollectiveCalibration(**{k: v for k, v in r.items()
                                     if k != "ratio"})
            for r in result["rows"]]
    cal_path = os.path.join(out_dir, "collective_calibration.json")
    with open(cal_path, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    problems: List[str] = []
    if not rows:
        problems.append("no collectives measurable (one rank?)")
    for r in rows:
        if not (r.measured_us > 0 and math.isfinite(r.measured_us)):
            problems.append(
                f"{r.op}/{r.strategy}/{r.tier}@{int(r.bytes)}B measured"
                f" {r.measured_us!r}")
    profile_path = None
    if fit_profile and rows:
        from ..search.machine_model import make_machine_model
        from .refit import FittedProfile, fit_collective_coefficients

        machine = make_machine_model(config, world)
        coeffs = fit_collective_coefficients(rows, machine)
        profile_path = FittedProfile(
            chip=machine.chip.name, backend=device,
            coefficients=coeffs, fitted_ops=len(rows), num_chips=world,
        ).save(os.path.join(out_dir, "fitted_profile.json"))
    largest: Dict[str, Any] = {}
    for r in rows:
        if r.op != "allreduce":
            continue
        cur = largest.get(r.strategy)
        if cur is None or r.bytes > cur["bytes"]:
            largest[r.strategy] = {"bytes": r.bytes,
                                   "measured_us": r.measured_us,
                                   "predicted_us": r.predicted_us}
    print("BENCH " + json.dumps({
        "metric": "collective_allreduce_us", "n_devices": world,
        "tiers": result["tiers"], "per_strategy": largest,
        "rows": len(rows), "calibration": cal_path,
        "fitted_profile": profile_path}))
    print(json.dumps({"ok": not problems, "out": out_dir, "rows": len(rows),
                      "tiers": result["tiers"],
                      "fitted_profile": profile_path,
                      "problems": problems}))
    return 0 if not problems else 1


if __name__ == "__main__":
    sys.exit(run_collective_bench(sys.argv[1:]))
