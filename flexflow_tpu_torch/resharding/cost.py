"""Price a ReshardSchedule with the machine model's collective terms.

The hook the simulator (search/simulator.py::reshard_cost_us) and the
serving resize path use to put a microsecond figure on a redistribution
BEFORE running it — so an elastic recovery can be compared against the
disk restore it replaces, and a mesh resize against the decode
iterations it displaces. Pricing reuses the SAME MachineModel collective
formulas the Unity search costs plans with (allgather_time_us /
p2p_time_us), so a resize is priced in the same currency as the plans it
moves between.

On a hierarchical machine (machine_model.HierarchicalMachineModel,
docs/machine.md) the same calls decompose over the tier path the step's
participant group spans — an allgather that crosses the DCN tier is
priced at DCN bandwidth, not like a neighbor hop — so redistribution
schedules stay communication-minimal across tiers (arXiv:2112.01075)
without this module knowing about tiers at all.
"""
from __future__ import annotations

from .plan import ALLGATHER, PERMUTE, SLICE, TRANSFER, ReshardSchedule


def step_cost_us(step, machine, n_devices: int = 0) -> float:
    if step.kind == ALLGATHER:
        n = max(2, step.participants)
        # allgather_time_us takes per-shard bytes; the step records the
        # total a chip receives ((n-1) shards)
        return machine.allgather_time_us(
            step.bytes_per_chip / max(1, n - 1), n)
    if step.kind in (TRANSFER, PERMUTE):
        # on a hierarchical machine the DEVICE GROUP fixes the tiers a
        # transfer crosses: a redistribution landing on a mesh spanning
        # two pods pays the DCN hop, not the innermost-link p2p a flat
        # model prices. The span is the target mesh's device count
        # (`n_devices`, threaded by schedule_cost_us) — NOT
        # step.participants, which records the array's new sharding
        # degree and is 1 for a replicated landing even when the
        # replicas live across pods. (ring_hop_time_us = the slowest
        # tier an n-group's simultaneous transfer rides; one-tier
        # groups keep the flat price.)
        span = max(int(n_devices), step.participants)
        if hasattr(machine, "ring_hop_time_us") and span > 1:
            return machine.ring_hop_time_us(step.bytes_per_chip, span)
        return machine.p2p_time_us(step.bytes_per_chip)
    if step.kind == SLICE:
        # local carve-out: HBM-bound read+write of the kept shard, which
        # the scratch model sizes as both sides of the round in flight
        return machine.compute_time_us(0.0, step.scratch_bytes)
    raise ValueError(f"unknown reshard step kind {step.kind!r}")


def schedule_cost_us(schedule: ReshardSchedule, machine) -> float:
    """Total predicted wall time of the schedule in microseconds: moves
    run serially, each round re-issuing its step sequence."""
    n_devices = len(schedule.new_mesh.device_ids)
    total = 0.0
    for move in schedule.moves:
        if move.noop:
            continue
        per_round = sum(step_cost_us(s, machine, n_devices=n_devices)
                        for s in move.steps)
        total += move.rounds * per_round
    return total
